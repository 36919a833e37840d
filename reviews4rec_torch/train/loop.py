"""Training loop of the port, for every SGD model (the id models
bias_only, MF_dot, MF, GMF, MLP, NeuMF; the review models deepconn,
deepconn++, NARRE, transnet, transnet++, MPCN). Counterpart of
`reviews4rec_tpu/train/loop.py` (`make_optimizer`, `_batch_loss`,
`train_epoch` and `train_epoch_cached` as one `train_epoch`, the device
doc caches, `train_complete`), with the same dynamics:

- Adam with additive (not decoupled) L2 weight decay: torch's
  `Adam(weight_decay=...)` is optax's `add_decayed_weights` then `adam`.
  The frozen word table is a buffer, so it never reaches the optimizer.
  MPCN's recipe (`ClippedAdam`): the gradient plus `mpcn_l2` * param,
  then optax's global-norm clip at `mpcn_clip_norm`, then Adam at
  `mpcn_lr` with no decay of its own, all on the device.
- per-batch loss: the mean squared error over the real rows of the
  padded batch. transnet's is routed: source MSE + target MSE +
  the transform loss, with `.detach()` inside the model sending each
  term to its own parameters. The reference steps three Adam optimizers
  on disjoint parameter groups from three backward passes of one
  forward; all three gradients are taken at the same point, each group
  gets only its own loss's gradient, and Adam is elementwise, so one
  Adam step on the routed sum makes the same updates.
- `hp.loss` CE / BPR / HINGE (`train.losses`): the model scores [B, C]
  candidate grids with the positive in column 0
  (`ReviewDataset.materialize_train_negs`, train at hp.seed, val at
  hp.seed + 1), and the epoch's "MSE" is its mean training loss.
  transnet refuses them, as JAX does.
- per-epoch validation (MSE, or for a ranking loss HR@k over the val
  grids, selected by -HR@1), a best-validation snapshot of the params,
  `early_stop` patience, a checkpoint each epoch and `hp.resume`.

Randomness: the JAX RNG streams cannot be reproduced in torch. The port
keys its own by the absolute epoch, as the JAX loop does: one
`torch.Generator` per epoch on the model's device, seeded from
(hp.seed, epoch), draws every dropout mask of that epoch in step order,
and the `Batcher` shuffle is keyed by seed + epoch. A resumed run is
therefore the same as an uninterrupted one. MPCN's Gumbel uniforms come
from the same generator as the dropout masks (JAX splits the two
streams), so its trajectories are the port's own.

The device caches (`hp.cache_doc_embeds`) keep a split's records on the
device, so a step moves only [B] row ids from the host:

- the per-example doc cache: every doc pre-embedded through the frozen
  word table ([N, T, E] f32), or kept as int ids per `hp.cache_sides`;
- the entity cache (`hp.cache_entity`): one doc per user and per item
  (`build_entity_tables`) plus per-example ids, ratings and the (start,
  len) span of the pair's own review, which the towers mask in place.
  With `hp.pallas_fuse_rows` the float tables reach the towers whole
  (`<side>_doc__table` keys) and the row-gathered kernels read each
  example's row themselves; without it the step gathers `table[rows]`.

`hp.scan_steps` = S > 1 groups S batches into one dispatch, as the JAX
package's `lax.scan` over S batches does (`ScanSteps`): on the card a
full group is one replay of a CUDA graph of S captured steps (Adam is
built `capturable` there for every S, so graph and single steps run the
same arithmetic), on the CPU its S steps run eagerly; a trailing group
smaller than S runs as single steps. The updates, their order and the
dropout masks are those of S = 1, bit for bit.

`hp.mesh_shape` other than (1, 1) trains on a (data, model) mesh of
`torch.distributed` ranks (`parallel.mesh`): `train_complete` lays the
model out on it (row-sharded tables over the model axis), every rank
takes its rows of each batch, the caches keep each data rank's example
rows, the gradients are summed over the mesh before Adam, and the
checkpoint, whole tables gathered, is written by the primary process.
The metrics are the single-device ones up to the order of the sums.

Over NARRE's per-review entity cache (rows > 1) every training step adds
to four counters of `train.profiler.counters`, from the host's own row
ids, graph replays included (`review_counts`): `narre.review_rows` and
`narre.review_words` (the review rows and word slots the two towers
encode), `narre.review_rows_live` (the rows holding a review the step
does not mask) and `narre.review_words_live` (the slots holding a
word). The gather of those tables is the span `cache.gather_rows`.
"""

from __future__ import annotations

import collections
import contextlib
import os
import statistics
import time
import weakref
from typing import Dict, Iterable, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import HyperParams
from ..data.batcher import Batcher
from ..data.corpus import NEIGHBOR_SLOTS, _doc_layout
from ..parallel.distributed import host_count, is_primary
from ..parallel.mesh import (full_opt_state, full_params, host_slice,
                             local_opt_state, local_params, mesh_from_hp,
                             model_mesh, reduce_grads, shard_cache,
                             shard_model)
from ..utils.device import host_tensor, to_device
from ..utils.logging import file_write, log_end_epoch
from . import profiler
from .checkpoint import load_checkpoint, save_checkpoint
from .evaluate import eval_ranking, evaluate, evaluate_cached
from .losses import bpr, hinge, softmax_ce
from .profiler import Throughput, annotate, count

Params = Dict[str, torch.Tensor]


def check_trainable(hp: HyperParams) -> None:
    """Raise for the training options the JAX trainer refuses."""
    if hp.loss != "RAW_MSE" and hp.model_type in ("transnet", "transnet++"):
        raise ValueError("ranking losses are not defined for transnet's "
                         "routed 3-loss objective; use loss='RAW_MSE'")


class ClippedAdam(torch.optim.Adam):
    """MPCN's optimizer, optax's `chain(add_decayed_weights(l2),
    clip_by_global_norm(max_norm), adam(lr))`: each gradient plus
    l2 * param, then all of them scaled by max_norm / ||g|| (g / ||g|| *
    max_norm, optax's form) where the global norm ||g|| >= max_norm,
    then Adam with no decay. The clip is a `torch.where` on the device
    with no host read, so a CUDA graph can hold it. (torch's
    `Adam(weight_decay=)` would add the decay after a clip, and
    `clip_grad_norm_` scales by max_norm / (||g|| + 1e-6).) On a mesh
    whose model axis shards some of the params (`sharded`), their
    squared norms are summed over that axis first."""

    def __init__(self, params, lr: float, l2: float, max_norm: float,
                 capturable: bool = False, sharded=(), mesh=None):
        super().__init__(params, lr=lr, weight_decay=0.0,
                         capturable=capturable)
        self.l2, self.max_norm = float(l2), float(max_norm)
        self.sharded, self.mesh = {id(p) for p in sharded}, mesh

    @torch.no_grad()
    def step(self, closure=None):
        params = [p for group in self.param_groups for p in group["params"]
                  if p.grad is not None]
        if params:
            grads = [p.grad for p in params]
            if self.l2:
                torch._foreach_add_(grads, params, alpha=self.l2)
            sq = [g.square().sum() for g in grads]
            if self.sharded:
                rows = [s for p, s in zip(params, sq) if id(p) in self.sharded]
                sq = [s for p, s in zip(params, sq)
                      if id(p) not in self.sharded]
                rows = (torch.stack(rows).sum() if rows
                        else torch.zeros_like(sq[0]))
                sq.append(self.mesh.all_reduce(rows, self.mesh.model_axis))
            norm = torch.stack(sq).sum().sqrt()
            keep = norm < self.max_norm
            for g in grads:
                g.copy_(torch.where(keep, g, g / norm * self.max_norm))
        return super().step(closure)


class Adam(torch.optim.Adam):
    """torch's Adam with additive L2, whose capturable step takes its bias
    corrections 1 - beta^t in float64 on the device. torch's capturable
    form raises the f32 beta to the f32 step count: 1 - f32(0.999) is
    1.3e-5 off 1e-3 at t = 1, which moved every update of the first steps
    by about 6e-6 of itself against Adam in exact arithmetic (enough, on
    NARRE, to move a max-pool near-tie a few steps later). The rest is
    torch's arithmetic in f32. A group whose parameters all have a
    gradient advances their step counts together, so one count gives its
    corrections; a group with a parameter left without one takes torch's
    step, as do the non-capturable (CPU) groups."""

    @torch.no_grad()
    def step(self, closure=None):
        groups = [g for g in self.param_groups
                  if g["capturable"] and not g["amsgrad"] and not g["maximize"]
                  and all(p.grad is not None for p in g["params"])]
        if len(groups) != len(self.param_groups):
            return super().step(closure)
        for group in groups:
            params = group["params"]
            if not params:
                continue
            beta1, beta2 = group["betas"]
            for p in params:
                state = self.state[p]
                if not state:
                    state["step"] = torch.zeros((), dtype=torch.float32,
                                                device=p.device)
                    state["exp_avg"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
                    state["exp_avg_sq"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
            steps = [self.state[p]["step"] for p in params]
            exp_avgs = [self.state[p]["exp_avg"] for p in params]
            exp_avg_sqs = [self.state[p]["exp_avg_sq"] for p in params]
            grads = [p.grad for p in params]
            torch._foreach_add_(steps, 1)
            if group["weight_decay"]:
                grads = torch._foreach_add(grads, params,
                                           alpha=group["weight_decay"])
            torch._foreach_lerp_(exp_avgs, grads, 1 - beta1)
            torch._foreach_mul_(exp_avg_sqs, beta2)
            torch._foreach_addcmul_(exp_avg_sqs, grads, grads, 1 - beta2)
            t = steps[0].double()
            step_size = (group["lr"] / (1 - torch.pow(beta1, t))).float()
            bc2_sqrt = torch.sqrt(1 - torch.pow(beta2, t)).float()
            denom = torch._foreach_sqrt(exp_avg_sqs)
            torch._foreach_div_(denom, bc2_sqrt)
            torch._foreach_add_(denom, group["eps"])
            update = torch._foreach_div(exp_avgs, denom)
            torch._foreach_mul_(update, step_size)
            torch._foreach_sub_(params, update)
        return None


def make_optimizer(hp: HyperParams, model: torch.nn.Module
                   ) -> torch.optim.Optimizer:
    """Adam with additive L2 (`Adam`; MPCN: `ClippedAdam`). On the card it
    is built `capturable` (step count and bias corrections as device
    tensors) for every `hp.scan_steps`, so that steps replayed from a
    CUDA graph and single steps run the same arithmetic."""
    params = list(model.parameters())
    capturable = bool(params) and params[0].device.type == "cuda"
    if hp.model_type == "MPCN":
        rows = getattr(model, "_mesh_rows", {})
        sharded = [p for name, p in model.named_parameters() if name in rows]
        return ClippedAdam(params, hp.mpcn_lr, hp.mpcn_l2, hp.mpcn_clip_norm,
                           capturable=capturable, sharded=sharded,
                           mesh=model_mesh(model))
    return Adam(params, lr=hp.lr, weight_decay=hp.weight_decay,
                capturable=capturable)


def _batch_loss(preds, batch: Dict[str, torch.Tensor],
                loss_name: str = "RAW_MSE", hinge_margin: float = 0.2,
                total=None
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The masked batch loss and its epoch accumulators.

    RAW_MSE over the real rows: (loss, (sum(sq * w), sum(w))). For
    transnet's (source, target, trans_loss) the loss is the routed sum
    (module docstring) and the sums are the source net's. CE / BPR /
    HINGE score [B, C] grids with the positive in column 0 (hinge summed
    over the pairs, then divided by the real rows, as JAX does), and the
    accumulators are (loss * sum(w), sum(w)).

    On a mesh's data axis, `batch` is this rank's rows and `total` sums
    a per-rank count over the axis: every normaliser is the whole
    batch's, so the rank losses (and gradients) add up to the batch's,
    and the accumulators add up over the ranks."""
    w = batch["weight"]
    y = batch["rating"]
    n = torch.sum(w)
    n_all = n if total is None else total(n)
    denom = torch.clamp(n_all, min=1.0)
    if isinstance(preds, tuple):
        source, target, trans_loss = preds
        sq_sum = torch.sum((source - y) ** 2 * w)
        loss = (sq_sum / denom + torch.sum((target - y) ** 2 * w) / denom
                + trans_loss)
        return loss, (sq_sum, n)
    if loss_name == "RAW_MSE":
        sq_sum = torch.sum((preds - y) ** 2 * w)
        return sq_sum / denom, (sq_sum, n)
    pos, neg = preds[:, :1], preds[:, 1:]
    wn = w[:, None].expand(neg.shape)
    if loss_name == "CE":
        labels = torch.zeros_like(preds)
        labels[:, 0] = 1.0
        loss = softmax_ce(preds, labels, w, denom=n_all)
    elif loss_name == "BPR":
        pairs = torch.sum(wn)
        loss = bpr(pos, neg, wn,
                   denom=pairs if total is None else total(pairs))
    elif loss_name == "HINGE":
        loss = hinge(pos, neg, hinge_margin, wn) / denom
    else:
        raise ValueError(f"unknown loss {loss_name!r}")
    return loss, (loss * n_all, n)


def train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None,
               loss_name: str = "RAW_MSE", hinge_margin: float = 0.2
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One update on one batch; returns (loss, and `_batch_loss`'s two
    accumulators) as device scalars, without waiting for the device. On a
    mesh (`parallel.mesh.shard_model`) `batch` is this rank's rows, the
    loss is normalised over the data axis and the gradients are summed
    over the mesh before the update; the returned loss is this rank's
    share."""
    mesh = model_mesh(model)
    total = (None if mesh is None else
             (lambda t: mesh.all_reduce(t, mesh.data_axis)))
    preds = model(batch, generator=generator)
    loss, (sq_sum, n) = _batch_loss(preds, batch, loss_name, hinge_margin,
                                    total)
    loss.backward()
    reduce_grads(model)
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)
    return loss.detach(), sq_sum.detach(), n.detach()


def epoch_generator(seed: int, epoch: int, device: torch.device
                    ) -> torch.Generator:
    """The dropout stream of one epoch, keyed by (seed, epoch)."""
    key = int(np.random.SeedSequence([seed, epoch]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(key)


def _lookahead(it: Iterable, depth: int = 2) -> Iterator:
    """Run the (eagerly placing) iterator `depth` items ahead of its
    consumer, so the next batch's copy is issued before this step."""
    buf: collections.deque = collections.deque()
    for item in it:
        buf.append(item)
        if len(buf) >= depth:
            yield buf.popleft()
    while buf:
        yield buf.popleft()


def _prefetch(batcher: Batcher, device: torch.device, depth: int = 2,
              mesh=None, counts=None):
    def placed():
        for b in batcher:
            b = host_slice(b, mesh)
            count_reviews(counts, [b])
            yield to_device(b, device)
    return _lookahead(placed(), depth)


class ScanSteps:
    """`hp.scan_steps` = S > 1: S training steps per dispatch, the JAX
    package's `lax.scan` over S batches (`make_scan_train_step`,
    `make_cached_train_step`), with the same updates in the same order
    as S single steps. On a mesh each rank stages its rows of the group
    and runs the S steps eagerly: a CUDA graph cannot capture a gloo
    collective (NCCL capture waits for a machine with a card a rank).

    A full group of S batches is staged into static [S, B, ...] input
    buffers (host records on the uncached path; [S, B] row ids and
    weights into a device `cache`, whose gather runs inside the group).
    On the card the group is one replay of a `torch.cuda.CUDAGraph`
    holding S captured `train_step`s, step s reading slice s: forward,
    the CUDA kernels, backward and Adam. The host stacks a group into one
    of two reused pinned buffers (one event each) and copies it with one
    transfer a key. On the CPU the group runs its S steps eagerly from
    the same buffers. A trailing group smaller than S runs as single
    steps, as JAX's does.

    The graph is captured at the first full group, after one warm-up step
    on the capture stream (which builds the kernel libraries, the dG
    workspace of that stream and the optimizer state) whose updates are
    then undone, so the warm-up changes nothing. It is captured again if
    a parameter or optimizer state tensor was replaced since. The dropout
    masks (and MPCN's Gumbel uniforms) come from one generator registered
    with the graph and set to the epoch's stream at the start of each
    epoch, so replays and single steps draw what eager steps draw, and
    resume stays keyed by (seed, epoch). The squared-error sums add up on
    the device across groups. Each replay adds to
    `train.profiler.counters` what the counters gained during its capture
    (the kernel launches of the S steps). A failure to capture or replay
    raises; a group never falls back to eager steps on the card.

    Spans (`train.profiler.annotate`): `scan.ring_wait` (the host waiting
    for its pinned slot's last copy), `scan.stage` (the group stacked
    into the slot and its copies enqueued; on the CPU the copy itself),
    `scan.capture` (counted in `profiler.counters["scan.captures"]`) and
    `scan.replay`. Each group's batches add to the review counters
    (`count_reviews`) from their host row ids, whether they replay or run
    eagerly.
    """

    def __init__(self, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer, steps: int,
                 device: torch.device, cache=None,
                 loss_name: str = "RAW_MSE", hinge_margin: float = 0.2):
        if steps < 2:
            raise ValueError(f"ScanSteps groups 2 or more steps, got {steps}")
        self.model, self.optimizer = model, optimizer
        self.objective = (loss_name, hinge_margin)
        self.steps, self.device, self.cache = steps, device, cache
        self.mesh = model_mesh(model)
        self.counts = review_counts(cache)
        self.on_card = device.type == "cuda" and self.mesh is None
        self.sq_sum = torch.zeros((), device=device)
        self.n = torch.zeros((), device=device)
        self.gen: Optional[torch.Generator] = None
        self._own_gen = (torch.Generator(device=device) if self.on_card
                         else None)
        self.static: Optional[Dict[str, torch.Tensor]] = None
        self._ring = [None, None]    # pinned host buffers
        self._events = [None, None]  # the copy out of each
        self._slot = 0
        self.graph = None
        self._addresses: Tuple[int, ...] = ()
        # the counts of one replay: what the counters gained in capture
        self.counted: Dict[str, int] = {}

    def start_epoch(self, generator: Optional[torch.Generator]) -> None:
        """Zero the sums and point the dropout stream at `generator`'s."""
        self.sq_sum.zero_()
        self.n.zero_()
        if generator is None or not self.on_card:
            self.gen = generator
        else:
            self._own_gen.set_state(generator.get_state())
            self.gen = self._own_gen

    def run(self, group) -> None:
        """Train on a list of host batches: one dispatch for S of them,
        single steps for fewer."""
        group = [host_slice(batch, self.mesh) for batch in group]
        count_reviews(self.counts, group)
        if len(group) < self.steps:
            for batch in group:
                self._step(to_device(batch, self.device))
            return
        self._stage(group)
        if not self.on_card:
            for s in range(self.steps):
                self._body(s)
            return
        if self.graph is None or self._addresses != self._state_addresses():
            with annotate("scan.capture"):
                count("scan.captures")
                self._capture()
        with annotate("scan.replay"):
            try:
                self.graph.replay()
            except RuntimeError as exc:
                raise RuntimeError(f"CUDA-graph replay of {self.steps} "
                                   f"training steps failed: {exc}") from exc
        for name, n in self.counted.items():
            count(name, n)

    def _step(self, batch: Dict[str, torch.Tensor]) -> None:
        """One step on a batch on the device ({"row", "weight"} with a
        cache), its sums added to the epoch's."""
        if self.cache is not None:
            batch = gather_cached_batch(self.cache, batch["row"],
                                        batch["weight"])
        _, sq, c = train_step(self.model, self.optimizer, batch, self.gen,
                              *self.objective)
        self.sq_sum += sq
        self.n += c

    def _body(self, s: int) -> None:
        """Training step s of the staged group: what the graph captures."""
        self._step({k: v[s] for k, v in self.static.items()})

    def _stage(self, group) -> None:
        """The group's batches into the static [S, B, ...] buffers."""
        first = group[0]
        if self.static is None:
            self.static = {
                k: torch.empty((self.steps,) + v.shape,
                               dtype=torch.from_numpy(np.asarray(v)).dtype,
                               device=self.device)
                for k, v in first.items()}
        if not self.on_card:
            with annotate("scan.stage"):
                for k, dst in self.static.items():
                    dst.copy_(torch.from_numpy(
                        np.stack([b[k] for b in group])))
            return
        slot = self._slot
        self._slot ^= 1
        if self._ring[slot] is None:
            self._ring[slot] = {k: torch.empty(v.shape, dtype=v.dtype,
                                               pin_memory=True)
                                for k, v in self.static.items()}
        else:
            with annotate("scan.ring_wait"):
                self._events[slot].synchronize()   # its last copy has left
        with annotate("scan.stage"):
            for k, host in self._ring[slot].items():
                arr = host.numpy()
                for s, batch in enumerate(group):
                    arr[s] = batch[k]
                self.static[k].copy_(host, non_blocking=True)
            self._events[slot] = torch.cuda.Event()
            self._events[slot].record()

    def _tensors(self):
        """The parameters and the tensors of their optimizer state."""
        params = [p for grp in self.optimizer.param_groups
                  for p in grp["params"]]
        state = [v for p in params
                 for v in self.optimizer.state.get(p, {}).values()
                 if torch.is_tensor(v)]
        return params, state

    def _state_addresses(self) -> Tuple[int, ...]:
        params, state = self._tensors()
        return tuple(t.data_ptr() for t in params + state)

    def _capture(self) -> None:
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        # warm-up on the capture stream, then every update it made undone
        params, state = self._tensors()
        had_state = {p for p in params if self.optimizer.state.get(p)}
        saved = [t.detach().clone() for t in params + state]
        sums = (self.sq_sum.clone(), self.n.clone())
        gen_state = self.gen.get_state() if self.gen is not None else None
        with torch.cuda.stream(stream):
            self._body(0)
        torch.cuda.current_stream(self.device).wait_stream(stream)
        with torch.no_grad():
            for t, v in zip(params + state, saved):
                t.copy_(v)
            for p in params:
                if p.requires_grad and not self.optimizer.state.get(p):
                    raise RuntimeError(
                        f"CUDA-graph capture: a parameter of shape "
                        f"{tuple(p.shape)} got no optimizer state in the "
                        f"warm-up step; capture would create it inside the "
                        f"graph")
                if p not in had_state:   # a fresh Adam state is all 0
                    for v in self.optimizer.state[p].values():
                        if torch.is_tensor(v):
                            v.zero_()
            self.sq_sum.copy_(sums[0])
            self.n.copy_(sums[1])
        if gen_state is not None:
            self.gen.set_state(gen_state)
        graph = torch.cuda.CUDAGraph()
        if self.gen is not None:
            graph.register_generator_state(self.gen)
        counters = profiler.counters
        before = dict(counters)
        try:
            with torch.cuda.graph(graph, stream=stream):
                for s in range(self.steps):
                    self._body(s)
        except RuntimeError as exc:
            raise RuntimeError(f"CUDA-graph capture of {self.steps} training "
                               f"steps failed: {exc}") from exc
        finally:
            counted = {k: v - before.get(k, 0) for k, v in counters.items()}
            counters.clear()
            counters.update(before)
        self.counted = {k: v for k, v in counted.items() if v}
        self.graph = graph
        self._addresses = self._state_addresses()


def _groups(batcher: Batcher, size: int) -> Iterator[list]:
    """The batcher's batches in lists of `size`, the last one shorter."""
    group = []
    for batch in batcher:
        group.append(batch)
        if len(group) == size:
            yield group
            group = []
    if group:
        yield group


def train_epoch(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                batcher: Batcher, generator: Optional[torch.Generator],
                device: torch.device, cache=None,
                scan: Optional[ScanSteps] = None, loss_name: str = "RAW_MSE",
                hinge_margin: float = 0.2) -> Dict:
    """One epoch of updates, in batch order. The squared-error sums stay
    on the device until the end of the epoch: one sync per epoch. Under a
    ranking `loss_name` the epoch's "MSE" is its mean loss (`scan`
    carries its own objective).

    With a device `cache` (the JAX package's `train_epoch_cached`),
    `batcher` iterates {"row", "weight"}: a Batcher over {"row":
    arange(n)} with the record Batcher's seed, so the shuffle is the
    record Batcher's, and each step gathers its batch on the device.
    Padded tail rows gather row 0 with weight 0, so loss and gradients
    are the padded batch's.

    With `scan` (a `ScanSteps` over the same model, optimizer and
    cache), full groups of `scan.steps` batches run one dispatch each;
    without, every batch is a single step, its host batch copied through
    pinned memory two steps ahead.

    On a mesh (`parallel.mesh.shard_model`) every rank takes its rows of
    each batch, and the epoch's sums are summed over the data axis."""
    with annotate("train_epoch"):
        model.train()
        mesh = model_mesh(model)
        tp = Throughput()
        bs, remaining = batcher.batch_size, batcher.n
        if scan is not None:
            scan.start_epoch(generator)
            for group in _groups(batcher, scan.steps):
                with annotate("train_step" if len(group) < scan.steps
                              else "train_group"):
                    scan.run(group)
                for _ in group:
                    tp.add(min(bs, remaining))
                    remaining -= bs
            sq_sum, n = scan.sq_sum, scan.n
        else:
            sq_sum = torch.zeros((), device=device)
            n = torch.zeros((), device=device)
            for batch in _prefetch(batcher, device, mesh=mesh,
                                   counts=review_counts(cache)):
                with annotate("train_step"):
                    if cache is not None:
                        batch = gather_cached_batch(cache, batch["row"],
                                                    batch["weight"])
                    _, s, c = train_step(model, optimizer, batch, generator,
                                         loss_name, hinge_margin)
                sq_sum += s
                n += c
                tp.add(min(bs, remaining))
                remaining -= bs
        if mesh is not None:
            sq_sum, n = mesh.all_reduce(torch.stack([sq_sum, n]),
                                        mesh.data_axis)
        total, seen = float(sq_sum), float(n)   # the epoch's one sync
        return {"MSE": round(total / max(seen, 1.0), 4), **tp.metrics()}


# ---------------------------------------------------------------------
# device caches (hp.cache_doc_embeds, hp.cache_entity)
# ---------------------------------------------------------------------
# Doc tensors that embed through the FROZEN word table: the keys the
# device cache pre-embeds.
DOC_KEYS = ("user_doc", "item_doc", "this_doc")


def doc_cache_keys(model_type: str, sides: str = "both"
                   ) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """(embed_keys, id_keys) for the device cache. embed_keys are
    pre-embedded through the frozen table; id_keys stay int32 ids on the
    device and are embedded by the model (the same values, at 4 bytes a
    word instead of 4 E). Only transnet reads `this_doc`. `sides`
    (hp.cache_sides): both | item | user pre-embeds those sides (this_doc
    counts as item side), ids none."""
    read = (DOC_KEYS if model_type in ("transnet", "transnet++")
            else ("user_doc", "item_doc"))
    side_of = {"user_doc": "user", "item_doc": "item", "this_doc": "item"}
    if sides == "both":
        embed = read
    elif sides == "ids":
        embed = ()
    elif sides in ("item", "user"):
        embed = tuple(k for k in read if side_of[k] == sides)
    else:
        raise ValueError(f"cache_sides must be both|item|user|ids, "
                         f"got {sides!r}")
    return embed, tuple(k for k in read if k not in embed)


def cache_dtype_for(hp: HyperParams) -> torch.dtype:
    """The dtype of cached doc embeddings, as the JAX package's
    `cache_dtype_for`: the conv's operand type. Under `use_pallas` f32,
    the kernels' type (JAX's off the TPU); otherwise `hp.compute_dtype`,
    which the TextCNN casts its x to, so a bf16 cache holds half the
    bytes. The cast of a frozen-table row commutes with the gather, so a
    cached run computes on the same values as an uncached one."""
    if hp.use_pallas:
        return torch.float32
    return getattr(torch, hp.compute_dtype)


def build_doc_cache(records: Dict[str, np.ndarray], word_vectors,
                    dtype: torch.dtype, device: torch.device,
                    keys: Tuple[str, ...] = DOC_KEYS,
                    id_keys: Tuple[str, ...] = (),
                    chunk_words: int = 4_096_000) -> Dict[str, torch.Tensor]:
    """Device-resident records with the frozen-table docs of `keys`
    pre-embedded (int ids [N, ...] -> f32 [N, ..., E]) and every other
    array moved as it is; a doc key in neither `keys` nor `id_keys` is
    dropped. Each doc array is embedded chunk by chunk straight into one
    preallocated buffer, so the peak is the buffer and one chunk of
    indices. The values are those of `table[ids]` in the step."""
    table = torch.as_tensor(np.asarray(word_vectors)).to(device, dtype)
    e = table.shape[1]
    cache = {}
    for k, v in records.items():
        if k in DOC_KEYS and k not in keys and k not in id_keys:
            continue
        arr = np.ascontiguousarray(v)
        if k not in DOC_KEYS or k not in keys:
            cache[k] = host_tensor(arr).to(device)
            continue
        buf = torch.empty(arr.shape + (e,), dtype=dtype, device=device)
        step = max(1, chunk_words // max(int(np.prod(arr.shape[1:])), 1))
        for s in range(0, arr.shape[0], step):
            ids = host_tensor(arr[s:s + step].reshape(-1)).to(device)
            torch.index_select(table, 0, ids.long(),
                               out=buf[s:s + step].view(-1, e))
        cache[k] = buf
    return cache


class EntityCache(NamedTuple):
    """The entity doc cache on the device: `example` holds the
    per-example arrays (ids, rating, leakage-mask spans), `tables` the
    canonical per-entity doc stores keyed by the record name they stand
    for ("user_doc" -> [U, ...], "item_doc" -> [I, ...]), or by
    `<name>__table` when the towers read them whole."""

    example: Dict[str, torch.Tensor]
    tables: Dict[str, torch.Tensor]


# the example key holding the entity id of each table; NARRE's neighbor
# id lists are the users who reviewed the ITEM and the items the USER
# reviewed
ENTITY_ID_KEY = {"user_doc": "user", "item_doc": "item",
                 "users_who_gave": "item", "items_reviewed": "user"}


def _take(records, rows: torch.Tensor) -> Dict[str, torch.Tensor]:
    """`records`' arrays at example rows `rows`: a local gather, or the
    exchange of `parallel.mesh.ShardedRecords` over a mesh's data axis."""
    if hasattr(records, "take"):
        return records.take(rows)
    return {k: v.index_select(0, rows) for k, v in records.items()}


def gather_cached_batch(cache, rows: torch.Tensor, weight: torch.Tensor
                        ) -> Dict[str, torch.Tensor]:
    """The batch of example rows `rows` [B] from a device cache, shared
    by the cached train and eval steps. From an EntityCache each doc
    side's canonical row is gathered by the example's entity id; a
    `<doc>__table` is passed WHOLE, for the row-gathered kernels. On a
    mesh `rows` are this rank's rows of the batch."""
    if isinstance(cache, EntityCache):
        batch = _take(cache.example, rows)
        # NARRE's per-review tables are the ones with neighbor ids
        with (annotate("cache.gather_rows") if "users_who_gave" in cache.tables
              else _NO_SPAN):
            for dk, table in cache.tables.items():
                batch[dk] = (table if dk.endswith("__table") else
                             table.index_select(0, batch[ENTITY_ID_KEY[dk]]))
    else:
        batch = _take(cache, rows)
    batch["weight"] = weight
    return batch


_NO_SPAN = contextlib.nullcontext()
# review_counts' results by id of the cache's skip array: (a weak
# reference to that array, the counts), dropped once the array is gone
_review_counts: Dict[int, Tuple[weakref.ref, Dict[str, np.ndarray]]] = {}


def review_counts(cache) -> Optional[Dict[str, np.ndarray]]:
    """For an EntityCache of NARRE's per-review tables ("user_doc"
    [U, R, W(, E)] beside the neighbor-id tables) holding training
    examples (their "user_skip" rows), the host int64 [N] counts of each
    example by counter name: the review rows (`narre.review_rows`, 2 R)
    and word slots (`narre.review_words`, 2 R W) a step's towers encode
    for it, the rows holding a review the step does not mask
    (`narre.review_rows_live`: a row with a word, not the pair's own) and
    the word slots holding a word in those rows
    (`narre.review_words_live`; a word is a non-zero id, or a non-zero
    embedded vector). Read from the cache once, in one pass
    over its tables and one copy to the host; kept while its example
    arrays live. None for any other cache, and on a mesh."""
    if (not isinstance(cache, EntityCache) or "users_who_gave" not in
            cache.tables or not isinstance(cache.example, dict)
            or "user_skip" not in cache.example):
        return None
    key = cache.example["user_skip"]
    held = _review_counts.get(id(key))
    if held is not None and held[0]() is key:
        return held[1]
    per_side = []
    for doc, ent, skip in (("user_doc", "user", "user_skip"),
                           ("item_doc", "item", "item_skip")):
        table = cache.tables[doc]
        words = torch.cat([(t != 0).any(-1) if t.is_floating_point()
                           else (t != 0)
                           for t in table.split(512)]).sum(-1)   # [N, R]
        ex = words.index_select(0, cache.example[ent].long())      # [n, R]
        r, w = table.shape[1], table.shape[2]
        own = (torch.arange(r, device=ex.device)[None, :]
               == cache.example[skip].long()[:, None])
        ex = torch.where(own, torch.zeros_like(ex), ex)
        per_side.append((r, w, ex))
    r_all = sum(r for r, _, _ in per_side)
    out = {"narre.review_rows_live": sum((ex > 0).sum(-1)
                                         for _, _, ex in per_side),
           "narre.review_words_live": sum(ex.sum(-1) for _, _, ex in per_side)}
    out = {k: v.to(torch.int64).cpu().numpy() for k, v in out.items()}
    n = len(out["narre.review_rows_live"])
    out["narre.review_rows"] = np.full(n, r_all, np.int64)
    out["narre.review_words"] = np.full(
        n, sum(r * w for r, w, _ in per_side), np.int64)
    for k in [k for k, (ref, _) in _review_counts.items() if ref() is None]:
        del _review_counts[k]
    _review_counts[id(key)] = (weakref.ref(key), out)
    return out


def count_reviews(counts: Optional[Dict[str, np.ndarray]], batches) -> None:
    """Add the host batches' examples ({"row", ...}, padding rows
    included: the towers encode them) to the review counters."""
    if counts is None:
        return
    rows = np.concatenate([np.asarray(b["row"]) for b in batches])
    for name, per_example in counts.items():
        count(name, int(per_example[rows].sum()))


def _fuse_tables(tables: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Float tables under `<doc>__table`, for the row-gathered kernels;
    int id tables keep their key (they are gathered, then embedded)."""
    return {(k + "__table" if v.is_floating_point() else k): v
            for k, v in tables.items()}


def build_entity_cache(records: Dict[str, np.ndarray],
                       entity_docs: Dict[str, np.ndarray], word_vectors,
                       dtype: torch.dtype, device: torch.device,
                       keys: Tuple[str, ...] = (),
                       id_keys: Tuple[str, ...] = (),
                       fuse_rows: bool = False) -> EntityCache:
    """EntityCache from per-example `records` (materialize_entity) and
    canonical `entity_docs` ({"user_doc": [U, T], "item_doc": [I, T]}
    int32), the docs embedded as `build_doc_cache` does. `fuse_rows`
    passes the float tables whole (`_fuse_tables`)."""
    tables = build_doc_cache(entity_docs, word_vectors, dtype, device,
                             keys=keys, id_keys=id_keys)
    if fuse_rows:
        tables = _fuse_tables(tables)
    return EntityCache(example=to_device(records, device),
                       tables=tables)


def entity_supported(hp: HyperParams) -> bool:
    """Whether `hp.model_type` has an entity doc store."""
    return hp.model_type in ("deepconn", "deepconn++", "NARRE",
                             "transnet", "transnet++")


def entity_serving(hp: HyperParams) -> bool:
    """Whether eval and serving score from the entity doc tables: the
    entity cache is on and the model has an entity doc store."""
    return bool(hp.cache_doc_embeds and hp.cache_entity
                and hp.family == "review" and entity_supported(hp))


def fuse_rows_for(hp: HyperParams) -> bool:
    """Whether entity training hands the float tables whole to the
    row-gathered kernels (hp.pallas_fuse_rows): the concatenated-doc
    towers only."""
    return hp.pallas_fuse_rows and hp.model_type in ("deepconn", "deepconn++")


def build_entity_tables(hp: HyperParams, dataset, device: torch.device
                        ) -> Dict[str, torch.Tensor]:
    """The canonical per-entity doc tables on the device, f32 embedded or
    int ids per hp.cache_sides, and NARRE's neighbor id tables: the
    shared builder of the entity train cache and the entity eval and
    serving paths."""
    rows, words = _doc_layout(hp)
    sides = "ids" if hp.model_type == "MPCN" else hp.cache_sides
    ck, idk = doc_cache_keys(hp.model_type, sides)
    # this_doc is per-example (transnet), never a table
    ck = tuple(k for k in ck if k != "this_doc")
    idk = tuple(k for k in idk if k != "this_doc")
    if rows > 1:
        udocs, idocs, who_gave, reviewed = dataset._entity_rows_docs(
            rows, words, NEIGHBOR_SLOTS, hp.user_pad_id, hp.item_pad_id)
        entity_docs = {"user_doc": udocs, "item_doc": idocs}
        if hp.model_type == "NARRE":
            entity_docs.update(users_who_gave=who_gave,
                               items_reviewed=reviewed)
    else:
        (udocs, _), (idocs, _) = dataset._entity_spans(words)
        entity_docs = {"user_doc": udocs, "item_doc": idocs}
    return build_doc_cache(entity_docs, dataset.word_vectors,
                           cache_dtype_for(hp), device, keys=ck, id_keys=idk)


def _cache_mode(hp: HyperParams, mesh=None) -> Tuple[bool, bool]:
    """(use the per-example or entity cache, use the entity cache), with
    the JAX trainer's refusals: on a mesh that spans hosts, its refusal
    of the per-example cache (the port shards it over the data ranks of
    one host, `parallel.mesh.ShardedRecords`)."""
    use_cache = hp.cache_doc_embeds
    use_entity = use_cache and hp.cache_entity
    if use_cache:
        if hp.family != "review":
            raise ValueError(
                "cache_doc_embeds caches review doc tensors and only "
                f"applies to the review family; {hp.model_type!r} has "
                f"no doc tensors")
        if hp.model_type == "MPCN" and hp.cache_sides != "ids":
            raise ValueError(
                "MPCN trains its word embeddings; only the ids-only "
                "cache applies (cache_sides='ids') — pre-embedded "
                "caches would freeze a trained table")
        if not use_entity and mesh is not None and host_count() > 1:
            raise ValueError(
                "per-example cache_doc_embeds + multi-host is "
                "unsupported (one global device array per split); use "
                "cache_entity=True (entity tables replicate per host) "
                "or drop the cache")
        # an epochs=0 run (smoke/eval-only) never trains: skip the
        # (device-memory-expensive) cache build entirely
        use_cache = use_cache and hp.epochs > 0
        use_entity = use_entity and hp.epochs > 0
    if use_entity:
        if not entity_supported(hp):
            raise ValueError(
                "cache_entity applies to the frozen-table review towers "
                f"(deepconn/deepconn++/NARRE/transnet); "
                f"{hp.model_type!r} has no entity doc store")
        if hp.loss != "RAW_MSE":
            raise ValueError(
                "cache_entity trains pointwise (RAW_MSE); candidate-grid "
                "ranking losses use the per-example cache")
    return use_cache, use_entity


def _snapshot(model: torch.nn.Module) -> Params:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _model_records(model: torch.nn.Module, recs: Dict[str, np.ndarray]
                   ) -> Dict[str, np.ndarray]:
    """The record arrays the model reads, plus label: the others
    (this_doc, neighbor lists) would be sliced and copied for nothing."""
    keep = set(getattr(model, "INPUTS", recs)) | {"rating"}
    return {k: v for k, v in recs.items() if k in keep}


def train_complete(hp: HyperParams, model: torch.nn.Module, dataset, *,
                   quiet: bool = True,
                   checkpoint_path: Optional[str] = None,
                   stats: Optional[Dict] = None
                   ) -> Tuple[Params, float]:
    """Train `model` in place on the train split, validating each epoch.
    Returns (best-validation `state_dict`, its val MSE); under a ranking
    `hp.loss` (CE / BPR / HINGE) the model trains on sampled candidate
    grids, each epoch is selected by its val HR@1 over the val grids, and
    the scalar returned is -(best HR@1).

    With `checkpoint_path`, every epoch saves the latest params,
    optimizer state and the best params in one file, and `hp.resume`
    continues from it. `stats` receives the per-epoch examples/s and val
    MSE, and `train_examples_per_s`, the median of the epochs'
    examples/s. Ctrl-C ends training and returns the best
    params so far. `hp.scan_steps` > 1 (the JAX package's `lax.scan`
    over S batches in one dispatch) trains each full group of S batches
    as one dispatch (`ScanSteps`: one CUDA-graph replay on the card),
    with the same updates in the same order as 1; the graph is captured
    after any resume, so it holds the params and state the run trains.

    With `hp.cache_doc_embeds` (and `hp.cache_entity`) the splits live in
    a device cache (module docstring); validation then reads a val cache
    that shares the train cache's entity tables."""
    check_trainable(hp)
    hp = dataset.apply_to(hp)
    mesh = model_mesh(model) or mesh_from_hp(hp)
    use_cache, use_entity = _cache_mode(hp, mesh)
    if mesh is not None:
        shard_model(model, hp, mesh)
    ranking = hp.loss != "RAW_MSE"
    device = next(model.parameters()).device
    optimizer = make_optimizer(hp, model)
    train_cache = val_cache = None
    if ranking:
        # [N, C] grids, the positive in column 0; the val grids are
        # scored by `eval_ranking`, never from a cache
        train_recs = _model_records(model, dataset.materialize_train_negs(
            hp, "train", seed=hp.seed))
        val_recs = _model_records(model, dataset.materialize_train_negs(
            hp, "val", seed=hp.seed + 1))
    elif use_entity:
        # no per-example doc tensors at all: ids, rating and mask spans
        train_recs = dataset.materialize_entity(hp, "train")
        val_recs = dataset.materialize_entity(hp, "val")
        tables = build_entity_tables(hp, dataset, device)
        if fuse_rows_for(hp):
            tables = _fuse_tables(tables)
        train_cache = EntityCache(to_device(train_recs, device), tables)
        # eval removes nothing: val shares the same doc tables
        val_cache = EntityCache(to_device(val_recs, device), tables)
    else:
        train_recs = _model_records(model, dataset.materialize(hp, "train"))
        val_recs = _model_records(model, dataset.materialize(hp, "val"))
    if hp.family == "review" and not use_entity:
        store = (f", out of core under {hp.data_dir()}/records"
                 if hp.out_of_core else "")
        file_write(None, f"host records: "
                         f"{dataset.materializer or 'no'} materializer"
                         f"{store}", quiet=quiet)
    if use_cache and not use_entity:
        ck, idk = doc_cache_keys(hp.model_type, hp.cache_sides)

        def cache(recs):
            return build_doc_cache(recs, dataset.word_vectors,
                                   cache_dtype_for(hp), device, keys=ck,
                                   id_keys=idk)

        train_cache = cache(train_recs)
        val_cache = None if ranking else cache(val_recs)
    if mesh is not None and train_cache is not None:
        # each data rank keeps its example rows; entity tables stay whole
        train_cache = shard_cache(train_cache, mesh)
        if val_cache is not None:
            val_cache = shard_cache(val_cache, mesh)
    # with a cache the batcher yields row ids into it, in the same
    # shuffled order as the record Batcher
    train_b = Batcher({"row": np.arange(len(train_recs["rating"]))}
                      if use_cache else train_recs, hp.batch_size,
                      shuffle=hp.shuffle_data_every_epoch, seed=hp.seed)
    val_b = Batcher(val_recs, hp.batch_size)

    start_epoch, step = 1, 0
    best_mse = float("inf")
    best_params = _snapshot(model)
    since_improve = 0
    if checkpoint_path and hp.resume and os.path.exists(checkpoint_path):
        # the file holds whole tables; on a mesh each rank keeps its rows
        payload = load_checkpoint(checkpoint_path, map_location=device)
        model.load_state_dict(local_params(model, payload["params"]))
        optimizer.load_state_dict(local_opt_state(model,
                                                  payload["opt_state"]))
        if payload["best_params"]:
            best_params = local_params(model, payload["best_params"])
        start_epoch = payload["epoch"] + 1
        step = payload["step"]
        best_mse = float(payload["extra"].get("val_mse", best_mse))
        since_improve = int(payload["extra"].get("since_improve", 0))
    train_b.set_epoch(start_epoch - 1)
    scan = (ScanSteps(model, optimizer, hp.scan_steps, device, train_cache,
                      hp.loss, hp.hinge_margin)
            if hp.scan_steps > 1 else None)

    log = hp.log_file()
    if scan is not None and mesh is not None:
        file_write(log, f"scan_steps {hp.scan_steps} on a mesh: each group "
                        f"runs as {hp.scan_steps} eager steps (a CUDA graph "
                        f"cannot capture a gloo collective)", quiet=quiet)
    try:
        for epoch in range(start_epoch, hp.epochs + 1):
            t0 = time.time()
            gen = epoch_generator(hp.seed, epoch, device)
            train_metrics = train_epoch(model, optimizer, train_b, gen,
                                        device, train_cache, scan, hp.loss,
                                        hp.hinge_margin)
            if ranking:
                rank = eval_ranking(model, val_recs, hp, hp.batch_size,
                                    device)
                # -HR@1, so the lower-is-better selection is shared
                metrics = {"train_loss": train_metrics["MSE"], **rank,
                           "MSE": -rank["HR@1"]}
            elif use_cache:
                metrics, _, _ = evaluate_cached(
                    model, val_cache, val_recs, hp, dataset.user_count,
                    dataset.item_count, device)
            else:
                metrics, _, _ = evaluate(model, val_b, hp,
                                         dataset.user_count,
                                         dataset.item_count, device)
            step += len(train_b)
            model.train()
            metrics["examples_per_s"] = train_metrics["examples_per_s"]
            if stats is not None:
                eps = stats.setdefault("epoch_examples_per_s", [])
                eps.append(train_metrics["examples_per_s"])
                stats.setdefault("epoch_val_mse", []).append(metrics["MSE"])
                stats["train_examples_per_s"] = round(
                    statistics.median(eps), 1)
            log_end_epoch(log, {k: v for k, v in metrics.items()
                                if not (ranking and k == "MSE")},
                          epoch, time.time() - t0, quiet=quiet)
            if metrics["MSE"] < best_mse:
                best_mse = metrics["MSE"]
                since_improve = 0
                best_params = _snapshot(model)
            else:
                since_improve += 1
            if checkpoint_path:
                # whole tables (gathered over the model axis on every
                # rank), written by the primary process only
                params = full_params(model, model.state_dict())
                opt_state = full_opt_state(model, optimizer.state_dict())
                best = full_params(model, best_params)
                if is_primary():
                    save_checkpoint(checkpoint_path, params,
                                    opt_state=opt_state, step=step,
                                    epoch=epoch,
                                    extra={"val_mse": best_mse,
                                           "since_improve": since_improve},
                                    best_params=best)
                if mesh is not None:   # every rank sees the file after
                    torch.distributed.barrier()
            if hp.early_stop and since_improve >= hp.early_stop:
                file_write(log, f"early stop at epoch {epoch}: no val "
                                f"improvement for {since_improve} epochs",
                           quiet=quiet)
                break
    except KeyboardInterrupt:
        # as the reference: Ctrl-C ends training, the run goes on to the
        # test eval with the best-validation params
        file_write(log, "KeyboardInterrupt: stopping training; returning "
                        "best-validation parameters", quiet=quiet)
    return best_params, best_mse

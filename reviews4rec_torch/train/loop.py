"""Training loop of the port, for the pointwise review towers (deepconn,
deepconn++) without the device doc cache. Counterpart of
`reviews4rec_tpu/train/loop.py` (`make_optimizer`, `_batch_loss`,
`train_epoch`, `train_complete`), with the same dynamics:

- Adam with additive (not decoupled) L2 weight decay: torch's
  `Adam(weight_decay=...)` is optax's `add_decayed_weights` then `adam`.
  The frozen word table is a buffer, so it never reaches the optimizer.
- per-batch loss: the mean squared error over the real rows of the
  padded batch.
- per-epoch validation MSE, a best-validation snapshot of the params,
  `early_stop` patience, a checkpoint each epoch and `hp.resume`.

Randomness: the JAX RNG streams cannot be reproduced in torch. The port
keys its own by the absolute epoch, as the JAX loop does: one
`torch.Generator` per epoch on the model's device, seeded from
(hp.seed, epoch), draws every dropout mask of that epoch in step order,
and the `Batcher` shuffle is keyed by seed + epoch. A resumed run is
therefore the same as an uninterrupted one.

Not ported here, each raising `NotImplementedError` with its ROADMAP.md
item: the device doc and entity caches (Queue 1 item 7), ranking losses
(item 11), transnet's routed loss (item 8) and meshes (item 13).
"""

from __future__ import annotations

import collections
import os
import statistics
import time
from typing import Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from ..config import HyperParams
from ..data.batcher import Batcher
from ..utils.logging import file_write, log_end_epoch
from .checkpoint import load_checkpoint, save_checkpoint
from .evaluate import evaluate
from .profiler import Throughput, annotate

Params = Dict[str, torch.Tensor]


def check_trainable(hp: HyperParams) -> None:
    """Raise for the training options this slice does not port."""
    if hp.cache_doc_embeds or hp.cache_entity:
        raise NotImplementedError(
            "the device doc cache and the entity cache (cache_doc_embeds, "
            "cache_entity) are not ported yet: ROADMAP.md Queue 1 item 7")
    if tuple(hp.mesh_shape) != (1, 1):
        raise NotImplementedError(
            f"mesh_shape {tuple(hp.mesh_shape)}: data / model parallel "
            f"training is not ported yet: ROADMAP.md Queue 1 item 13")
    if hp.loss != "RAW_MSE":
        raise NotImplementedError(
            f"loss {hp.loss!r}: ranking losses are not ported yet: "
            f"ROADMAP.md Queue 1 item 11")
    if hp.model_type in ("transnet", "transnet++"):
        raise NotImplementedError(
            f"{hp.model_type}'s routed loss is not ported yet: ROADMAP.md "
            f"Queue 1 item 8")


def make_optimizer(hp: HyperParams, model: torch.nn.Module
                   ) -> torch.optim.Optimizer:
    return torch.optim.Adam(model.parameters(), lr=hp.lr,
                            weight_decay=hp.weight_decay)


def _batch_loss(preds: torch.Tensor, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """RAW_MSE over the real rows: (loss, (sum(sq * w), sum(w)))."""
    w = batch["weight"]
    sq = (preds - batch["rating"]) ** 2
    sq_sum = torch.sum(sq * w)
    n = torch.sum(w)
    return sq_sum / torch.clamp(n, min=1.0), (sq_sum, n)


def train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One update on one batch; returns (loss, sum(sq * w), sum(w)) as
    device scalars, without waiting for the device."""
    preds = model(batch, generator=generator)
    loss, (sq_sum, n) = _batch_loss(preds, batch)
    loss.backward()
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)
    return loss.detach(), sq_sum.detach(), n.detach()


def epoch_generator(seed: int, epoch: int, device: torch.device
                    ) -> torch.Generator:
    """The dropout stream of one epoch, keyed by (seed, epoch)."""
    key = int(np.random.SeedSequence([seed, epoch]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(key)


def _place(batch: Dict[str, np.ndarray], device: torch.device
           ) -> Dict[str, torch.Tensor]:
    """Host batch -> device tensors; on CUDA through pinned memory, so
    the copy is asynchronous and overlaps the step before it."""
    pin = device.type == "cuda"
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if pin:
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=pin)
    return out


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


def _prefetch(batcher: Batcher, device: torch.device, depth: int = 2):
    return _lookahead((_place(b, device) for b in batcher), depth)


def train_epoch(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                batcher: Batcher, generator: Optional[torch.Generator],
                device: torch.device) -> Dict:
    """One epoch of updates, in batch order. The squared-error sums stay
    on the device until the end of the epoch: one sync per epoch."""
    model.train()
    tp = Throughput()
    sq_sum = torch.zeros((), device=device)
    n = torch.zeros((), device=device)
    bs, remaining = batcher.batch_size, batcher.n
    for batch in _prefetch(batcher, device):
        with annotate("train_step"):
            _, s, c = train_step(model, optimizer, batch, generator)
        sq_sum += s
        n += c
        tp.add(min(bs, remaining))
        remaining -= bs
    total, count = float(sq_sum), float(n)   # the epoch's one sync
    return {"MSE": round(total / max(count, 1.0), 4), **tp.metrics()}


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
    Returns (best-validation `state_dict`, its val MSE).

    With `checkpoint_path`, every epoch saves the latest params,
    optimizer state and the best params in one file, and `hp.resume`
    continues from it. `stats` receives the per-epoch examples/s and val
    MSE, and `train_examples_per_s`, the median of the epochs'
    examples/s. Ctrl-C ends training and returns the best
    params so far. `hp.scan_steps` > 1 (the JAX package's `lax.scan`
    over S batches in one dispatch) is accepted: the port runs the same
    updates in the same order, one step at a time, as 1 does."""
    check_trainable(hp)
    hp = dataset.apply_to(hp)
    device = next(model.parameters()).device
    optimizer = make_optimizer(hp, model)
    train_b = Batcher(_model_records(model, dataset.materialize(hp, "train")),
                      hp.batch_size, shuffle=hp.shuffle_data_every_epoch,
                      seed=hp.seed)
    val_b = Batcher(_model_records(model, dataset.materialize(hp, "val")),
                    hp.batch_size)

    start_epoch, step = 1, 0
    best_mse = float("inf")
    best_params = _snapshot(model)
    since_improve = 0
    if checkpoint_path and hp.resume and os.path.exists(checkpoint_path):
        payload = load_checkpoint(checkpoint_path, map_location=device)
        model.load_state_dict(payload["params"])
        optimizer.load_state_dict(payload["opt_state"])
        if payload["best_params"]:
            best_params = payload["best_params"]
        start_epoch = payload["epoch"] + 1
        step = payload["step"]
        best_mse = float(payload["extra"].get("val_mse", best_mse))
        since_improve = int(payload["extra"].get("since_improve", 0))
    train_b.set_epoch(start_epoch - 1)

    log = hp.log_file()
    try:
        for epoch in range(start_epoch, hp.epochs + 1):
            t0 = time.time()
            train_metrics = train_epoch(
                model, optimizer, train_b,
                epoch_generator(hp.seed, epoch, device), device)
            step += len(train_b)
            metrics, _, _ = evaluate(model, val_b, hp, dataset.user_count,
                                     dataset.item_count, device)
            model.train()
            metrics["examples_per_s"] = train_metrics["examples_per_s"]
            if stats is not None:
                eps = stats.setdefault("epoch_examples_per_s", [])
                eps.append(train_metrics["examples_per_s"])
                stats.setdefault("epoch_val_mse", []).append(metrics["MSE"])
                stats["train_examples_per_s"] = round(
                    statistics.median(eps), 1)
            log_end_epoch(log, metrics, epoch, time.time() - t0, quiet=quiet)
            if metrics["MSE"] < best_mse:
                best_mse = metrics["MSE"]
                since_improve = 0
                best_params = _snapshot(model)
            else:
                since_improve += 1
            if checkpoint_path:
                save_checkpoint(checkpoint_path, model.state_dict(),
                                opt_state=optimizer.state_dict(), step=step,
                                epoch=epoch,
                                extra={"val_mse": best_mse,
                                       "since_improve": since_improve},
                                best_params=best_params)
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

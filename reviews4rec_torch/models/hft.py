"""HFT: Hidden Factors as Topics (McAuley & Leskovec), counterpart of
`reviews4rec_tpu/models/hft.py`, with its names.

The model couples matrix factorization with an LDA-like topic model:
  rating(u, i) = alpha + beta_u + beta_i + gamma_u . gamma_i
where the item factors gamma_i double as topic proportions through
  theta_i[k] proportional to exp(kappa * gamma_i[k])
and each word w of a review of item i carries a latent topic z with
  p(z = k) proportional to exp(kappa gamma_i[k] + bg_w + topicWords[w, k]).

Training alternates (EM, `HFTTrainer.fit`):
  M-step: L-BFGS on the energy (`make_energy`): squared rating error
          - lambda * [topic + word log-likelihood terms]
          + latent_reg * ||gamma||^2, with the topic counts held fixed,
          by the port's own copy of `optax.lbfgs()` (`train.lbfgs`) and
          gradients from `torch.autograd`;
  E-step: every token's topic drawn at once (the probabilities depend on
          the parameters only) as argmax(logits + Gumbel noise), which is
          how `jax.random.categorical` draws, and the count tables
          rebuilt by `index_add_`; then each word's mean topic weight
          moves into the background (`normalize_word_weights`).

The Gumbel noise comes from a `torch.Generator` seeded with `hp.seed`
on the run's device (other numbers than JAX's), or from `gumbels`, one
[tokens, K] tensor per E-step, which is how the tests feed JAX's draws
in. Under `hp.lamda == 0` the gammas start U(0, 1) from the same
generator, or from `gamma_init`.

On a mesh (`hp.mesh_shape` over more than one device; one process a
device, `parallel.distributed`) the votes and the token stream are split
over the data ranks, padded with weight 0 (`shard_hft_data`), and the
parameters, count tables and eval sets stay whole on every rank. The
energy is each rank's share of the vote term plus 1/n of the rest,
summed over the ranks, and its gradient is summed likewise, so every
rank takes the same L-BFGS step; the E-step draws its Gumbel noise at
the whole token stream's shape and keeps the rank's tokens, so the draws
do not depend on the sharding, and the count tables are summed over the
ranks. Only the primary process writes the artifact files.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import HyperParams
from ..data.corpus import ReviewDataset
from ..train import lbfgs
from ..utils.device import DeviceLike, resolve_device

Params = Dict[str, torch.Tensor]


@dataclass
class HFTData:
    """Flattened corpus tensors on the run's device."""

    # train votes
    users: torch.Tensor      # [N] int64
    items: torch.Tensor      # [N] int64
    ratings: torch.Tensor    # [N] float32
    vote_weight: torch.Tensor  # [N] float32, all 1 (the JAX package pads)
    # token stream over all train reviews (HFT vocab ids)
    tok_word: torch.Tensor   # [T] int64
    tok_item: torch.Tensor   # [T] int64
    tok_weight: torch.Tensor  # [T] float32, all 1
    item_words: torch.Tensor  # [I] int32: tokens per item
    # eval splits: (users, items, ratings)
    eval_sets: Dict[str, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
    # negatives [M, 6]
    neg_users: torch.Tensor
    neg_items: torch.Tensor
    num_users: int
    num_items: int
    num_words: int
    # per-user/item vote counts over ALL splits (the beta init divisor)
    votes_per_user: torch.Tensor
    votes_per_item: torch.Tensor


def hft_arrays(hp: HyperParams, dataset: ReviewDataset,
               vocab_cap: Optional[int] = None) -> Dict[str, np.ndarray]:
    """The numpy arrays of `build_hft_data`: the train-order token stream
    of every train example's own review, cut to the top-`hft_vocab`
    dictionary by (-count, word id), its owner items, tokens per item,
    and the all-split vote counts."""
    cap = vocab_cap or hp.hft_vocab
    tr = dataset.splits["train"]
    flat = dataset._flat()
    _, _, _, _, this_rev = dataset._examples("train")
    rev_off = flat["rev_off"]
    valid = this_rev >= 0
    starts = rev_off[this_rev[valid]]
    lens = (rev_off[this_rev[valid] + 1] - starts).astype(np.int64)
    total = int(lens.sum())
    seg0 = np.cumsum(lens) - lens
    gather = np.repeat(starts - seg0, lens) + np.arange(total)
    words = flat["tokens"][gather]
    owner_item = np.repeat(tr.item[valid].astype(np.int32), lens)

    freq = np.bincount(words, minlength=dataset.num_words + 1)
    appearing = np.nonzero(freq)[0]
    order = appearing[np.lexsort((appearing, -freq[appearing]))]
    keep = order[:cap]
    remap = np.full(dataset.num_words + 1, -1, np.int32)
    remap[keep] = np.arange(len(keep), dtype=np.int32)
    mapped = remap[words]
    mask = mapped >= 0
    tok_word = mapped[mask].astype(np.int32)
    tok_item = owner_item[mask].astype(np.int32)
    item_words = (np.bincount(tok_item, minlength=dataset.num_items)
                  if len(tok_item) else np.zeros(dataset.num_items, np.int64))
    splits = ("train", "test", "val")
    vpu = np.bincount(np.concatenate([dataset.splits[s].user for s in splits]),
                      minlength=dataset.num_users)
    vpi = np.bincount(np.concatenate([dataset.splits[s].item for s in splits]),
                      minlength=dataset.num_items)
    return {"tok_word": tok_word, "tok_item": tok_item,
            "item_words": item_words.astype(np.int32),
            "num_words": max(len(keep), 1),
            "votes_per_user": np.maximum(vpu, 1).astype(np.float32),
            "votes_per_item": np.maximum(vpi, 1).astype(np.float32)}


def build_hft_data(hp: HyperParams, dataset: ReviewDataset,
                   vocab_cap: Optional[int] = None,
                   device: DeviceLike = None,
                   dtype: torch.dtype = torch.float32) -> HFTData:
    """The dataset as HFT tensors on `device` (None = the GPU), its real
    values in `dtype`, which the parameters and counts then take (float32;
    float64 for the tests that hold the EM against JAX's under x64)."""
    dev = resolve_device(device)
    a = hft_arrays(hp, dataset, vocab_cap)
    tr = dataset.splits["train"]

    def t(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype).to(dev)

    i64, f32 = torch.int64, dtype
    eval_sets = {s: (t(dataset.splits[s].user, i64),
                     t(dataset.splits[s].item, i64),
                     t(dataset.splits[s].rating, f32))
                 for s in ("train", "test", "val")}
    c = dataset.neg_cands.shape[1]
    return HFTData(
        users=t(tr.user, i64), items=t(tr.item, i64),
        ratings=t(tr.rating, f32),
        vote_weight=torch.ones(len(tr), dtype=f32, device=dev),
        tok_word=t(a["tok_word"], i64), tok_item=t(a["tok_item"], i64),
        tok_weight=torch.ones(len(a["tok_word"]), dtype=f32, device=dev),
        item_words=t(a["item_words"], torch.int32), eval_sets=eval_sets,
        neg_users=t(np.repeat(dataset.neg_users[:, None], c, axis=1), i64),
        neg_items=t(dataset.neg_cands, i64),
        num_users=dataset.num_users, num_items=dataset.num_items,
        num_words=a["num_words"],
        votes_per_user=t(a["votes_per_user"], f32),
        votes_per_item=t(a["votes_per_item"], f32))


def shard_hft_data(data: HFTData, mesh) -> HFTData:
    """This data rank's contiguous share of the votes and of the token
    stream, each padded to a multiple of the axis size with weight-0
    entries (index 0); everything else stays whole."""
    import dataclasses as dc

    n, d = mesh.shape[mesh.data_axis], mesh.index[mesh.data_axis]

    def mine(x):
        per = -(-x.shape[0] // n)
        part = x[d * per:(d + 1) * per]
        return torch.cat([part, part.new_zeros(per - part.shape[0])])

    return dc.replace(
        data, users=mine(data.users), items=mine(data.items),
        ratings=mine(data.ratings), vote_weight=mine(data.vote_weight),
        tok_word=mine(data.tok_word), tok_item=mine(data.tok_item),
        tok_weight=mine(data.tok_weight))


class _GradSum(torch.autograd.Function):
    """Identity whose backward sums the gradient over the data axis."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g, ctx.mesh.data_axis), None


class _ValueSum(torch.autograd.Function):
    """The sum over the data axis of each rank's share of a value whose
    gradient `_GradSum` sums: the backward is the identity."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce(x, mesh.data_axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _data_total(mesh, t: torch.Tensor) -> torch.Tensor:
    return t if mesh is None else mesh.all_reduce(t, mesh.data_axis)


def _predict(params: Params, users: torch.Tensor, items: torch.Tensor
             ) -> torch.Tensor:
    return (params["alpha"]
            + params["beta_u"][users] + params["beta_i"][items]
            + torch.sum(params["gamma_u"][users] * params["gamma_i"][items],
                        dim=-1))


def make_energy(data: HFTData, hp: HyperParams, mesh=None
                ) -> Callable[[Params, Dict, torch.Tensor], torch.Tensor]:
    """The M-step's energy. On a mesh (`data` sharded) each rank's share
    of it: the vote term of its votes plus 1/n of the other terms, summed
    over the data axis in value and gradient."""
    lam, lreg = hp.lamda, hp.latent_reg
    n = 1 if mesh is None else mesh.shape[mesh.data_axis]

    def energy(params: Params, counts: Dict[str, torch.Tensor],
               background: torch.Tensor) -> torch.Tensor:
        if n > 1:
            params = {k: _GradSum.apply(v, mesh) for k, v in params.items()}
        # rating term
        err = _predict(params, data.users, data.items) - data.ratings
        vote = torch.sum(err * err * data.vote_weight)
        # on a mesh the other terms are each rank's 1/n
        res = vote if n == 1 else torch.zeros_like(vote)
        # item-topic term
        act = params["kappa"] * params["gamma_i"]               # [I, K]
        logz = torch.logsumexp(act, dim=1, keepdim=True)
        res = res + -lam * torch.sum(counts["item_topic"] * (act - logz))
        # latent regularizer
        res = res + lreg * (torch.sum(params["gamma_u"] ** 2)
                            + torch.sum(params["gamma_i"] ** 2))
        # word-topic term
        wact = background[:, None] + params["topic_words"]      # [V, K]
        wlogz = torch.logsumexp(wact, dim=0, keepdim=True)
        res = res + -lam * torch.sum(counts["word_topic"] * (wact - wlogz))
        if n > 1:
            return _ValueSum.apply(vote + res / n, mesh)
        return res

    return energy


def _split_errors(params: Params, data: HFTData) -> Dict[str, float]:
    return {s: float(torch.mean((_predict(params, u, i) - r) ** 2))
            for s, (u, i, r) in data.eval_sets.items()}


def init_params(data: HFTData, hp: HyperParams, verbose=print,
                generator: Optional[torch.Generator] = None,
                gamma_init: Optional[Tuple] = None, mesh=None
                ) -> Tuple[Params, torch.Tensor]:
    """alpha = mean train rating, beta = mean residual over the all-split
    vote counts, both zeroed again when lambda > 0; gammas and topic
    words zero (U(0, 1) gammas from `generator`, or `gamma_init`
    (gamma_u, gamma_i), when lambda == 0); kappa 1; background = relative
    word frequency. Prints the offset-only and offset+bias anchors. On a
    mesh the sums over votes and tokens are summed over the data axis."""
    K = hp.latent_size
    dev = data.ratings.device
    f32 = data.ratings.dtype
    zeros = lambda *shape: torch.zeros(shape, dtype=f32, device=dev)
    n_votes = torch.clamp(_data_total(mesh, torch.sum(data.vote_weight)),
                          min=1.0)
    params = {
        "alpha": _data_total(mesh, torch.sum(data.ratings * data.vote_weight))
        / n_votes,
        "kappa": torch.tensor(1.0, dtype=f32, device=dev),
        "beta_u": zeros(data.num_users),
        "beta_i": zeros(data.num_items),
        "gamma_u": zeros(data.num_users, K),
        "gamma_i": zeros(data.num_items, K),
        "topic_words": zeros(data.num_words, K),
    }
    errs = _split_errors(params, data)
    verbose(f"Error w/ offset term only (train/valid/test) = "
            f"{errs['train']:.6f}/{errs['val']:.6f}/{errs['test']:.6f}")
    resid = (data.ratings - params["alpha"]) * data.vote_weight
    beta_u = _data_total(mesh, zeros(data.num_users).index_add_(
        0, data.users, resid)) / data.votes_per_user
    beta_i = _data_total(mesh, zeros(data.num_items).index_add_(
        0, data.items, resid)) / data.votes_per_item
    params = {**params, "beta_u": beta_u, "beta_i": beta_i}
    errs = _split_errors(params, data)
    verbose(f"Error w/ offset and bias (train/valid/test) = "
            f"{errs['train']:.6f}/{errs['val']:.6f}/{errs['test']:.6f}")
    if hp.lamda > 0:
        params = {**params,
                  "alpha": torch.tensor(0.0, dtype=f32, device=dev),
                  "beta_u": zeros(data.num_users),
                  "beta_i": zeros(data.num_items)}
    elif gamma_init is not None:
        params = {**params,
                  "gamma_u": torch.as_tensor(np.array(gamma_init[0]),
                                             dtype=f32).to(dev),
                  "gamma_i": torch.as_tensor(np.array(gamma_init[1]),
                                             dtype=f32).to(dev)}
    else:
        gen = generator or torch.Generator(device=dev).manual_seed(hp.seed)
        params = {**params,
                  "gamma_u": torch.rand(data.num_users, K, generator=gen,
                                        device=dev, dtype=f32),
                  "gamma_i": torch.rand(data.num_items, K, generator=gen,
                                        device=dev, dtype=f32)}
    total = torch.clamp(_data_total(mesh, torch.sum(data.tok_weight)),
                        min=1.0)
    background = _data_total(mesh, zeros(data.num_words).index_add_(
        0, data.tok_word, data.tok_weight)) / total
    return params, background


def gumbel_noise(shape, generator: torch.Generator, device,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """-log(-log(u)), u uniform on [tiny, 1) (JAX's low-range Gumbel)."""
    tiny = torch.finfo(dtype).tiny
    u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
    u = u * (1.0 - tiny) + tiny
    return -torch.log(-torch.log(u))


def e_step(params: Params, background: torch.Tensor, tok_word: torch.Tensor,
           tok_item: torch.Tensor, K: int,
           generator: Optional[torch.Generator] = None,
           tok_weight: Optional[torch.Tensor] = None,
           gumbel: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Every token's topic, argmax(logits + gumbel) over the K topics
    (`gumbel` [T, K], or drawn from `generator`), and the count tables
    rebuilt: word_topic [V, K], item_topic [I, K], topic_counts [K]. The
    counts are sums of ones (times `tok_weight`), exact in f32."""
    logits = (params["kappa"] * params["gamma_i"][tok_item]
              + background[tok_word][:, None]
              + params["topic_words"][tok_word])               # [T, K]
    if gumbel is None:
        gumbel = gumbel_noise(logits.shape, generator, logits.device,
                              logits.dtype)
    topics = torch.argmax(gumbel + logits, dim=-1)              # [T]
    w = (tok_weight if tok_weight is not None
         else torch.ones(tok_word.shape[0], dtype=logits.dtype,
                         device=logits.device))
    V, I = background.shape[0], params["gamma_i"].shape[0]

    def counts(n: int, index: torch.Tensor) -> torch.Tensor:
        return torch.zeros(n, dtype=w.dtype, device=w.device).index_add_(
            0, index, w)

    word_topic = counts(V * K, tok_word * K + topics).view(V, K)
    item_topic = counts(I * K, tok_item * K + topics).view(I, K)
    topic_counts = counts(K, topics)
    return {"word_topic": word_topic, "item_topic": item_topic,
            "topic_counts": topic_counts}


def normalize_word_weights(params: Params, background: torch.Tensor
                           ) -> Tuple[Params, torch.Tensor]:
    """Shift each word's mean topic weight into the background."""
    av = torch.mean(params["topic_words"], dim=1, keepdim=True)
    return ({**params, "topic_words": params["topic_words"] - av},
            background + av[:, 0])


def make_m_step(energy, grad_iters: int):
    """m_step(params, counts, background) -> (params, energy at the start
    of the last iteration): `grad_iters` L-BFGS iterations (a fresh
    optimizer state each M-step, as the JAX package's)."""

    def m_step(params: Params, counts: Dict, background: torch.Tensor):
        out, values = lbfgs.minimize(
            lambda p: energy(p, counts, background), params, grad_iters)
        return out, values[-1]

    return m_step


class HFTTrainer:
    """The EM loop: per iteration one L-BFGS M-step, one sampling E-step +
    word-weight normalization (lambda > 0), and best-validation
    snapshotting."""

    def __init__(self, hp: HyperParams, dataset: ReviewDataset,
                 verbose=lambda *_: None, device: DeviceLike = None,
                 gumbels: Optional[Sequence[torch.Tensor]] = None,
                 gamma_init: Optional[Tuple] = None,
                 dtype: torch.dtype = torch.float32):
        from ..parallel.mesh import mesh_from_hp
        self.hp = hp
        self.device = resolve_device(device)
        self.data = build_hft_data(hp, dataset, device=self.device,
                                   dtype=dtype)
        self.mesh = mesh_from_hp(hp)
        # the whole token count, at which the E-step draws its noise
        self.tokens = self.data.tok_word.shape[0]
        if self.mesh is not None:
            self.data = shard_hft_data(self.data, self.mesh)
        self.dataset = dataset
        self.energy = make_energy(self.data, hp, self.mesh)
        self.m_step = make_m_step(self.energy, hp.hft_grad_iters)
        self.verbose = verbose
        self.gumbels = gumbels
        self.gamma_init = gamma_init
        self.generator = torch.Generator(device=self.device).manual_seed(
            hp.seed)

    def errors(self, params: Params) -> Dict[str, float]:
        return _split_errors(params, self.data)

    def ranking(self, params: Params) -> float:
        """HR@1 over the 6-candidate groups with the reference C++'s tie
        rule: a negative scoring >= the positive beats it."""
        preds = _predict(params, self.data.neg_users, self.data.neg_items)
        hit = torch.sum(preds[:, 1:] >= preds[:, :1], dim=1) == 0
        return float(100.0 * torch.mean(hit.to(preds.dtype)))

    def count_maps(self, params: Params):
        from ..train.evaluate import _count_mse_maps

        u, i, r = self.data.eval_sets["test"]
        err = ((_predict(params, u, i) - r) ** 2).cpu().numpy()
        uc, ic = u.cpu().numpy(), i.cpu().numpy()
        return (_count_mse_maps(np.asarray(self.dataset.user_count)[uc], err),
                _count_mse_maps(np.asarray(self.dataset.item_count)[ic], err))

    def _e_step(self, params: Params, background: torch.Tensor, n: int):
        gumbel = self.gumbels[n] if self.gumbels is not None else None
        dtype = self.data.ratings.dtype
        if gumbel is not None:
            gumbel = torch.as_tensor(np.asarray(gumbel),
                                     dtype=dtype).to(self.device)
        mesh = self.mesh
        if mesh is None:
            return e_step(params, background, self.data.tok_word,
                          self.data.tok_item, self.hp.latent_size,
                          generator=self.generator,
                          tok_weight=self.data.tok_weight, gumbel=gumbel)
        # the whole stream's draws, this rank's tokens of them (the
        # padding's rows are zeros: its tokens weigh 0)
        K = self.hp.latent_size
        if gumbel is None:
            gumbel = gumbel_noise((self.tokens, K), self.generator,
                                  self.device, dtype)
        per, d = self.data.tok_word.shape[0], mesh.index[mesh.data_axis]
        mine = gumbel[d * per:(d + 1) * per]
        mine = torch.cat([mine, mine.new_zeros((per - mine.shape[0], K))])
        counts = e_step(params, background, self.data.tok_word,
                        self.data.tok_item, K,
                        tok_weight=self.data.tok_weight, gumbel=mine)
        return {k: _data_total(mesh, v) for k, v in counts.items()}

    def fit(self, em_iters: Optional[int] = None) -> "HFTTrainer":
        hp = self.hp
        em_iters = em_iters or hp.hft_em_iters
        params, background = init_params(self.data, hp, self.verbose,
                                         self.generator, self.gamma_init,
                                         self.mesh)
        counts = self._e_step(params, background, 0)
        best_valid = float("inf")
        best = {"params": params, "background": background}
        for it in range(em_iters):
            params, energy_val = self.m_step(params, counts, background)
            if hp.lamda > 0:
                counts = self._e_step(params, background, it + 1)
                params, background = normalize_word_weights(params,
                                                            background)
            errs = self.errors(params)
            self.verbose(
                f"iter {it}: energy={float(energy_val):.2f} "
                f"errors train/valid/test = {errs['train']:.4f}/"
                f"{errs['val']:.4f}/{errs['test']:.4f}")
            if errs["val"] < best_valid:
                best_valid = errs["val"]
                best = {"params": params, "background": background,
                        "errors": errs}
        self.params = best["params"]
        self.background = best["background"]
        self.best_errors = best.get("errors", self.errors(self.params))
        return self

    def top_words(self, k: int = 10):
        """Top words per topic."""
        tw = self.params["topic_words"].cpu().numpy()
        return [list(np.argsort(-tw[:, t])[:k]) for t in range(tw.shape[1])]


def save_artifacts(trainer: HFTTrainer, hp: HyperParams, hr1: float,
                   ucm: Dict, icm: Dict) -> str:
    """The research-output files of the reference binary, keyed by
    run_tag under log_dir, in the JAX package's names and line formats:
    <tag>_saved_metrics.txt (train/valid/test MSE and HR@1, one a line),
    <tag>_{user,item}_count_mse_map.txt (`count e1 e2 ... eN `) and
    <tag>_HFT_{train,test,val}_results (`prediction value`)."""
    os.makedirs(hp.log_dir, exist_ok=True)
    tag = os.path.join(hp.log_dir, hp.run_tag())
    errs = trainer.best_errors
    with open(tag + "_saved_metrics.txt", "w") as f:
        for v in (errs["train"], errs["val"], errs["test"], hr1):
            f.write(f"{v}\n")
    for name, cmap in (("user", ucm), ("item", icm)):
        with open(f"{tag}_{name}_count_mse_map.txt", "w") as f:
            for count in sorted(cmap):
                errs_s = " ".join(str(e) for e in cmap[count])
                f.write(f"{count} {errs_s} \n")
    for split in ("train", "test", "val"):
        u, i, r = trainer.data.eval_sets[split]
        preds = _predict(trainer.params, u, i).cpu().numpy()
        vals = r.cpu().numpy()
        with open(f"{tag}_HFT_{split}_results", "w") as f:
            for p, v in zip(preds, vals):
                f.write(f"{p} {v}\n")
    return tag


def run_hft(hp: HyperParams, dataset: ReviewDataset, quiet: bool = True,
            device: DeviceLike = None, **trainer_kw):
    """Fit, then the metrics, count maps and artifact files of the JAX
    package's `run_hft`: HR@1 on the narrow 1+5 sets with the C++ `>=`
    rule and, with `hp.eval_num_negs` > 0, the wide sets ranked with the
    shared strict `>`."""
    from ..train.evaluate import ranks_to_metrics, split_eval_ks

    verbose = (lambda *_: None) if quiet else print
    trainer = HFTTrainer(hp, dataset, verbose=verbose, device=device,
                         **trainer_kw).fit()
    hr1 = round(trainer.ranking(trainer.params), 2)
    metrics = {"MSE": round(trainer.best_errors["test"], 4), "HR@1": hr1}
    if hp.eval_num_negs > 0:
        _, wide_ks = split_eval_ks(hp)
        if wide_ks:
            wide = dataset.materialize_wide_negs(hp, hp.eval_num_negs,
                                                 seed=hp.seed)
            dev = trainer.device
            preds = _predict(trainer.params,
                             torch.as_tensor(wide["user"]).long().to(dev),
                             torch.as_tensor(wide["item"]).long().to(dev))
            ranks = torch.sum(preds[:, 1:] > preds[:, :1], dim=1)
            metrics.update(ranks_to_metrics(ranks.cpu().numpy(), wide_ks))
    ucm, icm = trainer.count_maps(trainer.params)
    from ..parallel.distributed import is_primary
    if is_primary():
        save_artifacts(trainer, hp, hr1, ucm, icm)
    return metrics, ucm, icm

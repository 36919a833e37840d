"""Surprise-equivalent models: baseline, SVD, SVD++, NMF, kNN.

Counterpart of `reviews4rec_tpu/models/neighbors.py`, with its names and
defaults (surprise's: baseline and SVD 20 SGD epochs at lr .005, reg
.02; SVD++ lr .007; SVD init N(0, 0.1); NMF 50 epochs of multiplicative
updates, reg .06, init U(0, 1); user-kNN with MSD similarity, k = 10).
Per-example SGD in train insertion order, unknown entities (no train
ratings) falling back to partial or global means, and predictions
clipped to the rating scale.

- `_sgd_fit`: baseline / SVD / SVD++, the whole fit one launch of the
  per-example SGD kernel on the card (`ops.neighbors.sgd_fit`,
  `csrc/neighbors_sgd.cu`), its plain version on the CPU.
- `_nmf_fit`: per-epoch multiplicative updates, scatters by `index_add_`.
- `_knn_predict`: the dense MSD similarity as three `torch.matmul`s and a
  top-k by a stable descending sort, so that among equal weights the
  lower user index comes first, as `jax.lax.top_k` gives it;
  `_knn_predict_chunked` is the bounded-memory form above
  `KNN_DENSE_CELL_LIMIT` cells.

Where the JAX package draws its init (`jax.random.normal` / `uniform`
from `hp.seed`), the port draws from a `torch.Generator` seeded the same
(other numbers), or takes the state as `init`, which is how the tests and
`chip_smoke.py` hold a fit against JAX's.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..config import HyperParams
from ..data.corpus import ReviewDataset
from ..ops import neighbors as sgd_ops
from ..utils.device import DeviceLike, resolve_device
from ..weights import neighbor_state

# Above this many dense-similarity cells the [U, I] / [U, U] matmul path
# switches to the bounded-memory path (`_knn_predict_chunked`), as in the
# JAX package.
KNN_DENSE_CELL_LIMIT = 100_000_000
# test pairs scored at once by the dense kNN ([rows, U] weights each)
KNN_PREDICT_ROWS = 4096


def _as_tensor(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)


def _train_arrays(dataset: ReviewDataset, device: torch.device):
    tr = dataset.splits["train"]
    return (_as_tensor(tr.user, torch.int32, device),
            _as_tensor(tr.item, torch.int32, device),
            _as_tensor(tr.rating, torch.float32, device))


# ----------------------------------------------------------------------
# baseline / SVD / SVD++ : per-example SGD
# ----------------------------------------------------------------------

def init_sgd_state(num_users: int, num_items: int, *, variant: str,
                   factors: int, seed: int) -> Dict[str, torch.Tensor]:
    """Zero biases and, for SVD and SVD++, N(0, 0.1) factors p, q (and y)
    drawn in that order from a generator seeded with `seed` (CPU)."""
    gen = torch.Generator().manual_seed(seed)
    state = {"bu": torch.zeros(num_users), "bi": torch.zeros(num_items)}
    if variant in ("SVD", "SVD++"):
        state["p"] = 0.1 * torch.randn(num_users, factors, generator=gen)
        state["q"] = 0.1 * torch.randn(num_items, factors, generator=gen)
    if variant == "SVD++":
        state["y"] = 0.1 * torch.randn(num_items, factors, generator=gen)
    return state


def _sgd_fit(users, items, ratings, num_users, num_items, mu, *,
             epochs: int, variant: str, factors: int, lr: float,
             reg: float, seed: int, rated_pad=None, rated_count=None,
             init: Optional[Mapping] = None) -> Dict[str, torch.Tensor]:
    """The fitted state dict (`bu`, `bi`, and `p`, `q`, `y` as the variant
    has them) on the device of `ratings`. `init`, a mapping of arrays of
    the same keys, replaces the drawn init."""
    dev = ratings.device
    if init is None:
        state = init_sgd_state(num_users, num_items, variant=variant,
                               factors=factors, seed=seed)
    else:
        state = neighbor_state({k: init[k] for k in sgd_ops.KEYS[variant]})
    state = {k: v.to(dev).contiguous() for k, v in state.items()}
    return sgd_ops.sgd_fit(users, items, ratings, state, variant, epochs,
                           float(mu), float(lr), float(reg), rated_pad,
                           rated_count)


def rated_lists(dataset: ReviewDataset) -> Tuple[np.ndarray, np.ndarray]:
    """(rated_pad [U, maxI] int32, rated_count [U] f32): each user's train
    items in train order, zero-padded (the JAX package's stable sort and
    segment-relative column)."""
    U = dataset.num_users
    maxI = max(1, int(dataset.user_count.max()))
    pad = np.zeros((U, maxI), np.int32)
    tr = dataset.splits["train"]
    order = np.argsort(tr.user, kind="stable")
    su = tr.user[order].astype(np.int64)
    si = tr.item[order].astype(np.int32)
    counts = np.bincount(su, minlength=U)
    col = np.arange(len(su)) - np.repeat(np.cumsum(counts) - counts, counts)
    pad[su, col] = si
    return pad, counts.astype(np.float32)


# ----------------------------------------------------------------------
# NMF : multiplicative updates (per-epoch accumulators)
# ----------------------------------------------------------------------

def init_nmf(num_users: int, num_items: int, *, factors: int, seed: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """U(0, 1) p and q drawn in that order from a generator seeded with
    `seed` (CPU)."""
    gen = torch.Generator().manual_seed(seed)
    return (torch.rand(num_users, factors, generator=gen),
            torch.rand(num_items, factors, generator=gen))


def _nmf_fit(users, items, ratings, num_users, num_items, *, epochs: int,
             factors: int, reg_pu: float = 0.06, reg_qi: float = 0.06,
             seed: int = 0, init: Optional[Mapping] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(p, q) after `epochs` multiplicative updates, every epoch's four
    accumulators from the factors before it. `init` ({"p", "q"} arrays)
    replaces the drawn init."""
    dev = ratings.device
    if init is None:
        p, q = init_nmf(num_users, num_items, factors=factors, seed=seed)
    else:
        p, q = (neighbor_state(init)[k] for k in ("p", "q"))
    p, q = p.to(dev), q.to(dev)
    ul, il = users.long(), items.long()
    ones = torch.ones_like(ratings)
    n_u = torch.zeros(num_users, device=dev).index_add_(0, ul, ones)
    n_i = torch.zeros(num_items, device=dev).index_add_(0, il, ones)
    r = ratings[:, None]
    for _ in range(epochs):
        pu, qi = p[ul], q[il]
        est = torch.sum(pu * qi, dim=-1)[:, None]
        user_num = torch.zeros_like(p).index_add_(0, ul, qi * r)
        user_den = torch.zeros_like(p).index_add_(0, ul, qi * est)
        item_num = torch.zeros_like(q).index_add_(0, il, pu * r)
        item_den = torch.zeros_like(q).index_add_(0, il, pu * est)
        p_new = p * user_num / (user_den + n_u[:, None] * reg_pu * p + 1e-12)
        q = q * item_num / (item_den + n_i[:, None] * reg_qi * q + 1e-12)
        p = p_new
    return p, q


# ----------------------------------------------------------------------
# user-kNN with MSD similarity
# ----------------------------------------------------------------------

def top_k_lower_first(w: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest of each row of w, the lower
    index first among equal values (`jax.lax.top_k`'s order; `torch.topk`
    promises none on ties)."""
    vals, idx = torch.sort(w, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _knn_estimate(topw, vals, mu: float, hp: HyperParams) -> torch.Tensor:
    denom = torch.sum(topw, dim=-1)
    est = torch.where(denom > 0, torch.sum(topw * vals, dim=-1) / denom,
                      torch.full_like(denom, mu))
    return torch.clamp(est, hp.rating_min, hp.rating_max)


def _knn_predict_chunked(dataset: ReviewDataset, hp: HyperParams,
                         test_u: np.ndarray, test_i: np.ndarray,
                         block: int = 128, device: DeviceLike = None
                         ) -> np.ndarray:
    """User-kNN MSD predictions in bounded memory, the same estimates as
    `_knn_predict`: per block of `block` test pairs every [block, U] row
    is built by scatter over the train COO stream (operands [block, nnz]),
    never a dense [U, U] or [U, I]."""
    dev = resolve_device(device)
    tr = dataset.splits["train"]
    U, I = dataset.num_users, dataset.num_items
    tu_all = np.asarray(test_u, np.int64)
    ti_all = np.asarray(test_i, np.int64)
    mu = float(tr.rating.mean())
    k = min(hp.knn_k, U)
    tr_u = _as_tensor(tr.user, torch.int64, dev)
    tr_i = _as_tensor(tr.item, torch.int64, dev)
    tr_r = _as_tensor(tr.rating, torch.float32, dev)

    def scatter_users(vals: torch.Tensor) -> torch.Tensor:
        # [p, nnz] per-nnz values -> [p, U] sums into their users' columns
        return torch.zeros(vals.shape[0], U, device=dev).index_add_(
            1, tr_u, vals)

    def block_predict(bu: torch.Tensor, bi: torch.Tensor) -> torch.Tensor:
        p = bu.shape[0]
        hit = (bu[:, None] == tr_u[None, :]).float()           # [p, nnz]
        rb = torch.zeros(p, I, device=dev).index_add_(1, tr_i,
                                                      hit * tr_r[None, :])
        mb = torch.clamp(torch.zeros(p, I, device=dev).index_add_(
            1, tr_i, hit), max=1.0)
        gb_r = rb[:, tr_i]                                      # [p, nnz]
        gb_m = mb[:, tr_i]
        common = scatter_users(gb_m)
        cross = scatter_users(gb_r * tr_r[None, :])
        sq_a = scatter_users(gb_r * gb_r)
        sq_b = scatter_users(gb_m * (tr_r * tr_r)[None, :])
        sd = sq_a + sq_b - 2.0 * cross
        sim = torch.where(common > 0, common / (sd + common),
                          torch.zeros((), device=dev))
        sim[torch.arange(p, device=dev), bu] = 0.0              # no self-vote
        is_i = (bi[:, None] == tr_i[None, :]).float()
        mcol = torch.clamp(scatter_users(is_i), max=1.0)
        rcol = scatter_users(is_i * tr_r[None, :])
        topw, topidx = top_k_lower_first(sim * mcol, k)
        vals = torch.gather(rcol, 1, topidx)
        return _knn_estimate(topw, vals, mu, hp)

    out = np.empty(len(tu_all), np.float64)
    for s in range(0, len(tu_all), block):
        e = min(s + block, len(tu_all))
        bu = np.zeros(block, np.int64)
        bi = np.zeros(block, np.int64)
        bu[:e - s] = tu_all[s:e]
        bi[:e - s] = ti_all[s:e]
        est = block_predict(torch.from_numpy(bu).to(dev),
                            torch.from_numpy(bi).to(dev))
        out[s:e] = est.cpu().numpy()[:e - s]
    return out


def _knn_predict(dataset: ReviewDataset, hp: HyperParams,
                 test_u: np.ndarray, test_i: np.ndarray,
                 device: DeviceLike = None) -> np.ndarray:
    dev = resolve_device(device)
    tr = dataset.splits["train"]
    U, I = dataset.num_users, dataset.num_items
    if max(U * I, U * U) > KNN_DENSE_CELL_LIMIT:
        return _knn_predict_chunked(dataset, hp, test_u, test_i,
                                    device=dev)
    tu_tr = _as_tensor(tr.user, torch.int64, dev)
    ti_tr = _as_tensor(tr.item, torch.int64, dev)
    R = torch.zeros(U, I, device=dev)
    R[tu_tr, ti_tr] = _as_tensor(tr.rating, torch.float32, dev)
    M = torch.zeros(U, I, device=dev)
    M[tu_tr, ti_tr] = 1.0
    # sum over common items of (r_a - r_b)^2, via three matmuls
    common = torch.matmul(M, M.T)                                # [U, U]
    sq = torch.matmul(R * R, M.T)
    cross = torch.matmul(R, R.T)
    sd = sq + sq.T - 2 * cross
    # MSD similarity: n_common / (sd + n_common); 0 without common items
    sim = torch.where(common > 0, common / (sd + common),
                      torch.zeros((), device=dev))
    S = sim * (1 - torch.eye(U, device=dev))
    mu = float(tr.rating.mean())
    k = min(hp.knn_k, U)
    tu = torch.as_tensor(np.asarray(test_u), dtype=torch.int64).to(dev)
    ti = torch.as_tensor(np.asarray(test_i), dtype=torch.int64).to(dev)
    out = []
    for s in range(0, tu.shape[0], KNN_PREDICT_ROWS):
        u, i = tu[s:s + KNN_PREDICT_ROWS], ti[s:s + KNN_PREDICT_ROWS]
        w = S[u] * M[:, i].T                # neighbors of u that rated i
        topw, topidx = top_k_lower_first(w, k)
        vals = R[topidx, i[:, None]]
        out.append(_knn_estimate(topw, vals, mu, hp))
    if not out:
        return np.zeros(0, np.float32)
    return torch.cat(out).cpu().numpy()


# ----------------------------------------------------------------------
# unified runner
# ----------------------------------------------------------------------

def fit(hp: HyperParams, dataset: ReviewDataset, device: DeviceLike = None,
        init: Optional[Mapping] = None) -> Callable:
    """Fit once on `device` (None = the GPU); returns predict(u_ids,
    i_ids) -> np.ndarray. `init` replaces the drawn init of SVD, SVD++
    (`p`, `q`, `y`, and `bu`, `bi`) and NMF (`p`, `q`)."""
    dev = resolve_device(device)
    users, items, ratings = _train_arrays(dataset, dev)
    mu = float(dataset.splits["train"].rating.mean())
    mt = hp.model_type
    U, I = dataset.num_users, dataset.num_items
    known_u = torch.as_tensor(dataset.user_count > 0).to(dev)
    known_i = torch.as_tensor(dataset.item_count > 0).to(dev)

    def ids(a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.int64).to(dev)

    def clip(est: torch.Tensor) -> np.ndarray:
        return torch.clamp(est, hp.rating_min, hp.rating_max).cpu().numpy()

    if mt == "kNN":
        return lambda tu, ti: _knn_predict(dataset, hp, tu, ti, device=dev)

    if mt == "NMF":
        p, q = _nmf_fit(users, items, ratings, U, I, epochs=hp.nmf_epochs,
                        factors=hp.latent_size, seed=hp.seed, init=init)

        def predict_nmf(test_u, test_i):
            tu, ti = ids(test_u), ids(test_i)
            est = torch.sum(p[tu] * q[ti], dim=-1)
            # unknown user/item -> global mean (PredictionImpossible)
            est = torch.where(known_u[tu] & known_i[ti], est,
                              torch.full_like(est, mu))
            return clip(est)

        predict_nmf.state = {"p": p, "q": q}
        return predict_nmf

    variant = {"baseline": "baseline", "SVD": "SVD", "SVD++": "SVD++"}[mt]
    lr = 0.007 if variant == "SVD++" else hp.surprise_lr
    kw = {}
    if variant == "SVD++":
        pad, cnt = rated_lists(dataset)
        kw = {"rated_pad": _as_tensor(pad, torch.int32, dev),
              "rated_count": _as_tensor(cnt, torch.float32, dev)}
    state = _sgd_fit(users, items, ratings, U, I, mu,
                     epochs=hp.surprise_epochs, variant=variant,
                     factors=hp.latent_size, lr=lr, reg=hp.surprise_reg,
                     seed=hp.seed, init=init, **kw)

    def predict_sgd(test_u, test_i):
        tu, ti = ids(test_u), ids(test_i)
        zero = torch.zeros((), device=dev)
        est = mu + torch.where(known_u[tu], state["bu"][tu], zero) \
            + torch.where(known_i[ti], state["bi"][ti], zero)
        if variant in ("SVD", "SVD++"):
            inter = torch.sum(state["p"][tu] * state["q"][ti], dim=-1)
            if variant == "SVD++":
                pad, cnt = kw["rated_pad"], kw["rated_count"]
                mask = (torch.arange(pad.shape[1], device=dev)[None, :]
                        < cnt[tu][:, None]).float()
                imp = torch.sum(state["y"][pad[tu].long()] * mask[..., None],
                                dim=1) \
                    * torch.rsqrt(torch.clamp(cnt[tu], min=1.0))[:, None]
                inter = torch.sum(state["q"][ti] * (state["p"][tu] + imp),
                                  dim=-1)
            est = est + torch.where(known_u[tu] & known_i[ti], inter, zero)
        return clip(est)

    predict_sgd.state = state
    return predict_sgd


def run_neighbor(hp: HyperParams, dataset: ReviewDataset,
                 device: DeviceLike = None, init: Optional[Mapping] = None):
    """Fit + test-set evaluation with count maps + HR@1 ranking, as the
    JAX package's `run_neighbor`: the narrow 1+5 sets and, with
    `hp.eval_num_negs` > 0, the wide sets ranked with strict `>`."""
    from ..train.evaluate import ranks_to_metrics, split_eval_ks

    predict = fit(hp, dataset, device=device, init=init)
    te = dataset.splits["test"]
    preds = predict(te.user, te.item)
    err = (preds - te.rating) ** 2
    metrics = {"MSE": round(float(err.mean()), 4)}

    ucm: Dict[int, list] = {}
    icm: Dict[int, list] = {}
    ucnt = dataset.user_count[te.user]
    icnt = dataset.item_count[te.item]
    for c, e in zip(ucnt, err):
        ucm.setdefault(int(c), []).append(float(e))
    for c, e in zip(icnt, err):
        icm.setdefault(int(c), []).append(float(e))

    narrow_ks, wide_ks = split_eval_ks(hp)

    def grid_ranks(users_2d, items_2d):
        m = items_2d.shape[0]
        scores = predict(np.asarray(users_2d).reshape(-1),
                         np.asarray(items_2d).reshape(-1)).reshape(m, -1)
        return (scores[:, 1:] > scores[:, :1]).sum(axis=1)

    m = dataset.neg_cands.shape[0]
    users = np.repeat(dataset.neg_users,
                      dataset.neg_cands.shape[1]).reshape(m, -1)
    metrics.update(ranks_to_metrics(grid_ranks(users, dataset.neg_cands),
                                    narrow_ks))
    if wide_ks:
        wide = dataset.materialize_wide_negs(hp, hp.eval_num_negs,
                                             seed=hp.seed)
        metrics.update(ranks_to_metrics(
            grid_ranks(wide["user"], wide["item"]), wide_ks))
    return metrics, ucm, icm

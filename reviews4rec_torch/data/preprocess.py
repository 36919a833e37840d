"""Offline preprocessing: raw Amazon-style JSON -> ReviewDataset.

The port's own copy of `reviews4rec_tpu/data/preprocess.py`, with the
same semantics, in one pass that writes the array-record corpus:

- iterative k-core filtering to a fixpoint;
- tokenization and a 50k-capped vocabulary with UNK=0;
- an 80/10/10 shuffle split;
- `percent_reviews_to_keep` review-text dropout on train only (ratings
  untouched);
- 64-d skip-gram word vectors trained on the train reviews (SGNS with
  negative sampling; the numpy host loop, or `_train_sgns_torch` on the
  device for a large corpus);
- per-user negative candidate sets from the test split.

Every array of the saved `corpus.npz` but `word_vectors` is bitwise the
JAX package's for the same dump and seed; `word_vectors` too with the
numpy backend. The torch backend does JAX's on-device updates
(`_train_sgns_jax`) on torch's random streams.

    python -m reviews4rec_torch.data.preprocess <name> <dump.json[.gz]>
        [--k-core 5] [--w2v-backend auto|numpy|torch] [--device cpu]
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device
from .corpus import ReviewDataset, Split
from .tokenizer import build_vocab, tokenize


def load_amazon_json(path: str) -> List[Dict]:
    """JSON-lines Amazon review dumps (optionally .gz): one object per
    line with reviewerID/asin/overall/reviewText."""
    opener = gzip.open if path.endswith(".gz") else open
    recs = []
    with opener(path, "rt") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            r = json.loads(line)
            recs.append({
                "reviewerID": r["reviewerID"],
                "asin": r["asin"],
                "overall": float(r["overall"]),
                "reviewText": r.get("reviewText", "") or "",
            })
    return recs


def load_ratebeer(path: str) -> List[Dict]:
    """RateBeer multi-line records: latin-1 text, one `key: value` field
    per line, a blank line ends a record. Ratings are "overall: N/20";
    the numerator is kept, so the scale is 1..20 (the dataset name
    'ratebeer' makes `api.run` use rating_max=20)."""
    opener = gzip.open if path.endswith(".gz") else open
    recs: List[Dict] = []
    cur: Dict = {}
    with opener(path, "rb") as f:
        for raw in f:
            line = raw.strip().decode("latin-1")
            if not line:
                if cur:
                    recs.append(cur)
                cur = {}
                continue
            if line.startswith("beer/beerId"):
                cur["asin"] = line.split(":")[-1].strip()
            elif line.startswith("review/profileName"):
                cur["reviewerID"] = line.split(":")[-1].strip()
            elif line.startswith("review/overall"):
                cur["overall"] = float(line.split(":")[-1].split("/")[0])
            elif line.startswith("review/text"):
                cur["reviewText"] = line.split(":", 1)[-1].strip()
    if cur:
        recs.append(cur)
    out = []
    for r in recs:
        if not {"asin", "reviewerID", "overall"} <= r.keys():
            continue
        r.setdefault("reviewText", "")
        out.append(r)
    return out


def k_core_filter(recs: Sequence[Dict], k_core: int
                  ) -> Tuple[List[Dict], Dict[str, int], Dict[str, int]]:
    """Drop users/items with < k interactions until a fixpoint, then
    densify ids in first-appearance order."""
    kept = list(recs)
    while True:
        ucnt: Dict[str, int] = {}
        icnt: Dict[str, int] = {}
        for r in kept:
            ucnt[r["reviewerID"]] = ucnt.get(r["reviewerID"], 0) + 1
            icnt[r["asin"]] = icnt.get(r["asin"], 0) + 1
        nxt = [r for r in kept
               if ucnt[r["reviewerID"]] >= k_core
               and icnt[r["asin"]] >= k_core]
        if len(nxt) == len(kept):
            break
        kept = nxt

    umap: Dict[str, int] = {}
    imap: Dict[str, int] = {}
    for r in kept:
        if r["reviewerID"] not in umap:
            umap[r["reviewerID"]] = len(umap)
        if r["asin"] not in imap:
            imap[r["asin"]] = len(imap)
    return kept, umap, imap


# ----------------------------------------------------------------------
# Self-contained skip-gram-with-negative-sampling word vectors.
# ----------------------------------------------------------------------

def _sigmoid(x: np.ndarray) -> np.ndarray:
    """Overflow-free logistic: exp() only ever sees non-positive args."""
    out = np.empty_like(x)
    pos = x >= 0
    out[pos] = 1.0 / (1.0 + np.exp(-x[pos]))
    ex = np.exp(x[~pos])
    out[~pos] = ex / (1.0 + ex)
    return out


def sgns_batching(n: int) -> Tuple[int, int]:
    """(batch size, batches an epoch) of the SGNS mini-batch loop: at
    least 64 updates an epoch on a small corpus (batched scatter-mean
    updates learn per batch, not per pair)."""
    bs = int(np.clip(n // 64, 256, 4096))
    return bs, -(-n // bs)


class TorchDraws:
    """The random draws of `_train_sgns_torch`, on one explicit
    `torch.Generator` on the device: each epoch's permutation of the
    padded pairs, then each batch's [bs, negatives] uniforms. A test
    hands the trainer an object with the same two methods holding JAX's
    draws instead (`jax.random` streams cannot come from torch)."""

    def __init__(self, seed: int, device: torch.device):
        self.device = device
        self.gen = torch.Generator(device=device).manual_seed(int(seed))

    def permutation(self, epoch: int, n: int) -> torch.Tensor:
        return torch.randperm(n, generator=self.gen, device=self.device)

    def uniform(self, epoch: int, batch: int, shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.gen, device=self.device)


def _train_sgns_torch(centers_a: np.ndarray, contexts_a: np.ndarray,
                      probs: np.ndarray, vec_in0: np.ndarray,
                      dim: int, epochs: int, negatives: int, lr: float,
                      seed: int, device: DeviceLike = None,
                      draws=None) -> np.ndarray:
    """On-device SGNS: the updates of the JAX package's `_train_sgns_jax`
    in the same order (its `lax.scan` over batches becomes a loop).
    Per batch: the linear lr decay over the whole run, negatives by
    inverse-CDF search of uniforms in the unigram^0.75 CDF, and the
    scatter-MEAN over in-batch duplicates (`index_add_` of the updates
    over `index_add_` counts; the padding pairs count too, as in JAX).
    `draws` (default `TorchDraws(seed, device)`) gives the permutations
    and uniforms; the body is held against JAX's on JAX's own draws.
    Returns the input table, [V, dim] float32 on the host."""
    dev = resolve_device(device)
    V = vec_in0.shape[0]
    n = len(centers_a)
    bs, n_batches = sgns_batching(n)
    pad = n_batches * bs - n

    def put(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    centers = put(np.concatenate([centers_a, np.zeros(pad)]), torch.int64)
    contexts = put(np.concatenate([contexts_a, np.zeros(pad)]), torch.int64)
    weight = put(np.arange(n_batches * bs) < n, torch.float32)
    cdf = put(np.cumsum(probs).astype(np.float32), torch.float32)
    draws = draws if draws is not None else TorchDraws(seed, dev)
    total_steps = max(epochs, 1) * n_batches
    ones = torch.ones(bs * (1 + negatives), device=dev)

    vin = put(vec_in0, torch.float32).clone()
    vout = torch.zeros_like(vin)
    for ep in range(max(epochs, 1)):
        order = draws.permutation(ep, n_batches * bs)
        for i in range(n_batches):
            # JAX's float32 schedule: lr * (1 - step / total), >= 1e-4
            step = np.float32(ep * n_batches + i) / np.float32(total_steps)
            lr_t = float(max(np.float32(lr) * (np.float32(1.0) - step),
                             np.float32(1e-4)))
            sel = order[i * bs:(i + 1) * bs]
            c = centers[sel]
            w = weight[sel]
            u = draws.uniform(ep, i, (bs, negatives))
            neg = torch.searchsorted(cdf, u, right=True).clamp_(0, V - 1)
            targets = torch.cat([contexts[sel][:, None], neg], 1)
            vi = vin[c]                                     # [b, d]
            vo = vout[targets]                              # [b, 1+k, d]
            score = torch.bmm(vo, vi[:, :, None])[..., 0]   # [b, 1+k]
            label = torch.zeros_like(score)
            label[:, 0] = 1.0
            g = (torch.sigmoid(score) - label) * lr_t * w[:, None]
            gi = torch.bmm(g[:, None, :], vo)[:, 0]         # [b, d]
            go = g[..., None] * vi[:, None, :]              # [b, 1+k, d]
            tflat = targets.reshape(-1)
            ci = torch.zeros(V, device=dev).index_add_(0, c, ones[:bs])
            co = torch.zeros(V, device=dev).index_add_(0, tflat, ones)
            vin = vin - torch.zeros_like(vin).index_add_(0, c, gi) \
                / ci.clamp(min=1.0)[:, None]
            vout = vout - torch.zeros_like(vout).index_add_(
                0, tflat, go.reshape(-1, dim)) / co.clamp(min=1.0)[:, None]
    return vin.cpu().numpy().astype(np.float32)


def _center_table(vecs: np.ndarray) -> np.ndarray:
    """Zero the UNK/pad row and remove the common mean from the rest
    (see train_word2vec docstring)."""
    vecs = vecs.astype(np.float32)
    vecs[1:] -= vecs[1:].mean(axis=0, keepdims=True)
    vecs[0] = 0.0
    return vecs


def train_word2vec(token_lists: Sequence[np.ndarray], num_words: int,
                   dim: int = 64, epochs: int = 20, window: int = 1,
                   negatives: int = 64, lr: float = 0.05,
                   seed: int = 0, backend: str = "auto",
                   sample: float = 1e-3,
                   device: DeviceLike = None) -> np.ndarray:
    """SGNS over word-id sequences; returns [num_words + 1, dim] with
    row 0 (UNK/pad) zeroed. The defaults are gensim's Word2Vec(size=64,
    sg=1, window=1, negative=64, iter=20). Backends: "numpy" (the
    mini-batched host loop, deterministic across machines), "torch"
    (`_train_sgns_torch` on `device`, None = the GPU), "auto" = torch
    from 500k pairs on, where the host loop becomes the preprocessing
    bottleneck.

    The returned table is MEAN-CENTERED (rows 1:): SGNS with 64
    negatives grows a large direction shared by every vector (the
    negative-sampling background), which would drown the lexical signal
    the frozen-table conv towers read; removing the common mean is the
    mean-only form of all-but-the-top postprocessing (Mu & Viswanath
    2018)."""
    if backend not in ("auto", "numpy", "torch"):
        raise ValueError(f"backend must be auto, numpy or torch, got "
                         f"{backend!r}")
    rng = np.random.default_rng(seed)
    V = num_words + 1
    vec_in = (rng.random((V, dim), np.float32) - 0.5) / dim
    vec_out = np.zeros((V, dim), np.float32)

    # frequent-word subsampling (gensim's default sample=1e-3):
    # p_keep = (sqrt(f/s)+1)*s/f; it also caps in-batch duplicate
    # multiplicity, so the batched scatter updates stay close to
    # sequential SGD
    if sample and sample > 0:
        total = sum(int(np.count_nonzero(np.asarray(t)))
                    for t in token_lists) or 1
        cnt = np.zeros(V, np.int64)
        for t in token_lists:
            a = np.asarray(t, np.int64)
            cnt += np.bincount(a[a > 0], minlength=V)
        f = cnt / total
        with np.errstate(divide="ignore", invalid="ignore"):
            keep = (np.sqrt(f / sample) + 1.0) * (sample / np.maximum(f, 1e-12))
        keep = np.clip(np.nan_to_num(keep, nan=1.0), 0.0, 1.0)
        keep[0] = 0.0
    else:
        keep = np.ones(V)

    centers: List[np.ndarray] = []
    contexts: List[np.ndarray] = []
    for toks in token_lists:
        t = np.asarray(toks, np.int64)
        t = t[t > 0]
        if sample and sample > 0 and len(t):
            t = t[rng.random(len(t)) < keep[t]]
        for off in range(1, window + 1):
            if len(t) > off:
                centers.append(t[:-off])
                contexts.append(t[off:])
                centers.append(t[off:])
                contexts.append(t[:-off])
    if not centers:
        return _center_table(vec_in)
    centers_a = np.concatenate(centers)
    contexts_a = np.concatenate(contexts)

    # unigram^(3/4) negative-sampling table
    freq = np.bincount(contexts_a, minlength=V).astype(np.float64)
    probs = freq ** 0.75
    probs[0] = 0.0
    probs /= probs.sum()

    n = len(centers_a)
    if backend == "torch" or (backend == "auto" and n >= 500_000):
        return _center_table(
            _train_sgns_torch(centers_a, contexts_a, probs, vec_in,
                              dim, epochs, negatives, lr, seed, device))

    bs, n_batches = sgns_batching(n)
    total_steps = max(epochs, 1) * n_batches
    step = 0
    for _ in range(max(epochs, 1)):
        order = rng.permutation(n)
        for s in range(0, n, bs):
            lr_t = max(lr * (1.0 - step / total_steps), 1e-4)
            step += 1
            sel = order[s:s + bs]
            c = centers_a[sel]
            pos = contexts_a[sel]
            neg = rng.choice(V, size=(len(sel), negatives), p=probs)
            vi = vec_in[c]                                   # [b, d]
            targets = np.concatenate([pos[:, None], neg], 1)  # [b, 1+k]
            vo = vec_out[targets]                            # [b, 1+k, d]
            score = np.einsum("bd,bkd->bk", vi, vo)
            label = np.zeros_like(score)
            label[:, 0] = 1.0
            g = (_sigmoid(score) - label) * lr_t             # [b, 1+k]
            gi = np.einsum("bk,bkd->bd", g, vo)
            go = g[..., None] * vi[:, None, :]
            # scatter-MEAN over in-batch duplicates: summing overshoots
            # by a row's multiplicity and diverges on small vocabularies
            tflat = targets.reshape(-1)
            upd_i = np.zeros_like(vec_in)
            np.add.at(upd_i, c, gi)
            ci = np.bincount(c, minlength=V)[:, None]
            vec_in -= upd_i / np.maximum(ci, 1)
            upd_o = np.zeros_like(vec_out)
            np.add.at(upd_o, tflat, go.reshape(-1, dim))
            co = np.bincount(tflat, minlength=V)[:, None]
            vec_out -= upd_o / np.maximum(co, 1)
    return _center_table(vec_in)


# ----------------------------------------------------------------------

def build_negatives(test: Split, num_negs: int = 5, seed: int = 0
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-user candidate rows from the TEST split: column 0 = one
    positive (rating >= 4.9), columns 1..num_negs = distinct sampled
    items the user rated < 4.9; users lacking either are skipped."""
    rng = np.random.default_rng(seed)
    by_user: Dict[int, List[Tuple[int, float]]] = {}
    for u, i, r in zip(test.user, test.item, test.rating):
        by_user.setdefault(int(u), []).append((int(i), float(r)))

    users: List[int] = []
    cands: List[List[int]] = []
    for u in sorted(by_user):
        pos = [i for i, r in by_user[u] if r >= 4.9]
        neg = [i for i, r in by_user[u] if r < 4.9]
        if not pos or len(neg) < num_negs:
            continue
        p = int(rng.choice(pos))
        ns = rng.choice(len(neg), size=num_negs, replace=False)
        users.append(u)
        cands.append([p] + [neg[j] for j in ns])
    if not users:
        return np.zeros(0, np.int32), np.zeros((0, 1 + num_negs), np.int32)
    return (np.asarray(users, np.int32),
            np.asarray(cands, np.int32))


def preprocess(recs: Sequence[Dict], k_core: int = 5,
               percent_reviews_to_keep: int = 100,
               vocab_cap: int = 50000, w2v_epochs: int = 20,
               w2v_backend: str = "auto",
               seed: int = 0, verbose: Callable = print,
               device: DeviceLike = None) -> ReviewDataset:
    """Full offline pipeline (module docstring); `device` is where the
    torch SGNS backend runs (None = the GPU)."""
    rng = np.random.default_rng(seed)
    kept, umap, imap = k_core_filter(recs, k_core)
    verbose(f"k-core({k_core}): {len(kept)}/{len(recs)} interactions, "
            f"{len(umap)} users, {len(imap)} items")

    # dedup (u, i) keeping the first occurrence
    seen = set()
    uniq = []
    for r in kept:
        key = (umap[r["reviewerID"]], imap[r["asin"]])
        if key in seen:
            continue
        seen.add(key)
        uniq.append((key[0], key[1], float(r["overall"]),
                     tokenize(r["reviewText"])))

    word_map, num_words = build_vocab([t for *_, t in uniq], cap=vocab_cap)
    verbose(f"vocab: {num_words} words")
    token_ids = [np.asarray([word_map[w] for w in toks], np.int32)
                 for *_, toks in uniq]

    n = len(uniq)
    order = rng.permutation(n)
    n_train = int(0.8 * n)
    n_test = (n - n_train + 1) // 2
    idx = {"train": order[:n_train],
           "test": order[n_train:n_train + n_test],
           "val": order[n_train + n_test:]}
    splits = {
        s: Split(np.asarray([uniq[j][0] for j in ix], np.int32),
                 np.asarray([uniq[j][1] for j in ix], np.int32),
                 np.asarray([uniq[j][2] for j in ix], np.float32))
        for s, ix in idx.items()}

    num_users, num_items = len(umap), len(imap)
    user_reviews: List[List[np.ndarray]] = [[] for _ in range(num_users)]
    item_reviews: List[List[np.ndarray]] = [[] for _ in range(num_items)]
    u_to_i: List[List[int]] = [[] for _ in range(num_users)]
    i_to_u: List[List[int]] = [[] for _ in range(num_items)]
    this_index: Dict[Tuple[int, int], Tuple[int, int]] = {}
    train_texts: List[np.ndarray] = []
    for j in idx["train"]:
        u, i, _, _ = uniq[j]
        toks = token_ids[j]
        # review-text dropout, train only (ratings untouched)
        if percent_reviews_to_keep < 100 and \
                rng.random() * 100 >= percent_reviews_to_keep:
            toks = np.zeros(0, np.int32)
        this_index[(u, i)] = (len(user_reviews[u]), len(item_reviews[i]))
        user_reviews[u].append(toks)
        item_reviews[i].append(toks)
        u_to_i[u].append(i)
        i_to_u[i].append(u)
        train_texts.append(toks)

    test_reviews = {(uniq[j][0], uniq[j][1]): token_ids[j]
                    for s in ("test", "val") for j in idx[s]}

    word_vectors = train_word2vec(train_texts, num_words,
                                  epochs=w2v_epochs, seed=seed,
                                  backend=w2v_backend, device=device)
    neg_users, neg_cands = build_negatives(splits["test"], seed=seed)
    verbose(f"split sizes train/test/val = {len(splits['train'])}/"
            f"{len(splits['test'])}/{len(splits['val'])}; "
            f"{len(neg_users)} users with negative sets")

    return ReviewDataset.build(
        num_users=num_users, num_items=num_items, num_words=num_words,
        splits=splits, user_reviews=user_reviews,
        item_reviews=item_reviews, u_to_i=u_to_i, i_to_u=i_to_u,
        this_index=this_index, test_reviews=test_reviews,
        neg_users=neg_users, neg_cands=neg_cands,
        word_vectors=word_vectors,
        vocab={w: j for w, j in word_map.items() if j > 0})


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m reviews4rec_torch.data.preprocess",
        description="preprocess a raw review dump")
    p.add_argument("name", help="dataset name")
    p.add_argument("raw", help="path to JSON-lines review dump (.json/.gz)")
    p.add_argument("--k-core", type=int, default=5)
    p.add_argument("--format", choices=("amazon", "ratebeer"), default=None,
                   help="raw format; default: ratebeer iff name is "
                        "'ratebeer'")
    p.add_argument("--percent", type=int, default=100,
                   help="percent of train review text to keep")
    p.add_argument("--out", default="data", help="output data root")
    p.add_argument("--w2v-epochs", type=int, default=20)
    p.add_argument("--w2v-backend", choices=("auto", "numpy", "torch"),
                   default="auto",
                   help="SGNS backend: the numpy host loop or torch on "
                        "--device; auto picks torch from 500k pairs on")
    p.add_argument("--device", default=None,
                   help="device of the torch SGNS backend (default: the "
                        "GPU; 'cpu' to run without one)")
    p.add_argument("--seed", type=int, default=0)
    return p


def main(argv: Optional[List[str]] = None) -> None:
    """Preprocess one raw dump into `<out>/<name>/<k>_core[/<p>_percent]/
    corpus.npz`."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    fmt = args.format or ("ratebeer" if args.name == "ratebeer" else "amazon")
    loader = load_ratebeer if fmt == "ratebeer" else load_amazon_json
    ds = preprocess(loader(args.raw), k_core=args.k_core,
                    percent_reviews_to_keep=args.percent,
                    w2v_epochs=args.w2v_epochs, seed=args.seed,
                    w2v_backend=args.w2v_backend, device=device)
    out = os.path.join(args.out, args.name, f"{args.k_core}_core")
    if args.percent != 100:
        out = os.path.join(out, f"{args.percent}_percent")
    ds.save(out)
    print(f"saved {out}/corpus.npz")


if __name__ == "__main__":
    main()

"""Corpus store and record materialization.

`ReviewDataset` holds the preprocessed corpus (rating triples per split,
per-entity review lists, the (u, i) -> review-index maps used for
leakage removal, held-out eval reviews, negative sets, word vectors) and
materializes fixed-shape int32 record tensors for the review models.
The records are byte-identical to the JAX package's
(`reviews4rec_tpu/data/corpus.py`) for the same corpus file:

- leakage removal on the train split: the (u, i) pair's own review is
  dropped from both the user's and the item's review list and returned
  separately as `this_doc`; eval splits keep everything and `this_doc`
  is the held-out review.
- doc layouts: one concatenated row of `input_length` words, or one row
  per review (NARRE, MPCN).
- neighbor-id lists padded to exactly 10 slots with the sentinel id
  `total + 1`.
- ranking-loss training grids (`materialize_train_negs`): each
  example's positive and `hp.num_negs` sampled negatives.
- the entity doc store (`hp.cache_entity`): one canonical doc per user
  and per item, concatenated (`_entity_spans`) or per review with the
  neighbor-id lists in the same slot order (`_entity_rows_docs`, NARRE),
  and per-example records of ids, rating, transnet's `this_doc` and, on
  train, where the pair's own review sits in each doc: its (start, len)
  word span or its review row (`materialize_entity`), which the model
  masks in place instead of removing it.
- the out-of-core record store (`hp.out_of_core`): the doc and
  neighbor tensors of a split or a candidate grid are built
  `hp.materialize_chunk_rows` examples at a time into .npy files under
  `data_dir()/records/<tag>/` and returned memory-mapped, read-only;
  byte-identical to the in-RAM records.

The records are assembled by the native (C++/OpenMP) materializer
(`data/native.py`) where g++ builds it, else by the numpy one
(`_python_text`), byte for byte the same; `materializer` names the one
that ran last. `save` writes the `corpus.npz` both packages read.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.io import load_json, load_npz, save_json, save_npz

NEIGHBOR_SLOTS = 10


@dataclass
class Split:
    """One rating split: parallel (user, item, rating) arrays."""

    user: np.ndarray
    item: np.ndarray
    rating: np.ndarray

    @classmethod
    def from_triples(cls, triples: Sequence[Sequence[float]]) -> "Split":
        if len(triples) == 0:
            return cls(np.zeros(0, np.int32), np.zeros(0, np.int32),
                       np.zeros(0, np.float32))
        arr = np.asarray(triples, np.float64)
        return cls(arr[:, 0].astype(np.int32), arr[:, 1].astype(np.int32),
                   arr[:, 2].astype(np.float32))

    def __len__(self) -> int:
        return int(self.user.shape[0])


def _doc_layout(hp) -> Tuple[int, int]:
    """(rows, words) per model family. rows == 1 -> concatenated doc."""
    if hp.model_type == "NARRE":
        return hp.narre_num_reviews, hp.narre_num_words
    if hp.model_type == "MPCN":
        return hp.mpcn_dmax, hp.mpcn_smax
    return 1, hp.input_length


def _open_store(d: str) -> Dict[str, np.ndarray]:
    """The arrays of a complete record store, memory-mapped read-only."""
    names = load_json(os.path.join(d, "manifest.json"))["arrays"]
    return {k: np.load(os.path.join(d, k + ".npy"), mmap_mode="r")
            for k in names}


def _create_store(d: str, spec: Dict[str, Tuple[Tuple[int, ...], type]],
                  id_arrays: Dict[str, np.ndarray]
                  ) -> Dict[str, np.ndarray]:
    """Writable .npy memmaps of `spec` under `d`, the id arrays filled."""
    os.makedirs(d, exist_ok=True)
    mm = {k: np.lib.format.open_memmap(os.path.join(d, k + ".npy"),
                                       mode="w+", dtype=dt, shape=shape)
          for k, (shape, dt) in spec.items()}
    for k, v in id_arrays.items():
        mm[k][:] = v
    return mm


def _seal_store(d: str, mm: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Flush the memmaps, then write the manifest: a store is valid only
    once complete. Returns the store reopened read-only."""
    for v in mm.values():
        v.flush()
    manifest = os.path.join(d, "manifest.json")
    save_json(manifest + ".tmp", {"arrays": sorted(mm)})
    os.replace(manifest + ".tmp", manifest)
    return _open_store(d)


class ReviewDataset:
    """In-memory corpus plus materialization cache. Construct with
    `load()` (a corpus.npz written by either package) or `build()`."""

    @classmethod
    def build(cls, *, num_users: int, num_items: int, num_words: int,
              splits: Dict[str, Split],
              user_reviews: List[List[np.ndarray]],
              item_reviews: List[List[np.ndarray]],
              u_to_i: List[List[int]], i_to_u: List[List[int]],
              this_index: Dict[Tuple[int, int], Tuple[int, int]],
              test_reviews: Dict[Tuple[int, int], np.ndarray],
              neg_users: np.ndarray, neg_cands: np.ndarray,
              word_vectors: np.ndarray,
              vocab: Optional[Dict[str, int]] = None) -> "ReviewDataset":
        self = cls.__new__(cls)
        self.num_users = int(num_users)
        self.num_items = int(num_items)
        self.num_words = int(num_words)
        self.splits = splits
        self.user_reviews = [
            [np.asarray(r, np.int32) for r in revs] for revs in user_reviews]
        self.item_reviews = [
            [np.asarray(r, np.int32) for r in revs] for revs in item_reviews]
        self.u_to_i = [list(map(int, lst)) for lst in u_to_i]
        self.i_to_u = [list(map(int, lst)) for lst in i_to_u]
        self.this_index = {
            (int(u), int(i)): (int(a), int(b))
            for (u, i), (a, b) in this_index.items()}
        self.test_reviews = {
            (int(u), int(i)): np.asarray(t, np.int32)
            for (u, i), t in test_reviews.items()}
        self.neg_users = np.asarray(neg_users, np.int32)
        self.neg_cands = np.asarray(neg_cands, np.int32)
        self.word_vectors = np.asarray(word_vectors, np.float32)
        self.vocab = dict(vocab) if vocab is not None else None
        tr = splits["train"]
        self.user_count = np.bincount(tr.user, minlength=num_users) \
            .astype(np.int64)
        self.item_count = np.bincount(tr.item, minlength=num_items) \
            .astype(np.int64)
        self._cache: Dict = {}
        self._flat_store = None
        self._ti_arrays = None
        self._train_pair_keys = None
        self.materializer: Optional[str] = None
        return self

    # ------------------------------------------------------------------
    def encode_text(self, text: str) -> np.ndarray:
        """Tokenize NEW review text against the persisted vocabulary
        (serving surface): letters-only tokens, unknown words -> UNK 0.
        Needs a corpus saved with its vocabulary (any corpus either
        package's preprocessing writes); older archives raise."""
        from .tokenizer import tokenize

        if self.vocab is None:
            raise ValueError(
                "this corpus was saved without its vocabulary map; "
                "re-run preprocessing to enable encode_text")
        return np.asarray([self.vocab.get(w, 0) for w in tokenize(text)],
                          np.int32)

    # ------------------------------------------------------------------
    def apply_to(self, hp):
        """Fill the corpus-size fields of `hp`."""
        return hp.replace(total_users=self.num_users,
                          total_items=self.num_items,
                          total_words=self.num_words)

    # ------------------------------------------------------------------
    # (u, i) -> this_index lookup: sorted int64 keys plus parallel value
    # arrays, searchsorted instead of a per-example dict get.
    # ------------------------------------------------------------------
    def _ti_lookup(self):
        if self._ti_arrays is None:
            items = sorted(self.this_index.items())
            if items:
                keys = np.asarray([u * self.num_items + i
                                   for (u, i), _ in items], np.int64)
                a = np.asarray([v[0] for _, v in items], np.int32)
                b = np.asarray([v[1] for _, v in items], np.int32)
            else:
                keys = np.zeros(0, np.int64)
                a = b = np.zeros(0, np.int32)
            self._ti_arrays = (keys, a, b)
        return self._ti_arrays

    def _ti_find(self, user: np.ndarray, item: np.ndarray):
        """(found_mask, ui_idx, iu_idx) for parallel (u, i) arrays."""
        keys, a, b = self._ti_lookup()
        q = user.astype(np.int64) * self.num_items + item.astype(np.int64)
        if len(keys) == 0:
            z = np.zeros(q.shape, np.int32)
            return np.zeros(q.shape, bool), z, z
        pos = np.searchsorted(keys, q)
        safe = np.minimum(pos, len(keys) - 1)
        return keys[safe] == q, a[safe], b[safe]

    # ------------------------------------------------------------------
    # Flat (CSR-style) review store the materializer reads.
    # ------------------------------------------------------------------
    def _flat(self) -> Dict:
        if self._flat_store is not None:
            return self._flat_store

        revs: List[np.ndarray] = []
        base = np.zeros(self.num_users + 1, np.int64)
        for u in range(self.num_users):
            base[u + 1] = base[u] + len(self.user_reviews[u])
            revs.extend(self.user_reviews[u])
        n_train_revs = len(revs)

        u_off = base.copy()
        u_revs = np.arange(n_train_revs, dtype=np.int32)
        u_other = np.asarray(
            [i for lst in self.u_to_i for i in lst], np.int32)
        if u_other.shape[0] != n_train_revs:
            # item id 0 is a real item: a zero-fill would corrupt the
            # neighbor-id features
            raise ValueError(
                f"u_to_i maps {u_other.shape[0]} reviews but the review "
                f"store holds {n_train_revs}; the corpus is inconsistent")

        i_counts = np.asarray([len(lst) for lst in self.i_to_u], np.int64)
        i_off = np.zeros(self.num_items + 1, np.int64)
        np.cumsum(i_counts, out=i_off[1:])
        i_other = np.asarray(
            [u for lst in self.i_to_u for u in lst], np.int32)
        pair_item = np.repeat(
            np.arange(self.num_items, dtype=np.int64), i_counts)
        # ui index of each (u, i) pair; missing pairs fall back to (0, 0)
        found, ui_of_pair, _ = self._ti_find(i_other, pair_item)
        ui_of_pair = np.where(found, ui_of_pair, 0)
        i_revs = (base[i_other] + ui_of_pair).astype(np.int32)

        # eval-split held-out reviews go after the train reviews, so
        # `this_rev` indexes one token store for every split
        eval_keys_l: List[int] = []
        for key in sorted(self.test_reviews):
            eval_keys_l.append(key[0] * self.num_items + key[1])
            revs.append(self.test_reviews[key])
        eval_keys = np.asarray(eval_keys_l, np.int64)
        eval_rids = np.arange(n_train_revs,
                              n_train_revs + len(eval_keys_l),
                              dtype=np.int32)

        if revs:
            tokens = np.concatenate(
                [np.asarray(r, np.int32).reshape(-1) for r in revs])
            lens = np.asarray([len(r) for r in revs], np.int64)
        else:
            tokens = np.zeros(0, np.int32)
            lens = np.zeros(0, np.int64)
        rev_off = np.zeros(len(revs) + 1, np.int64)
        np.cumsum(lens, out=rev_off[1:])

        self._flat_store = {
            "tokens": tokens.astype(np.int32), "rev_off": rev_off,
            "u_revs": u_revs, "u_off": u_off, "u_other": u_other,
            "i_revs": i_revs, "i_off": i_off, "i_other": i_other,
            "rev_base": base, "eval_keys": eval_keys,
            "eval_rids": eval_rids,
        }
        return self._flat_store

    # ------------------------------------------------------------------
    def _examples(self, split: str):
        """(user, item, ui_idx, iu_idx, this_rev) example arrays.
        Train: leakage-removal indices from this_index plus the pair's
        own review id. Eval: -1 indices (nothing removed), this_rev =
        held-out review."""
        sp = self.splits[split]
        flat = self._flat()
        n = len(sp)
        user = sp.user.astype(np.int32)
        item = sp.item.astype(np.int32)
        ui_idx = np.full(n, -1, np.int32)
        iu_idx = np.full(n, -1, np.int32)
        this_rev = np.full(n, -1, np.int32)
        if n == 0:
            return user, item, ui_idx, iu_idx, this_rev
        if split == "train":
            base = flat["rev_base"]
            found, a, b = self._ti_find(user, item)
            ui_idx = np.where(found, a, -1).astype(np.int32)
            iu_idx = np.where(found, b, -1).astype(np.int32)
            this_rev = np.where(found, base[user] + a, -1).astype(np.int32)
        else:
            keys, rids = flat["eval_keys"], flat["eval_rids"]
            if len(keys):
                q = user.astype(np.int64) * self.num_items + item
                pos = np.searchsorted(keys, q)
                safe = np.minimum(pos, len(keys) - 1)
                this_rev = np.where(keys[safe] == q, rids[safe],
                                    -1).astype(np.int32)
        return user, item, ui_idx, iu_idx, this_rev

    # ------------------------------------------------------------------
    @staticmethod
    def _native_text(flat, user, item, ui_idx, iu_idx, this_rev,
                     rows, words, slots, user_pad, item_pad):
        """The native materializer's records; None where it does not
        build (then the numpy materializer runs)."""
        from . import native
        return native.materialize_records(
            flat, user, item, ui_idx, iu_idx, this_rev,
            rows, words, slots, user_pad, item_pad)

    @staticmethod
    def _python_text(flat, user, item, ui_idx, iu_idx, this_rev,
                     rows, words, slots, user_pad, item_pad):
        """The numpy materializer: doc and neighbor tensors for parallel
        example arrays, byte-identical to `csrc/materialize.cc`'s."""
        tokens, rev_off = flat["tokens"], flat["rev_off"]
        u_off, u_other = flat["u_off"], flat["u_other"]
        i_revs, i_off, i_other = flat["i_revs"], flat["i_off"], flat["i_other"]
        u_revs = flat["u_revs"]
        n = user.shape[0]

        user_doc = np.zeros((n, rows, words), np.int32)
        item_doc = np.zeros((n, rows, words), np.int32)
        this_doc = np.zeros((n, rows, words), np.int32)
        who_gave = np.full((n, slots), user_pad, np.int32)
        reviewed = np.full((n, slots), item_pad, np.int32)

        def emit_docs(revs, skip, out):
            if rows == 1:
                at = 0
                for j, r in enumerate(revs):
                    if j == skip or at >= words:
                        continue
                    s, e = rev_off[r], rev_off[r + 1]
                    m = min(int(e - s), words - at)
                    out[0, at:at + m] = tokens[s:s + m]
                    at += m
            else:
                row = 0
                for j, r in enumerate(revs):
                    if j == skip or row >= rows:
                        continue
                    s, e = rev_off[r], rev_off[r + 1]
                    m = min(int(e - s), words)
                    out[row, :m] = tokens[s:s + m]
                    row += 1

        def emit_neighbors(other, skip, out):
            at = 0
            for j, o in enumerate(other):
                if j == skip or at >= slots:
                    continue
                out[at] = o
                at += 1

        for x in range(n):
            u, it = int(user[x]), int(item[x])
            ur = u_revs[u_off[u]:u_off[u + 1]]
            ir = i_revs[i_off[it]:i_off[it + 1]]
            emit_docs(ur, ui_idx[x], user_doc[x])
            emit_docs(ir, iu_idx[x], item_doc[x])
            r = int(this_rev[x])
            if r >= 0:
                s, e = rev_off[r], rev_off[r + 1]
                m = min(int(e - s), words)
                this_doc[x, 0, :m] = tokens[s:s + m]
            emit_neighbors(u_other[u_off[u]:u_off[u + 1]], ui_idx[x],
                           reviewed[x])
            emit_neighbors(i_other[i_off[it]:i_off[it + 1]], iu_idx[x],
                           who_gave[x])

        return {"user_doc": user_doc, "item_doc": item_doc,
                "this_doc": this_doc, "users_who_gave": who_gave,
                "items_reviewed": reviewed}

    def _text_records(self, hp, user, item, ui_idx, iu_idx, this_rev):
        rows, words = _doc_layout(hp)
        flat = self._flat()
        args = (flat, user, item, ui_idx, iu_idx, this_rev, rows, words,
                NEIGHBOR_SLOTS, hp.user_pad_id, hp.item_pad_id)
        out = self._native_text(*args)
        self.materializer = "numpy" if out is None else "native"
        if out is None:
            out = self._python_text(*args)
        if rows == 1:
            for k in ("user_doc", "item_doc", "this_doc"):
                out[k] = out[k].reshape(user.shape[0], words)
        return out

    # ------------------------------------------------------------------
    def materialize(self, hp, split: str) -> Dict[str, np.ndarray]:
        """Fixed-shape record tensors for one split under one model
        layout (cached). Review families add doc and neighbor tensors.
        With `hp.out_of_core` they are built chunk by chunk into
        memory-mapped .npy files instead of host RAM."""
        with_text = hp.family == "review"
        if with_text and hp.out_of_core:
            return self.materialize_to_disk(hp, split)
        key = (split, _doc_layout(hp) if with_text else "id",
               hp.user_pad_id if with_text else 0)
        if key in self._cache:
            return self._cache[key]
        sp = self.splits[split]
        recs = {"user": sp.user.astype(np.int32),
                "item": sp.item.astype(np.int32),
                "rating": sp.rating.astype(np.float32)}
        if with_text:
            user, item, ui_idx, iu_idx, this_rev = self._examples(split)
            recs.update(self._text_records(hp, user, item, ui_idx, iu_idx,
                                           this_rev))
        self._cache[key] = recs
        return recs

    @staticmethod
    def _doc_tails(hp) -> Dict[str, Tuple[int, ...]]:
        """Trailing shape of each doc and neighbor record of a layout."""
        rows, words = _doc_layout(hp)
        doc = (rows, words) if rows > 1 else (words,)
        return {"user_doc": doc, "item_doc": doc, "this_doc": doc,
                "users_who_gave": (NEIGHBOR_SLOTS,),
                "items_reviewed": (NEIGHBOR_SLOTS,)}

    def _fill_chunks(self, hp, out: Dict[str, np.ndarray], keys, n: int,
                     inputs) -> None:
        """Write the text records `keys` of `n` flattened examples
        (`inputs` = user, item, ui_idx, iu_idx, this_rev) into `out`,
        `hp.materialize_chunk_rows` examples at a time: the peak host
        RAM is one chunk."""
        chunk = max(1, int(hp.materialize_chunk_rows))
        for start in range(0, n, chunk):
            sl = slice(start, min(start + chunk, n))
            recs = self._text_records(hp, *(a[sl] for a in inputs))
            for k in keys:
                out[k][sl] = recs[k]

    def materialize_to_disk(self, hp, split: str,
                            root: Optional[str] = None
                            ) -> Dict[str, np.ndarray]:
        """Out-of-core `materialize` of one rating split: the records
        written chunk by chunk into `<root>/<tag>/*.npy` (root defaults
        to `data_dir()/records`) and returned memory-mapped, read-only.
        A complete store (its manifest written) is reopened as it is."""
        rows, words = _doc_layout(hp)
        root = root or os.path.join(hp.data_dir(), "records")
        d = os.path.join(root, f"{split}_{rows}x{words}_p{hp.user_pad_id}")
        if os.path.exists(os.path.join(d, "manifest.json")):
            return _open_store(d)
        sp = self.splits[split]
        n = len(sp)
        inputs = self._examples(split)
        ids = {"user": inputs[0], "item": inputs[1],
               "rating": sp.rating.astype(np.float32)}
        tails = self._doc_tails(hp)
        spec = {k: (v.shape, v.dtype) for k, v in ids.items()}
        spec.update({k: ((n,) + t, np.int32) for k, t in tails.items()})
        mm = _create_store(d, spec, ids)
        self._fill_chunks(hp, mm, tails, n, inputs)
        return _seal_store(d, mm)

    def _disk_grid_store(self, hp, tag: str, ids: Dict[str, np.ndarray],
                         *grid) -> Dict[str, np.ndarray]:
        """Out-of-core candidate-grid store under `data_dir()/records`:
        the `_grid_text_records` layout, each side assembled chunk by
        chunk."""
        d = os.path.join(hp.data_dir(), "records", tag)
        if os.path.exists(os.path.join(d, "manifest.json")):
            return _open_store(d)
        tails = self._doc_tails(hp)
        sides = self._grid_sides(*grid)
        spec = {k: (v.shape, v.dtype) for k, v in ids.items()}
        spec.update({k: (lead + tails[k], np.int32)
                     for keys, lead, _ in sides for k in keys})
        mm = _create_store(d, spec, ids)
        for keys, lead, inputs in sides:
            # C-order memmaps reshape to flat rows without a copy
            flat = {k: mm[k].reshape((-1,) + tails[k]) for k in keys}
            self._fill_chunks(hp, flat, keys, int(np.prod(lead)), inputs)
        return _seal_store(d, mm)

    # In candidate grids the user side is identical across the C
    # candidates, so it is materialized once per row at lead [.., 1]
    # and broadcast inside the models.
    _USER_SIDE = ("user_doc", "items_reviewed")
    _ITEM_SIDE = ("item_doc", "this_doc", "users_who_gave")

    def _grid_sides(self, user_rows, item_flat, ui_flat, iu_flat,
                    this_flat, m, c):
        """(record keys, lead shape, example inputs) of each side of an
        [m, c] candidate grid: the user side once per row, the item side
        per candidate."""
        neg1_m = np.full(m, -1, np.int32)
        return ((self._USER_SIDE, (m, 1),
                 (user_rows, np.zeros(m, np.int32), ui_flat[::c].copy(),
                  neg1_m, neg1_m)),
                (self._ITEM_SIDE, (m, c),
                 (np.zeros(m * c, np.int32), item_flat,
                  np.full(m * c, -1, np.int32), iu_flat, this_flat)))

    def _grid_text_records(self, hp, *grid):
        """Doc/neighbor tensors for an [m, c] candidate grid
        (`_grid_sides`): user side [m, 1, ...], item side [m, c, ...]."""
        out = {}
        for keys, lead, inputs in self._grid_sides(*grid):
            recs = self._text_records(hp, *inputs)
            for k in keys:
                out[k] = recs[k].reshape(lead + recs[k].shape[1:])
        return out

    def materialize_negs(self, hp,
                         include_text: Optional[bool] = None
                         ) -> Dict[str, np.ndarray]:
        """Candidate-grid records for ranking eval: [M, C] ids (positive
        in column 0), plus doc tensors for review models: item side
        [M, C, ...], user side [M, 1, ...]. No leakage removal;
        `this_doc` stays zero. With `hp.out_of_core` the doc grids are
        built chunk by chunk into the memory-mapped record store."""
        with_text = (hp.family == "review" if include_text is None
                     else include_text)
        m, c = self.neg_cands.shape
        user = np.repeat(self.neg_users, c).reshape(m, c).astype(np.int32)
        item = self.neg_cands.astype(np.int32)
        rating = np.zeros((m, c), np.float32)
        neg1 = np.full(m * c, -1, np.int32)
        if with_text and hp.out_of_core:
            rows, words = _doc_layout(hp)
            return self._disk_grid_store(
                hp, f"negs2_{rows}x{words}_p{hp.user_pad_id}_c{c}",
                {"user": user, "item": item, "rating": rating},
                self.neg_users.astype(np.int32), item.reshape(-1),
                neg1, neg1, neg1, m, c)
        key = ("negs", _doc_layout(hp) if with_text else "id",
               hp.user_pad_id if with_text else 0)
        if key in self._cache:
            return self._cache[key]
        recs = {"user": user, "item": item, "rating": rating}
        if with_text:
            recs.update(self._grid_text_records(
                hp, self.neg_users.astype(np.int32), item.reshape(-1),
                neg1, neg1, neg1, m, c))
        self._cache[key] = recs
        return recs

    def candidate_grid_records(self, hp, users: np.ndarray,
                               items: np.ndarray,
                               include_text: Optional[bool] = None
                               ) -> Dict[str, np.ndarray]:
        """[U, C] scoring-grid records for `users` x candidate `items`,
        in the layout the rank evaluator reads, with no leakage
        removal."""
        users = np.asarray(users, np.int32)
        items = np.asarray(items, np.int32)
        u, c = len(users), len(items)
        user = np.repeat(users, c).reshape(u, c)
        item = np.broadcast_to(items[None], (u, c)).copy()
        recs = {"user": user, "item": item,
                "rating": np.zeros((u, c), np.float32),
                "weight": np.ones(u, np.float32)}
        with_text = (hp.family == "review" if include_text is None
                     else include_text)
        if with_text:
            neg1 = np.full(u * c, -1, np.int32)
            recs.update(self._grid_text_records(
                hp, users, item.reshape(-1), neg1, neg1, neg1, u, c))
        return recs

    def train_pair_mask(self, users: np.ndarray, items: np.ndarray
                        ) -> np.ndarray:
        """Boolean mask (broadcast shape of users x items) marking the
        (u, i) pairs of the TRAIN split."""
        if self._train_pair_keys is None:
            tr = self.splits["train"]
            keys = (tr.user.astype(np.int64) * self.num_items
                    + tr.item.astype(np.int64))
            self._train_pair_keys = np.unique(keys)
        keys = self._train_pair_keys
        q = (np.asarray(users).astype(np.int64) * self.num_items
             + np.asarray(items).astype(np.int64))
        if len(keys) == 0:
            return np.zeros(q.shape, bool)
        pos = np.minimum(np.searchsorted(keys, q), len(keys) - 1)
        return keys[pos] == q

    def materialize_wide_negs(self, hp, num_negs: int, seed: int = 0,
                              include_text: Optional[bool] = None
                              ) -> Dict[str, np.ndarray]:
        """Wide eval candidate grids: per stored neg-set row, column 0
        keeps that row's positive and columns 1..num_negs are items
        sampled uniformly outside the user's train/val/test
        interactions (the 1+99 protocol). Same [M, C] layout as
        `materialize_negs`; `hp.out_of_core` streams the doc grids."""
        with_text = (hp.family == "review" if include_text is None
                     else include_text)
        m = int(self.neg_users.shape[0])
        c = num_negs + 1
        rng = np.random.default_rng(seed)
        all_keys = np.unique(np.concatenate(
            [s.user.astype(np.int64) * self.num_items + s.item
             for s in self.splits.values()]))

        def interacted(users_2d, items_2d):
            q = (users_2d.astype(np.int64) * self.num_items
                 + items_2d.astype(np.int64))
            if len(all_keys) == 0:
                return np.zeros(q.shape, bool)
            pos = np.minimum(np.searchsorted(all_keys, q),
                             len(all_keys) - 1)
            return all_keys[pos] == q

        cands = np.empty((m, c), np.int32)
        cands[:, 0] = self.neg_cands[:, 0]
        draw = rng.integers(0, self.num_items, size=(m, num_negs),
                            dtype=np.int64)
        u_col = self.neg_users.astype(np.int64)[:, None]
        for _ in range(10):  # bounded vectorized rejection
            bad = interacted(np.broadcast_to(u_col, draw.shape), draw)
            if not bad.any():
                break
            draw[bad] = rng.integers(0, self.num_items,
                                     size=int(bad.sum()))
        cands[:, 1:] = draw.astype(np.int32)

        user = np.repeat(self.neg_users, c).reshape(m, c).astype(np.int32)
        rating = np.zeros((m, c), np.float32)
        neg1 = np.full(m * c, -1, np.int32)
        if with_text and hp.out_of_core:
            rows, words = _doc_layout(hp)
            return self._disk_grid_store(
                hp, f"widenegs_{rows}x{words}_p{hp.user_pad_id}"
                    f"_c{c}_s{seed}",
                {"user": user, "item": cands, "rating": rating},
                self.neg_users.astype(np.int32), cands.reshape(-1),
                neg1, neg1, neg1, m, c)
        key = ("wide_negs", _doc_layout(hp) if with_text else "id",
               hp.user_pad_id if with_text else 0, num_negs, seed)
        if key in self._cache:
            return self._cache[key]
        recs = {"user": user, "item": cands, "rating": rating}
        if with_text:
            recs.update(self._grid_text_records(
                hp, self.neg_users.astype(np.int32), cands.reshape(-1),
                neg1, neg1, neg1, m, c))
        self._cache[key] = recs
        return recs

    def materialize_train_negs(self, hp, split: str = "train",
                               seed: int = 0) -> Dict[str, np.ndarray]:
        """Sampled candidate grids for ranking-loss training (hp.loss in
        CE / BPR / HINGE): per (u, i) example of `split`, candidates =
        [i, hp.num_negs items drawn uniformly outside u's train items]
        (a draw that lands in them is redrawn, 10 rounds at most), in the
        [N, C] layout of `materialize_negs`. For review models the pair's
        own review is removed from the user doc of every column and from
        the positive item's doc (column 0). Bitwise the JAX package's
        arrays for the same seed (cached; with `hp.out_of_core` the doc
        grids go to the memory-mapped record store instead)."""
        out_of_core = hp.family == "review" and hp.out_of_core
        key = ("train_negs", split,
               _doc_layout(hp) if hp.family == "review" else "id",
               hp.num_negs, seed)
        if not out_of_core and key in self._cache:
            return self._cache[key]
        sp = self.splits[split]
        tr = self.splits["train"]
        rng = np.random.default_rng(seed)
        n, k = len(sp), hp.num_negs
        tr_keys = np.unique(tr.user.astype(np.int64) * self.num_items
                            + tr.item.astype(np.int64))

        def in_train(users_2d, items_2d):
            q = (users_2d.astype(np.int64) * self.num_items
                 + items_2d.astype(np.int64))
            if len(tr_keys) == 0:
                return np.zeros(q.shape, bool)
            pos = np.minimum(np.searchsorted(tr_keys, q), len(tr_keys) - 1)
            return tr_keys[pos] == q

        cands = np.empty((n, k + 1), np.int32)
        cands[:, 0] = sp.item
        draw = rng.integers(0, self.num_items, size=(n, k), dtype=np.int64)
        u_col = sp.user.astype(np.int64)[:, None]
        for _ in range(10):   # a user who rated the whole catalog keeps
            # the collision
            bad = in_train(np.broadcast_to(u_col, draw.shape), draw)
            if not bad.any():
                break
            draw[bad] = rng.integers(0, self.num_items, size=int(bad.sum()))
        cands[:, 1:] = draw.astype(np.int32)

        user = np.repeat(sp.user, k + 1).reshape(n, k + 1).astype(np.int32)
        rating = np.zeros((n, k + 1), np.float32)
        rating[:, 0] = sp.rating
        recs = {"user": user, "item": cands, "rating": rating}
        if hp.family == "review":
            # the removal indices of the pair (train split only; eval
            # splits remove nothing)
            _, _, ui0, iu0, _ = self._examples(split)
            ui = np.repeat(ui0, k + 1).reshape(n, k + 1)
            iu = np.full((n, k + 1), -1, np.int32)
            iu[:, 0] = iu0
            neg1 = np.full(n * (k + 1), -1, np.int32)
            if out_of_core:
                rows, words = _doc_layout(hp)
                return self._disk_grid_store(
                    hp, f"trainnegs2_{split}_{rows}x{words}"
                        f"_p{hp.user_pad_id}_c{k + 1}_s{seed}",
                    recs, sp.user.astype(np.int32), cands.reshape(-1),
                    ui.reshape(-1), iu.reshape(-1), neg1, n, k + 1)
            recs.update(self._grid_text_records(
                hp, sp.user.astype(np.int32), cands.reshape(-1),
                ui.reshape(-1), iu.reshape(-1), neg1, n, k + 1))
        self._cache[key] = recs
        return recs

    # ------------------------------------------------------------------
    # Entity-level doc store (hp.cache_entity): ONE canonical concatenated
    # doc per user / per item, plus each train review's (start, len) span
    # inside its owner's doc, so train-time leakage removal becomes an
    # in-place MASK of the pair's own review (the TextCNN `skip`). Memory
    # scales with entities, not examples. The mask differs from the
    # per-example records, which REMOVE the shared review and pull later
    # words into the truncation window; eval splits remove nothing, so
    # their docs are the per-example ones.
    # ------------------------------------------------------------------
    def _entity_spans(self, words: int):
        """((user_docs, u_rev_span), (item_docs, i_rev_span)) for the
        concatenated rows==1 layout: canonical [U|I, words] docs and,
        aligned with u_off/i_off review ordering, each train review's
        (start, len) span inside its owner's doc (len 0 = truncated
        out). Cached per `words`."""
        key = ("entity_docs", words)
        if key in self._cache:
            return self._cache[key]
        flat = self._flat()
        tokens, rev_off = flat["tokens"], flat["rev_off"]
        u_off, i_off = flat["u_off"], flat["i_off"]
        i_revs = flat["i_revs"]
        n_train = int(flat["u_revs"].shape[0])

        def side(rids: np.ndarray, seg_off: np.ndarray, n_ent: int):
            lens = (rev_off[rids + 1] - rev_off[rids]).astype(np.int64)
            csum = np.concatenate([[0], np.cumsum(lens)])
            counts = np.diff(seg_off).astype(np.int64)
            # exclusive prefix length within the owner's segment
            excl = csum[:-1] - np.repeat(csum[seg_off[:-1]], counts)
            start = np.minimum(excl, words)
            ln = np.maximum(np.minimum(lens, words - start), 0)
            span = np.stack([start, ln], axis=1).astype(np.int32)
            docs = np.zeros((n_ent, words), np.int32)
            owner = np.repeat(np.arange(n_ent), counts)
            for j in range(len(rids)):
                m = int(ln[j])
                if m > 0:
                    s = int(start[j])
                    r = int(rids[j])
                    docs[owner[j], s:s + m] = \
                        tokens[rev_off[r]:rev_off[r] + m]
            return docs, span

        # user side: reviews are user-major 0..n_train in u_off order;
        # item side: i_revs indexes the same token store in i_off order
        out = (side(np.arange(n_train), u_off, self.num_users),
               side(i_revs, i_off, self.num_items))
        self._cache[key] = out
        return out

    def _entity_rows_docs(self, rows: int, words: int, slots: int,
                          user_pad: int, item_pad: int):
        """The per-review (rows > 1, NARRE) entity store: canonical
        [U|I, rows, words] docs, review j in row j, and the canonical
        neighbor-id lists [U, slots] items_reviewed and [I, slots]
        users_who_gave in the same slot order as the doc rows, which
        NARRE's attention relies on. Returns (user_docs, item_docs,
        who_gave, reviewed), cached. Leakage removal in this layout
        masks the pair's own review ROW where the per-example records
        remove it and move later reviews up a slot."""
        key = ("entity_rows", rows, words, slots, user_pad, item_pad)
        if key in self._cache:
            return self._cache[key]
        flat = self._flat()
        tokens, rev_off = flat["tokens"], flat["rev_off"]

        def slot_of(seg_off: np.ndarray, n: int):
            counts = np.diff(seg_off).astype(np.int64)
            owner = np.repeat(np.arange(len(counts)), counts)
            return owner, np.arange(n) - np.repeat(seg_off[:-1], counts)

        def side(rids: np.ndarray, seg_off: np.ndarray, n_ent: int):
            docs = np.zeros((n_ent, rows, words), np.int32)
            owner, pos = slot_of(seg_off, len(rids))
            for j in range(len(rids)):
                p = int(pos[j])
                if p < rows:
                    r = int(rids[j])
                    m = min(int(rev_off[r + 1] - rev_off[r]), words)
                    docs[owner[j], p, :m] = tokens[rev_off[r]:rev_off[r] + m]
            return docs

        def neighbors(other: np.ndarray, seg_off: np.ndarray, n_ent: int,
                      pad: int):
            out = np.full((n_ent, slots), pad, np.int32)
            owner, pos = slot_of(seg_off, len(other))
            keep = pos < slots
            out[owner[keep], pos[keep]] = other[keep]
            return out

        n_train = int(flat["u_revs"].shape[0])
        out = (side(np.arange(n_train), flat["u_off"], self.num_users),
               side(flat["i_revs"], flat["i_off"], self.num_items),
               neighbors(flat["i_other"], flat["i_off"], self.num_items,
                         user_pad),
               neighbors(flat["u_other"], flat["u_off"], self.num_users,
                         item_pad))
        self._cache[key] = out
        return out

    def materialize_entity(self, hp, split: str) -> Dict[str, np.ndarray]:
        """Per-example records for the entity doc cache: user, item,
        rating; transnet's `this_doc` [N, words] int32 (the pair's own
        review, per example by nature); and, on the train split only,
        'user_skip' / 'item_skip': [N, 2] int32 (start, len) word spans
        into the concatenated docs of `_entity_spans` (rows == 1), or [N]
        int32 review rows of `_entity_rows_docs` (rows > 1, -1 = none).
        No other doc tensors: those live once per entity."""
        rows, words = _doc_layout(hp)
        sp = self.splits[split]
        recs = {"user": sp.user.astype(np.int32),
                "item": sp.item.astype(np.int32),
                "rating": sp.rating.astype(np.float32)}
        if hp.model_type in ("transnet", "transnet++"):
            # stays int ids in the example cache, embedded in the step
            flat = self._flat()
            _, _, _, _, this_rev = self._examples(split)
            tokens, rev_off = flat["tokens"], flat["rev_off"]
            tdoc = np.zeros((len(sp), words), np.int32)
            for x in range(len(sp)):
                r = int(this_rev[x])
                if r >= 0:
                    m = min(int(rev_off[r + 1] - rev_off[r]), words)
                    tdoc[x, :m] = tokens[rev_off[r]:rev_off[r] + m]
            recs["this_doc"] = tdoc
        if split != "train":
            return recs
        flat = self._flat()
        user, item, ui_idx, iu_idx, _ = self._examples(split)
        if rows > 1:
            # reviews past `rows` never entered the tables: nothing to mask
            recs["user_skip"] = np.where(ui_idx < rows, ui_idx,
                                         -1).astype(np.int32)
            recs["item_skip"] = np.where(iu_idx < rows, iu_idx,
                                         -1).astype(np.int32)
            return recs
        (_, u_span), (_, i_span) = self._entity_spans(words)
        zero = np.zeros(2, np.int32)

        def spans(idx, off, ent, span):
            pos = off[ent] + np.maximum(idx, 0)
            s = span[np.minimum(pos, len(span) - 1)] \
                if len(span) else np.zeros((len(ent), 2), np.int32)
            return np.where(idx[:, None] >= 0, s, zero[None])

        recs["user_skip"] = spans(ui_idx, flat["u_off"], user,
                                  u_span).astype(np.int32)
        recs["item_skip"] = spans(iu_idx, flat["i_off"], item,
                                  i_span).astype(np.int32)
        return recs

    # ------------------------------------------------------------------
    # Persistence: one compressed `<path>/corpus.npz`, the archive both
    # packages save and load.
    # ------------------------------------------------------------------
    def save(self, path: str) -> None:
        arrays: Dict[str, np.ndarray] = {
            "meta": np.asarray([self.num_users, self.num_items,
                                self.num_words], np.int64),
            "neg_users": self.neg_users, "neg_cands": self.neg_cands,
            "word_vectors": self.word_vectors,
        }
        for s in ("train", "test", "val"):
            sp = self.splits[s]
            arrays[f"{s}_user"] = sp.user
            arrays[f"{s}_item"] = sp.item
            arrays[f"{s}_rating"] = sp.rating

        # ragged user reviews, user-major
        flat_revs = [r for revs in self.user_reviews for r in revs]
        arrays["ur_tokens"] = (np.concatenate(flat_revs)
                               if flat_revs else np.zeros(0, np.int32))
        arrays["ur_lens"] = np.asarray([len(r) for r in flat_revs], np.int64)
        arrays["ur_counts"] = np.asarray(
            [len(revs) for revs in self.user_reviews], np.int64)
        arrays["u_to_i"] = np.asarray(
            [i for lst in self.u_to_i for i in lst], np.int32)
        arrays["i_to_u"] = np.asarray(
            [u for lst in self.i_to_u for u in lst], np.int32)
        arrays["i_counts"] = np.asarray(
            [len(lst) for lst in self.i_to_u], np.int64)

        ti = sorted(self.this_index.items())
        arrays["ti"] = np.asarray(
            [[u, i, a, b] for (u, i), (a, b) in ti], np.int64).reshape(-1, 4)

        tv = sorted(self.test_reviews.items())
        arrays["tv_keys"] = np.asarray([[u, i] for (u, i), _ in tv],
                                       np.int64).reshape(-1, 2)
        tv_toks = [t for _, t in tv]
        arrays["tv_tokens"] = (np.concatenate(tv_toks)
                               if tv_toks else np.zeros(0, np.int32))
        arrays["tv_lens"] = np.asarray([len(t) for t in tv_toks], np.int64)

        if self.vocab is not None:
            items = sorted(self.vocab.items(), key=lambda kv: kv[1])
            arrays["vocab_words"] = np.asarray(
                [w for w, j in items if j > 0], dtype=str)
            arrays["vocab_ids"] = np.asarray(
                [j for _, j in items if j > 0], np.int64)

        save_npz(os.path.join(path, "corpus.npz"), **arrays)

    @classmethod
    def load(cls, path: str) -> "ReviewDataset":
        """Read `<path>/corpus.npz`, the archive either package saves."""
        a = load_npz(os.path.join(path, "corpus.npz"))
        num_users, num_items, num_words = (int(x) for x in a["meta"])
        splits = {
            s: Split(a[f"{s}_user"].astype(np.int32),
                     a[f"{s}_item"].astype(np.int32),
                     a[f"{s}_rating"].astype(np.float32))
            for s in ("train", "test", "val")}

        offs = np.zeros(len(a["ur_lens"]) + 1, np.int64)
        np.cumsum(a["ur_lens"], out=offs[1:])
        flat_revs = [a["ur_tokens"][offs[j]:offs[j + 1]].astype(np.int32)
                     for j in range(len(a["ur_lens"]))]
        user_reviews: List[List[np.ndarray]] = []
        u_to_i: List[List[int]] = []
        at = 0
        flat_u2i = a["u_to_i"]
        for u in range(num_users):
            cnt = int(a["ur_counts"][u])
            user_reviews.append(flat_revs[at:at + cnt])
            u_to_i.append(list(map(int, flat_u2i[at:at + cnt])))
            at += cnt

        i_to_u: List[List[int]] = []
        at = 0
        for i in range(num_items):
            cnt = int(a["i_counts"][i])
            i_to_u.append(list(map(int, a["i_to_u"][at:at + cnt])))
            at += cnt

        this_index = {(int(r[0]), int(r[1])): (int(r[2]), int(r[3]))
                      for r in a["ti"]}
        item_reviews: List[List[np.ndarray]] = [
            [np.zeros(0, np.int32)] * len(i_to_u[i])
            for i in range(num_items)]
        for (u, i), (ui, iu) in this_index.items():
            item_reviews[i][iu] = user_reviews[u][ui]

        toffs = np.zeros(len(a["tv_lens"]) + 1, np.int64)
        np.cumsum(a["tv_lens"], out=toffs[1:])
        test_reviews = {
            (int(k[0]), int(k[1])):
                a["tv_tokens"][toffs[j]:toffs[j + 1]].astype(np.int32)
            for j, k in enumerate(a["tv_keys"])}

        vocab = None
        if "vocab_words" in a:
            vocab = {str(w): int(j) for w, j in
                     zip(a["vocab_words"], a["vocab_ids"])}

        return cls.build(
            num_users=num_users, num_items=num_items, num_words=num_words,
            splits=splits, user_reviews=user_reviews,
            item_reviews=item_reviews, u_to_i=u_to_i, i_to_u=i_to_u,
            this_index=this_index, test_reviews=test_reviews,
            neg_users=a["neg_users"], neg_cands=a["neg_cands"],
            word_vectors=a["word_vectors"], vocab=vocab)

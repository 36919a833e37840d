"""Serving: predictions for a split and top-k retrieval per user.

Counterpart of `reviews4rec_tpu/serve.py` for every SGD model (the id
models bias_only, MF_dot, MF, GMF, MLP and NeuMF; deepconn, deepconn++,
NARRE, transnet, transnet++, MPCN; transnet serves and ranks by its
source net):

- `predict()` / `save_predictions()`: per-example predictions of a
  rating split, and the reference's `<tag>_{split}_results` files. With
  `hp.cache_doc_embeds` and `hp.cache_entity` a split scores from the
  entity doc tables on the device: no host doc records.
- `Recommender`: scores `users` x catalog grids through the model, one
  item chunk at a time, with a running top-k merge on the device; with
  `entity=True` the grids are id-only and their docs are gathered on the
  device from the entity tables (MPCN's: int ids, embedded by its
  trained table). MPCN, whose co-attention is pairwise, serves top-k
  here only. `recommend` is its one-shot form.
- `FactorizedRecommender`: runs the item tower once over the catalog at
  construction; a query encodes only its users and scores the catalog
  with the head split per side, exactly (the JAX package's seven
  models: bias_only, MF_dot, deepconn, deepconn++, NARRE, transnet,
  transnet++).

Every entry point takes the model to serve or, without one, restores
the best-validation params of the checkpoint `api.run` saved
(`restore_model`).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .config import HyperParams
from .data.batcher import Batcher
from .data.corpus import ReviewDataset
from .models import build_model
from .train import checkpoint as ckpt
from .train.evaluate import (assemble_entity_grid, grid_this_doc_words,
                             source_pred)
from .train.loop import (EntityCache, build_entity_tables, entity_serving,
                         gather_cached_batch)
from .utils.device import DeviceLike, module_device, to_device


def _check_servable(hp: HyperParams, what: str) -> None:
    if hp.family == "topic":
        raise ValueError(f"{what} for HFT: models/hft.py writes its "
                         f"per-split predictions itself")
    if hp.family == "neighbor":
        raise ValueError(f"{what} for {hp.model_type}: "
                         f"models/neighbors.py::fit_predict returns "
                         f"per-split predictions directly")


def restore_model(hp: HyperParams, dataset: ReviewDataset,
                  checkpoint_path: Optional[str] = None,
                  device: DeviceLike = None) -> torch.nn.Module:
    """The model of `hp` on `device` (None = the GPU), in `eval()`, with
    the best-validation params of the checkpoint `api.run` saved
    (`train.checkpoint.checkpoint_path(hp)` unless a path is given)."""
    _check_servable(hp, "restore_model")
    hp = dataset.apply_to(hp)
    path = checkpoint_path or ckpt.checkpoint_path(hp)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no checkpoint at {path}; train first (api.run with "
            f"hp.save_model=True, the default)")
    # normal tensors even when called from an inference-mode entry point
    with torch.inference_mode(False):
        model = build_model(hp, dataset.word_vectors, device=device)
        payload = ckpt.load_checkpoint(
            path, map_location=module_device(model, device))
        model.load_state_dict(payload["best_params"] or payload["params"])
    return model.eval()


@torch.inference_mode()
def predict(hp: HyperParams, dataset: ReviewDataset, split: str = "test",
            model: Optional[torch.nn.Module] = None,
            device: DeviceLike = None) -> np.ndarray:
    """Predicted ratings for every example of `split`, in split order;
    `model` defaults to the restored checkpoint.

    With the entity cache on, val / test predictions equal the host
    path's (eval removes nothing); train predictions mask the pair's own
    review in place where the host path removes it, as entity training
    does."""
    _check_servable(hp, "predict")
    if model is None:
        model = restore_model(hp, dataset, device=device)
    dev = module_device(model, device)
    hp = dataset.apply_to(hp)
    model.eval()
    outs, weights = [], []
    if entity_serving(hp):
        recs = dataset.materialize_entity(hp, split)
        cache = EntityCache(to_device(recs, dev),
                            build_entity_tables(hp, dataset, dev))
        for batch in Batcher({"row": np.arange(len(recs["rating"]))},
                             hp.batch_size):
            placed = to_device(batch, dev)
            outs.append(source_pred(model(gather_cached_batch(
                cache, placed["row"], placed["weight"]))))
            weights.append(batch["weight"].astype(bool))
    else:
        for batch in Batcher(dataset.materialize(hp, split), hp.batch_size):
            outs.append(source_pred(model(to_device(batch, dev))))
            weights.append(batch["weight"].astype(bool))
    if not outs:
        return np.zeros(0, np.float32)
    host = torch.stack(outs).cpu().numpy()
    return np.concatenate([p[w] for p, w in zip(host, weights)])


def save_predictions(hp: HyperParams, dataset: ReviewDataset,
                     model: Optional[torch.nn.Module] = None,
                     splits: Tuple[str, ...] = ("train", "test", "val"),
                     out_dir: Optional[str] = None,
                     device: DeviceLike = None) -> Dict[str, str]:
    """Write `<tag>_{split}_results`, one `prediction rating` line per
    example in split order. Returns {split: path}."""
    hp = dataset.apply_to(hp)
    if model is None:
        model = restore_model(hp, dataset, device=device)
    d = out_dir or hp.log_dir
    os.makedirs(d, exist_ok=True)
    paths = {}
    for split in splits:
        preds = predict(hp, dataset, split, model=model, device=device)
        ratings = dataset.splits[split].rating
        path = os.path.join(d, f"{hp.run_tag()}_{split}_results")
        with open(path, "w") as f:
            for p, r in zip(preds, ratings):
                f.write(f"{float(p):.6f} {float(r):.6f}\n")
        paths[split] = path
    return paths


def _merge_topk(top_s: torch.Tensor, top_i: torch.Tensor,
                scores: torch.Tensor, ids: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold one chunk's [U, C] scores into the running [U, k] top-k.
    Equal scores keep their order (`lax.top_k`'s): the running entries
    first, so a slot no unmasked item fills keeps its -1."""
    cat_s = torch.cat([top_s, scores], dim=1)
    cat_i = torch.cat([top_i, ids[None].expand(scores.shape)], dim=1)
    vals, pos = torch.sort(cat_s, dim=1, descending=True, stable=True)
    return vals[:, :k], torch.gather(cat_i, 1, pos[:, :k])


def _empty_topk(n: int, k: int, dev: torch.device):
    return (torch.full((n, k), -torch.inf, device=dev),
            torch.full((n, k), -1, dtype=torch.int32, device=dev))


class Recommender:
    """Top-k retrieval through the model's joint forward over
    [users, item_chunk] candidate grids (the rank evaluator's layout:
    the user tower runs once per grid row).

    `entity=True` (review models): the grids are id-only and their docs
    are gathered on the device from the entity doc tables, built once
    here, so a query builds no host doc records. Scores are the same
    (serving removes nothing)."""

    def __init__(self, hp: HyperParams, dataset: ReviewDataset,
                 model: Optional[torch.nn.Module] = None,
                 item_chunk: int = 512, device: DeviceLike = None,
                 entity: bool = False):
        _check_servable(hp, "Recommender")
        if entity and hp.family != "review":
            raise ValueError(
                "entity=True gathers review docs from entity "
                f"tables; {hp.model_type!r} has none")
        if model is None:
            model = restore_model(hp, dataset, device=device)
        self.hp = dataset.apply_to(hp)
        self.dataset = dataset
        self.model = model.eval()
        self.device = module_device(model, device)
        self.item_chunk = int(item_chunk)
        self._entity_tables = (build_entity_tables(self.hp, dataset,
                                                   self.device)
                               if entity else None)

    @torch.inference_mode()
    def topk(self, users: np.ndarray, k: int = 10,
             items: Optional[np.ndarray] = None,
             exclude_seen: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        """(item ids [U, k], scores [U, k]), highest first, per user."""
        hp, dataset, dev = self.hp, self.dataset, self.device
        users = np.asarray(users, np.int32)
        if items is None:
            items = np.arange(dataset.num_items, dtype=np.int32)
        items = np.asarray(items, np.int32)
        k = min(k, len(items))
        top_s, top_i = _empty_topk(len(users), k, dev)
        tables = self._entity_tables
        for start in range(0, len(items), self.item_chunk):
            chunk = items[start:start + self.item_chunk]
            batch = to_device(dataset.candidate_grid_records(
                hp, users, chunk,
                include_text=False if tables is not None else None), dev)
            if tables is not None:
                batch = assemble_entity_grid(batch, tables,
                                             grid_this_doc_words(hp))
            scores = source_pred(self.model(batch))
            if exclude_seen:
                mask = dataset.train_pair_mask(users[:, None], chunk[None])
                scores = scores.masked_fill(
                    torch.from_numpy(mask).to(dev), -torch.inf)
            top_s, top_i = _merge_topk(top_s, top_i, scores,
                                       torch.from_numpy(chunk).to(dev), k)
        return top_i.cpu().numpy(), top_s.cpu().numpy()


def recommend(hp: HyperParams, dataset: ReviewDataset,
              users: np.ndarray, k: int = 10,
              items: Optional[np.ndarray] = None,
              exclude_seen: bool = True, item_chunk: int = 512,
              model: Optional[torch.nn.Module] = None,
              device: DeviceLike = None) -> Tuple[np.ndarray, np.ndarray]:
    """One-shot `Recommender(...).topk(...)`: (item ids [U, k], scores
    [U, k]). Hold a `Recommender` to serve many queries from one
    restored model."""
    rec = Recommender(hp, dataset, model=model, item_chunk=item_chunk,
                      device=device)
    return rec.topk(users, k=k, items=items, exclude_seen=exclude_seen)


class FactorizedRecommender:
    """Two-tower serving index for the models whose score splits exactly
    into per-user and per-item terms:

    - bias_only / MF_dot: us(u) + is(i) (+ u.i).
    - deepconn (FM head): the FM over cat(u, i) is
      0.5*sum[(au+bi)^2 - cu - di] + w.cat + b = su + si + au.bi with
      au = u V_u, bi = i V_i and su, si the per-side halves, so a query
      is one [U, C] matmul.
    - deepconn++ (MLP head plus id biases): the head's first layer
      splits as cat(u, i) @ W0 = u @ W0[:L] + i @ W0[L:], so the index
      keeps the item half and a query runs relu(add) @ w1 per pair.
    - NARRE: each side's per-review towers and its attention over its
      own reviews, with its own neighbor ids as context, are per entity,
      so u = u_att + ue[u] and i = i_att + ie[i] are encoded once; per
      pair only relu((u*i) @ W0 + b0) @ w1 + b1 and the biases run.
    - transnet / transnet++ (ranked by the source net): the transform's
      first layer splits like deepconn++'s head, so each side keeps its
      half of `project_fc0` (and, in '++', its id embedding); per pair
      relu(uh + ih + b0) @ W1 + b1 and the source FM run.

    The item tower runs once over the catalog at construction
    (`item_chunk` items at a time; NARRE's towers then encode
    `item_chunk` x `narre_num_reviews` docs a launch); `topk` encodes
    only the query users. Scores equal the joint forward's up to float
    reassociation. Every other gradient model raises the JAX package's
    `ValueError` (MPCN's co-attention is intrinsically pairwise)."""

    SUPPORTED = ("bias_only", "MF_dot", "deepconn", "deepconn++", "NARRE",
                 "transnet", "transnet++")

    def __init__(self, hp: HyperParams, dataset: ReviewDataset,
                 model: Optional[torch.nn.Module] = None,
                 item_chunk: int = 1024, items: Optional[np.ndarray] = None,
                 device: DeviceLike = None):
        _check_servable(hp, "FactorizedRecommender")
        if hp.model_type not in self.SUPPORTED:
            raise ValueError(
                f"{hp.model_type!r} has no exact two-tower factorization "
                f"(supported: {self.SUPPORTED}); use Recommender")
        if model is None:
            model = restore_model(hp, dataset, device=device)
        self.hp = hp = dataset.apply_to(hp)
        self.dataset = dataset
        self.model = model.eval()
        self.device = module_device(model, device)
        if items is None:
            items = np.arange(dataset.num_items, dtype=np.int32)
        self.items = np.asarray(items, np.int32)
        self._build(item_chunk)

    def _side(self, ids: np.ndarray, side: str) -> Dict[str, torch.Tensor]:
        """The records of `ids` on one side of a candidate grid, on the
        device: `ids` and, for review models, the docs (and NARRE's
        neighbor ids) of the [U, 1] user side or the [1, C] item side,
        their grid axes dropped."""
        zero = np.zeros(1, np.int32)
        if side == "user":
            recs = self.dataset.candidate_grid_records(self.hp, ids, zero)
            out = {k: recs[k][:, 0] for k in ("user_doc", "items_reviewed")
                   if k in recs}
        else:
            recs = self.dataset.candidate_grid_records(self.hp, zero, ids)
            out = {k: recs[k][0] for k in ("item_doc", "users_who_gave")
                   if k in recs}
        out["ids"] = ids
        return to_device(out, self.device)

    @torch.inference_mode()
    def _build(self, item_chunk: int) -> None:
        mt = self.hp.model_type
        if mt in ("bias_only", "MF_dot"):
            enc = self._mf()
        elif mt == "NARRE":
            enc = self._narre()
        elif mt.startswith("transnet"):
            enc = self._transnet()
        else:
            enc = self._deepconn()
        item_enc, user_enc, score = enc
        vecs, scals = [], []
        for s in range(0, len(self.items), item_chunk):
            iv, isc = item_enc(self._side(self.items[s:s + item_chunk],
                                          "item"))
            vecs.append(iv)
            scals.append(isc)
        self.item_vec = None if vecs[0] is None else torch.cat(vecs)
        self.item_scal = torch.cat(scals)
        self._user_enc = lambda users: user_enc(self._side(users, "user"))
        self._score_chunk = score

    @staticmethod
    def _dot_score(uv, us, iv, isc):
        """us + is (+ u.i): the score of the MF models and deepconn."""
        s = us[:, None] + isc[None, :]
        return s if uv is None else s + uv @ iv.T

    # `_mf`, `_deepconn`, `_narre` and `_transnet` return (item_enc,
    # user_enc, score): the encoders map a side's records (`_side`) to
    # (vectors [N, D] or None, scalars [N]), and `score` maps a query's
    # and a catalog chunk's to [U, C].
    def _mf(self):
        m = self.model
        gb = m.global_bias[0]
        dot = self.hp.model_type == "MF_dot"

        def item_enc(rec):
            ids = rec["ids"]
            return (m.item_embedding[ids] if dot else None,
                    m.item_bias[ids] + gb)

        def user_enc(rec):
            ids = rec["ids"]
            return (m.user_embedding[ids] if dot else None,
                    m.user_bias[ids])

        return item_enc, user_enc, self._dot_score

    def _deepconn(self):
        m, L = self.model, self.hp.latent_size
        wv = m.word_vectors
        gb = m.global_bias[0]
        if self.hp.model_type == "deepconn++":
            w0 = m.final.fc0.weight.T                  # [2L, H]
            b0 = m.final.fc0.bias
            w1 = m.final.fc1.weight[0]
            b1 = m.final.fc1.bias[0]

            def item_enc(rec):
                f = m.item_conv(rec["item_doc"], table=wv)
                return f @ w0[L:] + b0, m.item_bias[rec["ids"]] + gb

            def user_enc(rec):
                f = m.user_conv(rec["user_doc"], table=wv)
                return f @ w0[:L], m.user_bias[rec["ids"]]

            def score(uv, us, iv, isc):
                hidden = torch.relu(uv[:, None, :] + iv[None, :, :])
                return hidden @ w1 + b1 + us[:, None] + isc[None, :]

            return item_enc, user_enc, score

        v = m.fm.V                                     # [2L, k]
        w = m.fm.lin.weight[0]
        b = m.fm.lin.bias[0]

        def half(f, vs, ws):
            a = f @ vs
            s = 0.5 * torch.sum(a * a - (f * f) @ (vs * vs), dim=-1)
            return a, s + f @ ws

        def item_enc(rec):
            bi, si = half(m.item_conv(rec["item_doc"], table=wv), v[L:],
                          w[L:])
            return bi, si + b + gb

        def user_enc(rec):
            return half(m.user_conv(rec["user_doc"], table=wv), v[:L], w[:L])

        return item_enc, user_enc, self._dot_score

    def _narre(self):
        m, r = self.model, self.hp.narre_num_reviews
        wv = m.word_vectors
        gb = m.global_bias[0]
        w0 = m.final.fc0.weight.T                      # [L, L]
        b0 = m.final.fc0.bias
        w1 = m.final.fc1.weight[0]
        b1 = m.final.fc1.bias[0]

        def attended(conv, docs, ctx, scorer):
            # the per-review docs [N, R, W] folded into the batch axis
            n, rr, words = docs.shape
            f = conv(docs.reshape(n * rr, words), table=wv).reshape(n, rr, -1)
            return m._attend(f, ctx, scorer, None)

        def item_enc(rec):
            ids = rec["ids"]
            i_att = attended(m.item_conv, rec["item_doc"], m.user_embedding[
                rec["users_who_gave"][:, :r]], m.att_item)
            return i_att + m.item_embedding[ids], m.item_bias[ids] + gb

        def user_enc(rec):
            ids = rec["ids"]
            u_att = attended(m.user_conv, rec["user_doc"], m.item_embedding[
                rec["items_reviewed"][:, :r]], m.att_user)
            return u_att + m.user_embedding[ids], m.user_bias[ids]

        def score(uv, us, iv, isc):
            hidden = torch.relu((uv[:, None, :] * iv[None, :, :]) @ w0 + b0)
            return hidden @ w1 + b1 + us[:, None] + isc[None, :]

        return item_enc, user_enc, score

    def _transnet(self):
        m, L = self.model, self.hp.latent_size
        wv = m.word_vectors
        w0 = m.project_fc0.weight.T                    # [2L, L]
        b0 = m.project_fc0.bias
        w1 = m.project_fc1.weight.T                    # [L, L]
        b1 = m.project_fc1.bias

        def enc(conv, docs, w0_half, emb, ids):
            h = conv(docs, table=wv) @ w0_half
            if m.plus:
                h = torch.cat([h, emb[ids]], dim=-1)
            return h, torch.zeros(h.shape[0], device=h.device)

        def item_enc(rec):
            return enc(m.source_item_conv, rec["item_doc"], w0[L:],
                       getattr(m, "item_embedding", None), rec["ids"])

        def user_enc(rec):
            return enc(m.source_user_conv, rec["user_doc"], w0[:L],
                       getattr(m, "user_embedding", None), rec["ids"])

        def score(uv, us, iv, isc):
            hidden = torch.relu(uv[:, None, :L] + iv[None, :, :L] + b0)
            x = hidden @ w1 + b1                       # [U, C, L]
            if m.plus:
                lead = x.shape[:2]
                x = torch.cat([uv[:, None, L:].expand(lead + (-1,)),
                               iv[None, :, L:].expand(lead + (-1,)), x],
                              dim=-1)
            return m.source_fm(x) + us[:, None] + isc[None, :]

        return item_enc, user_enc, score

    @torch.inference_mode()
    def topk(self, users: np.ndarray, k: int = 10,
             exclude_seen: bool = True, score_items: int = 16384
             ) -> Tuple[np.ndarray, np.ndarray]:
        """(item ids [U, k], scores [U, k]), highest first, per user;
        the catalog is scored `score_items` at a time."""
        users = np.asarray(users, np.int32)
        dev = self.device
        k = min(k, len(self.items))
        uv, us = self._user_enc(users)
        top_s, top_i = _empty_topk(len(users), k, dev)
        for start in range(0, len(self.items), score_items):
            end = min(start + score_items, len(self.items))
            chunk_ids = self.items[start:end]
            iv = None if self.item_vec is None else self.item_vec[start:end]
            scores = self._score_chunk(uv, us, iv, self.item_scal[start:end])
            if exclude_seen:
                mask = self.dataset.train_pair_mask(users[:, None],
                                                    chunk_ids[None])
                scores = scores.masked_fill(
                    torch.from_numpy(mask).to(dev), -torch.inf)
            top_s, top_i = _merge_topk(top_s, top_i, scores,
                                       torch.from_numpy(chunk_ids).to(dev),
                                       k)
        return top_i.cpu().numpy(), top_s.cpu().numpy()

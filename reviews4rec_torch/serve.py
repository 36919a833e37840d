"""Serving: predictions for a split and top-k retrieval per user.

Counterpart of `reviews4rec_tpu/serve.py` for the models the port has
(deepconn, deepconn++):

- `predict()` / `save_predictions()`: per-example predictions of a
  rating split, and the reference's `<tag>_{split}_results` files.
- `Recommender`: scores `users` x catalog grids through the model, one
  item chunk at a time, with a running top-k merge on the device.
- `FactorizedRecommender`: runs the item tower once over the catalog at
  construction; a query encodes only its users and scores the catalog
  with the head split per side, exactly.

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
    `model` defaults to the restored checkpoint."""
    _check_servable(hp, "predict")
    if model is None:
        model = restore_model(hp, dataset, device=device)
    dev = module_device(model, device)
    hp = dataset.apply_to(hp)
    model.eval()
    outs, weights = [], []
    for batch in Batcher(dataset.materialize(hp, split), hp.batch_size):
        outs.append(model(to_device(batch, dev)))
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
    """Fold one chunk's [U, C] scores into the running [U, k] top-k."""
    cat_s = torch.cat([top_s, scores], dim=1)
    cat_i = torch.cat([top_i, ids[None].expand(scores.shape)], dim=1)
    vals, pos = torch.topk(cat_s, k, dim=1)
    return vals, torch.gather(cat_i, 1, pos)


def _empty_topk(n: int, k: int, dev: torch.device):
    return (torch.full((n, k), -torch.inf, device=dev),
            torch.full((n, k), -1, dtype=torch.int32, device=dev))


class Recommender:
    """Top-k retrieval through the model's joint forward over
    [users, item_chunk] candidate grids (the rank evaluator's layout:
    the user tower runs once per grid row)."""

    def __init__(self, hp: HyperParams, dataset: ReviewDataset,
                 model: Optional[torch.nn.Module] = None,
                 item_chunk: int = 512, device: DeviceLike = None):
        _check_servable(hp, "Recommender")
        if model is None:
            model = restore_model(hp, dataset, device=device)
        self.hp = dataset.apply_to(hp)
        self.dataset = dataset
        self.model = model.eval()
        self.device = module_device(model, device)
        self.item_chunk = int(item_chunk)

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
        for start in range(0, len(items), self.item_chunk):
            chunk = items[start:start + self.item_chunk]
            batch = to_device(
                dataset.candidate_grid_records(hp, users, chunk), dev)
            scores = self.model(batch)
            if exclude_seen:
                mask = dataset.train_pair_mask(users[:, None], chunk[None])
                scores = scores.masked_fill(
                    torch.from_numpy(mask).to(dev), -torch.inf)
            top_s, top_i = _merge_topk(top_s, top_i, scores,
                                       torch.from_numpy(chunk).to(dev), k)
        return top_i.cpu().numpy(), top_s.cpu().numpy()


class FactorizedRecommender:
    """Two-tower serving index for the models whose head splits exactly
    into per-user and per-item terms:

    - deepconn (FM head): the FM over cat(u, i) is
      0.5*sum[(au+bi)^2 - cu - di] + w.cat + b = su + si + au.bi with
      au = u V_u, bi = i V_i and su, si the per-side halves, so a query
      is one [U, C] matmul.
    - deepconn++ (MLP head plus id biases): the head's first layer
      splits as cat(u, i) @ W0 = u @ W0[:L] + i @ W0[L:], so the index
      keeps the item half and a query runs relu(add) @ w1 per pair.

    The item tower runs once over the catalog at construction
    (`item_chunk` docs at a time); `topk` encodes only the query users.
    Scores equal the joint forward's up to float reassociation."""

    SUPPORTED = ("deepconn", "deepconn++")

    def __init__(self, hp: HyperParams, dataset: ReviewDataset,
                 model: Optional[torch.nn.Module] = None,
                 item_chunk: int = 1024, items: Optional[np.ndarray] = None,
                 device: DeviceLike = None):
        _check_servable(hp, "FactorizedRecommender")
        if hp.model_type == "MPCN":
            raise ValueError("MPCN has no exact two-tower factorization; "
                             "use Recommender")
        if hp.model_type not in self.SUPPORTED:
            raise NotImplementedError(
                f"factorized serving of {hp.model_type!r} is not ported "
                f"yet (ROADMAP.md, Queue 1 item 10)")
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

    def _docs(self, users: np.ndarray, items: np.ndarray, side: str
              ) -> torch.Tensor:
        recs = self.dataset.candidate_grid_records(self.hp, users, items)
        docs = recs["user_doc"][:, 0] if side == "user" \
            else recs["item_doc"][0]
        return torch.from_numpy(docs).to(self.device)

    @torch.inference_mode()
    def _build(self, item_chunk: int) -> None:
        m, L = self.model, self.hp.latent_size
        wv = m.word_vectors
        gb = m.global_bias[0]
        if self.hp.model_type == "deepconn++":
            w0 = m.final.fc0.weight.T                  # [2L, H]
            b0 = m.final.fc0.bias
            w1 = m.final.fc1.weight[0]
            b1 = m.final.fc1.bias[0]

            def item_enc(f, ids):
                return f @ w0[L:] + b0, m.item_bias[ids] + gb

            def user_enc(f, ids):
                return f @ w0[:L], m.user_bias[ids]

            def score(uv, us, iv, isc):
                hidden = torch.relu(uv[:, None, :] + iv[None, :, :])
                return hidden @ w1 + b1 + us[:, None] + isc[None, :]
        else:
            v = m.fm.V                                 # [2L, k]
            w = m.fm.lin.weight[0]
            b = m.fm.lin.bias[0]

            def half(f, vs, ws):
                a = f @ vs
                s = 0.5 * torch.sum(a * a - (f * f) @ (vs * vs), dim=-1)
                return a, s + f @ ws

            def item_enc(f, ids):
                bi, si = half(f, v[L:], w[L:])
                return bi, si + b + gb

            def user_enc(f, ids):
                return half(f, v[:L], w[:L])

            def score(uv, us, iv, isc):
                return us[:, None] + isc[None, :] + uv @ iv.T

        vecs, scals = [], []
        zero = np.zeros(1, np.int32)
        for s in range(0, len(self.items), item_chunk):
            chunk = self.items[s:s + item_chunk]
            f = m.item_conv(self._docs(zero, chunk, "item"), table=wv)
            iv, isc = item_enc(f, torch.from_numpy(chunk).to(self.device))
            vecs.append(iv)
            scals.append(isc)
        self.item_vec = torch.cat(vecs)
        self.item_scal = torch.cat(scals)

        def encode_users(users: np.ndarray):
            f = m.user_conv(self._docs(users, zero, "user"), table=wv)
            return user_enc(f, torch.from_numpy(users).to(self.device))

        self._user_enc = encode_users
        self._score_chunk = score

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
            scores = self._score_chunk(uv, us, self.item_vec[start:end],
                                       self.item_scal[start:end])
            if exclude_seen:
                mask = self.dataset.train_pair_mask(users[:, None],
                                                    chunk_ids[None])
                scores = scores.masked_fill(
                    torch.from_numpy(mask).to(dev), -torch.inf)
            top_s, top_i = _merge_topk(top_s, top_i, scores,
                                       torch.from_numpy(chunk_ids).to(dev),
                                       k)
        return top_i.cpu().numpy(), top_s.cpu().numpy()

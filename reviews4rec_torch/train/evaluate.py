"""Evaluation: rating MSE (with cold-start count maps) and candidate-set
ranking (HR@k / NDCG@k), as `reviews4rec_tpu/train/evaluate.py` defines
them:

- MSE is computed per example, then averaged over the whole split.
- The count-vs-MSE maps bucket each example's squared error by its
  user's / item's train-set frequency.
- Ranking: per stored set, the positive sits in column 0; its rank is
  the number of candidates scoring strictly higher, so a tie goes to
  the positive. Under a ranking loss the trainer validates each epoch
  by `eval_ranking` over the val candidate grids.
- transnet's forward gives (source, target, trans_loss): the source net
  is its prediction, in eval, ranking and serving alike (`source_pred`),
  and eval also reports the target net's `MSE_right` and the transform
  loss `MSE_transform`, each a mean over batches.
- Over the device caches (`train.loop`): `evaluate_cached` gathers each
  batch on the device from [B] row ids, and `assemble_entity_grid` builds
  an id-only candidate grid's docs from the entity tables. Eval removes
  nothing, so the entity docs are the per-example eval docs and the
  metrics equal the host path's.
- On a mesh (`parallel.mesh.shard_model`) each data rank scores its rows
  of every batch and the outputs are gathered over the data axis in
  order, so every rank reduces the single-device outputs.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import HyperParams
from ..data.batcher import Batcher
from ..parallel.mesh import host_slice, model_mesh
from ..utils.device import to_device
from .profiler import annotate, count


def source_pred(preds):
    """The prediction of a forward's output: transnet's source net, the
    output itself for every other model."""
    return preds[0] if isinstance(preds, tuple) else preds


def eval_step(model: torch.nn.Module, batch: Dict[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
    """Per-example squared errors and predictions of one batch (and
    transnet's target-net errors and transform loss)."""
    preds = model(batch)
    y = batch["rating"]
    if isinstance(preds, tuple):
        source, target, trans_loss = preds
        return {"sq": (source - y) ** 2, "pred": source,
                "sq_right": (target - y) ** 2, "trans": trans_loss}
    return {"sq": (preds - y) ** 2, "pred": preds}


def _count_mse_maps(counts: np.ndarray, sq: np.ndarray
                    ) -> Dict[int, list]:
    """{train-frequency: [squared errors]}, one entry per distinct
    count."""
    out: Dict[int, list] = {}
    if counts.size == 0:
        return out
    order = np.argsort(counts, kind="stable")
    counts_s = counts[order]
    sq_s = sq[order]
    uniq, starts = np.unique(counts_s, return_index=True)
    for j, c in enumerate(uniq):
        end = starts[j + 1] if j + 1 < len(uniq) else len(sq_s)
        out[int(c)] = sq_s[starts[j]:end].tolist()
    return out


def _reduce_eval(outs, weights, users_l, items_l, user_count,
                 item_count) -> Tuple[Dict, Dict, Dict]:
    """Host-side reduction of the per-batch outputs."""
    total_sq, total_n = 0.0, 0.0
    right_sq, trans_sum, batches = 0.0, 0.0, 0.0
    all_sq = []
    for out, w in zip(outs, weights):
        sq = out["sq"][w]
        total_sq += float(sq.sum())
        total_n += float(w.sum())
        if "sq_right" in out:
            right_sq += float(out["sq_right"][w].mean())
            trans_sum += float(out["trans"])
            batches += 1.0
        all_sq.append(sq)
    sq = np.concatenate(all_sq) if all_sq else np.zeros(0)
    users = np.concatenate(users_l) if users_l else np.zeros(0, int)
    items = np.concatenate(items_l) if items_l else np.zeros(0, int)
    metrics = {"MSE": round(total_sq / max(total_n, 1.0), 4)}
    if batches:
        metrics["MSE_right"] = round(right_sq / batches, 4)
        metrics["MSE_transform"] = round(trans_sum / batches, 4)
    return (metrics, _count_mse_maps(user_count[users], sq),
            _count_mse_maps(item_count[items], sq))


@torch.inference_mode()
def evaluate(model: torch.nn.Module, batcher: Batcher, hp: HyperParams,
             user_count: np.ndarray, item_count: np.ndarray,
             device: torch.device) -> Tuple[Dict, Dict, Dict]:
    """Split MSE and per-train-frequency MSE maps. Every batch is
    launched before the outputs come back to the host in one copy."""
    model.eval()
    mesh = model_mesh(model)
    outs, weights, users_l, items_l = [], [], [], []
    for batch in batcher:
        outs.append(eval_step(model, to_device(host_slice(batch, mesh),
                                               device)))
        w = batch["weight"].astype(bool)
        weights.append(w)
        users_l.append(batch["user"][w])
        items_l.append(batch["item"][w])
    outs = _to_host(outs, mesh)
    return _reduce_eval(outs, weights, users_l, items_l, user_count,
                        item_count)


@torch.inference_mode()
def evaluate_cached(model: torch.nn.Module, cache, records: Dict[str, np.ndarray],
                    hp: HyperParams, user_count: np.ndarray,
                    item_count: np.ndarray, device: torch.device
                    ) -> Tuple[Dict, Dict, Dict]:
    """`evaluate` over a device cache (per-example or EntityCache): the
    same metrics and maps, with only [B] row ids crossing to the device
    per batch and one host fetch per split. `records` gives the host's
    user / item ids for the count maps."""
    from .loop import gather_cached_batch
    model.eval()
    mesh = model_mesh(model)
    n = len(records["rating"])
    outs, weights, users_l, items_l = [], [], [], []
    for batch in Batcher({"row": np.arange(n)}, hp.batch_size):
        placed = to_device(host_slice(batch, mesh), device)
        outs.append(eval_step(model, gather_cached_batch(
            cache, placed["row"], placed["weight"])))
        w = batch["weight"].astype(bool)
        weights.append(w)
        sel = batch["row"][w]
        users_l.append(records["user"][sel])
        items_l.append(records["item"][sel])
    outs = _to_host(outs, mesh)
    return _reduce_eval(outs, weights, users_l, items_l, user_count,
                        item_count)


def _to_host(outs: List[Dict[str, torch.Tensor]], mesh=None
             ) -> List[Dict[str, np.ndarray]]:
    """Per-batch outputs on the host. On a mesh, each data rank's rows of
    every batch gathered in order (a per-batch scalar, transnet's
    transform loss, is each rank's share of the batch's: summed)."""
    if not outs:
        return []
    keys = list(outs[0])
    stacked = {k: torch.stack([o[k] for o in outs]) for k in keys}
    if mesh is not None:
        stacked = {k: _gather_rows(v, mesh) for k, v in stacked.items()}
    stacked = {k: v.cpu().numpy() for k, v in stacked.items()}
    return [{k: stacked[k][j] for k in keys} for j in range(len(outs))]


def _gather_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """[nb, b, ...] per-batch rank rows -> [nb, B, ...] over the data
    axis, rank order; [nb] per-batch scalars are summed."""
    every = mesh.all_gather(t, mesh.data_axis)           # [n, nb, ...]
    if t.dim() == 1:
        return every.sum(0)
    return every.transpose(0, 1).reshape(
        (t.shape[0], -1) + tuple(t.shape[2:]))


def assemble_entity_grid(batch: Dict[str, torch.Tensor],
                         tables: Dict[str, torch.Tensor],
                         this_doc_words: int = 0) -> Dict[str, torch.Tensor]:
    """The docs of an id-only [B, C] candidate grid from the entity
    tables (`train.loop.build_entity_tables`): the user's rows once per
    grid row at [B, 1, ...], the models' broadcast layout, and the item
    rows per candidate; NARRE's neighbor lists alike. transnet's
    `this_doc` (`this_doc_words` > 0) is zeros, as a grid's records hold
    no held-out review. Shared by the entity ranking pass and
    `serve.Recommender(entity=True)`."""
    b = dict(batch)
    users, items = b["user"][:, 0], b["item"]
    for key, user_side in (("user_doc", True), ("item_doc", False),
                           ("items_reviewed", True),
                           ("users_who_gave", False)):
        if key not in tables:
            continue
        t = tables[key]
        if user_side:
            b[key] = t.index_select(0, users)[:, None]
        else:
            b[key] = t.index_select(0, items.reshape(-1)).reshape(
                tuple(items.shape) + tuple(t.shape[1:]))
    if this_doc_words:
        b["this_doc"] = torch.zeros(tuple(items.shape) + (this_doc_words,),
                                    dtype=torch.int32, device=items.device)
    return b


def _splits_towers(model: torch.nn.Module) -> bool:
    """Whether `model` exposes its towers and its head apart
    (`entity_towers`, `pair_head`: deepconn and deepconn++)."""
    return (callable(getattr(model, "entity_towers", None))
            and callable(getattr(model, "pair_head", None)))


@torch.inference_mode()
def score_grid(model: torch.nn.Module, records: Dict[str, np.ndarray],
               batch_size: int, device: torch.device,
               entity_tables: Optional[Dict[str, torch.Tensor]] = None,
               this_doc_words: int = 0) -> np.ndarray:
    """Scores [M, C] of a candidate grid (positive in column 0). With
    `entity_tables` the records are id-only and each batch's docs are
    gathered on the device (`assemble_entity_grid`); for a model that
    splits its towers from its head, off a mesh, the call instead
    encodes each distinct user and item once (`_score_factorized`).
    Spans, a batch: `score_grid.place` (the batch drawn and copied to
    the device; on the factorized path its slices of the call's one
    placement), `score_grid.assemble`, `score_grid.forward`; a call:
    `score_grid.fetch` (the scores back on the host). Counters, a call:
    `score_grid.tower_slots` (the towers the grid names: a user's per
    grid row and an item's per pair), `score_grid.towers` (those its
    launches encode), `score_grid.batches` (the batches it runs) and
    `score_grid.placements` (the host-to-device copies it makes: one a
    batch, one a call on the factorized path)."""
    model.eval()
    mesh = model_mesh(model)
    slots = int(records["item"].shape[0] + records["item"].size)
    count("score_grid.tower_slots", slots)
    if (entity_tables is not None and mesh is None
            and _splits_towers(model)):
        return _score_factorized(model, records, batch_size, device,
                                 entity_tables)
    count("score_grid.towers", slots)
    if mesh is not None:   # whole rows for every data rank
        n = mesh.shape[mesh.data_axis]
        batch_size = -(-batch_size // n) * n
    scores, weights = [], []
    batcher = Batcher(records, batch_size)
    count("score_grid.batches", len(batcher))
    batches = iter(batcher)
    for _ in range(len(batcher)):
        with annotate("score_grid.place"):
            batch = next(batches)
            placed = to_device(host_slice(batch, mesh), device)
            count("score_grid.placements")
            weights.append(batch["weight"].astype(bool))
        if entity_tables is not None:
            with annotate("score_grid.assemble"):
                placed = assemble_entity_grid(placed, entity_tables,
                                              this_doc_words)
        with annotate("score_grid.forward"):
            scores.append(source_pred(model(placed)))
    return _fetch_scores(scores, weights, records, mesh)


def _fetch_scores(scores: List[torch.Tensor], weights: List[np.ndarray],
                  records: Dict[str, np.ndarray], mesh=None) -> np.ndarray:
    """The batches' scores on the host, their padding rows dropped."""
    if not scores:
        return np.zeros((0,) + records["item"].shape[1:], np.float32)
    with annotate("score_grid.fetch"):
        host = torch.stack(scores)
        if mesh is not None:
            host = _gather_rows(host, mesh)
        host = host.cpu().numpy()
        return np.concatenate([s[w] for s, w in zip(host, weights)])


def _score_factorized(model: torch.nn.Module, records: Dict[str, np.ndarray],
                      batch_size: int, device: torch.device,
                      tables: Dict[str, torch.Tensor]) -> np.ndarray:
    """`score_grid` over entity tables by the model's split. Span
    `score_grid.towers`: everything the call's device work reads placed
    in one copy (`_place_call`), then the call's distinct users and items
    (`np.unique` over the records) encoded once each by `entity_towers`,
    in even chunks of at most `batch_size` x C docs (the joint path's
    largest launch). Then a batch: its slices of the placed grids
    (`score_grid.place`), each pair's two tower vectors taken
    (`score_grid.assemble`) and `pair_head` run on them
    (`score_grid.forward`), on the joint path's [batch_size, C] shapes.
    Nothing waits for the device before the fetch: on CUDA the copy is
    asynchronous, so the batches' host work overlaps the towers.
    Evaluation draws no dropout and masks nothing, so each pair's score
    is the joint forward's arithmetic."""
    items = records["item"]
    m, c = items.shape
    u_ids, u_inv = np.unique(records["user"][:, 0], return_inverse=True)
    i_ids, i_inv = np.unique(items.reshape(-1), return_inverse=True)
    count("score_grid.towers", len(u_ids) + len(i_ids))
    nb = -(-m // batch_size)
    count("score_grid.batches", nb)
    if not nb:
        return _fetch_scores([], [], records)
    rows = nb * batch_size
    with annotate("score_grid.towers"):
        placed = _place_call(records, u_ids, u_inv, i_ids, i_inv, rows,
                             device)
        count("score_grid.placements")
        ids = {"user": placed[:len(u_ids)],
               "item": placed[len(u_ids):len(u_ids) + len(i_ids)]}
        # [user slot, item slot, user id, item id] of each grid row's
        # pairs; rows m and on pad the last batch
        grids = placed[len(u_ids) + len(i_ids):].view(4, rows, c)
        vecs = {}
        for side in ("user", "item"):
            n = len(ids[side])
            parts = -(-n // (batch_size * c))
            step = -(-n // parts)
            vecs[side] = torch.cat([
                model.entity_towers(side, tables[side + "_doc"],
                                    ids[side][s:s + step])
                for s in range(0, n, step)])
    real = np.arange(rows) < m
    scores, weights = [], []
    for j in range(nb):
        rows_j = slice(j * batch_size, (j + 1) * batch_size)
        with annotate("score_grid.place"):
            u_slot, i_slot, users, cands = grids[:, rows_j]
            weights.append(real[rows_j])
        with annotate("score_grid.assemble"):
            u = vecs["user"].index_select(0, u_slot.reshape(-1))
            i = vecs["item"].index_select(0, i_slot.reshape(-1))
        with annotate("score_grid.forward"):
            scores.append(model.pair_head(u, i, users, cands).reshape(
                cands.shape))
    return _fetch_scores(scores, weights, records)


def _place_call(records: Dict[str, np.ndarray], u_ids: np.ndarray,
                u_inv: np.ndarray, i_ids: np.ndarray, i_inv: np.ndarray,
                rows: int, device: torch.device) -> torch.Tensor:
    """One int32 buffer on `device`: the call's distinct user and item
    ids, then [4, rows, C] grids of each pair's user and item tower slot
    (the inverse indices) and user and item id, zero past the records'
    rows. Built in pinned memory and copied asynchronously on CUDA, as
    `utils.device.to_device` copies a batch."""
    m, c = records["item"].shape
    n_ids = len(u_ids) + len(i_ids)
    pin = device.type == "cuda"
    buf = torch.empty(n_ids + 4 * rows * c, dtype=torch.int32,
                      pin_memory=pin)
    host = buf.numpy()
    host[:len(u_ids)] = u_ids
    host[len(u_ids):n_ids] = i_ids
    grids = host[n_ids:].reshape(4, rows, c)
    grids[:, m:] = 0
    grids[0, :m] = u_inv.reshape(m, 1)
    grids[1, :m] = i_inv.reshape(m, c)
    grids[2, :m] = records["user"]
    grids[3, :m] = records["item"]
    return buf.to(device, non_blocking=pin)


def positive_ranks(scores: np.ndarray) -> np.ndarray:
    """0-based rank of column 0: the candidates scoring strictly
    higher."""
    return np.sum(scores[:, 1:] > scores[:, :1], axis=1)


def ranks_to_metrics(ranks: np.ndarray, ks) -> Dict[str, float]:
    """HR@k / NDCG@k from 0-based positive ranks (NDCG for k > 1)."""
    metrics: Dict[str, float] = {}
    total = max(len(ranks), 1)
    for k in ks:
        hr = float((ranks < k).sum()) / total
        metrics[f"HR@{k}"] = round(100.0 * hr, 2)
        if k > 1:
            ndcg = float(np.where(ranks < k, 1.0 / np.log2(ranks + 2),
                                  0.0).sum()) / total
            metrics[f"NDCG@{k}"] = round(100.0 * ndcg, 2)
    return metrics


def split_eval_ks(hp: HyperParams) -> Tuple[Tuple[int, ...],
                                            Tuple[int, ...]]:
    """(narrow_ks, wide_ks): with hp.eval_num_negs > 0, cutoffs above
    num_negs move to the wide 1+eval_num_negs candidate sets, on which
    they do not saturate by construction."""
    if hp.eval_num_negs <= 0:
        return tuple(hp.eval_ks), ()
    wide = tuple(k for k in hp.eval_ks if k > hp.num_negs)
    bad = [k for k in wide if hp.eval_num_negs < k]
    if bad:
        raise ValueError(
            f"eval_num_negs={hp.eval_num_negs} gives 1+{hp.eval_num_negs}"
            f"-candidate wide sets, on which HR@{bad[0]} saturates at 100 "
            f"by construction; set eval_num_negs >= {max(bad)}")
    return tuple(k for k in hp.eval_ks if k <= hp.num_negs), wide


def grid_this_doc_words(hp: HyperParams) -> int:
    """The length of the zero `this_doc` an id-only grid gives the
    model: transnet's doc length, 0 (none) for the other models."""
    return hp.input_length if hp.model_type.startswith("transnet") else 0


def eval_ranking(model: torch.nn.Module, neg_records: Dict[str, np.ndarray],
                 hp: HyperParams, batch_size: int, device: torch.device,
                 entity_tables: Optional[Dict[str, torch.Tensor]] = None
                 ) -> Dict[str, float]:
    """HR@k / NDCG@k at `hp.eval_ks` over per-user candidate sets; with
    `entity_tables`, over id-only grids whose docs come from them. One
    call is one `eval_ranking` span."""
    with annotate("eval_ranking"):
        scores = score_grid(model, neg_records, batch_size, device,
                            entity_tables, grid_this_doc_words(hp))
        return ranks_to_metrics(positive_ranks(scores), hp.eval_ks)

"""Top-level runner of the port.

- `run` trains `hp.model_type` and reports the full metric set, as the
  JAX package's `api.run` does: the id models (bias_only, MF_dot, MF,
  GMF, MLP, NeuMF, the last in its three phases), deepconn, deepconn++,
  NARRE, transnet, transnet++ and MPCN; transnet adds `MSE_right` and
  `MSE_transform`. The neighbor family (baseline, SVD, SVD++, NMF, kNN)
  goes to `models.neighbors.run_neighbor` and the topic family (HFT) to
  `models.hft.run_hft`, as in the JAX package. Under a ranking `hp.loss`
  (CE, BPR, HINGE; not transnet) the model trains on sampled candidate
  grids and keeps the epoch of best val HR@1; the test metrics are the
  same set.
- `finalize` scores a model the way the JAX package's `api._finalize`
  does: test MSE with the count-vs-MSE maps, HR@1 on the stored 1+5
  candidate sets and, with `hp.eval_num_negs > 0`, the k > num_negs
  cutoffs on the wide 1+eval_num_negs sets. With the entity cache on
  (`hp.cache_doc_embeds` and `hp.cache_entity`) it runs from the entity
  doc tables on the device: the test MSE through an entity example
  cache and the ranking over id-only grids (transnet's `this_doc` zeros
  of `input_length` words), with the same metrics as the host path
  (eval removes nothing).
- On a mesh (`hp.mesh_shape` other than (1, 1); one process a device,
  each calling `parallel.distributed.initialize` first) every rank
  calls `run` with its own device: the trainer lays the model out on the
  (data, model) grid, each data rank scores its rows, and every rank
  returns the single-device metrics. Only the primary writes logs and
  checkpoints.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import torch

from .config import HyperParams
from .data.batcher import Batcher
from .data.corpus import ReviewDataset
from .models import build_model
from .models.mf import neumf_warm_start
from .parallel.mesh import mesh_from_hp, shard_model
from .train.checkpoint import checkpoint_path
from .train.evaluate import (eval_ranking, evaluate, evaluate_cached,
                             split_eval_ks)
from .train.loop import (EntityCache, build_entity_tables, entity_serving,
                         train_complete)
from .utils.device import DeviceLike, module_device, to_device
from .utils.logging import log_end_epoch


def finalize(hp: HyperParams, model: torch.nn.Module,
             dataset: ReviewDataset, device: DeviceLike = None
             ) -> Tuple[Dict, Dict, Dict]:
    """(metrics, user_count_mse_map, item_count_mse_map) of `model` on
    the test split and the ranking sets."""
    dev = module_device(model, device)
    hp = dataset.apply_to(hp)
    use_ent = entity_serving(hp)
    tables = None
    if use_ent:
        tables = build_entity_tables(hp, dataset, dev)
        test_recs = dataset.materialize_entity(hp, "test")
        test_cache = EntityCache(to_device(test_recs, dev), tables)
        metrics, ucm, icm = evaluate_cached(model, test_cache, test_recs, hp,
                                            dataset.user_count,
                                            dataset.item_count, dev)
    else:
        test_b = Batcher(dataset.materialize(hp, "test"), hp.batch_size)
        metrics, ucm, icm = evaluate(model, test_b, hp, dataset.user_count,
                                     dataset.item_count, dev)
    text = False if use_ent else None
    neg_recs = dataset.materialize_negs(hp, include_text=text)
    # host review grids are large: a smaller outer batch, as the JAX
    # package; the entity path carries only ids per grid row
    heavy = hp.uses_reviews and not use_ent
    rank_bs = max(1, hp.batch_size // (4 if heavy else 1))
    if hp.eval_num_negs > 0:
        narrow_ks, wide_ks = split_eval_ks(hp)
        metrics.update(eval_ranking(model, neg_recs,
                                    hp.replace(eval_ks=narrow_ks),
                                    rank_bs, dev, tables))
        if wide_ks:
            wide_recs = dataset.materialize_wide_negs(
                hp, hp.eval_num_negs, seed=hp.seed, include_text=text)
            # the entity grid gathers [B, C, T, E] docs on the device:
            # a smaller outer batch keeps a 1+99 grid near 1 GB
            wide_bs = max(1, rank_bs // (8 if use_ent else
                                         4 if hp.uses_reviews else 1))
            metrics.update(eval_ranking(model, wide_recs,
                                        hp.replace(eval_ks=wide_ks),
                                        wide_bs, dev, tables))
    else:
        metrics.update(eval_ranking(model, neg_recs, hp, rank_bs, dev,
                                    tables))
    return metrics, ucm, icm


def _train_neumf(hp: HyperParams, dataset: ReviewDataset, quiet: bool,
                 device: DeviceLike) -> torch.nn.Module:
    """NeuMF's three phases (the JAX package's `api._run_neumf`): GMF,
    then MLP, each trained to its best-validation params with a
    checkpoint of its own (the run tag names the model type), then NeuMF
    initialized from `hp.seed`, warm-started from the two
    (`neumf_warm_start`) and trained. Returns NeuMF with its
    best-validation params."""
    best = {}
    for mt in ("GMF", "MLP"):
        php = hp.replace(model_type=mt)
        model = build_model(php, device=device)
        best[mt], _ = train_complete(
            php, model, dataset, quiet=quiet,
            checkpoint_path=checkpoint_path(php) if hp.save_model else None)
    model = build_model(hp, device=device)
    mesh = mesh_from_hp(hp)
    if mesh is not None:
        # the phases' best params are this rank's rows of each table:
        # lay NeuMF out the same way before the surgery
        shard_model(model, hp, mesh)
    model.load_state_dict(neumf_warm_start(model.state_dict(), best["GMF"],
                                           best["MLP"]))
    params, _ = train_complete(
        hp, model, dataset, quiet=quiet,
        checkpoint_path=checkpoint_path(hp) if hp.save_model else None)
    model.load_state_dict(params)
    return model


def run(hp: HyperParams, dataset: Optional[ReviewDataset] = None,
        quiet: bool = True, device: DeviceLike = None
        ) -> Tuple[Dict, Dict, Dict]:
    """Train + evaluate `hp.model_type` on `device` (None = the GPU).
    Returns (metrics, user_count_mse_map, item_count_mse_map). With
    `hp.save_model` (the default) the run's checkpoint, best-validation
    params included, is `train.checkpoint.checkpoint_path(hp)`, which
    `serve.restore_model` reads; NeuMF's GMF and MLP phases save theirs
    under their own model types."""
    if dataset is None:
        dataset = ReviewDataset.load(hp.data_dir())
    hp = dataset.apply_to(hp)
    if hp.dataset == "ratebeer" and hp.rating_max == 5.0:
        # RateBeer overall ratings are N/20 (reference data.py:101-102)
        hp = hp.replace(rating_max=20.0)
    start = time.time()
    stats: Dict = {}
    if hp.family == "neighbor":
        from .models.neighbors import run_neighbor
        metrics, ucm, icm = run_neighbor(hp, dataset, device=device)
    elif hp.family == "topic":
        from .models.hft import run_hft
        metrics, ucm, icm = run_hft(hp, dataset, quiet=quiet, device=device)
    else:
        if hp.model_type == "NeuMF":
            model = _train_neumf(hp, dataset, quiet, device)
        else:
            model = build_model(hp, dataset.word_vectors, device=device)
            best, _ = train_complete(
                hp, model, dataset, quiet=quiet,
                checkpoint_path=(checkpoint_path(hp) if hp.save_model
                                 else None),
                stats=stats)
            model.load_state_dict(best)
        metrics, ucm, icm = finalize(hp, model, dataset, device=device)
    if "train_examples_per_s" in stats:
        metrics["train_examples_per_s"] = stats["train_examples_per_s"]
    metrics["dataset"] = hp.dataset
    log_end_epoch(hp.log_file(), metrics, "final", time.time() - start,
                  metrics_on="(TEST)", quiet=quiet)
    return metrics, ucm, icm

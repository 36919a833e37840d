"""Top-level runner of the port.

- `run` trains `hp.model_type` and reports the full metric set, as the
  JAX package's `api.run` does: deepconn and deepconn++ so far (other
  families raise `NotImplementedError` naming their ROADMAP.md item).
- `finalize` scores a model the way the JAX package's `api._finalize`
  does on its host-materialized path: test MSE with the count-vs-MSE
  maps, HR@1 on the stored 1+5 candidate sets and, with
  `hp.eval_num_negs > 0`, the k > num_negs cutoffs on the wide
  1+eval_num_negs sets.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import torch

from .config import HyperParams
from .data.batcher import Batcher
from .data.corpus import ReviewDataset
from .models import build_model
from .train.checkpoint import checkpoint_path
from .train.evaluate import eval_ranking, evaluate, split_eval_ks
from .train.loop import train_complete
from .utils.device import DeviceLike, module_device
from .utils.logging import log_end_epoch


def finalize(hp: HyperParams, model: torch.nn.Module,
             dataset: ReviewDataset, device: DeviceLike = None
             ) -> Tuple[Dict, Dict, Dict]:
    """(metrics, user_count_mse_map, item_count_mse_map) of `model` on
    the test split and the ranking sets."""
    dev = module_device(model, device)
    hp = dataset.apply_to(hp)
    test_b = Batcher(dataset.materialize(hp, "test"), hp.batch_size)
    metrics, ucm, icm = evaluate(model, test_b, hp, dataset.user_count,
                                 dataset.item_count, dev)
    neg_recs = dataset.materialize_negs(hp)
    # review grids are large: a smaller outer batch, as the JAX package
    rank_bs = max(1, hp.batch_size // (4 if hp.uses_reviews else 1))
    if hp.eval_num_negs > 0:
        narrow_ks, wide_ks = split_eval_ks(hp)
        metrics.update(eval_ranking(model, neg_recs,
                                    hp.replace(eval_ks=narrow_ks),
                                    rank_bs, dev))
        if wide_ks:
            wide_recs = dataset.materialize_wide_negs(
                hp, hp.eval_num_negs, seed=hp.seed)
            wide_bs = max(1, rank_bs // (4 if hp.uses_reviews else 1))
            metrics.update(eval_ranking(model, wide_recs,
                                        hp.replace(eval_ks=wide_ks),
                                        wide_bs, dev))
    else:
        metrics.update(eval_ranking(model, neg_recs, hp, rank_bs, dev))
    return metrics, ucm, icm


def run(hp: HyperParams, dataset: Optional[ReviewDataset] = None,
        quiet: bool = True, device: DeviceLike = None
        ) -> Tuple[Dict, Dict, Dict]:
    """Train + evaluate `hp.model_type` on `device` (None = the GPU).
    Returns (metrics, user_count_mse_map, item_count_mse_map). With
    `hp.save_model` (the default) the run's checkpoint, best-validation
    params included, is `train.checkpoint.checkpoint_path(hp)`, which
    `serve.restore_model` reads."""
    if dataset is None:
        dataset = ReviewDataset.load(hp.data_dir())
    hp = dataset.apply_to(hp)
    if hp.dataset == "ratebeer" and hp.rating_max == 5.0:
        # RateBeer overall ratings are N/20 (reference data.py:101-102)
        hp = hp.replace(rating_max=20.0)
    start = time.time()
    model = build_model(hp, dataset.word_vectors, device=device)
    stats: Dict = {}
    best, _ = train_complete(
        hp, model, dataset, quiet=quiet,
        checkpoint_path=checkpoint_path(hp) if hp.save_model else None,
        stats=stats)
    model.load_state_dict(best)
    metrics, ucm, icm = finalize(hp, model, dataset, device=device)
    if "train_examples_per_s" in stats:
        metrics["train_examples_per_s"] = stats["train_examples_per_s"]
    metrics["dataset"] = hp.dataset
    log_end_epoch(hp.log_file(), metrics, "final", time.time() - start,
                  metrics_on="(TEST)", quiet=quiet)
    return metrics, ucm, icm

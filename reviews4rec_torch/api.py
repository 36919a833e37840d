"""Top-level runner of the port.

`finalize` scores a model the way the JAX package's `api._finalize`
does on its host-materialized path: test MSE with the count-vs-MSE
maps, HR@1 on the stored 1+5 candidate sets and, with
`hp.eval_num_negs > 0`, the k > num_negs cutoffs on the wide
1+eval_num_negs sets. Training (`run`) comes with the trainer slice
(ROADMAP.md, Queue 1 item 4).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .config import HyperParams
from .data.batcher import Batcher
from .data.corpus import ReviewDataset
from .train.evaluate import eval_ranking, evaluate, split_eval_ks
from .utils.device import DeviceLike, module_device


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

"""How `correct` is decided: each number compared against the plain
reference, each beside its limit from `portbench/limits/<cell>.json`.

- train: the first group of steps, one replay of the window's graph:
  its mean loss (from the program's own squared-error sums), Adam's
  first moment after it (the gradients as Adam took them, weighted by
  step) and the parameters' change over it, the last two per leaf as
  the gap between the program's norm and the reference's, over the
  larger of that leaf's reference norm and the median leaf's. Leaves
  whose reference first moment is under a thousandth of the median
  leaf's (a softmax scorer's output bias) are left out of both.
- rank: a call drawn from the seed among the window's calls: the widest
  gap of a grid score, and HR@k / NDCG@k as `eval_ranking` returned them
  against the interval the reference's scores allow where two scores lie
  within the score limit of each other.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

Numbers = Dict[str, float]


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in d.items()}


def _gaps(prog: Dict[str, float], ref: Dict[str, float], keep
          ) -> Dict[str, float]:
    """Each kept leaf's gap of norms over the larger of its reference
    norm and the median leaf's."""
    floor = float(np.median([ref[k] for k in keep]))
    return {k: abs(prog[k] - ref[k]) / max(ref[k], floor, 1e-30)
            for k in keep}


def train_numbers(prog: Dict, ref: Dict, p0: Dict[str, torch.Tensor]
                  ) -> Numbers:
    """`prog` and `ref`: {"loss", "exp_avg", "params"} after the group.
    The group's mean loss gap, and the first-moment and update norm gaps
    by the worst leaf and by the median leaf."""
    m_ref = _norms(ref["exp_avg"])
    median = float(np.median(list(m_ref.values())))
    keep = [k for k, v in m_ref.items() if v >= 1e-3 * median]
    m_prog = _norms({k: prog["exp_avg"].get(k, torch.zeros(())) for k in keep})
    d_ref = _norms({k: ref["params"][k] - p0[k] for k in keep})
    d_prog = _norms({k: prog["params"][k].to(p0[k].device) - p0[k]
                     for k in keep})
    moment, update = _gaps(m_prog, m_ref, keep), _gaps(d_prog, d_ref, keep)
    return {"loss_gap": abs(prog["loss"] - ref["loss"]) / abs(ref["loss"]),
            "moment_gap": max(moment.values()),
            "moment_median_gap": float(np.median(list(moment.values()))),
            "update_gap": max(update.values()),
            "update_median_gap": float(np.median(list(update.values())))}


def reference_train(ref: Dict) -> Dict:
    """The reference's steps in the program's terms: the group's mean
    loss (every batch full, so the mean of the steps' losses)."""
    return {"loss": float(np.mean(ref["losses"])), "exp_avg": ref["exp_avg"],
            "params": ref["params"]}


def _metric_bounds(pos: np.ndarray, neg: np.ndarray, tol: float, ks
                   ) -> Dict[str, Tuple[float, float]]:
    lo = np.sum(neg > pos[:, None] + tol, axis=1)
    hi = np.sum(neg >= pos[:, None] - tol, axis=1)
    out = {}
    for k in ks:
        out[f"HR@{k}"] = (100.0 * np.mean(hi < k), 100.0 * np.mean(lo < k))
        if k > 1:
            best = np.where(lo < k, 1.0 / np.log2(lo + 2), 0.0)
            worst = np.where(hi < k, 1.0 / np.log2(hi + 2), 0.0)
            out[f"NDCG@{k}"] = (100.0 * np.mean(worst), 100.0 * np.mean(best))
    return out


def harness_rank_metrics(scores: np.ndarray, ks) -> Dict[str, float]:
    """HR@k / NDCG@k of a [M, C] grid, positive in column 0, a tie to
    the positive: the metrics a control in the program's place reports."""
    b = _metric_bounds(scores[:, 0], scores[:, 1:], 0.0, ks)
    return {k: round(v[1], 2) for k, v in b.items()}


def rank_numbers(prog_scores: np.ndarray, prog_metrics: Dict[str, float],
                 ref_scores: np.ndarray, ks, tol: float) -> Numbers:
    bounds = _metric_bounds(ref_scores[:, 0], ref_scores[:, 1:], tol, ks)
    # the program reports percent to 2 decimals: compare at that grain
    outside = max(max(round(lo, 2) - prog_metrics[k],
                      prog_metrics[k] - round(hi, 2), 0.0)
                  for k, (lo, hi) in bounds.items())
    return {"score_gap": float(np.max(np.abs(prog_scores - ref_scores))),
            "rank_metric_gap": round(float(outside), 6)}


def judge(numbers: Numbers, limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]], Numbers]:
    """(every limited number within its limit (a NaN is not), each
    limited number with its limit, the numbers the limits leave out)."""
    checks = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks, {k: v for k, v in numbers.items() if k not in limits}

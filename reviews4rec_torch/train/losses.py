"""Loss library: the port's counterpart of `reviews4rec_tpu/train/losses.py`
(the MPCN stack's loss variants), with the same masks and reductions.

Every function takes an optional `weight` mask (1 = a real example,
0 = padding). The means divide by max(sum(weight), 1), or by
max(`denom`, 1) when given (on a mesh, the weight sum over the data
axis); hinge sums.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _mean(x: torch.Tensor, weight: Optional[torch.Tensor],
          denom: Optional[torch.Tensor] = None) -> torch.Tensor:
    if weight is None:
        return x.mean()
    n = weight.sum() if denom is None else denom
    return (x * weight).sum() / n.clamp(min=1.0)


def raw_mse(preds: torch.Tensor, targets: torch.Tensor,
            weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean squared error."""
    return _mean((preds - targets) ** 2, weight)


def softmax_ce(logits: torch.Tensor, labels: torch.Tensor,
               weight: Optional[torch.Tensor] = None,
               denom: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax cross-entropy over the last (candidate) axis; `labels` is
    a distribution (one-hot for the positive-then-negatives layout) and
    takes no gradient."""
    ce = -(labels.detach() * torch.log_softmax(logits, dim=-1)).sum(dim=-1)
    return _mean(ce, weight, denom)


def optax_sigmoid_ce(logits: torch.Tensor, labels: torch.Tensor
                     ) -> torch.Tensor:
    """Numerically stable binary cross-entropy with logits, elementwise:
    max(x, 0) - x * y + log1p(exp(-|x|)) (the JAX package's name)."""
    return (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def sigmoid_ce_point(logits: torch.Tensor, labels: torch.Tensor,
                     weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pointwise sigmoid cross-entropy on binary labels."""
    return _mean(optax_sigmoid_ce(logits, labels), weight)


def bpr(pos: torch.Tensor, neg: torch.Tensor,
        weight: Optional[torch.Tensor] = None,
        denom: Optional[torch.Tensor] = None) -> torch.Tensor:
    """BPR pairwise ranking loss: mean(-log sigmoid(pos - neg))."""
    return _mean(-F.logsigmoid(pos - neg), weight, denom)


def hinge(pos: torch.Tensor, neg: torch.Tensor, margin: float = 0.2,
          weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pairwise hinge ranking loss: sum(max(0, margin - pos + neg))."""
    h = torch.clamp(margin - pos + neg, min=0.0)
    if weight is not None:
        h = h * weight
    return h.sum()

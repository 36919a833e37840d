"""Shared neural blocks: factorization machine, text CNN, scorer MLP.

PyTorch counterparts of `reviews4rec_tpu/models/layers.py`, with the
same parameter layouts so that `weights.params_from_flax` maps one onto
the other: the TextCNN keeps its conv as a `[W*E, F]` tap-major matrix,
which the CUDA kernel reads directly. Dense layers are `nn.Linear`
(weight `[out, in]`, the transpose of a flax kernel). Initialization is
xavier-uniform from a `torch.Generator`, biases zero. Dropout draws its
mask from the `generator` a forward is given, so a training run is
keyed by its own seed and not by torch's global RNG.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.textcnn import textcnn_pool


def _linear(n_in: int, n_out: int, generator: Optional[torch.Generator]
            ) -> nn.Linear:
    lin = nn.Linear(n_in, n_out)
    nn.init.xavier_uniform_(lin.weight, generator=generator)
    nn.init.zeros_(lin.bias)
    return lin


class Dropout(nn.Module):
    """flax's `nn.Dropout`: in training, keep each value with probability
    1 - p and scale it by 1 / (1 - p), the mask drawn by `torch.rand`
    from `generator` on the value's device; the identity in `eval()` or
    at p = 0."""

    def __init__(self, p: float):
        super().__init__()
        self.p = float(p)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        mask = torch.rand(x.shape, generator=generator, device=x.device,
                          dtype=x.dtype) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


class FM(nn.Module):
    """Factorization machine head without global bias:
    score(x) = 0.5 * sum_k[(x V)_k^2 - (x^2 V^2)_k] + w.x + b."""

    def __init__(self, n_in: int, factors: int = 8,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.V = nn.Parameter(nn.init.xavier_uniform_(
            torch.empty(n_in, factors), generator=generator))
        self.lin = _linear(n_in, 1, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xv = x @ self.V
        x2v2 = (x * x) @ (self.V * self.V)
        inter = 0.5 * torch.sum(xv * xv - x2v2, dim=-1)
        return inter + self.lin(x)[..., 0]


class TextCNN(nn.Module):
    """Review-document encoder: conv window W over the full embedding
    width with F filters, ReLU, max over time (one fused op,
    `ops.textcnn.textcnn_pool`), FC to latent, dropout."""

    def __init__(self, embed_size: int, latent_size: int,
                 dropout: float = 0.6, num_filters: int = 100,
                 window: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.window = window
        self.conv_kernel = nn.Parameter(nn.init.xavier_uniform_(
            torch.empty(window * embed_size, num_filters),
            generator=generator))
        self.conv_bias = nn.Parameter(torch.zeros(num_filters))
        self.fc = _linear(num_filters, latent_size, generator)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor,
                table: Optional[torch.Tensor] = None,
                skip: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        # x: [B, T, E] embedded words, or int [B, T] ids with a `table`
        # [V, E] to embed them with. `skip` ([B, 2] int32 (start, len))
        # zeroes that word span of each doc. A buffer table (frozen) gives
        # an x that needs no gradient, so the backward skips dx.
        if table is not None and not x.is_floating_point():
            x = table[x]
        y, _ = textcnn_pool(x.contiguous(), self.conv_kernel,
                            self.conv_bias, self.window, skip)
        return self.dropout(self.fc(y), generator)


class ScorerMLP(nn.Module):
    """Dense -> ReLU -> Dropout -> Dense(1)."""

    def __init__(self, n_in: int, hidden: int, dropout: float = 0.6,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc0 = _linear(n_in, hidden, generator)
        self.dropout = Dropout(dropout)
        self.fc1 = _linear(hidden, 1, generator)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.dropout(torch.relu(self.fc0(x)), generator)
        return self.fc1(x)[..., 0]


def doc_shape(doc: torch.Tensor, ndims: int) -> Tuple[tuple, tuple]:
    """(lead, tail) split of a doc tensor whose layout trails with
    `ndims` dims when integer ids ([..., T] or [..., R, W]); float docs
    carry one extra trailing E axis."""
    if doc.is_floating_point():
        ndims += 1
    return tuple(doc.shape[:-ndims]), tuple(doc.shape[-ndims:])

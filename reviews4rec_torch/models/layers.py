"""Shared neural blocks: factorization machine, text CNN, scorer MLP.

PyTorch counterparts of `reviews4rec_tpu/models/layers.py`, with the
same parameter layouts so that `weights.params_from_flax` maps one onto
the other: the TextCNN keeps its conv as a `[W*E, F]` tap-major matrix,
which the CUDA kernel reads directly. Dense layers are `nn.Linear`
(weight `[out, in]`, the transpose of a flax kernel). Initialization is
xavier-uniform from a `torch.Generator`, biases zero.
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
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor,
                table: Optional[torch.Tensor] = None,
                skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        # x: [B, T, E] embedded words, or int [B, T] ids with a `table`
        # [V, E] to embed them with. `skip` ([B, 2] int32 (start, len))
        # zeroes that word span of each doc.
        if table is not None and not x.is_floating_point():
            x = table[x]
        y, _ = textcnn_pool(x.contiguous(), self.conv_kernel,
                            self.conv_bias, self.window, skip)
        return self.dropout(self.fc(y))


class ScorerMLP(nn.Module):
    """Dense -> ReLU -> Dropout -> Dense(1)."""

    def __init__(self, n_in: int, hidden: int, dropout: float = 0.6,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc0 = _linear(n_in, hidden, generator)
        self.dropout = nn.Dropout(dropout)
        self.fc1 = _linear(hidden, 1, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.dropout(torch.relu(self.fc0(x)))
        return self.fc1(x)[..., 0]


def doc_shape(doc: torch.Tensor, ndims: int) -> Tuple[tuple, tuple]:
    """(lead, tail) split of a doc tensor whose layout trails with
    `ndims` dims when integer ids ([..., T] or [..., R, W]); float docs
    carry one extra trailing E axis."""
    if doc.is_floating_point():
        ndims += 1
    return tuple(doc.shape[:-ndims]), tuple(doc.shape[-ndims:])

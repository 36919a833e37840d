"""Shared neural blocks: factorization machine, text CNN, scorer MLP,
MLP tower, highway layer, and the library blocks no model of either
package builds (layer norm, sinusoidal positional encoding, the
position-wise feed-forward block), kept for the library's surface.

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

from typing import Callable, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.textcnn import (textcnn_pool, textcnn_pool_embed,
                            textcnn_pool_rows)


# (index, count) of this process's rows of a batch split over a mesh's
# data axis, while a model laid out on the mesh runs its forward
# (`parallel.mesh.shard_model` sets it around the forward)
_data_shard: Optional[Tuple[int, int]] = None


def set_data_shard(shard: Optional[Tuple[int, int]]) -> None:
    global _data_shard
    _data_shard = shard


def uniform(shape, generator: Optional[torch.Generator],
            device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """`torch.rand(shape)` from `generator`. On a data shard of a mesh
    (dim 0 of `shape` being this rank's rows of the batch), the draws of
    the whole batch's shape, this rank's rows of them: the masks and
    samples of single-device training, whatever the sharding."""
    if _data_shard is None or _data_shard[1] == 1:
        return torch.rand(shape, generator=generator, device=device,
                          dtype=dtype)
    index, count = _data_shard
    rows = shape[0]
    every = torch.rand((rows * count,) + tuple(shape[1:]),
                       generator=generator, device=device, dtype=dtype)
    return every[index * rows:(index + 1) * rows]


def take_rows(module: nn.Module, table: torch.Tensor, ids: torch.Tensor,
              embedding: bool = False) -> torch.Tensor:
    """`table[ids]` for a per-entity table of `module`. On a mesh whose
    model axis shards the table's rows, the mesh's lookup
    (`parallel.embedding`): `hp.embedding_lookup` for the id models'
    embeddings (`embedding=True`), the owner-computes gather otherwise."""
    lookup = getattr(module, "embed_lookup" if embedding else "row_lookup",
                     None)
    return table[ids] if lookup is None else lookup(table, ids)


def data_sum(module: nn.Module, t: torch.Tensor) -> torch.Tensor:
    """`t` summed over the data axis of the mesh `module` is laid out on
    (a per-batch count, such as a loss's weight sum), else `t`."""
    mesh = getattr(module, "mesh", None)
    if mesh is None:
        return t
    return mesh.all_reduce(t, mesh.data_axis)


def _linear(n_in: int, n_out: int, generator: Optional[torch.Generator]
            ) -> nn.Linear:
    lin = nn.Linear(n_in, n_out)
    nn.init.xavier_uniform_(lin.weight, generator=generator)
    nn.init.zeros_(lin.bias)
    return lin


class Dropout(nn.Module):
    """flax's `nn.Dropout`: in training, keep each value with probability
    1 - p and scale it by 1 / (1 - p), the mask drawn by `uniform` from
    `generator` on the value's device; the identity in `eval()` or at
    p = 0."""

    def __init__(self, p: float):
        super().__init__()
        self.p = float(p)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        mask = uniform(x.shape, generator, x.device, x.dtype) < keep
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
    `ops.textcnn.textcnn_pool`), FC to latent, dropout.

    `fuse_gather` (`hp.use_pallas and hp.pallas_fuse_gather`): int ids
    with a `table` and no skip span go to `textcnn_pool_embed`, whose
    kernels read each word from the table, in place of `table[ids]` and
    the plain-x op; the JAX TextCNN takes its fused gather under the same
    condition. The two give the same bits.

    `compute_dtype` "bfloat16" or "float16" (`hp.compute_dtype` without
    `use_pallas`, the JAX TextCNN's XLA branch): rows and ids are
    gathered first, and the conv runs on the 16-bit values of x and K
    with f32 sums (`textcnn_pool(..., dtype=torch.bfloat16)` or
    `torch.float16`)."""

    def __init__(self, embed_size: int, latent_size: int,
                 dropout: float = 0.6, num_filters: int = 100,
                 window: int = 3,
                 generator: Optional[torch.Generator] = None,
                 fuse_gather: bool = False, compute_dtype: str = "float32"):
        super().__init__()
        self.window = window
        self.fuse_gather = fuse_gather
        self.dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                      "float16": torch.float16}[compute_dtype]
        self.conv_kernel = nn.Parameter(nn.init.xavier_uniform_(
            torch.empty(window * embed_size, num_filters),
            generator=generator))
        self.conv_bias = nn.Parameter(torch.zeros(num_filters))
        self.fc = _linear(num_filters, latent_size, generator)
        self.dropout = Dropout(dropout)
        # hp.seq_parallel: the mesh whose model axis splits the time axis
        # (set by `parallel.mesh.shard_model`)
        self.seq_mesh = None

    def _seq_pool(self, x: torch.Tensor, table, skip, rows) -> torch.Tensor:
        """The pooled conv with the time axis split over the mesh's model
        axis (`parallel.sequence.textcnn_pool_seq`, plain PyTorch as the
        JAX package's is XLA): the docs are embedded and masked whole,
        then each model rank keeps its chunk."""
        from ..parallel.sequence import textcnn_pool_seq
        mesh = self.seq_mesh
        n, m = mesh.shape[mesh.model_axis], mesh.index[mesh.model_axis]
        if rows is not None:
            x = x[rows.long()]
        if table is not None and not x.is_floating_point():
            x = table[x]
        x = x.to(self.conv_kernel.dtype)
        t = x.shape[1]
        if skip is not None:
            ts = torch.arange(t, device=x.device)[None, :]
            st, ln = skip[:, :1].long(), skip[:, 1:2].long()
            x = torch.where(((ts >= st) & (ts < st + ln))[..., None],
                            torch.zeros((), dtype=x.dtype, device=x.device),
                            x)
        assert t % n == 0, (t, n)
        c = t // n
        return textcnn_pool_seq(x[:, m * c:(m + 1) * c], self.conv_kernel,
                                self.conv_bias, self.window, mesh,
                                mesh.model_axis)

    def forward(self, x: torch.Tensor,
                table: Optional[torch.Tensor] = None,
                skip: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                rows: Optional[torch.Tensor] = None) -> torch.Tensor:
        # x: [B, T, E] embedded words, or int [B, T] ids with a `table`
        # [V, E] to embed them with. `skip` ([B, 2] int32 (start, len))
        # zeroes that word span of each doc. A buffer table (frozen) gives
        # an x that needs no gradient, so the backward skips dx.
        # `rows` ([B] int32): x is then a whole per-entity doc table and
        # example b reads row rows[b] (hp.pallas_fuse_rows). A float
        # [N, T, E] table goes to the row-gathered kernels, which read
        # the rows themselves; int [N, T] ids are gathered first.
        if self.seq_mesh is not None:
            y = self._seq_pool(x, table, skip, rows)
            return self.dropout(self.fc(y), generator)
        f32 = self.dtype == torch.float32
        if (rows is not None and x.is_floating_point() and x.dim() == 3
                and f32):
            y, _ = textcnn_pool_rows(x, rows.to(torch.int32).contiguous(),
                                     self.conv_kernel, self.conv_bias,
                                     self.window, skip)
            return self.dropout(self.fc(y), generator)
        if rows is not None:
            x = x[rows.long()]
        if table is not None and not x.is_floating_point():
            if self.fuse_gather and skip is None and f32:
                y, _ = textcnn_pool_embed(x.to(torch.int32).contiguous(),
                                          table, self.conv_kernel,
                                          self.conv_bias, self.window)
                return self.dropout(self.fc(y), generator)
            x = table[x]
        y, _ = textcnn_pool(x.contiguous(), self.conv_kernel,
                            self.conv_bias, self.window, skip, self.dtype)
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


class MLPTower(nn.Module):
    """Dropout (when `dropout_first`), then Dense layers `fc{j}` of
    `sizes` with ReLU between them, then `final_activation` if given."""

    def __init__(self, n_in: int, sizes: Sequence[int], dropout: float = 0.6,
                 dropout_first: bool = True,
                 final_activation: Optional[Callable] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout = Dropout(dropout) if dropout_first else None
        self.final_activation = final_activation
        self.depth = len(sizes)
        for j, size in enumerate(sizes):
            self.add_module(f"fc{j}", _linear(n_in, size, generator))
            n_in = size

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.dropout is not None:
            x = self.dropout(x, generator)
        for j in range(self.depth):
            x = getattr(self, f"fc{j}")(x)
            if j < self.depth - 1:
                x = torch.relu(x)
        if self.final_activation is not None:
            x = self.final_activation(x)
        return x


class Highway(nn.Module):
    """gate * relu(trans(x)) + (1 - gate) * x, with gate = sigmoid(
    gate(x)); when the output width differs from the input's, the carried
    x goes through a Dense `carry` first. MPCN's `projection="HIGH"`."""

    def __init__(self, n_in: int, dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.trans = _linear(n_in, dim, generator)
        self.gate = _linear(n_in, dim, generator)
        self.carry = _linear(n_in, dim, generator) if n_in != dim else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        trans = torch.relu(self.trans(x))
        gate = torch.sigmoid(self.gate(x))
        if self.carry is not None:
            x = self.carry(x)
        return gate * trans + (1.0 - gate) * x


class LayerNorm(nn.Module):
    """Layer normalization over the last axis: gamma * (x - mean) *
    rsqrt(var + epsilon) + beta, with the population variance and epsilon
    inside the root (the JAX package's `LayerNorm`). `gamma` (ones) and
    `beta` (zeros) are of the last axis' width `dim`."""

    def __init__(self, dim: int, epsilon: float = 1e-8):
        super().__init__()
        self.epsilon = epsilon
        self.gamma = nn.Parameter(torch.ones(dim))
        self.beta = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, correction=0, keepdim=True)
        return (self.gamma * (x - mean) * torch.rsqrt(var + self.epsilon)
                + self.beta)


def positional_encoding(length: int, dim: int, zero_pad: bool = False,
                        scale: bool = False,
                        device: Optional[torch.device] = None
                        ) -> torch.Tensor:
    """Sinusoidal positional-encoding table [length, dim] float32: sin on
    even columns, cos on odd, angle pos / 10000^(2 i / dim) with i the
    raw column index (so even and odd columns pair up at almost the same
    frequency, as the JAX package's rule has it); row 0 zeroed with
    `zero_pad`, the table times sqrt(dim) with `scale`. A constant: it is
    built on the host, as XLA folds the JAX package's at trace time, and
    returned on `device` (the CPU if None)."""
    pos = torch.arange(length, dtype=torch.float32)[:, None]
    i = torch.arange(dim, dtype=torch.float32)[None, :]
    angle = pos / torch.pow(torch.tensor(10000.0), 2.0 * i / dim)
    table = torch.where(torch.arange(dim) % 2 == 0, torch.sin(angle),
                        torch.cos(angle))
    if zero_pad:
        table[0] = 0.0
    if scale:
        table = table * torch.sqrt(torch.tensor(float(dim)))
    return table.to(device)


class PosFFN(nn.Module):
    """Position-wise feed-forward block: Dense `inner` (ReLU) and Dense
    `readout` back to the input width, the residual added, then
    `LayerNorm` `ln` (the JAX package's `PosFFN`). flax infers the input
    width `dim` at the first call; torch needs it at construction."""

    def __init__(self, dim: int, hidden: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.inner = _linear(dim, hidden, generator)
        self.readout = _linear(hidden, dim, generator)
        self.ln = LayerNorm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ln(x + self.readout(torch.relu(self.inner(x))))


def doc_shape(doc: torch.Tensor, ndims: int) -> Tuple[tuple, tuple]:
    """(lead, tail) split of a doc tensor whose layout trails with
    `ndims` dims when integer ids ([..., T] or [..., R, W]); float docs
    carry one extra trailing E axis."""
    if doc.is_floating_point():
        ndims += 1
    return tuple(doc.shape[:-ndims]), tuple(doc.shape[-ndims:])

"""Co-attention and attention library: the port's counterpart of
`reviews4rec_tpu/models/att.py`, with the same parameter names and
layouts so that `weights.params_from_flax` maps one onto the other.

- `CoAttention`: affinity SOFT / BILINEAR / TENSOR / MLP / MD between
  two sequence batches, pooled MAX / MIN / SUM / MEAN into weights over
  each side's positions (a softmax, or the straight-through Gumbel
  pointer), or MATRIX alignment attention.
- `gumbel_softmax` (straight-through) and `hard_argmax` (the pointer at
  eval). Both compare with the max, as JAX does: an exact tie gives a
  multi-hot vector (padded reviews tie exactly), not one index.
- `IntraAttention`: self-alignment with a learned bias per clipped
  distance.
- `_Conv1D` (SAME-padded, a windowed matmul with the `[w*E, F]`
  tap-major kernel; JAX's padding lo = (w-1)//2, hi = w-1-lo, so even
  windows pad as it does), `ConvAttention`, `_PooledCNN` and
  `DualAttention` (D-ATT). The convs carry the flax auto-names of their
  JAX twins (`_Conv1D_0`, ...), so a flax params tree loads with
  `strict=True`.

The maxima are `amax` / `amin`, whose gradient splits equally over tied
elements, as JAX's `max` does. Randomness (dropout masks, Gumbel
uniforms) comes from the `generator` a forward is given; a forward may
instead take fixed Gumbel uniforms `u`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dropout, _linear, uniform

AFFINITIES = ("SOFT", "BILINEAR", "TENSOR", "MLP", "MD")
POOLINGS = ("MAX", "MIN", "SUM", "MEAN", "MATRIX")


def _xavier(shape: Tuple[int, ...], generator: Optional[torch.Generator]
            ) -> nn.Parameter:
    return nn.Parameter(nn.init.xavier_uniform_(torch.empty(shape),
                                                generator=generator))


def gumbel_uniform(shape, generator: Optional[torch.Generator],
                   device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """Uniforms in [1e-20, 1), JAX's `uniform(minval=1e-20, maxval=1)`."""
    return uniform(shape, generator, device, dtype).clamp_min(1e-20)


def gumbel_softmax(logits: torch.Tensor, temperature: float,
                   generator: Optional[torch.Generator] = None,
                   u: Optional[torch.Tensor] = None,
                   hard: bool = True) -> torch.Tensor:
    """Straight-through Gumbel softmax: softmax((logits + g) / t) with
    g = -log(-log(u)); `hard` gives the forward value of the one-hot of
    its max (multi-hot on an exact tie) and the gradient of the soft
    sample. `u` defaults to fresh uniforms from `generator`."""
    if u is None:
        u = gumbel_uniform(logits.shape, generator, logits.device,
                           logits.dtype)
    g = -torch.log(-torch.log(u))
    y = torch.softmax((logits + g) / temperature, dim=-1)
    if hard:
        y_hard = (y == y.amax(dim=-1, keepdim=True)).to(y.dtype)
        y = (y_hard - y).detach() + y
    return y


def hard_argmax(logits: torch.Tensor) -> torch.Tensor:
    """The eval pointer: 1 where a logit equals its row's max."""
    return (logits == logits.amax(dim=-1, keepdim=True)).to(logits.dtype)


class CoAttention(nn.Module):
    """Co-attention over a: [B, la, d] and b: [B, lb, d]. Returns
    (final_a, final_b, w_a, w_b, affinity y [B, la, lb]):

    - pooling MAX / MIN / SUM / MEAN: w_a [B, la] (y pooled over b's
      positions), w_b [B, lb], and final_* the projected inputs scaled
      position-wise by them, then dropped out;
    - pooling MATRIX: w_a [B, lb, la] and w_b [B, la, lb] row-softmaxed
      alignments, final_a = w_a @ a and final_b = w_b @ b of the inputs
      before projection.

    `gumbel`: in training the weights are straight-through Gumbel
    pointers (`u` = (u_a, u_b) fixes their uniforms), in eval the hard
    pointer. `finals=False` skips the final_* (returned as None)."""

    def __init__(self, d: int, att_type: str = "SOFT", pooling: str = "MAX",
                 k: int = 10, transform_layers: int = 1, gumbel: bool = False,
                 temperature: float = 0.5, dropout_rate: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if att_type not in AFFINITIES:
            raise ValueError(f"affinity {att_type!r} not in {AFFINITIES}")
        if pooling not in POOLINGS:
            raise ValueError(f"pooling {pooling!r} not in {POOLINGS}")
        self.att_type, self.pooling = att_type, pooling
        self.transform_layers = transform_layers
        self.gumbel, self.temperature = gumbel, temperature
        for layer in range(transform_layers):
            # one projection shared by both sides
            self.add_module(f"att_proj{layer}", _linear(d, d, generator))
        if att_type == "BILINEAR":
            self.weights_U = _xavier((d, d), generator)
        elif att_type == "TENSOR":
            self.weights_T = _xavier((d, k, d), generator)
        elif att_type == "MLP":
            self.co_att = _linear(2 * d, 1, generator)
        elif att_type == "MD":
            self.co_att_md = _linear(2 * d, k, generator)
            self.co_att_md_out = _linear(k, 1, generator)
        self.dropout = Dropout(dropout_rate)

    def _affinity(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.att_type == "SOFT":
            return a @ b.transpose(-1, -2)
        if self.att_type == "BILINEAR":
            return (a @ self.weights_U) @ b.transpose(-1, -2)
        if self.att_type == "TENSOR":
            y = torch.einsum("bid,dke,bje->bijk", a, self.weights_T, b)
            return y.amax(dim=-1)
        la, lb, d = a.shape[-2], b.shape[-2], a.shape[-1]
        lead = a.shape[:-2]
        pair = torch.cat([a[..., :, None, :].expand(lead + (la, lb, d)),
                          b[..., None, :, :].expand(lead + (la, lb, d))],
                         dim=-1)
        if self.att_type == "MLP":
            return self.co_att(pair)[..., 0]
        return self.co_att_md_out(torch.relu(self.co_att_md(pair)))[..., 0]

    def forward(self, a: torch.Tensor, b: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                u: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                finals: bool = True):
        orig_a, orig_b = a, b
        for layer in range(self.transform_layers):
            proj = getattr(self, f"att_proj{layer}")
            a = torch.relu(proj(a))
            b = torch.relu(proj(b))
        y = self._affinity(a, b)

        if self.pooling == "MATRIX":
            w_a = torch.softmax(y.transpose(-1, -2), dim=-1)   # [B, lb, la]
            w_b = torch.softmax(y, dim=-1)                     # [B, la, lb]
            if not finals:
                return None, None, w_a, w_b, y
            return (self.dropout(w_a @ orig_a, generator),
                    self.dropout(w_b @ orig_b, generator), w_a, w_b, y)

        if self.pooling == "MAX":
            att_row, att_col = y.amax(dim=-2), y.amax(dim=-1)
        elif self.pooling == "MIN":
            att_row, att_col = y.amin(dim=-2), y.amin(dim=-1)
        elif self.pooling == "SUM":
            att_row, att_col = y.sum(dim=-2), y.sum(dim=-1)
        else:  # MEAN
            att_row, att_col = y.mean(dim=-2), y.mean(dim=-1)

        if self.gumbel:
            if self.training:
                u_a, u_b = u if u is not None else (None, None)
                w_a = gumbel_softmax(att_col, self.temperature, generator,
                                     u_a)
                w_b = gumbel_softmax(att_row, self.temperature, generator,
                                     u_b)
            else:
                w_a, w_b = hard_argmax(att_col), hard_argmax(att_row)
        else:
            w_a = torch.softmax(att_col, dim=-1)
            w_b = torch.softmax(att_row, dim=-1)
        if not finals:
            return None, None, w_a, w_b, y
        return (self.dropout(w_a[..., None] * a, generator),
                self.dropout(w_b[..., None] * b, generator), w_a, w_b, y)


class IntraAttention(nn.Module):
    """Self-alignment: a 2-layer ReLU projection, dot-product affinity
    plus a learned bias per clipped token distance (j - i clipped to
    [0, dist_bias - 1]), row softmax; returns [x, att @ x]."""

    def __init__(self, n_in: int, dim: int, dist_bias: int = 10,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.intra_proj0 = _linear(n_in, dim, generator)
        self.intra_proj1 = _linear(dim, dim, generator)
        self.dist_bias = nn.Parameter(torch.zeros(dist_bias))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = x.shape[-2]
        x = torch.relu(self.intra_proj1(torch.relu(self.intra_proj0(x))))
        pos = torch.arange(t, device=x.device)
        rel = (pos[None, :] - pos[:, None]).clamp(0, self.dist_bias.numel()
                                                  - 1)
        att = torch.softmax(x @ x.transpose(-1, -2) + self.dist_bias[rel],
                            dim=-1)
        return torch.cat([x, att @ x], dim=-1)


class _Conv1D(nn.Module):
    """SAME-padded 1-D conv as a windowed matmul: x [B, T, E] padded
    (w-1)//2 before and the rest after, windows [B, T, w*E] (tap-major)
    times `<prefix>_kernel` [w*E, F] plus `<prefix>_bias` (init 0.1)."""

    def __init__(self, n_in: int, features: int, window: int,
                 name_prefix: str = "conv",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.window, self.prefix = window, name_prefix
        self.register_parameter(f"{name_prefix}_kernel", _xavier(
            (window * n_in, features), generator))
        self.register_parameter(f"{name_prefix}_bias", nn.Parameter(
            torch.full((features,), 0.1)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, e = x.shape
        w = self.window
        lo = (w - 1) // 2
        xp = F.pad(x, (0, 0, lo, w - 1 - lo))
        windows = xp.unfold(1, w, 1).transpose(-1, -2).reshape(b, t, w * e)
        return (windows @ getattr(self, f"{self.prefix}_kernel")
                + getattr(self, f"{self.prefix}_bias"))


class ConvAttention(nn.Module):
    """x * sigmoid(conv(x)): a width-`window` conv to one channel."""

    def __init__(self, n_in: int, window: int = 5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self._Conv1D_0 = _Conv1D(n_in, 1, window, "gate", generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(self._Conv1D_0(x))


class _PooledCNN(nn.Module):
    """Per window size: conv -> ReLU -> max over time; concatenated."""

    def __init__(self, n_in: int, features: int,
                 windows: Sequence[int] = (3,),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        per = features // len(windows)
        self.out_features = per * len(windows)
        self.n_convs = len(windows)
        for j, w in enumerate(windows):
            self.add_module(f"_Conv1D_{j}",
                            _Conv1D(n_in, per, w, f"cnn{w}", generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([
            torch.relu(getattr(self, f"_Conv1D_{j}")(x)).amax(dim=1)
            for j in range(self.n_convs)], dim=-1)


class DualAttention(nn.Module):
    """D-ATT: a local branch (the conv gate, then a window-3 pooled CNN)
    and a global branch (pooled CNN over windows 2, 3, 4), concatenated,
    then two ReLU Dense layers `ffn0`, `ffn1`, each after dropout."""

    def __init__(self, n_in: int, features: int, dropout_rate: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.local = _PooledCNN(n_in, features, (3,), generator)
        self.local_gate = ConvAttention(n_in, generator=generator)
        # "global" is a keyword: registered by name, read by `_modules`
        self.add_module("global", _PooledCNN(n_in, features, (2, 3, 4),
                                             generator))
        width = self.local.out_features + self._modules["global"].out_features
        self.ffn0 = _linear(width, features, generator)
        self.ffn1 = _linear(features, features, generator)
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = torch.cat([self.local(self.local_gate(x)),
                       self._modules["global"](x)], dim=-1)
        for ffn in (self.ffn0, self.ffn1):
            h = torch.relu(ffn(self.dropout(h, generator)))
        return h

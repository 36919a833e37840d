"""Sequence parallelism for the review-document CNN encoders. Counterpart
of `reviews4rec_tpu/parallel/sequence.py`.

The TextCNN conv is local in the time axis, so a document split over
the model ranks needs only a halo exchange of the (window - 1) boundary
rows of each neighbour, followed by a max over the ranks of the local
max-over-time partials. Semantics match the single-device TextCNN
exactly (the conv pads window - 1 zeros on both ends): the ranks at the
two ends take zeros for their missing neighbour, which is that padding,
and neighbouring ranks recompute the (window - 1) overlapping windows,
which a max does not count twice.

The local windows are plain PyTorch, as JAX's are XLA: under
`seq_parallel` no TextCNN kernel runs. The two collectives are autograd
functions with JAX's gradients: the halo's backward sends each halo
row's gradient back to the rank it came from, and the max over the ranks
gives the (replicated) cotangent to the ranks holding the maximum, split
evenly among ties as JAX's max does, so that the conv gradients summed
over the model axis are the single-device ones.
"""

from __future__ import annotations

import torch


class _Halo(torch.autograd.Function):
    """[b, c, E] chunk -> [b, (w-1) + c + (w-1), E]: the previous rank's
    last w-1 rows, the chunk, the next rank's first w-1 rows (zeros at
    the ends of the axis)."""

    @staticmethod
    def forward(ctx, xs, halo, mesh, axis):
        ctx.halo, ctx.mesh, ctx.axis = halo, mesh, axis
        n, m = mesh.shape[axis], mesh.index[axis]
        edges = mesh.all_gather(torch.stack([xs[:, -halo:], xs[:, :halo]]),
                                axis)                   # [n, 2, b, w-1, E]
        zero = torch.zeros_like(xs[:, :halo])
        left = edges[m - 1, 0] if m > 0 else zero
        right = edges[m + 1, 1] if m < n - 1 else zero
        return torch.cat([left, xs, right], dim=1)

    @staticmethod
    def backward(ctx, g):
        halo, mesh, axis = ctx.halo, ctx.mesh, ctx.axis
        n, m = mesh.shape[axis], mesh.index[axis]
        back = mesh.all_gather(torch.stack([g[:, :halo], g[:, -halo:]]),
                               axis)
        dx = g[:, halo:-halo].clone()
        # my last rows are the next rank's left halo, my first rows the
        # previous rank's right halo
        if m < n - 1:
            dx[:, -halo:] += back[m + 1, 0]
        if m > 0:
            dx[:, :halo] += back[m - 1, 1]
        return dx, None, None, None


class _MaxOverAxis(torch.autograd.Function):
    """The elementwise max of every rank's y, replicated over the axis;
    the cotangent goes to the ranks holding the max, split over ties."""

    @staticmethod
    def forward(ctx, y, mesh, axis):
        every = mesh.all_gather(y, axis)                # [n, b, F]
        out = every.amax(0)
        ctx.save_for_backward(y == out, (every == out).sum(0))
        return out

    @staticmethod
    def backward(ctx, g):
        mine, ties = ctx.saved_tensors
        return torch.where(mine, g / ties, torch.zeros_like(g)), None, None


def textcnn_pool_seq(x: torch.Tensor, kernel: torch.Tensor,
                     bias: torch.Tensor, window: int, mesh,
                     axis: str = "model") -> torch.Tensor:
    """Sequence-sharded fused conv + relu + max over time.

    x:      [b, C, E], this model rank's chunk of the time axis (rank m
            holds positions [m * C, (m + 1) * C) of every document)
    kernel: [window * E, F], replicated
    bias:   [F], replicated
    Returns [b, F], replicated over `axis`: the single-device TextCNN's
    pooled output before its FC.
    """
    w = window
    n = mesh.shape[axis]
    bl, c, e = x.shape
    # the halo comes from ONE neighbour: a chunk shorter than the halo
    # cannot supply it
    assert c >= w - 1, (
        f"per-shard chunk {c} < window-1 ({w - 1}); shard the "
        f"sequence over fewer devices or grow input_length")
    ext = _Halo.apply(x, w - 1, mesh, axis) if w > 1 and n > 1 else (
        torch.nn.functional.pad(x, (0, 0, w - 1, w - 1)) if w > 1 else x)
    # every window whose start lies in this rank's halo-extended range:
    # the union over the ranks covers every padded global window
    idx = (torch.arange(c + w - 1, device=x.device)[:, None]
           + torch.arange(w, device=x.device)[None, :])
    win = ext[:, idx, :].reshape(bl, c + w - 1, w * e)
    y = torch.relu(win @ kernel + bias).amax(dim=1)
    if n == 1:
        return y
    return _MaxOverAxis.apply(y, mesh, axis)

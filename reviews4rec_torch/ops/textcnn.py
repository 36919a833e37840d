"""The TextCNN pooling op: `max_t relu(conv1d(x) @ K + b)` with its
first argmax, the hot op of every review tower, and its gradient.

x is [B, T, E] embedded words, K is [W*E, F] tap-major (rows w*E..w*E+E
hold tap w), b is [F]. The doc is zero-padded by W-1 words on both ends,
so there are T+W-1 window starts, windows of padding included. Returns
out [B, F] f32, the max over starts of the ReLU'd conv, and idx [B, F]
int32, the lowest start that reaches it. An optional skip [B, 2] int32
(start, len) zeroes that word span of each doc first.

The gradient routes each (b, f) cotangent, gated by out > 0, to the one
window start idx[b, f] (the JAX package's custom VJP,
`reviews4rec_tpu/ops/textcnn_pallas.py::_bwd`):

    dK[w*E+e, f] = sum_b g[b, f] * x_pad[b, idx[b, f] + w, e]
    db[f]        = sum_b g[b, f]
    dx[b, t, e]  = sum_{f, w: idx[b, f] + w = t + W - 1} g[b, f] * K[w*E+e, f]

with x_pad read as 0 in the padding and inside the skip span, and dx 0
inside the skip span.

- `textcnn_pool_reference` / `textcnn_pool_backward_reference`: the
  plain PyTorch versions (any device). The CPU tests hold them against
  the JAX package, and the GPU checks hold the kernels against them.
- `textcnn_pool`: the op, a `TextCNNPool` autograd function. Its forward
  and its two backward halves each go through a wrapper that runs the
  plain version for a CPU tensor and, for a CUDA tensor, launches its
  kernel or raises: `csrc/textcnn_pool_fwd.cu`,
  `csrc/textcnn_pool_bwd_dg.cu` (dK) and `csrc/textcnn_pool_bwd_dx.cu`
  (dx, only when x needs a gradient). Each launch adds one to that
  kernel's entry of `launches`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

FWD, BWD_DG, BWD_DX = "textcnn_pool_fwd", "textcnn_pool_bwd_dg", \
    "textcnn_pool_bwd_dx"
KERNELS = (FWD, BWD_DG, BWD_DX)

# kernel launches since the counts were last set to 0
launches: Dict[str, int] = {name: 0 for name in KERNELS}


def _span_mask(skip: torch.Tensor, t: int) -> torch.Tensor:
    """[B, T] bool: True inside each row's (start, len) skip span."""
    ts = torch.arange(t, device=skip.device)[None, :]
    st = skip[:, :1].long()
    return (ts >= st) & (ts < st + skip[:, 1:2].long())


def textcnn_pool_reference(x: torch.Tensor, kernel: torch.Tensor,
                           bias: torch.Tensor, window: int = 3,
                           skip: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    b, t, e = x.shape
    if skip is not None:
        x = torch.where(_span_mask(skip, t)[..., None],
                        torch.zeros((), dtype=x.dtype, device=x.device), x)
    halo = window - 1
    t_out = t + halo
    xp = F.pad(x, (0, 0, halo, halo))
    # [B, t_out, E, W] -> tap-major [B, t_out, W*E], one matmul with K
    windows = xp.unfold(1, window, 1).transpose(2, 3).reshape(
        b, t_out, window * e)
    y = torch.relu(windows @ kernel + bias)              # [B, t_out, F]
    out = y.amax(dim=1)
    starts = torch.arange(t_out, device=x.device,
                          dtype=torch.int32)[None, :, None]
    last = torch.full((), t_out, dtype=torch.int32, device=x.device)
    idx = torch.where(y == out[:, None, :], starts, last).amin(dim=1)
    return out, idx


def _taps(idx: torch.Tensor, window: int) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """(batch rows [B, 1, 1], padded positions [B, F, W]) of the W
    winning taps of each (b, f)."""
    b = idx.shape[0]
    tap_t = (idx.long()[:, :, None]
             + torch.arange(window, device=idx.device)[None, None, :])
    return torch.arange(b, device=idx.device)[:, None, None], tap_t


def _dg_reference(x, g, idx, window, skip):
    t, e = x.shape[1], x.shape[2]
    if skip is not None:
        x = torch.where(_span_mask(skip, t)[..., None],
                        torch.zeros((), dtype=x.dtype, device=x.device), x)
    halo = window - 1
    bidx, tap_t = _taps(idx, window)
    taps = F.pad(x, (0, 0, halo, halo))[bidx, tap_t]      # [B, F, W, E]
    return torch.einsum("bfwe,bf->wef", taps, g).reshape(window * e, -1)


def _dx_reference(g, idx, kernel, t, window, skip):
    b, f = g.shape
    e = kernel.shape[0] // window
    halo = window - 1
    bidx, tap_t = _taps(idx, window)
    contrib = torch.einsum("bf,wef->bfwe", g,
                           kernel.reshape(window, e, f))  # [B, F, W, E]
    dxp = torch.zeros((b, t + 2 * halo, e), dtype=g.dtype, device=g.device)
    dxp.index_put_((bidx, tap_t), contrib, accumulate=True)
    dx = dxp[:, halo:halo + t]
    if skip is not None:
        dx = torch.where(_span_mask(skip, t)[..., None],
                         torch.zeros((), dtype=dx.dtype, device=dx.device),
                         dx)
    return dx.contiguous()


def textcnn_pool_backward_reference(
        x: torch.Tensor, kernel: torch.Tensor, g: torch.Tensor,
        idx: torch.Tensor, window: int = 3,
        skip: Optional[torch.Tensor] = None, need_dx: bool = False
) -> Tuple[Optional[torch.Tensor], torch.Tensor, torch.Tensor]:
    """(dx or None, dK, db) from the gated cotangent g [B, F] (already
    `where(out > 0, g, 0)`) and the winning starts idx, written from idx
    as the JAX backward's XLA branch is (`textcnn_pallas.py:702-718`):
    an exact tie between starts is routed to idx alone, not split."""
    dk = _dg_reference(x, g, idx, window, skip)
    dx = (_dx_reference(g, idx, kernel, x.shape[1], window, skip)
          if need_dx else None)
    return dx, dk, g.sum(0)


# ---------------------------------------------------------------------
# kernel wrappers: the plain version for a CPU tensor, else the kernel
# ---------------------------------------------------------------------
def _library(name: str) -> ctypes.CDLL:
    """The built library of `csrc/<name>.cu`, its entry points typed:
    `<name>_f32(5 or 6 pointers, B, T, E, F, W, stream)`,
    `<name>_smem_bytes(E, W)` and `<name>_error_string(code)`."""
    lib = _build.load(name)
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        fn = getattr(lib, f"{name}_f32")
        fn.argtypes = [p] * (6 if name == FWD else 5) + [i] * 5 + [p]
        fn.restype = i
        getattr(lib, f"{name}_smem_bytes").argtypes = [i, i]
        getattr(lib, f"{name}_smem_bytes").restype = ctypes.c_size_t
        getattr(lib, f"{name}_error_string").argtypes = [i]
        getattr(lib, f"{name}_error_string").restype = ctypes.c_char_p
        if name == FWD:
            lib.textcnn_pool_fwd_max_window.argtypes = []
            lib.textcnn_pool_fwd_max_window.restype = i
        lib._typed = True
    return lib


def _launch(name: str, ref: torch.Tensor, pointers, b: int, t: int, e: int,
            f: int, window: int) -> None:
    """Launch `<name>_f32` on the current stream of `ref`'s device, raise
    with the shape and shared-memory figure if CUDA refuses it, and
    count the launch."""
    lib = _library(name)
    with torch.cuda.device(ref.device):
        stream = torch.cuda.current_stream(ref.device).cuda_stream
        err = getattr(lib, f"{name}_f32")(*pointers, b, t, e, f, window,
                                          stream)
    if err != 0:
        smem = getattr(lib, f"{name}_smem_bytes")(e, window)
        raise RuntimeError(
            f"{name} launch failed at B={b}, T={t}, E={e}, F={f}, "
            f"W={window} ({smem} bytes of shared memory per block): "
            f"{getattr(lib, f'{name}_error_string')(err).decode()}")
    launches[name] += 1


def _ptr(ten: Optional[torch.Tensor]):
    return ten.data_ptr() if ten is not None else None


def _check_cuda(what: str, tensors, dtypes) -> None:
    dev = tensors[0][1].device
    if dev.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, not {dev}")
    for (name, ten), dtype in zip(tensors, dtypes):
        if ten is None:
            continue
        if ten.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {ten.dtype}")
        if ten.device != dev:
            raise ValueError(f"{name} lies on {ten.device}, "
                             f"{tensors[0][0]} on {dev}")
        if not ten.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_skip(skip: Optional[torch.Tensor], b: int) -> None:
    if skip is not None and (tuple(skip.shape) != (b, 2)
                             or skip.dtype != torch.int32):
        raise ValueError(f"skip must be int32 [{b}, 2], got "
                         f"{skip.dtype} {tuple(skip.shape)}")


def _check_forward(x, kernel, bias, window, skip) -> None:
    if x.dim() != 3:
        raise ValueError(f"x must be [B, T, E], got {tuple(x.shape)}")
    b, t, e = x.shape
    if kernel.dim() != 2 or kernel.shape[0] != window * e:
        raise ValueError(f"kernel must be [W*E={window * e}, F], got "
                         f"{tuple(kernel.shape)}")
    f = kernel.shape[1]
    if tuple(bias.shape) != (f,):
        raise ValueError(f"bias must be [{f}], got {tuple(bias.shape)}")
    _check_skip(skip, b)
    f32 = torch.float32
    _check_cuda("textcnn_pool", [("x", x), ("kernel", kernel),
                                 ("bias", bias), ("skip", skip)],
                [f32, f32, f32, torch.int32])
    if min(b, t, e, f) < 1:
        raise ValueError(f"empty operand: B={b}, T={t}, E={e}, F={f}")


def textcnn_pool_forward(x: torch.Tensor, kernel: torch.Tensor,
                         bias: torch.Tensor, window: int = 3,
                         skip: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, idx) without autograd: the plain version on the CPU, else
    `csrc/textcnn_pool_fwd.cu`."""
    if x.device.type == "cpu":
        return textcnn_pool_reference(x, kernel, bias, window, skip)
    _check_forward(x, kernel, bias, window, skip)
    b, t, e = x.shape
    f = kernel.shape[1]
    max_window = _library(FWD).textcnn_pool_fwd_max_window()
    if not 1 <= window <= max_window:
        raise ValueError(f"window {window} outside the kernel's "
                         f"1..{max_window}")
    out = torch.empty((b, f), dtype=torch.float32, device=x.device)
    idx = torch.empty((b, f), dtype=torch.int32, device=x.device)
    _launch(FWD, x, (x.data_ptr(), kernel.data_ptr(), bias.data_ptr(),
                     _ptr(skip), out.data_ptr(), idx.data_ptr()),
            b, t, e, f, window)
    return out, idx


def _check_backward(what, g, idx, other, skip, window) -> None:
    b, f = g.shape
    if tuple(idx.shape) != (b, f):
        raise ValueError(f"idx must be [{b}, {f}], got {tuple(idx.shape)}")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    _check_skip(skip, b)
    f32 = torch.float32
    _check_cuda(what, [("g", g), ("idx", idx), other, ("skip", skip)],
                [f32, torch.int32, f32, torch.int32])


def textcnn_pool_bwd_dg(x: torch.Tensor, g: torch.Tensor, idx: torch.Tensor,
                        window: int = 3, skip: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """dK [W*E, F] from the saved x [B, T, E], the gated g [B, F] and
    idx: the plain version on the CPU, else
    `csrc/textcnn_pool_bwd_dg.cu`."""
    if x.device.type == "cpu":
        return _dg_reference(x, g, idx, window, skip)
    if x.dim() != 3 or g.dim() != 2 or x.shape[0] != g.shape[0]:
        raise ValueError(f"x [B, T, E] and g [B, F] expected, got "
                         f"{tuple(x.shape)} and {tuple(g.shape)}")
    _check_backward(BWD_DG, g, idx, ("x", x), skip, window)
    b, t, e = x.shape
    f = g.shape[1]
    dk = torch.empty((window * e, f), dtype=torch.float32, device=x.device)
    _launch(BWD_DG, x, (x.data_ptr(), g.data_ptr(), idx.data_ptr(),
                        _ptr(skip), dk.data_ptr()), b, t, e, f, window)
    return dk


def textcnn_pool_bwd_dx(g: torch.Tensor, idx: torch.Tensor,
                        kernel: torch.Tensor, t: int, window: int = 3,
                        skip: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """dx [B, T, E] from the gated g [B, F], idx and K [W*E, F]: the
    plain version on the CPU, else `csrc/textcnn_pool_bwd_dx.cu`."""
    if g.device.type == "cpu":
        return _dx_reference(g, idx, kernel, t, window, skip)
    if (g.dim() != 2 or kernel.dim() != 2 or kernel.shape[1] != g.shape[1]
            or kernel.shape[0] % window):
        raise ValueError(f"g [B, F] and kernel [W*E, F] expected, got "
                         f"{tuple(g.shape)} and {tuple(kernel.shape)}")
    _check_backward(BWD_DX, g, idx, ("kernel", kernel), skip, window)
    b, f = g.shape
    e = kernel.shape[0] // window
    if min(t, e) < 1:
        raise ValueError(f"empty operand: T={t}, E={e}")
    dx = torch.empty((b, t, e), dtype=torch.float32, device=g.device)
    _launch(BWD_DX, g, (g.data_ptr(), idx.data_ptr(), kernel.data_ptr(),
                        _ptr(skip), dx.data_ptr()), b, t, e, f, window)
    return dx


class TextCNNPool(torch.autograd.Function):
    """(out, idx) of the op, differentiable in x, K and b. The backward
    computes dx only when x needs it (the JAX op's `need_dx`); a tower
    over the frozen word table never asks for it."""

    @staticmethod
    def forward(ctx, x, kernel, bias, window, skip):
        out, idx = textcnn_pool_forward(x, kernel, bias, window, skip)
        ctx.window = window
        ctx.save_for_backward(x, kernel, out, idx, skip)
        ctx.mark_non_differentiable(idx)
        return out, idx

    @staticmethod
    def backward(ctx, g_out, _g_idx):
        x, kernel, out, idx, skip = ctx.saved_tensors
        w = ctx.window
        # ReLU gate: a max clamped to zero passes no gradient
        g = torch.where(out > 0, g_out, torch.zeros((), dtype=g_out.dtype,
                                                    device=g_out.device))
        g = g.contiguous()
        dx = (textcnn_pool_bwd_dx(g, idx, kernel, x.shape[1], w, skip)
              if ctx.needs_input_grad[0] else None)
        dk = (textcnn_pool_bwd_dg(x, g, idx, w, skip)
              if ctx.needs_input_grad[1] else None)
        return dx, dk, g.sum(0), None, None


def textcnn_pool(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                 window: int = 3, skip: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B, F] f32, idx [B, F] int32); see the module docstring."""
    return TextCNNPool.apply(x, kernel, bias, window, skip)

"""The TextCNN pooling op: `max_t relu(conv1d(x) @ K + b)` with its
first argmax, the hot op of every review tower.

x is [B, T, E] embedded words, K is [W*E, F] tap-major (rows w*E..w*E+E
hold tap w), b is [F]. The doc is zero-padded by W-1 words on both ends,
so there are T+W-1 window starts, windows of padding included. Returns
out [B, F] f32, the max over starts of the ReLU'd conv, and idx [B, F]
int32, the lowest start that reaches it. An optional skip [B, 2] int32
(start, len) zeroes that word span of each doc first.

- `textcnn_pool_reference`: the plain PyTorch version (any device). The
  CPU tests hold it against the JAX package, and the GPU checks hold the
  kernel against it.
- `textcnn_pool`: the wrapper. A CPU tensor runs the plain version; a
  CUDA tensor launches `csrc/textcnn_pool_fwd.cu` or raises. Each launch
  adds one to `launches`.

There is no backward yet: the serving path runs at train=False.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

KERNEL = "textcnn_pool_fwd"

# kernel launches since the counter was last set to 0
launches = 0


def textcnn_pool_reference(x: torch.Tensor, kernel: torch.Tensor,
                           bias: torch.Tensor, window: int = 3,
                           skip: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    b, t, e = x.shape
    if skip is not None:
        ts = torch.arange(t, device=x.device)[None, :]
        st = skip[:, :1].long()
        ln = skip[:, 1:2].long()
        x = torch.where(((ts >= st) & (ts < st + ln))[..., None],
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


def _library() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.textcnn_pool_fwd_f32.argtypes = [p, p, p, p, p, p,
                                             i, i, i, i, i, p]
        lib.textcnn_pool_fwd_f32.restype = i
        lib.textcnn_pool_fwd_smem_bytes.argtypes = [i, i]
        lib.textcnn_pool_fwd_smem_bytes.restype = ctypes.c_size_t
        lib.textcnn_pool_fwd_max_window.argtypes = []
        lib.textcnn_pool_fwd_max_window.restype = i
        lib.textcnn_pool_fwd_error_string.argtypes = [i]
        lib.textcnn_pool_fwd_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(x, kernel, bias, window, skip) -> None:
    if x.dim() != 3:
        raise ValueError(f"x must be [B, T, E], got {tuple(x.shape)}")
    b, t, e = x.shape
    if kernel.dim() != 2 or kernel.shape[0] != window * e:
        raise ValueError(f"kernel must be [W*E={window * e}, F], got "
                         f"{tuple(kernel.shape)}")
    f = kernel.shape[1]
    if tuple(bias.shape) != (f,):
        raise ValueError(f"bias must be [{f}], got {tuple(bias.shape)}")
    tensors = [("x", x), ("kernel", kernel), ("bias", bias)]
    for name, ten in tensors:
        if ten.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {ten.dtype}")
    if skip is not None:
        if tuple(skip.shape) != (b, 2) or skip.dtype != torch.int32:
            raise ValueError(f"skip must be int32 [{b}, 2], got "
                             f"{skip.dtype} {tuple(skip.shape)}")
        tensors.append(("skip", skip))
    for name, ten in tensors:
        if ten.device != x.device:
            raise ValueError(f"{name} lies on {ten.device}, x on {x.device}")
        if not ten.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if min(b, t, e, f) < 1:
        raise ValueError(f"empty operand: B={b}, T={t}, E={e}, F={f}")
    if any(ten.requires_grad for _, ten in tensors) and torch.is_grad_enabled():
        raise RuntimeError("textcnn_pool has no backward kernel yet; call it "
                           "under torch.no_grad() or torch.inference_mode()")


def textcnn_pool(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                 window: int = 3, skip: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B, F] f32, idx [B, F] int32); see the module docstring."""
    if x.device.type == "cpu":
        return textcnn_pool_reference(x, kernel, bias, window, skip)
    if x.device.type != "cuda":
        raise ValueError(f"textcnn_pool runs on cpu or cuda, not {x.device}")
    _check(x, kernel, bias, window, skip)
    b, t, e = x.shape
    f = kernel.shape[1]
    out = torch.empty((b, f), dtype=torch.float32, device=x.device)
    idx = torch.empty((b, f), dtype=torch.int32, device=x.device)
    lib = _library()
    if not 1 <= window <= lib.textcnn_pool_fwd_max_window():
        raise ValueError(f"window {window} outside the kernel's 1.."
                         f"{lib.textcnn_pool_fwd_max_window()}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.textcnn_pool_fwd_f32(
            x.data_ptr(), kernel.data_ptr(), bias.data_ptr(),
            skip.data_ptr() if skip is not None else None,
            out.data_ptr(), idx.data_ptr(), b, t, e, f, window, stream)
    if err != 0:
        smem = lib.textcnn_pool_fwd_smem_bytes(e, window)
        raise RuntimeError(
            f"{KERNEL} launch failed at B={b}, T={t}, E={e}, F={f}, "
            f"W={window} ({smem} bytes of shared memory per block): "
            f"{lib.textcnn_pool_fwd_error_string(err).decode()}")
    global launches
    launches += 1
    return out, idx

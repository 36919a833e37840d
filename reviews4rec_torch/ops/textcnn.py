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
  kernel's entry of `launches`. Where a gradient will be routed (K or x
  needs one), idx is held to exact arithmetic at max-pool near-ties:
  for each (b, f) whose best and second values (the second: the largest
  of a start other than idx's, equal values included) lie within
  `TIE_TOL` x max(1, out) of each other, idx is the first start of the
  largest window value recomputed in float64. The forward kernel does
  that itself (`refine`); on the CPU `refine_ties` does it after the
  plain version, and it is the kernel's plain version. The kernel's
  3xTF32 sums sit up to about 1.4e-6 from float64 at NARRE's shape
  (f32's own, about 1e-7), enough to give a window of a near-tie the
  gradient that exact arithmetic gives its rival.
- `textcnn_pool_rows`: the same op on `table[rows]` of a whole [N, T, E]
  entity doc table (the entity doc cache under `hp.pallas_fuse_rows`),
  a `TextCNNPoolRows` autograd function differentiable in K and b only.
  Its two kernels read each row straight from the table, so the
  [B, T, E] copy `table[rows]` never exists: the row-gathered
  instantiations of the forward and dG kernels, in the same two sources,
  `textcnn_pool_fwd_rows` and `textcnn_pool_bwd_dg_rows`. Their plain
  version is `textcnn_pool_rows_reference`, the op on `table[rows]`.
- `textcnn_pool_embed`: the same op on `table[ids]` of a frozen [V, E]
  word table and [B, T] int32 word ids (the fused word gather under
  `hp.pallas_fuse_gather`; the JAX package's `textcnn_pool_embed`), a
  `TextCNNPoolEmbed` autograd function differentiable in K and b only.
  Its kernels, the word-gathered instantiations `textcnn_pool_fwd_ids`
  and `textcnn_pool_bwd_dg_ids` of the same two sources, read each word
  straight from the table, so the [B, T, E] doc never exists. Its plain
  version is `textcnn_pool_embed_reference`, the op on `table[ids]`, and
  `textcnn_pool_embed_backward_reference` its (dK, db).

The three forms of the forward and of the dG share one kernel body each,
so the rows and ids forms give the bits of the plain-x kernels on
`table[rows]` and `table[ids]`.

- `textcnn_pool(..., dtype=torch.bfloat16)` or `dtype=torch.float16`:
  the op with 16-bit operands, as the JAX package's XLA TextCNN branch
  computes it at `compute_dtype="bfloat16"` or `"float16"`
  (`reviews4rec_tpu/models/layers.py:174-187`), a `TextCNNPool16`
  autograd function. x and K are cast to the 16-bit type, the conv sums
  in f32 and the bias is added in f32. Its forward is
  `textcnn_pool_fwd_bf16` or `textcnn_pool_fwd_f16` (two instantiations
  of one body in `csrc/textcnn_pool_fwd.cu`, one 16-bit `mma.sync` pass);
  its dK is `textcnn_pool_bwd_dg_bf16` or `textcnn_pool_bwd_dg_f16`
  (`csrc/textcnn_pool_bwd_dg.cu`, the dG body on 16-bit x), each value
  the f32 sum rounded to the 16-bit type once, as JAX's cotangent of
  `kernel.astype(dtype)` is; db is the f32 sum of g, unrounded. Where x
  needs a gradient, dx is the f32 dx kernel on the 16-bit values of K,
  rounded to the 16-bit type (the cotangent of `x.astype(dtype)`). The
  wrappers take the 16-bit type first: `textcnn_pool_forward_16(dtype,
  ...)` and `textcnn_pool_bwd_dg_16(dtype, ...)`, with the plain versions
  `textcnn_pool_16_reference` (the f32 plain forward on the 16-bit
  values) and `textcnn_pool_16_dg_reference` (the f32 plain dG on the
  16-bit values of x, rounded to the 16-bit type).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

FWD, BWD_DG, BWD_DX = "textcnn_pool_fwd", "textcnn_pool_bwd_dg", \
    "textcnn_pool_bwd_dx"
FWD_ROWS, BWD_DG_ROWS = "textcnn_pool_fwd_rows", "textcnn_pool_bwd_dg_rows"
FWD_IDS, BWD_DG_IDS = "textcnn_pool_fwd_ids", "textcnn_pool_bwd_dg_ids"
FWD_BF16, BWD_DG_BF16 = "textcnn_pool_fwd_bf16", "textcnn_pool_bwd_dg_bf16"
FWD_F16, BWD_DG_F16 = "textcnn_pool_fwd_f16", "textcnn_pool_bwd_dg_f16"
KERNELS = (FWD, BWD_DG, BWD_DX, FWD_ROWS, BWD_DG_ROWS, FWD_IDS, BWD_DG_IDS,
           FWD_BF16, BWD_DG_BF16, FWD_F16, BWD_DG_F16)
# the source `csrc/<source>.cu` that holds each kernel's entry point
SOURCE = {FWD: FWD, BWD_DG: BWD_DG, BWD_DX: BWD_DX, FWD_ROWS: FWD,
          BWD_DG_ROWS: BWD_DG, FWD_IDS: FWD, BWD_DG_IDS: BWD_DG,
          FWD_BF16: FWD, BWD_DG_BF16: BWD_DG, FWD_F16: FWD,
          BWD_DG_F16: BWD_DG}
# (pointer, int) argument counts of each entry point, before its stream
_ARGS = {FWD: (8, 6), BWD_DG: (7, 5), BWD_DX: (6, 5), FWD_ROWS: (7, 6),
         BWD_DG_ROWS: (8, 6), FWD_IDS: (6, 6), BWD_DG_IDS: (7, 6),
         FWD_BF16: (6, 5), BWD_DG_BF16: (7, 5), FWD_F16: (6, 5),
         BWD_DG_F16: (7, 5)}
# the sizes each source's `<source>_smem_bytes` takes, in order
_SMEM_ARGS = {FWD: ("E", "W"), BWD_DG: ("E", "W"), BWD_DX: ("W", "F")}
# the (forward, dG) kernels of each 16-bit operand type
KERNELS_16 = {torch.bfloat16: (FWD_BF16, BWD_DG_BF16),
              torch.float16: (FWD_F16, BWD_DG_F16)}


def _entry(name: str) -> str:
    """The C entry point of kernel `name`: `<name>` for the 16-bit
    kernels, `<name>_f32` for the others."""
    return name if name.endswith(("_bf16", "_f16")) else f"{name}_f32"


def _smem_fn(name: str) -> str:
    """The C function that gives the shared memory of kernel `name`."""
    return (f"{FWD}_16_smem_bytes" if name in (FWD_BF16, FWD_F16)
            else f"{SOURCE[name]}_smem_bytes")


# kernel launches since the counts were last set to 0
launches: Dict[str, int] = {name: 0 for name in KERNELS}
# the dG kernel's workspace by (device, stream): f32 sums of the batch
# slices and int32 per-filter counters, zeroed once, which every launch
# leaves 0 again; launches on one stream run in turn, so they share it
_dg_workspaces: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}
# the forward's near-tie list by (device, stream), as the dG workspace: four
# int32 counters, zeroed once and left 0 by every launch, then the list's
# (row, filter) pairs
_tie_workspaces: Dict[Tuple[int, int], torch.Tensor] = {}


def _span_mask(skip: torch.Tensor, t: int) -> torch.Tensor:
    """[B, T] bool: True inside each row's (start, len) skip span."""
    ts = torch.arange(t, device=skip.device)[None, :]
    st = skip[:, :1].long()
    return (ts >= st) & (ts < st + skip[:, 1:2].long())


def textcnn_pool_reference(x: torch.Tensor, kernel: torch.Tensor,
                           bias: torch.Tensor, window: int = 3,
                           skip: Optional[torch.Tensor] = None,
                           second: bool = False):
    """(out, idx), and with `second` the second value too: the largest
    value of a start other than idx's, equal values included (-1 where
    there is none)."""
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
    if not second:
        return out, idx
    others = y.scatter(1, idx[:, None, :].long(),
                       torch.full((), -1.0, dtype=y.dtype, device=y.device)
                       .expand(b, 1, y.shape[2]))
    return out, idx, torch.maximum(others.amax(dim=1),
                                   torch.full_like(out, -1.0))


# a (b, f) is a near-tie when out - second <= TIE_TOL * max(1, out):
# seven times the largest gap between the forward kernel's window values
# and float64 that chip_smoke.py reads at NARRE's shape (1.4e-6)
TIE_TOL = 1e-5


def near_ties(out: torch.Tensor, second: torch.Tensor, bias: torch.Tensor
              ) -> torch.Tensor:
    """[B, F] bool: out > 0, out - second <= TIE_TOL * max(1, out), and
    out is not relu(bias[f]), the value every all-zero window gives
    exactly (windows of equal content, whose tie the first start takes
    in any precision)."""
    return ((out > 0) & (out - second <= TIE_TOL * torch.clamp(out, min=1.0))
            & (out != torch.relu(bias)[None, :]))


def refine_ties(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                window: int, skip: Optional[torch.Tensor], out: torch.Tensor,
                idx: torch.Tensor, second: torch.Tensor) -> torch.Tensor:
    """idx with each near-tie (b, f) (`near_ties`) taken from float64:
    the first start of the largest window value of that (b, f), each
    window summed in float64. The plain version of the forward kernel's
    `refine`."""
    rows, cols = near_ties(out, second, bias).nonzero(as_tuple=True)
    if rows.numel() == 0:
        return idx
    t, e = x.shape[1], x.shape[2]
    xs = x.index_select(0, rows)
    if skip is not None:
        xs = torch.where(_span_mask(skip.index_select(0, rows), t)[..., None],
                         torch.zeros((), dtype=xs.dtype, device=xs.device),
                         xs)
    halo = window - 1
    xp = F.pad(xs.double(), (0, 0, halo, halo))            # [n, T+2h, E]
    taps = kernel.double().reshape(window, e, -1)[:, :, cols]  # [W, E, n]
    per_tap = torch.bmm(xp, taps.permute(2, 1, 0))        # [n, T+2h, W]
    t_out = t + halo
    vals = sum(per_tap[:, w:w + t_out, w] for w in range(window))
    vals = torch.relu(vals + bias.double()[cols][:, None])
    starts = torch.arange(t_out, device=x.device, dtype=idx.dtype)[None, :]
    first = torch.where(vals == vals.amax(dim=1, keepdim=True), starts,
                        torch.full((), t_out, dtype=idx.dtype,
                                   device=x.device)).amin(dim=1)
    refined = idx.clone()
    refined[rows, cols] = first
    return refined


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


def take_rows(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """table[rows] (rows of any shape), raising IndexError for a row
    outside [0, N) (plain indexing would wrap a negative one)."""
    n = table.shape[0]
    if rows.numel() and not (0 <= int(rows.min()) and int(rows.max()) < n):
        raise IndexError(f"rows must lie in [0, {n}), got "
                         f"{int(rows.min())}..{int(rows.max())}")
    return table[rows.long()]


def textcnn_pool_rows_reference(table: torch.Tensor, rows: torch.Tensor,
                                kernel: torch.Tensor, bias: torch.Tensor,
                                window: int = 3,
                                skip: Optional[torch.Tensor] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, idx) of the op on table[rows] ([N, T, E] table, [B] rows),
    the plain version of the row-gathered forward kernel."""
    return textcnn_pool_reference(take_rows(table, rows), kernel, bias,
                                  window, skip)


def textcnn_pool_embed_reference(ids: torch.Tensor, table: torch.Tensor,
                                 kernel: torch.Tensor, bias: torch.Tensor,
                                 window: int = 3
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, idx) of the op on table[ids] ([V, E] table, [B, T] ids),
    the plain version of the word-gathered forward kernel."""
    return textcnn_pool_reference(take_rows(table, ids), kernel, bias,
                                  window)


def textcnn_pool_embed_backward_reference(
        ids: torch.Tensor, table: torch.Tensor, g: torch.Tensor,
        idx: torch.Tensor, window: int = 3
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, db) of the op on table[ids] from the gated g [B, F] and idx:
    the W winning taps regathered from the ids, as the JAX package's
    `_bwd_embed` does; the table gets no gradient."""
    return _dg_reference(take_rows(table, ids), g, idx, window, None), \
        g.sum(0)


def _values_16(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The f32 tensor of t's rounding to the 16-bit `dtype` (to nearest
    even; at float16 subnormals are kept, as JAX's convert keeps them)."""
    return t.to(dtype).float()


def textcnn_pool_16_reference(dtype: torch.dtype, x: torch.Tensor,
                              kernel: torch.Tensor, bias: torch.Tensor,
                              window: int = 3,
                              skip: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, idx) of the op on the values of x and K (any float type) at
    the 16-bit `dtype`, summed in f32: the plain version of that type's
    forward kernel."""
    return textcnn_pool_reference(_values_16(x, dtype),
                                  _values_16(kernel, dtype), bias, window,
                                  skip)


def textcnn_pool_16_dg_reference(dtype: torch.dtype, x: torch.Tensor,
                                 g: torch.Tensor, idx: torch.Tensor,
                                 window: int = 3,
                                 skip: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """dK [W*E, F] f32 of the op on the values of x at the 16-bit
    `dtype`, summed in f32 and rounded to that type once: the plain
    version of that type's dG kernel."""
    return _values_16(_dg_reference(_values_16(x, dtype), g, idx, window,
                                    skip), dtype)


# ---------------------------------------------------------------------
# kernel wrappers: the plain version for a CPU tensor, else the kernel
# ---------------------------------------------------------------------
def _library(name: str) -> ctypes.CDLL:
    """The built library of kernel `name`'s source, its entry points
    typed: `_entry(name)(pointers, [N,] B, T, E, F, W, stream)`, its
    `_smem_fn(name)(*_SMEM_ARGS[source])` and the source's
    `<source>_error_string(code)`."""
    src = SOURCE[name]
    lib = _build.load(src)
    typed = getattr(lib, "_typed", set())
    if name not in typed:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn = getattr(lib, _entry(name))
        pointers, ints = _ARGS[name]
        fn.argtypes = [p] * pointers + [i] * ints + [p]
        fn.restype = i
        getattr(lib, _smem_fn(name)).argtypes = [i] * len(_SMEM_ARGS[src])
        getattr(lib, _smem_fn(name)).restype = ctypes.c_size_t
        getattr(lib, f"{src}_error_string").argtypes = [i]
        getattr(lib, f"{src}_error_string").restype = ctypes.c_char_p
        if src == FWD:
            lib.textcnn_pool_fwd_max_window.argtypes = []
            lib.textcnn_pool_fwd_max_window.restype = i
        if src == BWD_DG:
            lib.textcnn_pool_bwd_dg_slice_rows.argtypes = [i, i]
            lib.textcnn_pool_bwd_dg_slice_rows.restype = i
        lib._typed = typed | {name}
    return lib


def _launch(name: str, ref: torch.Tensor, pointers,
            dims: Dict[str, int]) -> None:
    """Launch `_entry(name)` with the sizes `dims` ([N,] B, T, E, F, W,
    in that order) on the current stream of `ref`'s device, raise with the
    shape and shared-memory figure if CUDA refuses it, and count the
    launch."""
    lib = _library(name)
    src = SOURCE[name]
    with torch.cuda.device(ref.device):
        stream = torch.cuda.current_stream(ref.device).cuda_stream
        err = getattr(lib, _entry(name))(*pointers, *dims.values(), stream)
    if err != 0:
        smem = getattr(lib, _smem_fn(name))(
            *(dims[k] for k in _SMEM_ARGS[src]))
        shape = ", ".join(f"{k}={v}" for k, v in dims.items())
        raise RuntimeError(
            f"{name} launch failed at {shape} ({smem} bytes of shared "
            f"memory per block): "
            f"{getattr(lib, f'{src}_error_string')(err).decode()}")
    launches[name] += 1


def _ptr(ten: Optional[torch.Tensor]):
    return ten.data_ptr() if ten is not None else None


@functools.lru_cache(maxsize=256)
def dg_slice_rows(b: int, f: int) -> int:
    """Batch rows per slice of the dG kernel at B rows and F filters: a
    block per filter and slice, the slices' sums added in slice order."""
    return _library(BWD_DG).textcnn_pool_bwd_dg_slice_rows(b, f)


def _dg_workspace(ref: torch.Tensor, b: int, f: int, span: int
                  ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(partial, counter) of a dG launch on the current stream: room for
    f32 [slices, F, W*E] slice sums and int32 [F] counters, or (None,
    None) when one slice covers the batch."""
    rows = dg_slice_rows(b, f)
    slices = -(-b // rows) if rows > 0 else 1
    if slices == 1:
        return None, None
    dev = ref.device
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    partial, counter = _dg_workspaces.get(key, (None, None))
    if partial is None or partial.numel() < slices * f * span:
        partial = torch.empty(slices * f * span, dtype=torch.float32,
                              device=dev)
    if counter is None or counter.numel() < f:
        counter = torch.zeros(f, dtype=torch.int32, device=dev)
    _dg_workspaces[key] = partial, counter
    return partial, counter


def _tie_workspace(ref: torch.Tensor, n: int) -> torch.Tensor:
    """The forward's near-tie list on the current stream: int32, at least
    `n` long, its first four values 0."""
    dev = ref.device
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    ties = _tie_workspaces.get(key)
    if ties is None or ties.numel() < n:
        ties = torch.zeros(n, dtype=torch.int32, device=dev)
        _tie_workspaces[key] = ties
    return ties


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


def _check_forward(x, kernel, bias, window, skip, rows=None,
                   dtype=torch.float32) -> None:
    """x is [B, T, E], or with `rows` [B] int32 a [N, T, E] table; x and
    the kernel of type `dtype`, the bias f32."""
    if x.dim() != 3:
        raise ValueError(f"x must be [B, T, E] (a table [N, T, E] with "
                         f"rows), got {tuple(x.shape)}")
    if rows is not None and rows.dim() != 1:
        raise ValueError(f"rows must be [B], got {tuple(rows.shape)}")
    b = x.shape[0] if rows is None else rows.shape[0]
    t, e = x.shape[1], x.shape[2]
    if kernel.dim() != 2 or kernel.shape[0] != window * e:
        raise ValueError(f"kernel must be [W*E={window * e}, F], got "
                         f"{tuple(kernel.shape)}")
    f = kernel.shape[1]
    if tuple(bias.shape) != (f,):
        raise ValueError(f"bias must be [{f}], got {tuple(bias.shape)}")
    _check_skip(skip, b)
    _check_cuda("textcnn_pool", [("x", x), ("kernel", kernel),
                                 ("bias", bias), ("skip", skip),
                                 ("rows", rows)],
                [dtype, dtype, torch.float32, torch.int32, torch.int32])
    if min(x.shape[0], b, t, e, f) < 1:
        raise ValueError(f"empty operand: {x.shape[0]} rows, B={b}, "
                         f"T={t}, E={e}, F={f}")


def textcnn_pool_forward(x: torch.Tensor, kernel: torch.Tensor,
                         bias: torch.Tensor, window: int = 3,
                         skip: Optional[torch.Tensor] = None,
                         second: bool = False, refine: bool = False):
    """(out, idx) without autograd, and with `second` the second value
    [B, F] too (`textcnn_pool_reference`'s); with `refine`, idx of each
    near-tie from float64 (`refine_ties`): the plain version on the CPU,
    else `csrc/textcnn_pool_fwd.cu`."""
    if x.device.type == "cpu":
        if not (second or refine):
            return textcnn_pool_reference(x, kernel, bias, window, skip)
        out, idx, sec = textcnn_pool_reference(x, kernel, bias, window, skip,
                                               second=True)
        if refine:
            idx = refine_ties(x, kernel, bias, window, skip, out, idx, sec)
        return (out, idx, sec) if second else (out, idx)
    _check_forward(x, kernel, bias, window, skip)
    b, t, e = x.shape
    f = kernel.shape[1]
    max_window = _library(FWD).textcnn_pool_fwd_max_window()
    if not 1 <= window <= max_window:
        raise ValueError(f"window {window} outside the kernel's "
                         f"1..{max_window}")
    out = torch.empty((b, f), dtype=torch.float32, device=x.device)
    idx = torch.empty((b, f), dtype=torch.int32, device=x.device)
    sec = (torch.empty((b, f), dtype=torch.float32, device=x.device)
           if second else None)
    ties = _tie_workspace(x, 4 + 2 * b * f) if refine else None
    _launch(FWD, x, (x.data_ptr(), kernel.data_ptr(), bias.data_ptr(),
                     _ptr(skip), out.data_ptr(), idx.data_ptr(), _ptr(sec),
                     _ptr(ties)),
            dict(B=b, T=t, E=e, F=f, W=window, refine=int(refine)))
    return (out, idx, sec) if second else (out, idx)


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
    partial, counter = _dg_workspace(x, b, f, window * e)
    _launch(BWD_DG, x, (x.data_ptr(), g.data_ptr(), idx.data_ptr(),
                        _ptr(skip), dk.data_ptr(), _ptr(partial),
                        _ptr(counter)),
            dict(B=b, T=t, E=e, F=f, W=window))
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
    # scratch the launch fills with K transposed, [F, W*E]
    kt = torch.empty(kernel.numel(), dtype=torch.float32, device=g.device)
    _launch(BWD_DX, g, (g.data_ptr(), idx.data_ptr(), kernel.data_ptr(),
                        _ptr(skip), dx.data_ptr(), kt.data_ptr()),
            dict(B=b, T=t, E=e, F=f, W=window))
    return dx


def textcnn_pool_fwd_rows(table: torch.Tensor, rows: torch.Tensor,
                          kernel: torch.Tensor, bias: torch.Tensor,
                          window: int = 3,
                          skip: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, idx) of the op on table[rows] without autograd: the plain
    version on the CPU, else the row-gathered instantiation of
    `csrc/textcnn_pool_fwd.cu`. On the card a row outside [0, N) gives
    NaN in `out` and -1 in `idx` for its batch row."""
    if table.device.type == "cpu":
        return textcnn_pool_rows_reference(table, rows, kernel, bias, window,
                                           skip)
    _check_forward(table, kernel, bias, window, skip, rows)
    n, t, e = table.shape
    b, f = rows.shape[0], kernel.shape[1]
    max_window = _library(FWD_ROWS).textcnn_pool_fwd_max_window()
    if not 1 <= window <= max_window:
        raise ValueError(f"window {window} outside the kernel's "
                         f"1..{max_window}")
    out = torch.empty((b, f), dtype=torch.float32, device=table.device)
    idx = torch.empty((b, f), dtype=torch.int32, device=table.device)
    _launch(FWD_ROWS, table, (table.data_ptr(), rows.data_ptr(),
                              kernel.data_ptr(), bias.data_ptr(), _ptr(skip),
                              out.data_ptr(), idx.data_ptr()),
            dict(N=n, B=b, T=t, E=e, F=f, W=window))
    return out, idx


def textcnn_pool_bwd_dg_rows(table: torch.Tensor, rows: torch.Tensor,
                             g: torch.Tensor, idx: torch.Tensor,
                             window: int = 3,
                             skip: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """dK [W*E, F] of the op on table[rows] from the gated g [B, F] and
    idx: the plain version on the CPU, else the row-gathered
    instantiation of `csrc/textcnn_pool_bwd_dg.cu`."""
    if table.device.type == "cpu":
        return _dg_reference(take_rows(table, rows), g, idx, window, skip)
    if (table.dim() != 3 or rows.dim() != 1 or g.dim() != 2
            or rows.shape[0] != g.shape[0]):
        raise ValueError(f"table [N, T, E], rows [B] and g [B, F] expected, "
                         f"got {tuple(table.shape)}, {tuple(rows.shape)} "
                         f"and {tuple(g.shape)}")
    _check_backward(BWD_DG_ROWS, g, idx, ("table", table), skip, window)
    _check_cuda(BWD_DG_ROWS, [("table", table), ("rows", rows)],
                [torch.float32, torch.int32])
    n, t, e = table.shape
    b, f = g.shape
    dk = torch.empty((window * e, f), dtype=torch.float32, device=g.device)
    partial, counter = _dg_workspace(table, b, f, window * e)
    _launch(BWD_DG_ROWS, table, (table.data_ptr(), rows.data_ptr(),
                                 g.data_ptr(), idx.data_ptr(), _ptr(skip),
                                 dk.data_ptr(), _ptr(partial),
                                 _ptr(counter)),
            dict(N=n, B=b, T=t, E=e, F=f, W=window))
    return dk


def _check_embed(ids: torch.Tensor, table: torch.Tensor) -> None:
    if ids.dim() != 2 or table.dim() != 2:
        raise ValueError(f"ids [B, T] and table [V, E] expected, got "
                         f"{tuple(ids.shape)} and {tuple(table.shape)}")
    _check_cuda("textcnn_pool_embed", [("table", table), ("ids", ids)],
                [torch.float32, torch.int32])


def textcnn_pool_fwd_ids(ids: torch.Tensor, table: torch.Tensor,
                         kernel: torch.Tensor, bias: torch.Tensor,
                         window: int = 3
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, idx) of the op on table[ids] without autograd: the plain
    version on the CPU, else the word-gathered instantiation of
    `csrc/textcnn_pool_fwd.cu`. On the card an id outside [0, V) gives
    NaN in `out` and -1 in `idx` for its batch row."""
    if table.device.type == "cpu":
        return textcnn_pool_embed_reference(ids, table, kernel, bias, window)
    _check_embed(ids, table)
    v, e = table.shape
    b, t = ids.shape
    # the table's rows as docs of one word: K, bias, types, layout
    _check_forward(table.view(v, 1, e), kernel, bias, window, None)
    if min(b, t) < 1:
        raise ValueError(f"empty operand: B={b}, T={t}")
    f = kernel.shape[1]
    max_window = _library(FWD_IDS).textcnn_pool_fwd_max_window()
    if not 1 <= window <= max_window:
        raise ValueError(f"window {window} outside the kernel's "
                         f"1..{max_window}")
    out = torch.empty((b, f), dtype=torch.float32, device=table.device)
    idx = torch.empty((b, f), dtype=torch.int32, device=table.device)
    _launch(FWD_IDS, table, (table.data_ptr(), ids.data_ptr(),
                             kernel.data_ptr(), bias.data_ptr(),
                             out.data_ptr(), idx.data_ptr()),
            dict(V=v, B=b, T=t, E=e, F=f, W=window))
    return out, idx


def textcnn_pool_bwd_dg_ids(ids: torch.Tensor, table: torch.Tensor,
                            g: torch.Tensor, idx: torch.Tensor,
                            window: int = 3) -> torch.Tensor:
    """dK [W*E, F] of the op on table[ids] from the gated g [B, F] and
    idx: the plain version on the CPU, else the word-gathered
    instantiation of `csrc/textcnn_pool_bwd_dg.cu` (W <= 8)."""
    if table.device.type == "cpu":
        return textcnn_pool_embed_backward_reference(ids, table, g, idx,
                                                     window)[0]
    if g.dim() != 2 or ids.dim() != 2 or ids.shape[0] != g.shape[0]:
        raise ValueError(f"ids [B, T] and g [B, F] expected, got "
                         f"{tuple(ids.shape)} and {tuple(g.shape)}")
    _check_embed(ids, table)
    _check_backward(BWD_DG_IDS, g, idx, ("table", table), None, window)
    v, e = table.shape
    b, t = ids.shape
    f = g.shape[1]
    dk = torch.empty((window * e, f), dtype=torch.float32, device=g.device)
    partial, counter = _dg_workspace(table, b, f, window * e)
    _launch(BWD_DG_IDS, table, (table.data_ptr(), ids.data_ptr(),
                                g.data_ptr(), idx.data_ptr(), dk.data_ptr(),
                                _ptr(partial), _ptr(counter)),
            dict(V=v, B=b, T=t, E=e, F=f, W=window))
    return dk


def textcnn_pool_forward_16(dtype: torch.dtype, x: torch.Tensor,
                            kernel: torch.Tensor, bias: torch.Tensor,
                            window: int = 3,
                            skip: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, idx) without autograd from x [B, T, E] and K [W*E, F] of the
    16-bit `dtype` and f32 bias: the plain version on the CPU, else that
    type's instantiation of the 16-bit body of `csrc/textcnn_pool_fwd.cu`
    (`textcnn_pool_fwd_bf16` or `textcnn_pool_fwd_f16`, W <= 8)."""
    if x.device.type == "cpu":
        return textcnn_pool_16_reference(dtype, x, kernel, bias, window,
                                         skip)
    name = KERNELS_16[dtype][0]
    _check_forward(x, kernel, bias, window, skip, dtype=dtype)
    b, t, e = x.shape
    f = kernel.shape[1]
    max_window = _library(name).textcnn_pool_fwd_max_window()
    if not 1 <= window <= max_window:
        raise ValueError(f"window {window} outside the kernel's "
                         f"1..{max_window}")
    out = torch.empty((b, f), dtype=torch.float32, device=x.device)
    idx = torch.empty((b, f), dtype=torch.int32, device=x.device)
    _launch(name, x, (x.data_ptr(), kernel.data_ptr(), bias.data_ptr(),
                      _ptr(skip), out.data_ptr(), idx.data_ptr()),
            dict(B=b, T=t, E=e, F=f, W=window))
    return out, idx


def textcnn_pool_bwd_dg_16(dtype: torch.dtype, x: torch.Tensor,
                           g: torch.Tensor, idx: torch.Tensor,
                           window: int = 3,
                           skip: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """dK [W*E, F] f32 holding values of the 16-bit `dtype`, from x
    [B, T, E] of that type, the gated f32 g [B, F] and idx: the plain
    version on the CPU, else that type's instantiation of
    `csrc/textcnn_pool_bwd_dg.cu` (`textcnn_pool_bwd_dg_bf16` or
    `textcnn_pool_bwd_dg_f16`)."""
    if x.device.type == "cpu":
        return textcnn_pool_16_dg_reference(dtype, x, g, idx, window, skip)
    name = KERNELS_16[dtype][1]
    if x.dim() != 3 or g.dim() != 2 or x.shape[0] != g.shape[0]:
        raise ValueError(f"x [B, T, E] and g [B, F] expected, got "
                         f"{tuple(x.shape)} and {tuple(g.shape)}")
    _check_backward(name, g, idx, ("g", g), skip, window)
    _check_cuda(name, [("x", x)], [dtype])
    b, t, e = x.shape
    f = g.shape[1]
    dk = torch.empty((window * e, f), dtype=torch.float32, device=x.device)
    partial, counter = _dg_workspace(x, b, f, window * e)
    _launch(name, x, (x.data_ptr(), g.data_ptr(), idx.data_ptr(),
                      _ptr(skip), dk.data_ptr(), _ptr(partial),
                      _ptr(counter)),
            dict(B=b, T=t, E=e, F=f, W=window))
    return dk


class TextCNNPool(torch.autograd.Function):
    """(out, idx) of the op, differentiable in x, K and b. The backward
    computes dx only when x needs it (the JAX op's `need_dx`); a tower
    over the frozen word table never asks for it. Where x or K needs a
    gradient, idx is refined at near-ties (the forward's `refine`)
    before it is saved and returned."""

    @staticmethod
    def forward(ctx, x, kernel, bias, window, skip):
        out, idx = textcnn_pool_forward(
            x, kernel, bias, window, skip,
            refine=ctx.needs_input_grad[0] or ctx.needs_input_grad[1])
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


class TextCNNPoolRows(torch.autograd.Function):
    """(out, idx) of the op on table[rows], differentiable in K and b
    only (the JAX op returns zeros for the table and no cotangent for
    rows). The table is the frozen entity doc cache; a table that needs
    a gradient is refused, since the op has no dx."""

    @staticmethod
    def forward(ctx, table, rows, kernel, bias, window, skip):
        if table.requires_grad:
            raise ValueError("textcnn_pool_rows computes no gradient for its "
                             "table; gather table[rows] and use textcnn_pool")
        out, idx = textcnn_pool_fwd_rows(table, rows, kernel, bias, window,
                                         skip)
        ctx.window = window
        ctx.save_for_backward(table, rows, out, idx, skip)
        ctx.mark_non_differentiable(idx)
        return out, idx

    @staticmethod
    def backward(ctx, g_out, _g_idx):
        table, rows, out, idx, skip = ctx.saved_tensors
        g = torch.where(out > 0, g_out, torch.zeros((), dtype=g_out.dtype,
                                                    device=g_out.device))
        g = g.contiguous()
        dk = (textcnn_pool_bwd_dg_rows(table, rows, g, idx, ctx.window, skip)
              if ctx.needs_input_grad[2] else None)
        return None, None, dk, g.sum(0), None, None


class TextCNNPoolEmbed(torch.autograd.Function):
    """(out, idx) of the op on table[ids], differentiable in K and b only:
    the ids are integers and the word table is frozen (the JAX op gives
    it a zero cotangent; here it gets none)."""

    @staticmethod
    def forward(ctx, ids, table, kernel, bias, window):
        out, idx = textcnn_pool_fwd_ids(ids, table, kernel, bias, window)
        ctx.window = window
        ctx.save_for_backward(ids, table, out, idx)
        ctx.mark_non_differentiable(idx)
        return out, idx

    @staticmethod
    def backward(ctx, g_out, _g_idx):
        ids, table, out, idx = ctx.saved_tensors
        g = torch.where(out > 0, g_out, torch.zeros((), dtype=g_out.dtype,
                                                    device=g_out.device))
        g = g.contiguous()
        dk = (textcnn_pool_bwd_dg_ids(ids, table, g, idx, ctx.window)
              if ctx.needs_input_grad[2] else None)
        return None, None, dk, g.sum(0), None


class TextCNNPool16(torch.autograd.Function):
    """(out, idx) of the op on the values of x and K in the 16-bit
    `dtype` (bfloat16 or float16), differentiable in x, K and b: dK is
    that type's dG kernel's (16-bit values in f32), dx (only when x needs
    it) the f32 dx kernel on the 16-bit values of K, rounded to the
    16-bit type, and db the f32 sum of the gated g."""

    @staticmethod
    def forward(ctx, x, kernel, bias, window, skip, dtype):
        xh = x.to(dtype).contiguous()
        kh = kernel.to(dtype).contiguous()
        out, idx = textcnn_pool_forward_16(dtype, xh, kh, bias, window,
                                           skip)
        ctx.window, ctx.dtype = window, dtype
        ctx.save_for_backward(xh, kh, out, idx, skip)
        ctx.mark_non_differentiable(idx)
        return out, idx

    @staticmethod
    def backward(ctx, g_out, _g_idx):
        xh, kh, out, idx, skip = ctx.saved_tensors
        w, dtype = ctx.window, ctx.dtype
        g = torch.where(out > 0, g_out, torch.zeros((), dtype=g_out.dtype,
                                                    device=g_out.device))
        g = g.contiguous()
        dx = (_values_16(textcnn_pool_bwd_dx(g, idx, kh.float(),
                                             xh.shape[1], w, skip), dtype)
              if ctx.needs_input_grad[0] else None)
        dk = (textcnn_pool_bwd_dg_16(dtype, xh, g, idx, w, skip)
              if ctx.needs_input_grad[1] else None)
        return dx, dk, g.sum(0), None, None, None


def textcnn_pool(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                 window: int = 3, skip: Optional[torch.Tensor] = None,
                 dtype: torch.dtype = torch.float32
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B, F] f32, idx [B, F] int32); see the module docstring.
    `dtype` is the conv's operand type: float32, bfloat16 or float16."""
    if dtype in KERNELS_16:
        return TextCNNPool16.apply(x, kernel, bias, window, skip, dtype)
    if dtype != torch.float32:
        raise ValueError(f"dtype must be float32, bfloat16 or float16, got "
                         f"{dtype}")
    return TextCNNPool.apply(x, kernel, bias, window, skip)


def textcnn_pool_rows(table: torch.Tensor, rows: torch.Tensor,
                      kernel: torch.Tensor, bias: torch.Tensor,
                      window: int = 3, skip: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B, F] f32, idx [B, F] int32) of the op on table[rows], for a
    [N, T, E] table and [B] int32 rows; see the module docstring."""
    return TextCNNPoolRows.apply(table, rows, kernel, bias, window, skip)


def textcnn_pool_embed(ids: torch.Tensor, table: torch.Tensor,
                       kernel: torch.Tensor, bias: torch.Tensor,
                       window: int = 3) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B, F] f32, idx [B, F] int32) of the op on table[ids], for a
    [V, E] word table and [B, T] int32 ids; see the module docstring."""
    return TextCNNPoolEmbed.apply(ids, table, kernel, bias, window)

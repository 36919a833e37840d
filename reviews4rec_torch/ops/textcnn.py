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
- The three launchers run the plain version for a CPU tensor and, for a
  CUDA tensor, launch their kernel or raise: `textcnn_pool_forward`
  (`csrc/textcnn_pool_fwd.cu`), `textcnn_pool_bwd_dg` (dK,
  `csrc/textcnn_pool_bwd_dg.cu`) and `textcnn_pool_bwd_dx` (dx,
  `csrc/textcnn_pool_bwd_dx.cu`). The first two take each input form
  and operand type their source has: a dense x, `rows=` into an entity
  table or `ids=` into a word table, and `dtype=` f32, bfloat16 or
  float16. `KERNELS` names every kernel with its source, C entry point,
  arguments, form and type. Each launch adds one to the kernel's name in
  `train.profiler.counters`.
- `textcnn_pool`: the op on a dense x, a `TextCNNPool` autograd
  function differentiable in x, K and b; the backward computes dx only
  when x needs it. Where a gradient will be routed (K or x needs one),
  the f32 idx is held to exact arithmetic at max-pool near-ties: for
  each (b, f) whose best and second values (the second: the largest of
  a start other than idx's, equal values included) lie within `TIE_TOL`
  x max(1, out) of each other, idx is the first start of the largest
  window value recomputed in float64. The forward kernel does that
  itself (`refine`); on the CPU `refine_ties` does it after the plain
  version, and it is the kernel's plain version. The kernel's 3xTF32
  sums sit up to about 1.4e-6 from float64 at NARRE's shape (f32's own,
  about 1e-7), enough to give a window of a near-tie the gradient that
  exact arithmetic gives its rival.
- `textcnn_pool_rows` and `textcnn_pool_embed`: the same op on
  `table[rows]` of a whole [N, T, E] entity doc table (the entity doc
  cache under `hp.pallas_fuse_rows`) and on `table[ids]` of a frozen
  [V, E] word table and [B, T] int32 word ids (the fused word gather
  under `hp.pallas_fuse_gather`; the JAX package's `textcnn_pool_embed`),
  a `TextCNNPoolTable` autograd function differentiable in K and b only.
  Their kernels (`textcnn_pool_fwd_rows`, `textcnn_pool_bwd_dg_rows`,
  `textcnn_pool_fwd_ids`, `textcnn_pool_bwd_dg_ids`) read each row or
  word straight from the table, so the [B, T, E] gather never exists.
  Their plain versions are `textcnn_pool_rows_reference` and
  `textcnn_pool_embed_reference` (the op on the gather) and
  `textcnn_pool_embed_backward_reference` (its dK, db).

The three forms of the forward and of the dG share one kernel body each,
so the rows and ids forms give the bits of the plain-x kernels on
`table[rows]` and `table[ids]`, with one exception: the rows forward at
the shapes `fwd_body` names ((E, W) = (64, 3), 96 < F <= 104: every
entity tower of deepconn and deepconn++) issues its products by warpgroup
(`wgmma`, 3xTF32 as the other body) from a body of its own, whose sums
may differ from the `mma.sync` body's in the last bits. Such launches
also count under `FWD_ROWS_WGMMA`.

- `textcnn_pool(..., dtype=torch.bfloat16)` or `dtype=torch.float16`:
  the op with 16-bit operands, as the JAX package's XLA TextCNN branch
  computes it at `compute_dtype="bfloat16"` or `"float16"`
  (`reviews4rec_tpu/models/layers.py:174-187`). x and K are cast to the
  16-bit type, the conv sums in f32 and the bias is added in f32. Its
  forward is `textcnn_pool_fwd_bf16` or `textcnn_pool_fwd_f16` (two
  instantiations of one body in `csrc/textcnn_pool_fwd.cu`, one 16-bit
  `mma.sync` pass); its dK is `textcnn_pool_bwd_dg_bf16` or
  `textcnn_pool_bwd_dg_f16` (`csrc/textcnn_pool_bwd_dg.cu`, the dG body
  on 16-bit x), each value the f32 sum rounded to the 16-bit type once,
  as JAX's cotangent of `kernel.astype(dtype)` is; db is the f32 sum of
  g, unrounded. Where x needs a gradient, dx is the f32 dx kernel on the
  16-bit values of K, rounded to the 16-bit type (the cotangent of
  `x.astype(dtype)`). Their plain versions are
  `textcnn_pool_16_reference` (the f32 plain forward on the 16-bit
  values) and `textcnn_pool_16_dg_reference` (the f32 plain dG on the
  16-bit values of x, rounded to the 16-bit type).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..train.profiler import count
from . import _build

FWD, BWD_DG, BWD_DX = "textcnn_pool_fwd", "textcnn_pool_bwd_dg", \
    "textcnn_pool_bwd_dx"
FWD_ROWS, BWD_DG_ROWS = "textcnn_pool_fwd_rows", "textcnn_pool_bwd_dg_rows"
# the rows forward's launches that took its warpgroup body (`fwd_body`);
# every rows forward launch also counts under FWD_ROWS
FWD_ROWS_WGMMA = FWD_ROWS + ".wgmma"
FWD_IDS, BWD_DG_IDS = "textcnn_pool_fwd_ids", "textcnn_pool_bwd_dg_ids"
FWD_BF16, BWD_DG_BF16 = "textcnn_pool_fwd_bf16", "textcnn_pool_bwd_dg_bf16"
FWD_F16, BWD_DG_F16 = "textcnn_pool_fwd_f16", "textcnn_pool_bwd_dg_f16"
_F32 = torch.float32


class Kernel(NamedTuple):
    """One kernel: the source `csrc/<source>.cu` that holds it, its C
    entry point, its (pointer, int) argument counts before the stream,
    the C function giving its shared memory and the sizes that takes,
    its input form ("x"; "rows" into an [N, T, E] table; "ids" into a
    [V, E] word table) and the type of its x or table."""
    source: str
    entry: str
    args: Tuple[int, int]
    smem: str
    smem_args: Tuple[str, ...]
    form: str
    dtype: torch.dtype


_FWD_SMEM = ("textcnn_pool_fwd_smem_bytes", ("E", "W"))
_FWD16_SMEM = ("textcnn_pool_fwd_16_smem_bytes", ("E", "W"))
_DG_SMEM = ("textcnn_pool_bwd_dg_smem_bytes", ("E", "W"))
KERNELS: Dict[str, Kernel] = {
    FWD: Kernel(FWD, "textcnn_pool_fwd_f32", (8, 6), *_FWD_SMEM, "x", _F32),
    BWD_DG: Kernel(BWD_DG, "textcnn_pool_bwd_dg_f32", (7, 5), *_DG_SMEM,
                   "x", _F32),
    BWD_DX: Kernel(BWD_DX, "textcnn_pool_bwd_dx_f32", (6, 5),
                   "textcnn_pool_bwd_dx_smem_bytes", ("W", "F"), "x", _F32),
    FWD_ROWS: Kernel(FWD, "textcnn_pool_fwd_rows_f32", (7, 6), *_FWD_SMEM,
                     "rows", _F32),
    BWD_DG_ROWS: Kernel(BWD_DG, "textcnn_pool_bwd_dg_rows_f32", (8, 6),
                        *_DG_SMEM, "rows", _F32),
    FWD_IDS: Kernel(FWD, "textcnn_pool_fwd_ids_f32", (6, 6), *_FWD_SMEM,
                    "ids", _F32),
    BWD_DG_IDS: Kernel(BWD_DG, "textcnn_pool_bwd_dg_ids_f32", (7, 6),
                       *_DG_SMEM, "ids", _F32),
    FWD_BF16: Kernel(FWD, FWD_BF16, (6, 5), *_FWD16_SMEM, "x",
                     torch.bfloat16),
    BWD_DG_BF16: Kernel(BWD_DG, BWD_DG_BF16, (7, 5), *_DG_SMEM, "x",
                        torch.bfloat16),
    FWD_F16: Kernel(FWD, FWD_F16, (6, 5), *_FWD16_SMEM, "x", torch.float16),
    BWD_DG_F16: Kernel(BWD_DG, BWD_DG_F16, (7, 5), *_DG_SMEM, "x",
                       torch.float16),
}
# each kernel's name by (source, form, type)
_BY_FORM = {(k.source, k.form, k.dtype): name for name, k in KERNELS.items()}

# The rows forward's warpgroup body (`csrc/textcnn_pool_fwd.cu`,
# `wg_takes`): built for these (E, W), 104 filters a product (13 n8 tiles,
# so F in (96, 104]), and its shared memory: K's hi and lo copies, a ring
# of four x tiles of 64 + W - 1 words at a pitch of E + 4 floats, two
# mbarriers a tile, one 8-byte merge key a filter
WGMMA_SHAPES = ((64, 3),)
WGMMA_N = 104
WGMMA_STAGES = 4
# the H100's shared memory a block may opt into
SMEM_OPTIN = 232448


def wgmma_smem_bytes(e: int, w: int) -> int:
    """Shared memory of one block of the rows forward's warpgroup body."""
    k_copy = w * (e // 8) * (WGMMA_N // 8) * 256
    stage = 4 * (64 + w - 1) * (e + 4)
    return 2 * k_copy + WGMMA_STAGES * stage + 16 * WGMMA_STAGES + \
        8 * WGMMA_N


def fwd_body(form: str, e: int, f: int, w: int) -> str:
    """The f32 forward's body for an input form ("x", "rows", "ids") at
    (E, F, W): "wgmma" for the rows form at a shape its warpgroup body
    takes, else "mma_sync". The launcher counts by the card's own choice
    (`textcnn_pool_fwd_rows_wgmma`, which reads the card's shared memory;
    the body also wants the table 16-byte aligned); chip_smoke.py holds
    the two to each other."""
    if (form == "rows" and (e, w) in WGMMA_SHAPES
            and WGMMA_N - 8 < f <= WGMMA_N
            and wgmma_smem_bytes(e, w) <= SMEM_OPTIN):
        return "wgmma"
    return "mma_sync"


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
# launchers: the plain version for a CPU tensor, else the kernel
# ---------------------------------------------------------------------
def _library(name: str) -> ctypes.CDLL:
    """The built library of kernel `name`'s source, every kernel of that
    source typed from `KERNELS`: `<entry>(pointers, [N or V,] B, T, E,
    F, W, [refine,] stream)`, its `<smem>(*smem_args)` and the source's
    `<source>_error_string(code)`; the forward source's window bound
    read once, as `max_window`."""
    src = KERNELS[name].source
    lib = _build.load(src)
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        for spec in KERNELS.values():
            if spec.source != src:
                continue
            fn = getattr(lib, spec.entry)
            pointers, ints = spec.args
            fn.argtypes = [p] * pointers + [i] * ints + [p]
            fn.restype = i
            getattr(lib, spec.smem).argtypes = [i] * len(spec.smem_args)
            getattr(lib, spec.smem).restype = ctypes.c_size_t
        getattr(lib, f"{src}_error_string").argtypes = [i]
        getattr(lib, f"{src}_error_string").restype = ctypes.c_char_p
        if src == FWD:
            lib.textcnn_pool_fwd_max_window.argtypes = []
            lib.textcnn_pool_fwd_max_window.restype = i
            lib.max_window = lib.textcnn_pool_fwd_max_window()
            lib.textcnn_pool_fwd_rows_wgmma.argtypes = [i, i, i]
            lib.textcnn_pool_fwd_rows_wgmma.restype = i
        if src == BWD_DG:
            lib.textcnn_pool_bwd_dg_slice_rows.argtypes = [i, i]
            lib.textcnn_pool_bwd_dg_slice_rows.restype = i
        lib._typed = True
    return lib


def _launch(name: str, ref: torch.Tensor, tensors,
            dims: Dict[str, int]) -> None:
    """Launch kernel `name` on the pointers of `tensors` (None for a
    null) and the sizes `dims` ([N,] B, T, E, F, W, in that order) on the
    current stream of `ref`'s device, raise with the shape and
    shared-memory figure if CUDA refuses it, and count the launch."""
    spec = KERNELS[name]
    lib = _library(name)
    pointers = [t.data_ptr() if t is not None else None for t in tensors]
    with torch.cuda.device(ref.device):
        stream = torch.cuda.current_stream(ref.device).cuda_stream
        err = getattr(lib, spec.entry)(*pointers, *dims.values(), stream)
    if err != 0:
        smem = getattr(lib, spec.smem)(*(dims[k] for k in spec.smem_args))
        shape = ", ".join(f"{k}={v}" for k, v in dims.items())
        raise RuntimeError(
            f"{name} launch failed at {shape} ({smem} bytes of shared "
            f"memory per block): "
            f"{getattr(lib, f'{spec.source}_error_string')(err).decode()}")
    count(name)


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


def _check_grad(what, g, idx, window, skip, others, dtypes) -> None:
    """g [B, F] f32, idx [B, F] int32, W >= 1, the skip, and the (name,
    tensor) pairs `others` of types `dtypes`, on g's card."""
    b, f = g.shape
    if tuple(idx.shape) != (b, f):
        raise ValueError(f"idx must be [{b}, {f}], got {tuple(idx.shape)}")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    _check_skip(skip, b)
    _check_cuda(what, [("g", g), ("idx", idx), ("skip", skip), *others],
                [torch.float32, torch.int32, torch.int32, *dtypes])


def _kernel(source: str, rows, ids, skip, dtype: torch.dtype) -> str:
    """The name of `source`'s kernel for the input form (`rows` or `ids`
    given, else a dense x) and the operand type `dtype`."""
    form = "rows" if rows is not None else "ids" if ids is not None else "x"
    if form == "ids" and skip is not None:
        raise ValueError("the ids form takes no skip span")
    name = _BY_FORM.get((source, form, dtype))
    if name is None:
        raise ValueError(f"{source} has no kernel for {form} at {dtype}")
    return name


def _operands(x, rows, ids) -> Tuple[int, int, int, Dict[str, int]]:
    """(B, T, E, the table's size: {"N": n}, {"V": v} or {}) of a
    launch's input: x [B, T, E]; with `rows` [B] a table [N, T, E]; with
    `ids` [B, T] a word table [V, E]."""
    if ids is not None:
        if x.dim() != 2 or ids.dim() != 2:
            raise ValueError(f"table [V, E] and ids [B, T] expected, got "
                             f"{tuple(x.shape)} and {tuple(ids.shape)}")
        return ids.shape[0], ids.shape[1], x.shape[1], {"V": x.shape[0]}
    if x.dim() != 3 or (rows is not None and rows.dim() != 1):
        raise ValueError(f"x [B, T, E], or a table [N, T, E] and rows [B], "
                         f"expected, got {tuple(x.shape)}"
                         + ("" if rows is None else f", {tuple(rows.shape)}"))
    n, t, e = x.shape
    return (n, t, e, {}) if rows is None else (rows.shape[0], t, e, {"N": n})


def textcnn_pool_forward(x: torch.Tensor, kernel: torch.Tensor,
                         bias: torch.Tensor, window: int = 3,
                         skip: Optional[torch.Tensor] = None,
                         second: bool = False, refine: bool = False, *,
                         rows: Optional[torch.Tensor] = None,
                         ids: Optional[torch.Tensor] = None,
                         dtype: torch.dtype = torch.float32):
    """(out, idx) without autograd: the plain version on the CPU, else a
    kernel of `csrc/textcnn_pool_fwd.cu`. x is [B, T, E] of type `dtype`
    (f32, or bfloat16 / float16 with K of that type); with `rows` [B]
    int32 an f32 [N, T, E] table read at those rows; with `ids` [B, T]
    int32 an f32 [V, E] word table read at those words (no skip). On the
    card a row or id outside the table gives NaN in `out` and -1 in
    `idx` for its batch row. The f32 dense form alone has `second` (the
    second value [B, F] too, `textcnn_pool_reference`'s) and `refine`
    (idx of each near-tie from float64, `refine_ties`)."""
    name = _kernel(FWD, rows, ids, skip, dtype)
    if (second or refine) and name != FWD:
        raise ValueError(f"{name} keeps no second value")
    if x.device.type == "cpu":
        if rows is not None:
            return textcnn_pool_rows_reference(x, rows, kernel, bias, window,
                                               skip)
        if ids is not None:
            return textcnn_pool_embed_reference(ids, x, kernel, bias, window)
        if dtype != _F32:
            return textcnn_pool_16_reference(dtype, x, kernel, bias, window,
                                             skip)
        if not (second or refine):
            return textcnn_pool_reference(x, kernel, bias, window, skip)
        out, idx, sec = textcnn_pool_reference(x, kernel, bias, window, skip,
                                               second=True)
        if refine:
            idx = refine_ties(x, kernel, bias, window, skip, out, idx, sec)
        return (out, idx, sec) if second else (out, idx)
    b, t, e, size = _operands(x, rows, ids)
    if kernel.dim() != 2 or kernel.shape[0] != window * e:
        raise ValueError(f"kernel must be [W*E={window * e}, F], got "
                         f"{tuple(kernel.shape)}")
    f = kernel.shape[1]
    if tuple(bias.shape) != (f,):
        raise ValueError(f"bias must be [{f}], got {tuple(bias.shape)}")
    _check_skip(skip, b)
    _check_cuda(name, [("x", x), ("kernel", kernel), ("bias", bias),
                       ("skip", skip), ("rows", rows), ("ids", ids)],
                [dtype, dtype, torch.float32] + [torch.int32] * 3)
    if min(x.shape[0], b, t, e, f) < 1:
        raise ValueError(f"empty operand: {x.shape[0]} rows, B={b}, "
                         f"T={t}, E={e}, F={f}")
    max_window = _library(name).max_window
    if not 1 <= window <= max_window:
        raise ValueError(f"window {window} outside the kernel's "
                         f"1..{max_window}")
    out = torch.empty((b, f), dtype=torch.float32, device=x.device)
    idx = torch.empty((b, f), dtype=torch.int32, device=x.device)
    sec = (torch.empty((b, f), dtype=torch.float32, device=x.device)
           if second else None)
    ties = _tie_workspace(x, 4 + 2 * b * f) if refine else None
    index = [i for i in (rows, ids) if i is not None]
    spans = [] if ids is not None else [skip]
    tensors = [x, *index, kernel, bias, *spans, out, idx]
    dims = dict(size, B=b, T=t, E=e, F=f, W=window)
    if name == FWD:
        tensors += [sec, ties]
        dims["refine"] = int(refine)
    _launch(name, x, tensors, dims)
    if (name == FWD_ROWS and x.data_ptr() % 16 == 0
            and _library(name).textcnn_pool_fwd_rows_wgmma(e, f, window)):
        count(FWD_ROWS_WGMMA)
    return (out, idx, sec) if second else (out, idx)


def textcnn_pool_bwd_dg(x: torch.Tensor, g: torch.Tensor, idx: torch.Tensor,
                        window: int = 3, skip: Optional[torch.Tensor] = None,
                        *, rows: Optional[torch.Tensor] = None,
                        ids: Optional[torch.Tensor] = None,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """dK [W*E, F] f32 from the saved x, the gated g [B, F] and idx: the
    plain version on the CPU, else a kernel of
    `csrc/textcnn_pool_bwd_dg.cu`. x, `rows`, `ids` and `dtype` as
    `textcnn_pool_forward`'s; at a 16-bit `dtype` each dK value is the
    f32 sum rounded to that type once (W <= 8 there and with `ids`)."""
    name = _kernel(BWD_DG, rows, ids, skip, dtype)
    if x.device.type == "cpu":
        if rows is not None:
            return _dg_reference(take_rows(x, rows), g, idx, window, skip)
        if ids is not None:
            return textcnn_pool_embed_backward_reference(ids, x, g, idx,
                                                         window)[0]
        if dtype != _F32:
            return textcnn_pool_16_dg_reference(dtype, x, g, idx, window,
                                                skip)
        return _dg_reference(x, g, idx, window, skip)
    b, t, e, size = _operands(x, rows, ids)
    if g.dim() != 2 or g.shape[0] != b:
        raise ValueError(f"g must be [{b}, F], got {tuple(g.shape)}")
    _check_grad(name, g, idx, window, skip,
                [("x", x), ("rows", rows), ("ids", ids)],
                [dtype, torch.int32, torch.int32])
    f = g.shape[1]
    dk = torch.empty((window * e, f), dtype=torch.float32, device=g.device)
    partial, counter = _dg_workspace(x, b, f, window * e)
    index = [i for i in (rows, ids) if i is not None]
    spans = [] if ids is not None else [skip]
    _launch(name, x, [x, *index, g, idx, *spans, dk, partial, counter],
            dict(size, B=b, T=t, E=e, F=f, W=window))
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
    _check_grad(BWD_DX, g, idx, window, skip, [("kernel", kernel)],
                [torch.float32])
    b, f = g.shape
    e = kernel.shape[0] // window
    if min(t, e) < 1:
        raise ValueError(f"empty operand: T={t}, E={e}")
    dx = torch.empty((b, t, e), dtype=torch.float32, device=g.device)
    # scratch the launch fills with K transposed, [F, W*E]
    kt = torch.empty(kernel.numel(), dtype=torch.float32, device=g.device)
    _launch(BWD_DX, g, [g, idx, kernel, skip, dx, kt],
            dict(B=b, T=t, E=e, F=f, W=window))
    return dx


def _gate(out: torch.Tensor, g_out: torch.Tensor) -> torch.Tensor:
    """The cotangent of out gated by the ReLU (a max clamped to zero
    passes no gradient), contiguous; db is its sum over the batch."""
    return torch.where(out > 0, g_out, torch.zeros(
        (), dtype=g_out.dtype, device=g_out.device)).contiguous()


class TextCNNPool(torch.autograd.Function):
    """(out, idx) of the op on a dense x, differentiable in x, K and b,
    with the conv's operands of type `dtype`. The backward computes dx
    only when x needs it (the JAX op's `need_dx`); a tower over the
    frozen word table never asks for it. At f32, where x or K needs a
    gradient, idx is refined at near-ties (the forward's `refine`) before
    it is saved and returned. At a 16-bit `dtype` x and K are cast to it:
    dK is that type's dG kernel's (16-bit values in f32), dx the f32 dx
    kernel on the 16-bit values of K, rounded to the 16-bit type, and db
    the f32 sum of the gated g."""

    @staticmethod
    def forward(ctx, x, kernel, bias, window, skip, dtype):
        if dtype == _F32:
            out, idx = textcnn_pool_forward(
                x, kernel, bias, window, skip,
                refine=ctx.needs_input_grad[0] or ctx.needs_input_grad[1])
        else:
            x, kernel = x.to(dtype).contiguous(), kernel.to(dtype).contiguous()
            out, idx = textcnn_pool_forward(x, kernel, bias, window, skip,
                                            dtype=dtype)
        ctx.window, ctx.dtype = window, dtype
        ctx.save_for_backward(x, kernel, out, idx, skip)
        ctx.mark_non_differentiable(idx)
        return out, idx

    @staticmethod
    def backward(ctx, g_out, _g_idx):
        x, kernel, out, idx, skip = ctx.saved_tensors
        w, dtype = ctx.window, ctx.dtype
        g = _gate(out, g_out)
        dx = dk = None
        if ctx.needs_input_grad[0] and dtype == _F32:
            dx = textcnn_pool_bwd_dx(g, idx, kernel, x.shape[1], w, skip)
        elif ctx.needs_input_grad[0]:
            dx = _values_16(textcnn_pool_bwd_dx(g, idx, kernel.float(),
                                                x.shape[1], w, skip), dtype)
        if ctx.needs_input_grad[1]:
            dk = textcnn_pool_bwd_dg(x, g, idx, w, skip, dtype=dtype)
        return dx, dk, g.sum(0), None, None, None


class TextCNNPoolTable(torch.autograd.Function):
    """(out, idx) of the op on a frozen table read through an index,
    differentiable in K and b only: `form` "rows", [B] rows of an
    [N, T, E] entity doc cache (the JAX op returns zeros for the table
    and no cotangent for rows; a table that needs a gradient is refused,
    since the op has no dx), or "ids", [B, T] word ids of a [V, E] word
    table (the JAX op gives it a zero cotangent; here it gets none)."""

    @staticmethod
    def forward(ctx, table, index, kernel, bias, window, skip, form):
        if form == "rows" and table.requires_grad:
            raise ValueError("textcnn_pool_rows computes no gradient for its "
                             "table; gather table[rows] and use textcnn_pool")
        out, idx = textcnn_pool_forward(table, kernel, bias, window, skip,
                                        **{form: index})
        ctx.window, ctx.form = window, form
        ctx.save_for_backward(table, index, out, idx, skip)
        ctx.mark_non_differentiable(idx)
        return out, idx

    @staticmethod
    def backward(ctx, g_out, _g_idx):
        table, index, out, idx, skip = ctx.saved_tensors
        g = _gate(out, g_out)
        dk = (textcnn_pool_bwd_dg(table, g, idx, ctx.window, skip,
                                  **{ctx.form: index})
              if ctx.needs_input_grad[2] else None)
        return None, None, dk, g.sum(0), None, None, None


def textcnn_pool(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                 window: int = 3, skip: Optional[torch.Tensor] = None,
                 dtype: torch.dtype = torch.float32
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B, F] f32, idx [B, F] int32); see the module docstring.
    `dtype` is the conv's operand type: float32, bfloat16 or float16."""
    if dtype not in (_F32, torch.bfloat16, torch.float16):
        raise ValueError(f"dtype must be float32, bfloat16 or float16, got "
                         f"{dtype}")
    return TextCNNPool.apply(x, kernel, bias, window, skip, dtype)


def textcnn_pool_rows(table: torch.Tensor, rows: torch.Tensor,
                      kernel: torch.Tensor, bias: torch.Tensor,
                      window: int = 3, skip: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B, F] f32, idx [B, F] int32) of the op on table[rows], for a
    [N, T, E] table and [B] int32 rows; see the module docstring."""
    return TextCNNPoolTable.apply(table, rows, kernel, bias, window, skip,
                                  "rows")


def textcnn_pool_embed(ids: torch.Tensor, table: torch.Tensor,
                       kernel: torch.Tensor, bias: torch.Tensor,
                       window: int = 3) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B, F] f32, idx [B, F] int32) of the op on table[ids], for a
    [V, E] word table and [B, T] int32 ids; see the module docstring."""
    return TextCNNPoolTable.apply(table, ids, kernel, bias, window, None,
                                  "ids")

// TextCNN backward, kernel gradient only:
//   dK[w*E + e, f] = sum_b g[b, f] * x_pad[b, idx[b, f] + w, e]
// where g is the output cotangent already gated by out > 0, idx the
// forward's winning window start, and x_pad the doc zero-padded by W - 1
// words on both ends and zeroed inside the optional per-row skip span
// [skip_lo, skip_lo + len). dK is [W*E, F] tap-major, the layout of
// TextCNN.conv_kernel. db = sum_b g is left to PyTorch.
//
// Replaces two kernels of reviews4rec_tpu/ops/textcnn_pallas.py:
// `_paired_bwd_dg_kernel` (launched from `_dg_only_from_xp`), the backward
// of every TextCNN tower over the frozen word table, where dx is dead, as
// `textcnn_pool_bwd_dg_f32`; and `_gathered_bwd_dg_kernel` (launched from
// `_gathered_dg`), the same on table[rows] of a whole [N, T, E] entity doc
// table, as `textcnn_pool_bwd_dg_rows_f32`; and, as
// `textcnn_pool_bwd_dg_ids_f32`, the dK of `textcnn_pool_embed`'s backward
// `_bwd_embed` (:784), which regathers the W winning taps from word ids
// (a plain XLA gather and einsum on the TPU). The TPU kernels rebuild a
// winner mask over every window start and run one matmul with it; none of
// that layout carries over: the work is a gather of the W winning taps per
// (b, f) and a reduction over b.
//
// Bound. At the training shape (B=256, T=1000, E=64, F=100, W=3, f32) the
// function needs 2*W*E FLOP per non-zero g (at most 9.8 MFLOP), nothing
// for a tensor core. It must read each distinct doc position that some
// winning window of a non-zero g covers, E floats each (at most
// B*F*W*E*4 = 19.7 MB, fewer where windows overlap), g and idx (0.2 MB)
// and write dK (77 KB). chip_smoke.py counts exactly that from the run's
// own idx and g (the distinct (row, position) pairs, table positions for
// the rows form) and divides by 3.35 TB/s: a few microseconds. It is bound
// by bytes, and at this size by how many of those bytes are in flight.
//
// What held the first body back. It ran one thread per dK value: 19200
// threads, about one block of 4 warps per SM. Each thread walked all B rows
// in a dependent chain: load g[b, f] and idx[b, f] (and rows[b]), and only
// then the address of x was known, so each warp had a few loads in flight,
// each behind two or three memory latencies; in the rows form the table
// reads were 128-byte pieces scattered over the table.
//
// Layout. A block is (f, b-slice): 8 warps over one filter and a slice of
// the batch, warp k walking its own contiguous run of the slice's rows.
// 1. The block first stages g, the window's first position idx - (W - 1),
//    the skip span and (rows form) rows[b] of its slice in shared memory.
//    After that every x address is known without a global load.
// 2. A warp reads a whole window of one (b, f) at once: the W taps are one
//    contiguous span of W*E floats of x (768 B at E=64, W=3), lane l
//    taking vectors l, l+32, ... of the span, 16 bytes each where E % 4 ==
//    0 and x is 16-byte aligned, else single floats (the same body). A pad
//    position or one inside the skip span reads nothing and adds nothing;
//    a row with g == 0 loads nothing. Each warp keeps four rows' windows
//    in flight. At the training shape the grid is 400 blocks, 4 slices of
//    64 rows for each of the 100 filters: 3200 warps, where the first body
//    ran 600 warps of one chain each. A span longer than 256 floats
//    (E > 85 at W=3) is taken 256 floats at a time, the warp walking its
//    rows again for each.
// 3. Each lane keeps its floats' sums in registers over the warp's rows,
//    in row order. The 8 warps' sums are added in shared memory in warp
//    order. With one slice the block writes dK; with several, each block
//    writes its slice's sums to `partial` [slices, F, W*E], fences, and
//    counts itself done on `counter[f]`; the last of f's blocks adds the
//    slices in slice order, writes dK[:, f] and sets the counter back to 0
//    for the next launch (launches on one stream run in turn).
// The slice count depends on B and F only: as many blocks as fit the card
// at once (4 a SM on 132 SMs: 528) where B allows at least 4 rows a warp,
// and at most 512 rows a slice.
//
// Deterministic. No float atomics: every dK value is a sum over rows in
// row order within a warp, then over warps in warp order, then over slices
// in slice order, and that order depends only on (B, F). Two launches on
// the same inputs give the same bits; a lane's vector width does not
// enter the order, so aligned and unaligned x agree bitwise too.
//
// One body, three forms. kSrc changes only where a batch row's window is
// read: x[b], table[rows[b]] (rows), or tap by tap table[ids[b, p]] of a
// [V, E] word table (ids: the block also stages the W ids of each of its
// rows' windows, ids_pad[b, idx + w], beside the rest of step 1, and a
// lane's vector of tap w reads E floats' worth of row ids[...] in place
// of x). The staging, the order of the sums and the tiling are the same,
// so the rows form is bitwise the plain-x form on table[rows] and the ids
// form on table[ids]. A row outside [0, N) (rows) or an id outside
// [0, V) (ids, W <= 8) with a non-zero g reads NaN in place of each
// in-doc tap it covers, which reaches every dK value those taps touch.
// The ids form's bound counts the bytes of the winning windows' ids and
// of the distinct table rows they touch (chip_smoke.py, on the run's
// data).
//
// bf16 x, `textcnn_pool_bwd_dg_bf16`, and f16 x, `textcnn_pool_bwd_dg_f16`:
// the dK of the JAX package's XLA TextCNN branch at
// `compute_dtype="bfloat16"` or `"float16"`
// (reviews4rec_tpu/models/layers.py:174-187; an XLA dot there, no Pallas
// kernel). The plain-x body reads x as 16-bit values (8-byte vectors of 4,
// or single values) and g in f32, and sums in f32 in the same fixed order.
// JAX's cotangent of `kernel.astype(bfloat16)` (or float16) is the f32 sum
// rounded to that type once, so each dK value is rounded to nearest even
// at its store (`__float2bfloat16_rn`, `__float2half_rn`, which keeps
// f16's subnormals down to 2^-24 as JAX's convert does; no fast-math flag
// flushes them) and written as the f32 that holds it; the slices' partial
// sums stay unrounded. db (PyTorch's sum of g) is not rounded: the bias is
// added in f32.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;                 // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;                // windows in flight per warp
constexpr int kChunk = 256;               // span floats a warp sums per pass
constexpr int kMaxSliceRows = 512;        // staged batch rows per block
constexpr int kTargetBlocks = 4 * 132;    // four blocks on each of 132 SMs
constexpr int kMaxIdsWindow = 8;          // taps a row the ids form stages

// where a batch row's window is read
enum Source { kPlain = 0, kRows = 1, kIds = 2 };
static_assert(kChunk == kThreads, "one thread per chunk float in the warp sum");

// one staged batch row of a block's slice
struct Row {
  float g;    // gated cotangent of (b, f); 0 loads and adds nothing
  int p0;     // doc position of the window's first tap, idx - (W - 1)
  int lo;     // skip span [lo, hi); empty without skip
  int hi;
};

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// batch rows per warp; a slice is kWarps times that
int rows_per_warp(int B, int F) {
  long long s = kTargetBlocks / F;  // one wave of blocks
  const long long most = ceil_div(B, kWarps * kUnroll);
  if (s > most) s = most;
  if (s < ceil_div(B, kMaxSliceRows)) s = ceil_div(B, kMaxSliceRows);
  if (s < 1) s = 1;
  return (int)(ceil_div(ceil_div(B, s * kWarps), kUnroll) * kUnroll);
}

template <int kVec>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[kVec]) {
  if constexpr (kVec == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    v[0] = __ldg(p);
  }
}

// bf16 x: 4 values in one 8-byte load, or one
template <int kVec>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[kVec]) {
  if constexpr (kVec == 4) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
    v[0] = __low2float(lo); v[1] = __high2float(lo);
    v[2] = __low2float(hi); v[3] = __high2float(hi);
  } else {
    v[0] = __bfloat162float(p[0]);
  }
}

// f16 x: 4 values in one 8-byte load, or one
template <int kVec>
__device__ __forceinline__ void load_vec(const __half* p, float (&v)[kVec]) {
  if constexpr (kVec == 4) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    const __half2 lo = *reinterpret_cast<const __half2*>(&q.x);
    const __half2 hi = *reinterpret_cast<const __half2*>(&q.y);
    v[0] = __low2float(lo); v[1] = __high2float(lo);
    v[2] = __low2float(hi); v[3] = __high2float(hi);
  } else {
    v[0] = __half2float(p[0]);
  }
}

// a dK value as stored: f32, or for 16-bit x the f32 of its rounding to
// that type (nearest even; f16 keeps its subnormals and gives 0 below
// half the least of them)
template <typename Tx>
__device__ __forceinline__ float stored(float sum) {
  if constexpr (std::is_same<Tx, __nv_bfloat16>::value)
    return __bfloat162float(__float2bfloat16_rn(sum));
  if constexpr (std::is_same<Tx, __half>::value) return __half2float(__float2half_rn(sum));
  return sum;
}

// kSrc == kRows: x is a [N, T, E] table and batch row b reads x[rows[b]].
// kSrc == kIds: x is a [N, E] word table, `rows` holds ids [B, T] and doc
// position p of batch row b is x[rows[b * T + p]].
// kVec: floats a lane loads at once (4 needs E % 4 == 0 and aligned x).
// Tx: float, or __nv_bfloat16 / __half for the 16-bit forms (kPlain only).
template <int kSrc, int kVec, typename Tx>
__global__ void __launch_bounds__(kThreads, 4)
textcnn_pool_bwd_dg_kernel(const Tx* __restrict__ x, const int* __restrict__ rows,
                           const float* __restrict__ g, const int* __restrict__ idx,
                           const int* __restrict__ skip, float* __restrict__ dk,
                           float* __restrict__ partial, int* __restrict__ counter, int N,
                           int B, int T, int E, int F, int W, int per_warp) {
  constexpr int kSlots = kChunk / 32 / kVec;  // vectors a lane holds per pass
  __shared__ Row staged[kMaxSliceRows];
  __shared__ int src_row[kSrc == kRows ? kMaxSliceRows : 1];
  __shared__ int tap_id[kSrc == kIds ? kMaxSliceRows * kMaxIdsWindow : 1];
  __shared__ __align__(16) float red[kWarps][kChunk];
  __shared__ bool last;

  const int f = (int)(blockIdx.x % (unsigned)F);
  const int s = (int)(blockIdx.x / (unsigned)F);
  const int slices = (int)(gridDim.x / (unsigned)F);
  const int b0 = s * per_warp * kWarps;
  const int nb = min(per_warp * kWarps, B - b0);

  // 1. stage the slice's g, window start, skip span and source row
  for (int i = threadIdx.x; i < nb; i += kThreads) {
    const int b = b0 + i;
    const size_t bf = (size_t)b * F + f;
    Row r;
    r.g = g[bf];
    r.p0 = idx[bf] - (W - 1);
    r.lo = 0;
    r.hi = 0;
    if (skip != nullptr) {
      const long long lo = skip[2 * b];
      long long hi = lo + skip[2 * b + 1];
      hi = hi > 0x7fffffffLL ? 0x7fffffffLL : hi;
      r.lo = (int)lo;
      r.hi = (int)(hi < lo ? lo : hi);
    }
    staged[i] = r;
    if constexpr (kSrc == kRows) src_row[i] = rows[b];
  }
  if constexpr (kSrc == kIds) {
    // the W word ids of each row's window, 0 at a padding position
    for (int i = threadIdx.x; i < nb * W; i += kThreads) {
      const int r = i / W;
      const int b = b0 + r;
      const int p = idx[(size_t)b * F + f] - (W - 1) + (i - r * W);
      tap_id[i] = p >= 0 && p < T ? rows[(size_t)b * T + p] : 0;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * per_warp;
  const int r1 = min(r0 + per_warp, nb);
  const int span = W * E;
  const float nan = __int_as_float(0x7fc00000);

  for (int c0 = 0; c0 < span; c0 += kChunk) {
    // this lane's vectors of the pass: offset in the window and its tap
    int off[kSlots], tap[kSlots];
    bool has[kSlots];
#pragma unroll
    for (int v = 0; v < kSlots; ++v) {
      off[v] = c0 + (v * 32 + lane) * kVec;
      has[v] = off[v] < span;
      tap[v] = off[v] / E;
    }
    float acc[kSlots][kVec];
#pragma unroll
    for (int v = 0; v < kSlots; ++v)
#pragma unroll
      for (int k = 0; k < kVec; ++k) acc[v][k] = 0.f;

    // 2. the warp's rows in order, kUnroll windows in flight
    for (int i = r0; i < r1; i += kUnroll) {
      float val[kUnroll][kSlots][kVec];
      bool in[kUnroll][kSlots];
      float gv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = i + u;
        Row row = {0.f, 0, 0, 0};
        if (r < r1) row = staged[r];
        gv[u] = row.g;
        bool ok = true;
        long long base = 0;
        if constexpr (kSrc == kRows) {
          const int src = r < r1 ? src_row[r] : 0;
          ok = src >= 0 && src < N;
          base = ((long long)(ok ? src : 0) * T + row.p0) * E;
        } else if constexpr (kSrc == kPlain) {
          base = ((long long)(b0 + r) * T + row.p0) * E;
        }
#pragma unroll
        for (int v = 0; v < kSlots; ++v) {
          const int p = row.p0 + tap[v];
          in[u][v] = has[v] && row.g != 0.f && p >= 0 && p < T &&
                     (p < row.lo || p >= row.hi);
          const Tx* src = x + base + off[v];
          if constexpr (kSrc == kIds) {
            // tap[v]'s word: E floats of its table row, at the same
            // offset within the tap
            const int id = in[u][v] ? tap_id[r * W + tap[v]] : 0;
            ok = id >= 0 && id < N;
            src = x + (long long)(ok ? id : 0) * E + (off[v] - tap[v] * E);
          }
          if (in[u][v] && ok) {
            load_vec<kVec>(src, val[u][v]);
          } else {
#pragma unroll
            for (int k = 0; k < kVec; ++k) val[u][v][k] = nan;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int v = 0; v < kSlots; ++v)
          if (in[u][v]) {
#pragma unroll
            for (int k = 0; k < kVec; ++k) acc[v][k] = fmaf(gv[u], val[u][v][k], acc[v][k]);
          }
    }

    // 3. the block's warps added in warp order
#pragma unroll
    for (int v = 0; v < kSlots; ++v)
#pragma unroll
      for (int k = 0; k < kVec; ++k) red[warp][(v * 32 + lane) * kVec + k] = acc[v][k];
    __syncthreads();
    const int j = c0 + threadIdx.x;
    if (j < span) {
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) sum += red[k][threadIdx.x];
      if (slices == 1) {
        dk[(size_t)j * F + f] = stored<Tx>(sum);
      } else {
        partial[((size_t)s * F + f) * span + j] = sum;
      }
    }
    __syncthreads();
  }
  if (slices == 1) return;

  // the last of f's blocks adds the slices in slice order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&counter[f], 1) == slices - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int j = threadIdx.x; j < span; j += kThreads) {
    float sum = 0.f;
    for (int k = 0; k < slices; ++k) sum += __ldcg(&partial[((size_t)k * F + f) * span + j]);
    dk[(size_t)j * F + f] = stored<Tx>(sum);
  }
  if (threadIdx.x == 0) counter[f] = 0;
}

template <int kSrc, typename Tx = float>
int launch(const Tx* x, const int* rows, const float* g, const int* idx, const int* skip,
           float* dk, float* partial, int* counter, int N, int B, int T, int E, int F, int W,
           void* stream) {
  if (N <= 0 || B <= 0 || T <= 0 || E <= 0 || F <= 0 || W <= 0)
    return (int)cudaErrorInvalidValue;
  const int per_warp = rows_per_warp(B, F);
  const long long slices = ceil_div(B, (long long)per_warp * kWarps);
  const long long blocks = slices * F;
  if (blocks > 0x7fffffffLL || (long long)W * E > 0x3fffffffLL) return (int)cudaErrorInvalidValue;
  if (slices > 1 && (partial == nullptr || counter == nullptr))
    return (int)cudaErrorInvalidValue;
  if (kSrc == kIds && W > kMaxIdsWindow) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E % 4 == 0 && reinterpret_cast<uintptr_t>(x) % (4 * sizeof(Tx)) == 0) {
    textcnn_pool_bwd_dg_kernel<kSrc, 4, Tx><<<(unsigned)blocks, kThreads, 0, st>>>(
        x, rows, g, idx, skip, dk, partial, counter, N, B, T, E, F, W, per_warp);
  } else {
    textcnn_pool_bwd_dg_kernel<kSrc, 1, Tx><<<(unsigned)blocks, kThreads, 0, st>>>(
        x, rows, g, idx, skip, dk, partial, counter, N, B, T, E, F, W, per_warp);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Static shared memory of a block of the ids form, the largest (the
// plain-x form stages no source rows or tap ids): the staged slice, its
// tap ids and the warps' sums.
size_t textcnn_pool_bwd_dg_smem_bytes(int, int) {
  return sizeof(Row) * kMaxSliceRows + sizeof(int) * kMaxSliceRows * kMaxIdsWindow +
         sizeof(float) * kWarps * kChunk + 16;
}

// Batch rows per block slice at (B, F). With ceil(B / rows) > 1 slices the
// caller passes `partial` (f32 [slices, F, W*E], any contents) and
// `counter` (int32 [F], all 0; the kernel leaves it 0), else null for both.
int textcnn_pool_bwd_dg_slice_rows(int B, int F) {
  return B > 0 && F > 0 ? rows_per_warp(B, F) * kWarps : 0;
}

// x [B, T, E] f32, g [B, F] f32 (gated), idx [B, F] int32, skip [B, 2]
// int32 or null, all contiguous; dk [W*E, F] f32. Launches on `stream`
// and returns the CUDA error code of the launch (0 on success).
int textcnn_pool_bwd_dg_f32(const float* x, const float* g, const int* idx, const int* skip,
                            float* dk, float* partial, int* counter, int B, int T, int E, int F,
                            int W, void* stream) {
  return launch<kPlain>(x, nullptr, g, idx, skip, dk, partial, counter, B, B, T, E, F, W, stream);
}

// The row-gathered dK: table [N, T, E] and rows [B] int32 in place of x;
// batch row b reads table[rows[b]]. g, idx and skip are per batch row.
int textcnn_pool_bwd_dg_rows_f32(const float* table, const int* rows, const float* g,
                                 const int* idx, const int* skip, float* dk, float* partial,
                                 int* counter, int N, int B, int T, int E, int F, int W,
                                 void* stream) {
  return launch<kRows>(table, rows, g, idx, skip, dk, partial, counter, N, B, T, E, F, W, stream);
}

// The word-gathered dK: a word table [V, E] and ids [B, T] int32 in place
// of x; doc position p of batch row b is table[ids[b, p]]. No skip span;
// W <= 8. g and idx are per batch row.
int textcnn_pool_bwd_dg_ids_f32(const float* table, const int* ids, const float* g,
                                const int* idx, float* dk, float* partial, int* counter, int V,
                                int B, int T, int E, int F, int W, void* stream) {
  return launch<kIds>(table, ids, g, idx, nullptr, dk, partial, counter, V, B, T, E, F, W,
                      stream);
}

// bf16 x: x [B, T, E] bf16 (bit patterns), the rest as
// `textcnn_pool_bwd_dg_f32`; each dK value is the f32 sum rounded to bf16
// (nearest even), stored as f32.
int textcnn_pool_bwd_dg_bf16(const void* x, const float* g, const int* idx, const int* skip,
                             float* dk, float* partial, int* counter, int B, int T, int E, int F,
                             int W, void* stream) {
  return launch<kPlain>(static_cast<const __nv_bfloat16*>(x), nullptr, g, idx, skip, dk,
                        partial, counter, B, B, T, E, F, W, stream);
}

// f16 x: as `textcnn_pool_bwd_dg_bf16`, x as f16 bit patterns and each dK
// value the f32 sum rounded to f16 (nearest even, subnormals kept).
int textcnn_pool_bwd_dg_f16(const void* x, const float* g, const int* idx, const int* skip,
                            float* dk, float* partial, int* counter, int B, int T, int E, int F,
                            int W, void* stream) {
  return launch<kPlain>(static_cast<const __half*>(x), nullptr, g, idx, skip, dk, partial,
                        counter, B, B, T, E, F, W, stream);
}

const char* textcnn_pool_bwd_dg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// TextCNN backward, input gradient:
//   dx[b, t, e] = sum_{f, w : idx[b, f] + w = t + W - 1} g[b, f] * K[w*E + e, f]
// where g is the output cotangent already gated by out > 0 and idx the
// forward's winning window start (in the coordinates of the doc padded by
// W - 1 words on both ends, so tap w of start s reads word s + w - (W-1)).
// Taps that fall in the padding are dropped, and dx is 0 inside the
// optional per-row skip span [skip_lo, skip_lo + len), which the forward
// read as zeros.
//
// Replaces the dx half of `_paired_bwd_kernel` of
// reviews4rec_tpu/ops/textcnn_pallas.py (launched from `_backward_paired`),
// the full backward of `textcnn_pool` when its input needs a gradient. The
// dK half of that kernel is textcnn_pool_bwd_dg.cu's output: the port
// computes (dx, dK) in two launches where the TPU used one. The TPU
// kernel's mask matmul, pair-row spill and carry do not carry over.
//
// Bound. At the training shape (B=256, T=1000, E=64, F=100, W=3, f32)
// the function writes dx, 65.5 MB, and reads g, idx and K (0.3 MB) for
// 2*B*F*W*E = 9.8 MFLOP: about 20 us of HBM traffic at 3.35 TB/s, bound
// by its writes. Only a quarter of the rows are non-zero (at most F*W =
// 300 taps land in a doc's 1000 rows), so the work is to store every byte
// once at full rate and to find each row's few taps beside it.
//
// What held the first body back. A block per (b, 64 rows) kept a [64, E]
// tile in 48 KB of shared memory: 4096 blocks, each walking all F*W taps
// with dependent global loads of g and idx, reading K strided by F across
// lanes, half its 128 threads idle at E=64, then a zeroing pass and a copy
// out with 4-byte stores, a divide and a skip test per element.
//
// Layout.
// 1. A small kernel first writes K transposed, Kt[f][w*E + e], to a
//    scratch buffer the caller passes (76.8 KB at E=64): a tap's E
//    weights are then one contiguous run, read with 16-byte loads that
//    stay in each SM's L1 after the first. (Staging Kt into the shared
//    memory of every block instead costs each of them 76.8 KB from the
//    same L2 lines before its first tap: PERF.md, the dx findings.)
// 2. Persistent blocks of 8 warps, as many as fit the card, walk items of
//    (b, up to 256 output rows; a doc's items of equal size). Per item,
//    from g[b, :] and idx[b, :] (copied with cp.async during the previous
//    item's stores), a bit mask for each window start over the filters
//    whose winning window starts there, g != 0: the warp of filters
//    32c..32c+31 groups its lanes by start with one `__match_any_sync`,
//    and the lowest lane of each group writes the group's bits. No
//    atomics: every word has one writer.
// 3. A group of lanes owns a row, each lane kPer pieces of 4 floats. A
//    row's filters are the OR of the W start masks whose windows cover it
//    (none inside the skip span; rows of the padding are not rows of dx).
//    From 0.f each lane adds fmaf(g[f], Kt[f][w*E + e..e+3], acc) over the
//    set bits in ascending f (the row fixes each filter's tap w), and
//    writes its pieces with 16-byte stores. A row with no bit (most rows,
//    and every row of the skip span) is written as zeros. Where E % 4 != 0
//    or dx is not 16-byte aligned the same body works one float at a time.
// g, idx and the start masks are double-buffered: an item costs two block
// barriers. Each element is the fmaf chain of the first body in the same
// (f, w) order, so the result is bitwise that body's, and the same from
// launch to launch. (A stable counting sort of the (f, w) taps by row,
// `__match_any_sync` over every tap to count and again to place, was
// slower: PERF.md, the dx findings.)

#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 256;  // output rows an item
constexpr int kPer = 4;        // V-float pieces of a row a lane holds at once
constexpr int kMaxWords = 4;   // mask words a row keeps in registers (F <= 128)
constexpr int kTile = 32;      // the transpose's tile

__host__ __device__ int mask_words(int f) { return (f + 31) / 32; }

// Shared memory: two slots of g and idx and two buffers of start masks,
// for items of `rows` rows.
size_t smem_bytes(int w, int f, int rows) {
  return sizeof(float) * (4 * (size_t)f + 2 * ((size_t)rows + w - 1) * mask_words(f));
}

// kt [F][W*E] = k [W*E, F] transposed, through a 32 x 33 tile
__global__ void __launch_bounds__(kTile * 8)
textcnn_pool_bwd_dx_transpose(const float* __restrict__ k, float* __restrict__ kt, int WE,
                              int F) {
  __shared__ float tile[kTile][kTile + 1];
  const int f0 = blockIdx.x * kTile, r0 = blockIdx.y * kTile;
  for (int i = threadIdx.y; i < kTile; i += 8) {
    const int r = r0 + i, f = f0 + threadIdx.x;
    if (r < WE && f < F) tile[i][threadIdx.x] = k[(size_t)r * F + f];
  }
  __syncthreads();
  for (int i = threadIdx.y; i < kTile; i += 8) {
    const int f = f0 + i, r = r0 + threadIdx.x;
    if (r < WE && f < F) kt[(size_t)f * WE + r] = tile[threadIdx.x][i];
  }
}

// word c of row r's filter mask, from the start masks
__device__ __forceinline__ unsigned row_word(const unsigned* sm, int r, int c, int words, int W,
                                             bool skipped) {
  unsigned m = 0u;
  if (!skipped)
    for (int w = 0; w < W; ++w) m |= sm[(r + w) * words + c];
  return m;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// V floats a piece (4: 16-byte loads and stores; 1: single floats)
template <int V>
__global__ void __launch_bounds__(kThreads)
textcnn_pool_bwd_dx_kernel(const float* __restrict__ g, const int* __restrict__ idx,
                           const float* __restrict__ kt, const int* __restrict__ skip,
                           float* __restrict__ dx, int T, int E, int F, int W, int rows,
                           int n_chunks, int items) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int words = mask_words(F);
  const int starts = rows + W - 1;  // window starts that reach an item row
  const int WE = W * E;
  float* gsl = smem;                                         // [2][F] g
  int* isl = reinterpret_cast<int*>(gsl + 2 * F);            // [2][F] idx
  unsigned* smk = reinterpret_cast<unsigned*>(isl + 2 * F);  // [2][starts][words]

  int item = blockIdx.x;
  if (item < items) {  // the first item's g and idx
    const int b = item / n_chunks;
    for (int f = tid; f < F; f += kThreads) {
      cp_async4(gsl + f, g + (size_t)b * F + f);
      cp_async4(isl + f, idx + (size_t)b * F + f);
    }
  }
  cp_async_commit();

  // a group of L lanes a row, rp rows at a time; lane q of a row takes
  // the pieces v = q, q + L, ... (kPer of them at a time)
  const int nv = E / V;
  const int L = min(kThreads, (nv + kPer - 1) / kPer);
  const int rp = kThreads / L;
  const int q = tid % L, rs = tid / L;

  for (int li = 0; item < items; ++li, item += gridDim.x) {
    const int s = li & 1;
    const int b = item / n_chunks;
    const int t0 = (item - b * n_chunks) * rows;
    const int n = min(rows, T - t0);
    unsigned* sm = smk + (size_t)s * starts * words;
    for (int i = tid; i < (n + W - 1) * words; i += kThreads) sm[i] = 0u;
    cp_async_wait_all();
    __syncthreads();  // this item's g and idx are in slot s; its start masks are 0
    const float* gs = gsl + s * F;
    const int* is = isl + s * F;

    // start masks: the filters of word c whose window covers item rows
    // p - (W - 1) .. p, one writer each (the lowest lane of a group)
    for (int c = warp; c < words; c += kWarps) {
      const int f = 32 * c + lane;
      const int p = f < F && gs[f] != 0.f ? is[f] - t0 : -1;
      const bool live = p >= 0 && p < n + W - 1;
      const unsigned same = __match_any_sync(0xffffffffu, live ? p : INT_MIN + lane);
      if (live && lane == __ffs(same) - 1) sm[p * words + c] = same;
    }
    __syncthreads();  // the start masks are complete

    const int next = item + gridDim.x;  // its g and idx land during the stores
    if (next < items) {
      const int nb = next / n_chunks;
      for (int f = tid; f < F; f += kThreads) {
        cp_async4(gsl + (s ^ 1) * F + f, g + (size_t)nb * F + f);
        cp_async4(isl + (s ^ 1) * F + f, idx + (size_t)nb * F + f);
      }
    }
    cp_async_commit();

    if (rs >= rp) continue;
    int lo = 0, hi = 0;
    if (skip != nullptr) {
      lo = skip[2 * b];
      hi = lo + skip[2 * b + 1];
    }
    for (int r = rs; r < n; r += rp) {
      const bool skipped = t0 + r >= lo && t0 + r < hi;
      unsigned mrow[kMaxWords];
#pragma unroll
      for (int c = 0; c < kMaxWords; ++c)
        mrow[c] = c < words ? row_word(sm, r, c, words, W, skipped) : 0u;
      float* out = dx + ((size_t)b * T + t0 + r) * E;
      const int tap0 = t0 + r + (W - 1);  // filter f's tap in this row: tap0 - idx[f]
      for (int v0 = q; v0 < nv; v0 += L * kPer) {
        float a[kPer][V];
#pragma unroll
        for (int j = 0; j < kPer; ++j)
#pragma unroll
          for (int i = 0; i < V; ++i) a[j][i] = 0.f;
        for (int c = 0; c < words; ++c) {
          const unsigned word = c < kMaxWords ? mrow[c] : row_word(sm, r, c, words, W, skipped);
          for (unsigned bits = word; bits != 0u; bits &= bits - 1u) {
            const int f = 32 * c + __ffs(bits) - 1;
            const float gv = gs[f];
            const float* krow = kt + (size_t)f * WE + (tap0 - is[f]) * E;
#pragma unroll
            for (int j = 0; j < kPer; ++j) {
              const int v = v0 + L * j;
              if (v >= nv) break;
              if constexpr (V == 4) {
                const float4 kv = __ldg(reinterpret_cast<const float4*>(krow) + v);
                a[j][0] = fmaf(gv, kv.x, a[j][0]);
                a[j][1] = fmaf(gv, kv.y, a[j][1]);
                a[j][2] = fmaf(gv, kv.z, a[j][2]);
                a[j][3] = fmaf(gv, kv.w, a[j][3]);
              } else {
                a[j][0] = fmaf(gv, __ldg(krow + v), a[j][0]);
              }
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int v = v0 + L * j;
          if (v >= nv) break;
          if constexpr (V == 4) {
            *reinterpret_cast<float4*>(out + 4 * v) =
                make_float4(a[j][0], a[j][1], a[j][2], a[j][3]);
          } else {
            out[v] = a[j][0];
          }
        }
      }
    }
  }
  cp_async_wait_all();  // no copy outlives the block
}

struct LaunchCache {
  int dev = -1;
  size_t smem = 0;
  int per_sm = 0;
};

template <int V>
int launch(const float* g, const int* idx, const float* kt, const int* skip, float* dx, int B,
           int T, int E, int F, int W, int rows, int dev, int sms, size_t smem,
           cudaStream_t stream) {
  auto kernel = textcnn_pool_bwd_dx_kernel<V>;
  static LaunchCache cache;  // the attribute and occupancy of the last shape
  if (cache.dev != dev || cache.smem != smem) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    int per_sm = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    cache = {dev, smem, per_sm};
  }
  const int n_chunks = (T + rows - 1) / rows;
  const int items = B * n_chunks;
  const long long fill = (long long)sms * cache.per_sm;
  const int blocks = (int)(items < fill ? items : fill);
  kernel<<<blocks, kThreads, smem, stream>>>(g, idx, kt, skip, dx, T, E, F, W, rows, n_chunks,
                                             items);
  return (int)cudaGetLastError();
}

// (device, opt-in shared memory a block, SMs) of the current device
cudaError_t device_limits(int* dev, int* max_smem, int* sms) {
  cudaError_t err = cudaGetDevice(dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, *dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, *dev);
  return err;
}

}  // namespace

extern "C" {

// Shared memory a block needs at window w and f filters (items of 256
// rows).
size_t textcnn_pool_bwd_dx_smem_bytes(int w, int f) {
  return w > 0 && f > 0 ? smem_bytes(w, f, kMaxRows) : 0;
}

// g [B, F] f32 (gated), idx [B, F] int32, k [W*E, F] f32, skip [B, 2]
// int32 or null, all contiguous; dx [B, T, E] f32; kt, scratch of W*E*F
// floats that the launch overwrites with K transposed. Launches on
// `stream` and returns the CUDA error code of the launches (0 on
// success).
int textcnn_pool_bwd_dx_f32(const float* g, const int* idx, const float* k, const int* skip,
                            float* dx, float* kt, int B, int T, int E, int F, int W,
                            void* stream) {
  if (B <= 0 || T <= 0 || E <= 0 || F <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  // int offsets into K and into the list of items (of at least one row)
  if ((long long)W * E * F >= INT_MAX || (long long)B * T >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  int dev = 0, max_smem = 0, sms = 0;
  cudaError_t err = device_limits(&dev, &max_smem, &sms);
  if (err != cudaSuccess) return (int)err;
  // a doc in items of equal rows (250 each at T=1000, one of 100 at T=100)
  const int chunks = (T + kMaxRows - 1) / kMaxRows;
  const int rows = (T + chunks - 1) / chunks;
  const size_t smem = smem_bytes(W, F, rows);
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;  // F in the thousands
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int WE = W * E;
  textcnn_pool_bwd_dx_transpose<<<dim3((F + kTile - 1) / kTile, (WE + kTile - 1) / kTile),
                                  dim3(kTile, 8), 0, s>>>(k, kt, WE, F);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const bool vec = E % 4 == 0 && reinterpret_cast<uintptr_t>(dx) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(kt) % 16 == 0;
  return vec ? launch<4>(g, idx, kt, skip, dx, B, T, E, F, W, rows, dev, sms, smem, s)
             : launch<1>(g, idx, kt, skip, dx, B, T, E, F, W, rows, dev, sms, smem, s);
}

const char* textcnn_pool_bwd_dx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

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
// by bytes. The design writes every dx byte once, coalesced, and reads
// K only where a tap lands.
//
// Layout. One block per (batch row, tile of `rows` word positions). The
// block zeroes its [rows, E] tile in shared memory, walks f and then w in
// order and, where idx[b, f] + w - (W-1) falls in the tile, adds
// g[b, f] * K[w*E + e, f] to that row; thread j owns the columns
// e = j mod kThreads, so no two threads touch one value and the sum
// runs in the same (f, w) order every time: no atomics, bitwise the same
// result from run to run. Then it zeroes the skip span and writes the
// tile out.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxRows = 64;
constexpr int kSmemFloats = 12288;  // 48 KB: no opt-in attribute needed

int tile_rows(int e) {
  const int r = kSmemFloats / e;
  return r < kMaxRows ? r : kMaxRows;
}

__global__ void __launch_bounds__(kThreads)
textcnn_pool_bwd_dx_kernel(const float* __restrict__ g, const int* __restrict__ idx,
                           const float* __restrict__ k, const int* __restrict__ skip,
                           float* __restrict__ dx, int T, int E, int F, int W, int rows,
                           int n_tiles) {
  extern __shared__ float tile[];  // [rows][E]
  const int b = blockIdx.x / n_tiles;
  const int t0 = (blockIdx.x - b * n_tiles) * rows;
  const int n = min(rows, T - t0);
  const int tid = threadIdx.x;
  for (int i = tid; i < n * E; i += kThreads) tile[i] = 0.f;
  __syncthreads();

  const float* gb = g + (size_t)b * F;
  const int* ib = idx + (size_t)b * F;
  const int lo_start = t0 + (W - 1);  // start s puts tap w at s + w - lo_start
  for (int f = 0; f < F; ++f) {
    const float gv = gb[f];
    if (gv == 0.f) continue;  // gated: adds nothing
    const int s = ib[f];
    for (int w = 0; w < W; ++w) {
      const int r = s + w - lo_start;
      if (r < 0 || r >= n) continue;  // the branch is uniform in the block
      float* row = tile + (size_t)r * E;
      const float* kw = k + (size_t)w * E * F + f;
      for (int e = tid; e < E; e += kThreads) row[e] = fmaf(gv, kw[(size_t)e * F], row[e]);
    }
  }
  __syncthreads();

  int lo = 0, hi = 0;
  if (skip != nullptr) {
    lo = skip[2 * b];
    hi = lo + skip[2 * b + 1];
  }
  float* out = dx + ((size_t)b * T + t0) * E;
  for (int i = tid; i < n * E; i += kThreads) {
    const int t = t0 + i / E;
    out[i] = (t >= lo && t < hi) ? 0.f : tile[i];
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs at word width e.
size_t textcnn_pool_bwd_dx_smem_bytes(int e, int) {
  return e > 0 ? sizeof(float) * (size_t)tile_rows(e) * e : 0;
}

// g [B, F] f32 (gated), idx [B, F] int32, k [W*E, F] f32, skip [B, 2]
// int32 or null, all contiguous; dx [B, T, E] f32. Launches on `stream`
// and returns the CUDA error code of the launch (0 on success).
int textcnn_pool_bwd_dx_f32(const float* g, const int* idx, const float* k, const int* skip,
                            float* dx, int B, int T, int E, int F, int W, void* stream) {
  if (B <= 0 || T <= 0 || E <= 0 || F <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const int rows = tile_rows(E);
  if (rows < 1) return (int)cudaErrorInvalidValue;  // E > 12288
  const int n_tiles = (T + rows - 1) / rows;
  const long long blocks = (long long)B * n_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)rows * E;
  textcnn_pool_bwd_dx_kernel<<<(unsigned)blocks, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(g, idx, k, skip, dx, T, E, F,
                                                                    W, rows, n_tiles);
  return (int)cudaGetLastError();
}

const char* textcnn_pool_bwd_dx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// TextCNN backward, kernel gradient only:
//   dK[w*E + e, f] = sum_b g[b, f] * x_pad[b, idx[b, f] + w, e]
// where g is the output cotangent already gated by out > 0, idx the
// forward's winning window start, and x_pad the doc zero-padded by W - 1
// words on both ends and zeroed inside the optional per-row skip span
// [skip_lo, skip_lo + len). dK is [W*E, F] tap-major, the layout of
// TextCNN.conv_kernel. db = sum_b g is left to PyTorch.
//
// Replaces `_paired_bwd_dg_kernel` of reviews4rec_tpu/ops/textcnn_pallas.py
// (launched from `_dg_only_from_xp`), the backward of every TextCNN tower
// over the frozen word table, where dx is dead. The TPU kernel rebuilds a
// winner mask over every window start and runs one matmul with it; none
// of that layout (paired operand, scattered G, phase mask, fold-back)
// carries over: the work is a gather of the W winning taps per (b, f)
// and a reduction over b.
//
// Bound. At the training shape (B=256, T=1000, E=64, F=100, W=3, f32)
// the function needs 2*B*F*W*E = 9.8 MFLOP, nothing for a tensor core,
// and must read the distinct doc rows that some winning window covers
// (at most B*F*W*E*4 = 19.7 MB, fewer where windows overlap), g and idx
// (0.2 MB) and write dK (77 KB): a few microseconds of HBM traffic at
// 3.35 TB/s. It is bound by bytes, and by latency at this size, since
// the whole output is only 19200 values.
//
// Layout. One thread per output element (w, e, f), e fastest, so the 32
// lanes of a warp read 32 consecutive floats of one word row. Each
// thread walks b in order and keeps its sum in a register: no atomics,
// no second pass, and the result is bitwise the same from run to run.
// Rows with g == 0 (gated) are skipped without reading x.
//
// Row-gathered variant, `textcnn_pool_bwd_dg_rows_f32`: the same kernel
// body (template flag kGather) reading x_pad from table[rows[b]] of a whole
// [N, T, E] entity doc table, with no [B, T, E] copy. Replaces
// `_gathered_bwd_dg_kernel` (reviews4rec_tpu/ops/textcnn_pallas.py,
// launched from `_gathered_dg`), whose per-row DMA pipeline has no
// counterpart: each thread loads rows[b] where it would use b. The sums
// run in the same order as the plain kernel's, so the two agree bitwise on
// table[rows]. A row outside [0, N) with a non-zero g adds NaN to the dK
// values it touches. Bound as above: 9.8 MFLOP and at most 19.7 MB of
// winning-tap rows (the distinct table rows and positions the winning
// windows cover), a few microseconds.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;

// kGather: x is a [N, T, E] table and batch row b reads x[rows[b]]
template <bool kGather>
__global__ void __launch_bounds__(kThreads)
textcnn_pool_bwd_dg_kernel(const float* __restrict__ x, const int* __restrict__ rows,
                           const float* __restrict__ g, const int* __restrict__ idx,
                           const int* __restrict__ skip, float* __restrict__ dk, int N,
                           int B, int T, int E, int F, int W) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)W * E * F) return;
  const int e = (int)(i % E);
  const long long wf = i / E;
  const int f = (int)(wf % F);
  const int w = (int)(wf / F);
  const int shift = w - (W - 1);  // doc position = start + shift

  float acc = 0.f;
#pragma unroll 4
  for (int b = 0; b < B; ++b) {
    const float gv = g[(size_t)b * F + f];
    const int p = idx[(size_t)b * F + f] + shift;
    bool in = gv != 0.f && p >= 0 && p < T;
    if (skip != nullptr) {
      const int lo = skip[2 * b];
      in = in && (p < lo || p >= lo + skip[2 * b + 1]);
    }
    if (in) {
      float xv;
      if constexpr (kGather) {
        const int src = rows[b];
        xv = (src >= 0 && src < N) ? x[((size_t)src * T + p) * E + e]
                                   : __int_as_float(0x7fc00000);  // NaN
      } else {
        xv = x[((size_t)b * T + p) * E + e];
      }
      acc = fmaf(gv, xv, acc);
    }
  }
  dk[((size_t)w * E + e) * F + f] = acc;
}

template <bool kGather>
int launch(const float* x, const int* rows, const float* g, const int* idx, const int* skip,
           float* dk, int N, int B, int T, int E, int F, int W, void* stream) {
  if (N <= 0 || B <= 0 || T <= 0 || E <= 0 || F <= 0 || W <= 0)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)W * E * F;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  textcnn_pool_bwd_dg_kernel<kGather>
      <<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          x, rows, g, idx, skip, dk, N, B, T, E, F, W);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The kernel uses no shared memory.
size_t textcnn_pool_bwd_dg_smem_bytes(int, int) { return 0; }

// x [B, T, E] f32, g [B, F] f32 (gated), idx [B, F] int32, skip [B, 2]
// int32 or null, all contiguous; dk [W*E, F] f32. Launches on `stream`
// and returns the CUDA error code of the launch (0 on success).
int textcnn_pool_bwd_dg_f32(const float* x, const float* g, const int* idx, const int* skip,
                            float* dk, int B, int T, int E, int F, int W, void* stream) {
  return launch<false>(x, nullptr, g, idx, skip, dk, B, B, T, E, F, W, stream);
}

// The row-gathered dK: table [N, T, E] and rows [B] int32 in place of x;
// batch row b reads table[rows[b]]. g, idx and skip are per batch row.
int textcnn_pool_bwd_dg_rows_f32(const float* table, const int* rows, const float* g,
                                 const int* idx, const int* skip, float* dk, int N, int B,
                                 int T, int E, int F, int W, void* stream) {
  return launch<true>(table, rows, g, idx, skip, dk, N, B, T, E, F, W, stream);
}

const char* textcnn_pool_bwd_dg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

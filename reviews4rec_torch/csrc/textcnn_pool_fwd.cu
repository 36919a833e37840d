// TextCNN forward: out[b, f] = max_s relu(sum_w x_pad[b, s + w, :] . K[w*E:(w+1)*E, f] + bias[f])
// over the T + W - 1 window starts s of the doc zero-padded by W - 1 words
// on both ends, and idx[b, f] = the LOWEST start that reaches the max.
//
// Replaces the two Pallas forwards of reviews4rec_tpu/ops/textcnn_pallas.py:
// `_paired_kernel` (E = 64, W <= 3) and `_kernel` (any E, W). Unlike
// `_paired_kernel`, which keeps the even start of an exact tie inside one
// 256-start chunk, this kernel returns the true first argmax, as `_kernel`
// does. An optional per-row (start, len) word span is zeroed before the
// conv, as `_input_mask` does; len 0 masks nothing.
//
// Bound. At the serving shape (B=256, T=1000, E=64, F=100, W=3, f32) one
// call does 2*B*(T+W-1)*W*E*F = 9.85 GFLOP on 65.5 MB of input: about 20 us
// of HBM traffic at 3.35 TB/s, but 147 us of float32 FMA at the 67 TFLOP/s
// the H100 has outside its tensor cores. In f32 the op is bound by
// operations. This first kernel spends them on the CUDA cores: the window
// overlap is used in registers (each word row of a thread's 8 starts is
// loaded once from shared memory and feeds W taps), each K value loaded
// feeds 8 starts, and nothing but [B, F] leaves the chip. TF32 or bf16
// tensor cores (wgmma) and TMA loads are the next step.
//
// Layout. One block per (batch row, tile of 64 filters); blocks share no
// state. The block stages its [W*E, 64] slice of K in shared memory once,
// then walks over time in tiles of 64 starts: it loads the tile's
// 64 + W - 1 padded word rows (its own halo) transposed into shared memory,
// each warp computes 8 starts x 64 filters (2 filters and 8 starts a
// thread), and every thread keeps its running max and first argmax in
// registers. A last pass over shared memory merges the 8 warps' results,
// lowest start first on equal values. The sum runs in the same order for
// every start, so windows of equal content give bit-equal values and the
// tie goes to the lower start.
//
// Row-gathered variant, `textcnn_pool_fwd_rows_f32`: the same kernel body
// (template flag kGather) on table[rows[b]] of a whole [N, T, E] entity doc
// table. Replaces `_gathered_paired_kernel` (textcnn_pallas.py, launched
// from `_gathered_call`), whose per-row DMA pipeline, semaphores and
// double-buffered slots have no counterpart here: the block loads rows[b]
// once and reads its doc from that row. It does exactly the plain kernel's
// arithmetic in the same order, so the two agree bitwise on table[rows],
// tie rule included. A row outside [0, N) writes NaN to its block's out and
// -1 to its idx, so a bad id shows in the loss instead of reading foreign
// memory. Bound as above: 9.85 GFLOP, 0.147 ms at 67 TFLOP/s (operations),
// over at most 65.5 MB of table rows (the distinct rows of the batch). What
// it saves is the [B, T, E] copy table[rows] that the plain kernel needs:
// 65.5 MB written and read back, 131 MB, at least 39 us at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kFiltersPerThread = 2;
constexpr int kFT = 32 * kFiltersPerThread;  // filters per block
constexpr int kRT = 8;                        // starts per thread and tile
constexpr int kTT = kWarps * kRT;             // starts per tile
constexpr int kMaxWindow = 8;

__host__ __device__ constexpr int round_up4(int v) { return (v + 3) & ~3; }

// floats of one word column of the transposed tile: a warp reads
// round_up4(kRT + W - 1) rows from its first start, 16-byte aligned
__host__ __device__ constexpr int tile_pitch(int window) {
  return kTT - kRT + round_up4(kRT + window - 1);
}

size_t smem_bytes(int e, int window) {
  return sizeof(float) * ((size_t)window * e * kFT           // K slice
                          + (size_t)e * tile_pitch(window)   // x tile
                          + 2 * (size_t)kWarps * kFT);        // merge scratch
}

// kGather: x is a [N, T, E] table and block row b reads x[rows[b]]
template <int W, bool kGather>
__global__ void __launch_bounds__(kThreads)
textcnn_pool_fwd_kernel(const float* __restrict__ x, const int* __restrict__ rows,
                        const float* __restrict__ k, const float* __restrict__ bias,
                        const int* __restrict__ skip, float* __restrict__ out,
                        int* __restrict__ idx, int N, int T, int E, int F) {
  constexpr int kPitch = tile_pitch(W);
  constexpr int kRows = kTT + W - 1;             // padded rows a tile reads
  constexpr int kVec = round_up4(kRT + W - 1) / 4;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);   // [W*E][kFT]
  float* xs = ks + (size_t)W * E * kFT;          // [E][kPitch]
  float* merge_v = xs + (size_t)E * kPitch;      // [kWarps][kFT]
  int* merge_i = reinterpret_cast<int*>(merge_v + kWarps * kFT);

  const int b = blockIdx.x;
  const int f0 = blockIdx.y * kFT;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int t_out = T + W - 1;
  int src = b;
  if constexpr (kGather) {
    src = rows[b];
    if (src < 0 || src >= N) {  // the whole block leaves: no barrier crossed
      if (tid < kFT && f0 + tid < F) {
        out[(size_t)b * F + f0 + tid] = __int_as_float(0x7fc00000);  // NaN
        idx[(size_t)b * F + f0 + tid] = -1;
      }
      return;
    }
  }
  const float* xb = x + (size_t)src * T * E;

  int skip_lo = 0, skip_hi = 0;
  if (skip != nullptr) {
    skip_lo = skip[2 * b];
    skip_hi = skip_lo + skip[2 * b + 1];
  }

  for (int i = tid; i < W * E * kFT; i += kThreads) {
    const int r = i / kFT;
    const int f = f0 + i % kFT;
    ks[i] = f < F ? k[(size_t)r * F + f] : 0.f;
  }
  float bias_c[kFiltersPerThread];
#pragma unroll
  for (int c = 0; c < kFiltersPerThread; ++c) {
    const int f = f0 + kFiltersPerThread * lane + c;
    bias_c[c] = f < F ? bias[f] : 0.f;
  }

  float best[kFiltersPerThread];
  int best_s[kFiltersPerThread];
#pragma unroll
  for (int c = 0; c < kFiltersPerThread; ++c) {
    best[c] = -1.f;  // every valid start gives relu(.) >= 0
    best_s[c] = 0;
  }

  const int tr = warp * kRT;  // this warp's first start within the tile
  for (int s0 = 0; s0 < t_out; s0 += kTT) {
    __syncthreads();  // the previous tile is no longer read
    for (int i = tid; i < kRows * E; i += kThreads) {
      const int r = i / E;
      const int e = i - r * E;
      const int word = s0 + r - (W - 1);
      float v = 0.f;
      if (word >= 0 && word < T && (word < skip_lo || word >= skip_hi))
        v = xb[(size_t)word * E + e];
      xs[e * kPitch + r] = v;
    }
    __syncthreads();

    float acc[kRT][kFiltersPerThread];
#pragma unroll
    for (int j = 0; j < kRT; ++j)
#pragma unroll
      for (int c = 0; c < kFiltersPerThread; ++c) acc[j][c] = 0.f;

    for (int e = 0; e < E; ++e) {
      const float4* col = reinterpret_cast<const float4*>(xs + e * kPitch + tr);
      float xv[4 * kVec];
#pragma unroll
      for (int q = 0; q < kVec; ++q) {
        const float4 v = col[q];
        xv[4 * q] = v.x;
        xv[4 * q + 1] = v.y;
        xv[4 * q + 2] = v.z;
        xv[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const float2 kv = *reinterpret_cast<const float2*>(
            ks + (size_t)(w * E + e) * kFT + kFiltersPerThread * lane);
#pragma unroll
        for (int j = 0; j < kRT; ++j) {
          acc[j][0] = fmaf(xv[j + w], kv.x, acc[j][0]);
          acc[j][1] = fmaf(xv[j + w], kv.y, acc[j][1]);
        }
      }
    }

    // starts rise with j, so a strict > keeps the first of equal values
#pragma unroll
    for (int j = 0; j < kRT; ++j) {
      const int s = s0 + tr + j;
      if (s < t_out) {
#pragma unroll
        for (int c = 0; c < kFiltersPerThread; ++c) {
          const float v = fmaxf(acc[j][c] + bias_c[c], 0.f);
          if (v > best[c]) {
            best[c] = v;
            best_s[c] = s;
          }
        }
      }
    }
  }

  // merge the warps, which hold interleaved slabs of starts
#pragma unroll
  for (int c = 0; c < kFiltersPerThread; ++c) {
    merge_v[warp * kFT + kFiltersPerThread * lane + c] = best[c];
    merge_i[warp * kFT + kFiltersPerThread * lane + c] = best_s[c];
  }
  __syncthreads();
  if (tid < kFT && f0 + tid < F) {
    float v = merge_v[tid];
    int s = merge_i[tid];
    for (int w = 1; w < kWarps; ++w) {
      const float ov = merge_v[w * kFT + tid];
      const int os = merge_i[w * kFT + tid];
      if (ov > v || (ov == v && os < s)) {
        v = ov;
        s = os;
      }
    }
    out[(size_t)b * F + f0 + tid] = v;
    idx[(size_t)b * F + f0 + tid] = s;
  }
}

template <int W, bool kGather>
int launch(const float* x, const int* rows, const float* k, const float* bias,
           const int* skip, float* out, int* idx, int N, int B, int T, int E, int F,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(E, W);
  cudaError_t err = cudaFuncSetAttribute(textcnn_pool_fwd_kernel<W, kGather>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B, (F + kFT - 1) / kFT);
  textcnn_pool_fwd_kernel<W, kGather><<<grid, kThreads, smem, stream>>>(
      x, rows, k, bias, skip, out, idx, N, T, E, F);
  return (int)cudaGetLastError();
}

template <bool kGather>
int dispatch(const float* x, const int* rows, const float* k, const float* bias,
             const int* skip, float* out, int* idx, int N, int B, int T, int E, int F, int W,
             void* stream) {
  if (N <= 0 || B <= 0 || T <= 0 || E <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 1: return launch<1, kGather>(x, rows, k, bias, skip, out, idx, N, B, T, E, F, s);
    case 2: return launch<2, kGather>(x, rows, k, bias, skip, out, idx, N, B, T, E, F, s);
    case 3: return launch<3, kGather>(x, rows, k, bias, skip, out, idx, N, B, T, E, F, s);
    case 4: return launch<4, kGather>(x, rows, k, bias, skip, out, idx, N, B, T, E, F, s);
    case 5: return launch<5, kGather>(x, rows, k, bias, skip, out, idx, N, B, T, E, F, s);
    case 6: return launch<6, kGather>(x, rows, k, bias, skip, out, idx, N, B, T, E, F, s);
    case 7: return launch<7, kGather>(x, rows, k, bias, skip, out, idx, N, B, T, E, F, s);
    case 8: return launch<8, kGather>(x, rows, k, bias, skip, out, idx, N, B, T, E, F, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs; the caller checks it against the card.
size_t textcnn_pool_fwd_smem_bytes(int e, int window) { return smem_bytes(e, window); }

int textcnn_pool_fwd_max_window() { return kMaxWindow; }

// x [B, T, E], k [W*E, F], bias [F], skip [B, 2] or null, all contiguous;
// out [B, F] f32 and idx [B, F] int32. Launches on `stream` and returns
// the CUDA error code of the launch (0 on success).
int textcnn_pool_fwd_f32(const float* x, const float* k, const float* bias, const int* skip,
                         float* out, int* idx, int B, int T, int E, int F, int W,
                         void* stream) {
  return dispatch<false>(x, nullptr, k, bias, skip, out, idx, B, B, T, E, F, W, stream);
}

// The row-gathered forward: table [N, T, E] and rows [B] int32 in place of
// x; batch row b reads table[rows[b]]. skip, out and idx are per batch row
// as above.
int textcnn_pool_fwd_rows_f32(const float* table, const int* rows, const float* k,
                              const float* bias, const int* skip, float* out, int* idx,
                              int N, int B, int T, int E, int F, int W, void* stream) {
  return dispatch<true>(table, rows, k, bias, skip, out, idx, N, B, T, E, F, W, stream);
}

const char* textcnn_pool_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

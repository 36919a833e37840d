// A yardstick, not an op, for the warpgroup TF32 product of the TextCNN
// forward's rows body (wgmma_tf32.cuh, textcnn_pool_fwd.cu):
// - `wgmma_tf32_check`: one 64 x 104 tile D = A . B over K (a multiple of
//   8, at most 192) in 3xTF32, by wgmma (A from registers, B from shared
//   memory by a descriptor with the given byte offsets) and by
//   `mma.sync.m16n8k8` on the same split (hi = rna_tf32(v), lo =
//   rna_tf32(v - hi); per k-step lo*hi, hi*lo, hi*hi), for chip_smoke.py to
//   hold against float64;
// - `wgmma_tf32_rate_launch`: two warpgroups a block, one block an SM,
//   each warpgroup issuing the forward's k-step (three m64n104k8 into one
//   accumulator, a commit, a wait for all but the last group) on fixed
//   register fragments, 24 k-steps a tile; chip_smoke.py prints TFLOP/s
//   = 2 * 64 * 104 * 8 a wgmma over the time.

#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_tf32.cuh"

namespace {

constexpr int kNT = wg::kN / 8;  // n8 tiles

__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

// B's offset in floats inside one of its hi / lo copies: [k-step][n8 tile]
// [k half][column in the tile][k in the half], core matrices of 128 bytes
__device__ __forceinline__ int b_offset(int kk, int f) {
  return (((kk / 8) * kNT + f / 8) * 2 + (kk % 8) / 4) * 32 + (f % 8) * 4 + kk % 4;
}

// one warpgroup: a [64, K], b [K, 104], d [64, 104], row-major f32
__global__ void __launch_bounds__(128, 1)
wgmma_tile(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ d,
           int K, int lbo, int sbo) {
  extern __shared__ float bs[];
  const int tid = threadIdx.x;
  const int per = K * wg::kN;  // floats of one copy
  for (int i = tid; i < per; i += blockDim.x) {
    const int kk = i / wg::kN, f = i - kk * wg::kN;
    uint32_t hi, lo;
    split_tf32(b[i], hi, lo);
    bs[b_offset(kk, f)] = __uint_as_float(hi);
    bs[per + b_offset(kk, f)] = __uint_as_float(lo);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(bs));
  float acc[wg::kAcc];
#pragma unroll
  for (int i = 0; i < wg::kAcc; ++i) acc[i] = 0.f;
  for (int ks = 0; ks < K / 8; ++ks) {
    const float* ap = a + (size_t)(warp * 16 + g) * K + ks * 8 + tq;
    uint32_t hi[4], lo[4];
    split_tf32(ap[0], hi[0], lo[0]);
    split_tf32(ap[8 * K], hi[1], lo[1]);
    split_tf32(ap[4], hi[2], lo[2]);
    split_tf32(ap[8 * K + 4], hi[3], lo[3]);
    const uint64_t bh = wg::desc(base + ks * kNT * 256, lbo, sbo);
    const uint64_t bl = wg::desc(base + 4 * per + ks * kNT * 256, lbo, sbo);
    wg::pin(acc);
    wg::fence();
    wg::mma(acc, lo, bh, ks > 0);
    wg::mma(acc, hi, bl, 1);
    wg::mma(acc, hi, bh, 1);
    wg::commit();
    wg::wait<0>();
    wg::pin(acc);
  }
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      d[(size_t)(warp * 16 + g) * wg::kN + 8 * j + 2 * tq + c] = acc[4 * j + c];
      d[(size_t)(warp * 16 + g + 8) * wg::kN + 8 * j + 2 * tq + c] = acc[4 * j + 2 + c];
    }
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the same tile by four warps of mma.sync, 16 rows each
__global__ void mma_sync_tile(const float* __restrict__ a, const float* __restrict__ b,
                              float* __restrict__ d, int K) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  float acc[kNT][4] = {};
  for (int ks = 0; ks < K / 8; ++ks) {
    const float* ap = a + (size_t)(warp * 16 + g) * K + ks * 8 + tq;
    uint32_t hi[4], lo[4];
    split_tf32(ap[0], hi[0], lo[0]);
    split_tf32(ap[8 * K], hi[1], lo[1]);
    split_tf32(ap[4], hi[2], lo[2]);
    split_tf32(ap[8 * K + 4], hi[3], lo[3]);
    for (int j = 0; j < kNT; ++j) {
      uint32_t b0h, b0l, b1h, b1l;
      split_tf32(b[(size_t)(ks * 8 + tq) * wg::kN + 8 * j + g], b0h, b0l);
      split_tf32(b[(size_t)(ks * 8 + tq + 4) * wg::kN + 8 * j + g], b1h, b1l);
      mma_tf32(acc[j], lo, b0h, b1h);
      mma_tf32(acc[j], hi, b0l, b1l);
      mma_tf32(acc[j], hi, b0h, b1h);
    }
  }
  for (int j = 0; j < kNT; ++j)
    for (int c = 0; c < 2; ++c) {
      d[(size_t)(warp * 16 + g) * wg::kN + 8 * j + 2 * tq + c] = acc[j][c];
      d[(size_t)(warp * 16 + g + 8) * wg::kN + 8 * j + 2 * tq + c] = acc[j][2 + c];
    }
}

constexpr int kRateSteps = 24;  // k-steps of a tile at W = 3, E = 64

__global__ void __launch_bounds__(256, 1) wgmma_stream(float* out, int iters) {
  extern __shared__ float bs[];
  const int per = kRateSteps * 8 * wg::kN;
  for (int i = threadIdx.x; i < 2 * per; i += blockDim.x) bs[i] = 1e-3f * (i % 7);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(bs));
  uint32_t hi[4], lo[4];
  for (int q = 0; q < 4; ++q) split_tf32(1.0f + threadIdx.x * 1e-3f + q, hi[q], lo[q]);
  float acc[wg::kAcc];
#pragma unroll
  for (int i = 0; i < wg::kAcc; ++i) acc[i] = 0.f;
  for (int it = 0; it < iters; ++it)
    for (int ks = 0; ks < kRateSteps; ++ks) {
      const uint64_t bh = wg::desc(base + ks * kNT * 256, 128, 256);
      const uint64_t bl = wg::desc(base + 4 * per + ks * kNT * 256, 128, 256);
      wg::fence();
      wg::mma(acc, lo, bh, 1);
      wg::mma(acc, hi, bl, 1);
      wg::mma(acc, hi, bh, 1);
      wg::commit();
      wg::wait<1>();
    }
  wg::wait<0>();
  wg::pin(acc);
  float s = 0.f;
  for (int i = 0; i < wg::kAcc; ++i) s += acc[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

extern "C" {

// a [64, K], b [K, 104], d_wg and d_mma [64, 104], all f32 on the card;
// K % 8 == 0 and K <= 192. Returns the CUDA error of the launches.
int wgmma_tf32_check(const float* a, const float* b, float* d_wg, float* d_mma, int K, int lbo,
                     int sbo, void* stream) {
  if (K <= 0 || K % 8 || K > 192) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = 2 * K * wg::kN * 4;
  cudaError_t err =
      cudaFuncSetAttribute(wgmma_tile, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  wgmma_tile<<<1, 128, smem, s>>>(a, b, d_wg, K, lbo, sbo);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mma_sync_tile<<<1, 128, 0, s>>>(a, b, d_mma, K);
  return (int)cudaGetLastError();
}

// `blocks` blocks of two warpgroups, each `iters` x 24 k-steps of three
// wgmma; out holds blocks * 256 floats
int wgmma_tf32_rate_launch(float* out, int blocks, int iters, void* stream) {
  const int smem = 2 * kRateSteps * 8 * wg::kN * 4;
  cudaError_t err =
      cudaFuncSetAttribute(wgmma_stream, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  wgmma_stream<<<blocks, 256, smem, static_cast<cudaStream_t>(stream)>>>(out, iters);
  return (int)cudaGetLastError();
}

}  // extern "C"

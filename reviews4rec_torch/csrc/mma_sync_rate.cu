// A yardstick, not an op: every warp issues a stream of independent
// `mma.sync.aligned.m16n8k8` TF32 on register fragments (16 accumulators,
// no memory traffic in the loop). Its rate is the ceiling of any kernel
// built on that instruction, such as the TextCNN forward
// (textcnn_pool_fwd.cu), which issues three per product term (3xTF32).
// chip_smoke.py times it at the forward's 8 warps a block, one block per
// SM, and prints TFLOP/s = 2 * 16 * 8 * 8 per mma over the time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void mma_sync_stream(float* out, int iters) {
  float acc[16][4] = {};
  uint32_t a[4], b[2];
  for (int q = 0; q < 4; ++q) a[q] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + q);
  for (int q = 0; q < 2; ++q) b[q] = __float_as_uint(1e-3f * (q + 1));
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  // one store per thread, so the compiler keeps every mma
  float s = 0.f;
  for (int j = 0; j < 16; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

extern "C" {

// `blocks` blocks of `threads` threads, each warp `iters` x 16 mma; out
// holds blocks * threads floats. Returns the CUDA error of the launch.
int mma_sync_rate_launch(float* out, int blocks, int threads, int iters, void* stream) {
  mma_sync_stream<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(out, iters);
  return (int)cudaGetLastError();
}

}  // extern "C"

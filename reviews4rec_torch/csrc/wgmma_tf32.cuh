// Warpgroup TF32 products (`wgmma.mma_async`, sm_90a) as the TextCNN
// forward uses them: m64n104k8 with A, 64 rows by 8 k, from registers and
// B, 8 k by 104 columns, from shared memory by descriptor. Shared by
// textcnn_pool_fwd.cu and the wgmma_tf32_rate.cu yardstick.
//
// A in registers: warp q of the warpgroup holds rows 16q..16q+15 as
// `mma.sync.m16n8k8`'s A fragment: lane (g = lane / 4, tq = lane % 4)
// holds (row g, k tq), (g + 8, tq), (g, tq + 4), (g + 8, tq + 4).
// The accumulators: 52 a thread, d[4j + c] = (row g, column 8j + 2tq + c)
// and d[4j + 2 + c] = (row g + 8, column 8j + 2tq + c), rows of warp q
// offset by 16q, as 13 `mma.sync` m16n8 accumulators side by side.
//
// B in shared memory, K-major without swizzle: core matrices of 8
// columns (n) by 4 k (16 bytes a column), each 128 contiguous bytes;
// `lbo` bytes from a core matrix to the next 4 k, `sbo` bytes to the next
// 8 columns.

#pragma once

#include <stdint.h>

namespace wg {

constexpr int kN = 104;       // columns of one product: 13 n8 tiles
constexpr int kAcc = kN / 2;  // accumulators a thread

__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3fff) | ((uint64_t)((lbo >> 4) & 0x3fff) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3fff) << 32);
}

// orders this thread's register and shared-memory writes before the
// warpgroup's next wgmma
__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most kPending committed groups are in flight
template <int kPending>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// the compiler may not move a read or write of the accumulators across
// this point (their values change behind its back while a wgmma runs)
__device__ __forceinline__ void pin(float (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d = a * b + (accumulate ? d : 0), in f32 from tf32 operands
__device__ __forceinline__ void mma(float (&d)[kAcc], const uint32_t (&a)[4], uint64_t b,
                                    int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %57, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51}, {%52, %53, %54, %55}, %56, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

}  // namespace wg

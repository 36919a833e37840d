// Per-example SGD of the surprise-equivalent baseline, SVD and SVD++
// models: the whole epoch x example recurrence of
// reviews4rec_tpu/models/neighbors.py `_sgd_fit` (:51-113), one
// `lax.scan` over the train stream inside a scan over epochs there, as
// one launch here. Per example (u, i, r), from the state as it stood
// before that example (JAX's `new = dict(state)`):
//
//   est  = mu + bu[u] + bi[i] (+ p[u] . q[i]               SVD)
//                             (+ q[i] . (p[u] + imp)        SVD++)
//   imp  = |I_u|^-1/2 sum_{j < cnt[u]} y[pad[u, j]]          (SVD++)
//   err  = r - est
//   bu[u] += lr (err - reg bu[u]);   bi[i] += lr (err - reg bi[i])
//   p[u]  += lr (err q[i] - reg p[u])
//   q[i]  += lr (err p[u] - reg q[i])            (SVD; SVD++: p[u] + imp)
//   y[pad[u, j]] += lr (err |I_u|^-1/2 q[i] - reg y[pad[u, j]])  (SVD++)
//
// The y update is JAX's `.at[items_u].add` over the padded list: the pad
// slots (j >= cnt[u]) add 0 and are skipped here, and an item that
// appears twice in a user's list gets both updates, each computed from
// the value before the example. So the y updates of an example are first
// computed into `scratch` ([max_items, K]) and then added.
//
// Why a kernel. The recurrence is sequential: 20 epochs x 79,577
// examples = 1,591,540 dependent updates at the e2e corpus's size. In
// eager PyTorch each is some 10-30 launches of a few microseconds; a
// CUDA graph replays the same launch count.
//
// Design. One block of one warp runs the whole loop in train insertion
// order. Lane k owns factor column k (and k + 32, ... for K > 32) of p,
// q and y: it is the only thread that reads or writes those addresses,
// so program order within the lane orders each write before the next
// example's read of it, and no fence is needed between lanes. bu and bi
// are read and written by lane 0 alone for the same reason. The dot
// products are summed across lanes with `__shfl_xor_sync` (registers,
// not memory) and `err` is broadcast from lane 0 with `__shfl_sync`. The
// state stays in global memory: SVD++ holds U + I + (U + 2I) K floats,
// 59,315 (237 KB) at the e2e corpus's U = 2500, I = 1515, K = 10, more
// than the 227 KB of shared memory a block may have; it stays in the
// 50 MB L2. Products and sums are rounded one at a time (`__fmul_rn`,
// `__fadd_rn`: no fused multiply-add), in the order of the expressions
// above, as the plain PyTorch version computes them; only the order of
// the dot products' sums (a tree over lanes) and of the SVD++ implicit
// sum (sequential over j) differ from it.
//
// Bound. Each update reads and writes a few state values that the
// previous update may have written: the recurrence is latency bound,
// updates x one dependent read-modify-write of the state. The bytes it
// moves (the train stream once an epoch, the state once) take
// microseconds at 3.35 TB/s. `neighbors_sgd_rmw_chain` below times a
// chain of dependent read-modify-writes of one global float, the
// yardstick chip_smoke.py prints beside the kernel.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kMaxPerLane = 4;  // factor columns a lane owns: K <= 128
enum Variant { kBaseline = 0, kSvd = 1, kSvdpp = 2 };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <int kVariant>
__global__ void __launch_bounds__(32, 1)
neighbors_sgd_kernel(const int* __restrict__ users, const int* __restrict__ items,
                     const float* __restrict__ ratings, int n, float* bu, float* bi, float* p,
                     float* q, float* y, const int* __restrict__ rated_pad,
                     const float* __restrict__ rated_count, int max_items, float* scratch,
                     int K, int epochs, float mu, float lr, float reg) {
  const int lane = threadIdx.x;
  for (int ep = 0; ep < epochs; ++ep) {
    for (int ex = 0; ex < n; ++ex) {
      const int u = users[ex];
      const int i = items[ex];
      const float r = ratings[ex];
      float pu[kMaxPerLane], qi[kMaxPerLane], imp[kMaxPerLane];
      float part = 0.f;
      float sq = 0.f;  // |I_u|^-1/2
      int cnt = 0;
      const int* pad = rated_pad + (size_t)u * max_items;
      if constexpr (kVariant == kSvdpp) {
        const float c = rated_count[u];
        cnt = (int)c;
        sq = __frsqrt_rn(fmaxf(c, 1.f));
      }
      if constexpr (kVariant != kBaseline) {
#pragma unroll
        for (int m = 0; m < kMaxPerLane; ++m) {
          const int k = lane + 32 * m;
          pu[m] = qi[m] = imp[m] = 0.f;
          if (k >= K) continue;
          pu[m] = p[(size_t)u * K + k];
          qi[m] = q[(size_t)i * K + k];
          if constexpr (kVariant == kSvdpp) {
            float s = 0.f;
            for (int j = 0; j < cnt; ++j) s = __fadd_rn(s, y[(size_t)pad[j] * K + k]);
            imp[m] = __fmul_rn(s, sq);
            part = __fadd_rn(part, __fmul_rn(qi[m], __fadd_rn(pu[m], imp[m])));
          } else {
            part = __fadd_rn(part, __fmul_rn(pu[m], qi[m]));
          }
        }
      }
      const float dot = kVariant == kBaseline ? 0.f : warp_sum(part);
      float err = 0.f;
      if (lane == 0) {
        const float bu_u = bu[u];
        const float bi_i = bi[i];
        float est = __fadd_rn(__fadd_rn(mu, bu_u), bi_i);
        if (kVariant != kBaseline) est = __fadd_rn(est, dot);
        err = __fsub_rn(r, est);
        bu[u] = __fadd_rn(bu_u, __fmul_rn(lr, __fsub_rn(err, __fmul_rn(reg, bu_u))));
        bi[i] = __fadd_rn(bi_i, __fmul_rn(lr, __fsub_rn(err, __fmul_rn(reg, bi_i))));
      }
      err = __shfl_sync(0xffffffffu, err, 0);
      if constexpr (kVariant != kBaseline) {
#pragma unroll
        for (int m = 0; m < kMaxPerLane; ++m) {
          const int k = lane + 32 * m;
          if (k >= K) continue;
          const float pterm = kVariant == kSvdpp ? __fadd_rn(pu[m], imp[m]) : pu[m];
          p[(size_t)u * K + k] = __fadd_rn(
              pu[m], __fmul_rn(lr, __fsub_rn(__fmul_rn(err, qi[m]), __fmul_rn(reg, pu[m]))));
          q[(size_t)i * K + k] = __fadd_rn(
              qi[m], __fmul_rn(lr, __fsub_rn(__fmul_rn(err, pterm), __fmul_rn(reg, qi[m]))));
          if constexpr (kVariant == kSvdpp) {
            // every update from the value before the example, then added
            const float eq = __fmul_rn(__fmul_rn(err, sq), qi[m]);
            for (int j = 0; j < cnt; ++j) {
              const float yj = y[(size_t)pad[j] * K + k];
              scratch[(size_t)j * K + k] = __fmul_rn(lr, __fsub_rn(eq, __fmul_rn(reg, yj)));
            }
            for (int j = 0; j < cnt; ++j) {
              float* yp = y + (size_t)pad[j] * K + k;
              *yp = __fadd_rn(*yp, scratch[(size_t)j * K + k]);
            }
          }
        }
      }
    }
  }
}

template <int kVariant>
int launch(const int* users, const int* items, const float* ratings, int n, float* bu,
           float* bi, float* p, float* q, float* y, const int* rated_pad,
           const float* rated_count, int max_items, float* scratch, int K, int epochs, float mu,
           float lr, float reg, cudaStream_t stream) {
  neighbors_sgd_kernel<kVariant><<<1, 32, 0, stream>>>(users, items, ratings, n, bu, bi, p, q,
                                                       y, rated_pad, rated_count, max_items,
                                                       scratch, K, epochs, mu, lr, reg);
  return (int)cudaGetLastError();
}

// a chain of dependent read-modify-writes of one float: the next address
// depends on the value read, so each load waits for the previous one
__global__ void rmw_chain_kernel(float* a, int n) {
  int j = 0;
  for (int it = 0; it < n; ++it) {
    const float v = a[j];
    a[j] = v + 1.f;
    j = (int)(v * 0.f);
  }
}

}  // namespace

extern "C" {

// users, items [n] int32 and ratings [n] f32: the train stream in
// insertion order. State, updated in place: bu [U], bi [I] and, for SVD
// and SVD++ (variant 1, 2), p [U, K], q [I, K]; for SVD++ also y [I, K],
// rated_pad [U, max_items] int32, rated_count [U] f32 and scratch
// [max_items, K] f32. Unused pointers may be null. K <= 128. Launches one
// warp on `stream` and returns the CUDA error code of the launch.
int neighbors_sgd_fit(const int* users, const int* items, const float* ratings, int n,
                      float* bu, float* bi, float* p, float* q, float* y, const int* rated_pad,
                      const float* rated_count, int max_items, float* scratch, int K,
                      int epochs, int variant, float mu, float lr, float reg, void* stream) {
  if (n < 0 || epochs < 0 || K < 0 || K > 32 * kMaxPerLane) return (int)cudaErrorInvalidValue;
  if (variant != kBaseline && (p == nullptr || q == nullptr || K < 1))
    return (int)cudaErrorInvalidValue;
  if (variant == kSvdpp &&
      (y == nullptr || rated_pad == nullptr || rated_count == nullptr || scratch == nullptr ||
       max_items < 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kBaseline:
      return launch<kBaseline>(users, items, ratings, n, bu, bi, p, q, y, rated_pad,
                               rated_count, max_items, scratch, K, epochs, mu, lr, reg, st);
    case kSvd:
      return launch<kSvd>(users, items, ratings, n, bu, bi, p, q, y, rated_pad, rated_count,
                          max_items, scratch, K, epochs, mu, lr, reg, st);
    case kSvdpp:
      return launch<kSvdpp>(users, items, ratings, n, bu, bi, p, q, y, rated_pad, rated_count,
                            max_items, scratch, K, epochs, mu, lr, reg, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// n dependent read-modify-writes of a[0] by one thread (a yardstick).
int neighbors_sgd_rmw_chain(float* a, int n, void* stream) {
  rmw_chain_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(a, n);
  return (int)cudaGetLastError();
}

const char* neighbors_sgd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

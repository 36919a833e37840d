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
// appears m times in a user's list gets m equal updates, each computed
// from the value before the example and added one after the other. The
// host hands the kernel each list as (item, mult) slots
// (`ops/neighbors.py::slot_table`): mult is the item's count in the list
// at its first slot and 0 at every later slot of it, so exactly one
// lane writes each row and adds its update mult times.
//
// Why a kernel. The recurrence is sequential: 20 epochs x 79,577
// examples = 1,591,540 dependent updates at the e2e corpus's size. In
// eager PyTorch each is some 10-30 launches of a few microseconds; a
// CUDA graph replays the same launch count.
//
// Bound. Each update reads state that the previous update may have
// written, so the recurrence is latency bound: updates x the chain of
// one update. The bytes it moves (the train stream once an epoch, the
// state once) take microseconds at 3.35 TB/s. `neighbors_sgd_rmw_chain`
// below times a chain of dependent read-modify-writes of one global
// float (29.8 ns on the H100), the yardstick chip_smoke.py prints beside
// the kernel.
//
// Design. A warp issues at most one instruction a cycle and waits out
// each dependent one (a few cycles for an add, tens for a shuffle or a
// shared-memory load), so an update costs its instruction count plus its
// chain; the design cuts both.
// - Lanes over (list slot, factor) pairs, fixed at compile time. KP
//   lanes (K rounded up to a power of two, at most 32) cover a row's
//   factors, a lane owning factors kb, kb + KP, ... (kM <= 4 of them,
//   K <= 128), and G = 32 / KP groups of them a warp take slots of the
//   user's list. SVD++ runs 4 warps, one on each of the SM's four
//   schedulers, so 4 G groups (8 at K = 10: 8 slots x 10 factors a pass)
//   take slots j = g, g + 4G, ...; baseline and SVD run one warp. A lane
//   holds 8 / kM slots' rows in registers (64 of a list at K = 10; the
//   e2e corpus's longest has 51), read back to back (only pad -> y
//   depends) in blocks, a block skipped when the list ends before it, and
//   keeps them for the y update, so a row is read once an example. Slots
//   past the registers (longer lists) are summed chunk by chunk and
//   re-read for their update: a row is written only at its item's first
//   slot, so no row a later chunk re-reads has been written in the same
//   example.
// - Fixed-order reductions, no atomics: a block's slots by a pairwise
//   tree and the blocks in order; a factor's group partials by an xor
//   butterfly over the group bits, then (SVD++) the 4 warps' partials
//   through shared memory, added in warp order by every warp; the dot
//   over the KP factor lanes by an xor butterfly (four steps at K = 10).
//   In an xor butterfly every lane adds the same two values, so every
//   lane holds the same bits of the implicit sum and of err, and two
//   launches agree bitwise.
// - Prefetch. The train stream (u, i, r and, for SVD++, the user's list
//   count, with a flag for a list that repeats an item, and its
//   |I_u|^-1/2, which the host computes once a fit) is read 32
//   examples at a time, one example a lane, a batch ahead, and handed
//   out by shuffle. At the head of example n the warps issue the loads of
//   example n + 2's p[u], q[i], bu[u], bi[i] and example n + 1's list
//   slots up to its count. Values read before examples n and n + 1
//   stored are replaced in registers by theirs where they wrote the same
//   user or item (forwarding); nothing else can write them. The loop is
//   unrolled three times, the three value sets taking turns, so no
//   register is copied out of a load still in flight. Only the y rows are
//   read inside the chain, once the previous example has stored.
// - State in shared memory where it fits. The host picks, greedily in
//   the order y, q, bi, bu, p (the most read first), the arrays that fit
//   in the card's opt-in shared memory less 2 KB for the warps' partial
//   sums (`ops/neighbors.py::placement`, 225 KB on the H100; set by
//   `cudaFuncSetAttribute`); the block's eight warps copy them in, the
//   fit runs, and the eight copy them back. y, when placed, is read and
//   written by 32-bit shared addresses (`ld.shared`): through a generic
//   pointer each access converts the address again. At the e2e corpus
//   (U = 2500, I = 1515, K = 10) SVD++ places y, q, bi and bu (137 KB)
//   and leaves p (100 KB) in global memory, where only prefetched loads
//   read it; SVD and baseline place everything. At 10^5 users the user
//   arrays stay global, and with as many items nothing is placed: the
//   same body runs on global memory (L1 and the 50 MB L2).
// - Order of memory between lanes and warps. Every lane computes the
//   same new bu, bi and the same p, q for its factors, and all of them
//   store those same bits: no predicate and no divergence around the
//   stores, each lane's forwarded copy agrees with memory, and a lane
//   only reads a bias or factor value that it stored itself (or never),
//   so its own program order orders it. SVD++'s y rows are written by
//   the lane of a slot and read by any lane or warp at the next example:
//   a barrier of its 4 warps (`bar.sync 1`) closes every example, and
//   within an example every y read of the implicit sum precedes the
//   first y store through the barrier where the warps exchange their
//   partial sums.
// - Products and sums are rounded one at a time (`__fmul_rn`,
//   `__fadd_rn`: no fused multiply-add), in the order of the expressions
//   above, as the plain PyTorch version computes them; only the order of
//   the sums inside the dot products and the implicit sum differ from it.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

// the block's shared memory: the placed arrays, y first when placed
extern __shared__ float4 smem4[];

namespace {

constexpr int kThreads = 256;  // every warp copies; warp 0 runs the fit
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRedBytes = 2048;  // SVD++: the warps' partial sums, 4 x kM x KP floats
enum Variant { kBaseline = 0, kSvd = 1, kSvdpp = 2 };
// the arrays that may lie in shared memory, as bits of `smem_mask`
enum Placed { kBu = 1, kBi = 2, kP = 4, kQ = 8, kY = 16 };
// a packed slot: item in the low 24 bits, mult above; an example's list
// meta: count in the low 30 bits, bit 30 set when an item repeats
constexpr int kItemBits = 24;
constexpr int kItemMask = (1 << kItemBits) - 1;
constexpr int kCountMask = (1 << 30) - 1;

struct State {
  float *bu, *bi, *p, *q, *y;
};

struct Stream {
  const int* __restrict__ users;
  const int* __restrict__ items;
  const float* __restrict__ ratings;
  const int* __restrict__ meta;    // SVD++: the list meta of each example
  const float* __restrict__ sqs;   // SVD++: |I_u|^-1/2 of each example
};

__host__ __device__ constexpr size_t align16(size_t b) { return (b + 15) & ~(size_t)15; }

// bytes of shared memory of the placed arrays (each 16-byte aligned)
__host__ __device__ size_t placed_bytes(int mask, int U, int I, int K) {
  size_t b = 0;
  if (mask & kY) b += align16(4 * (size_t)I * K);
  if (mask & kQ) b += align16(4 * (size_t)I * K);
  if (mask & kP) b += align16(4 * (size_t)U * K);
  if (mask & kBi) b += align16(4 * (size_t)I);
  if (mask & kBu) b += align16(4 * (size_t)U);
  return b;
}

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// v += lr (grad - reg v), the update of every parameter
__device__ __forceinline__ float step(float v, float grad, float lr, float reg) {
  return add(v, mul(lr, sub(grad, mul(reg, v))));
}

// the xor butterfly over lane bits [kFrom, 32): every lane of a set that
// differs only in those bits gets the same bits of their sum
template <int kFrom>
__device__ __forceinline__ float butterfly(float v) {
#pragma unroll
  for (int off = kFrom; off < 32; off <<= 1) v = add(v, __shfl_xor_sync(kFull, v, off));
  return v;
}
template <int kTo>
__device__ __forceinline__ float butterfly_below(float v) {
#pragma unroll
  for (int off = 1; off < kTo; off <<= 1) v = add(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// y in shared memory, by 32-bit shared addresses (no generic pointer,
// so no conversion at each access); the stores are ordered after every
// earlier load by the data they store
__device__ __forceinline__ float lds(uint32_t a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ void sts(uint32_t a, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(a), "f"(v) : "memory");
}
// the fit's warps meet (barrier 1; barrier 0 is the block's)
template <int kWarps>
__device__ __forceinline__ void fit_sync() {
  if constexpr (kWarps == 1)
    __syncwarp();
  else
    asm volatile("bar.sync 1, %0;\n" ::"n"(kWarps * 32) : "memory");
}

// an example's biases and factor rows as the chain reads them
template <int kM>
struct Vals {
  float bu, bi;
  float p[kM], q[kM];
};

template <int kVariant, int kKP, int kM>
__device__ __forceinline__ void fetch_vals(Vals<kM>& f, const State& s, int u, int i, int K,
                                           int kb) {
  f.bu = s.bu[u];
  f.bi = s.bi[i];
  if constexpr (kVariant != kBaseline) {
    const int pu = u * K + kb, qi = i * K + kb;
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      const bool ok = kb + kKP * m < K;
      f.p[m] = ok ? s.p[pu + kKP * m] : 0.f;
      f.q[m] = ok ? s.q[qi + kKP * m] : 0.f;
    }
  }
}

// where u (i) is the user (item) example `from` wrote, its new values
template <int kVariant, int kM>
__device__ __forceinline__ void forward(Vals<kM>& f, int u, int i, int fu, int fi,
                                        const Vals<kM>& from) {
  if (u == fu) {
    f.bu = from.bu;
#pragma unroll
    for (int m = 0; m < kM; ++m)
      if (kVariant != kBaseline) f.p[m] = from.p[m];
  }
  if (i == fi) {
    f.bi = from.bi;
#pragma unroll
    for (int m = 0; m < kM; ++m)
      if (kVariant != kBaseline) f.q[m] = from.q[m];
  }
}

// this lane's packed slots of a list, up to its count; the table's width
// is a multiple of the slot groups x kBlock, so a block that starts
// before the count lies inside the row
template <int kGT, int kSlots, int kBlock>
__device__ __forceinline__ void fetch_slots(int (&sl)[kSlots], const int* __restrict__ row,
                                            int cnt) {
#pragma unroll
  for (int b = 0; b < kSlots / kBlock; ++b) {
    if (kGT * kBlock * b >= cnt) continue;
#pragma unroll
    for (int t = b * kBlock; t < (b + 1) * kBlock; ++t) sl[t] = row[kGT * t];
  }
}

// one batch of 32 examples of the stream, example base + lane a lane
template <int kVariant>
__device__ __forceinline__ void load_batch(int base, int lane, int total, int n,
                                           const Stream& st, int& bu, int& bi, float& br,
                                           int& bm, float& bsq) {
  const int g = base + lane;
  bu = bi = bm = 0;
  br = bsq = 0.f;
  if (g < total) {
    const int e = g % n;
    bu = st.users[e];
    bi = st.items[e];
    br = st.ratings[e];
    if constexpr (kVariant == kSvdpp) {
      bm = st.meta[e];
      bsq = st.sqs[e];
    }
  }
}

// a fixed pairwise sum of N (a power of two) values
template <int N>
__device__ __forceinline__ float tree_sum(float (&v)[N]) {
#pragma unroll
  for (int w = N / 2; w >= 1; w /= 2)
#pragma unroll
    for (int t = 0; t < w; ++t) v[t] = add(v[t], v[t + w]);
  return v[0];
}

// The fit, run by kWarps warps (SVD++: 4, one on each of the SM's four
// schedulers; else 1). kYs: y lies in shared memory at shared address ys,
// read and written there by 32-bit offsets; else through s.y. red: room
// in shared memory for the warps' partial implicit sums.
template <int kVariant, int kKP, int kM, int kWarps, bool kYs>
struct Fit {
  static constexpr int kG = 32 / kKP;                             // slot groups a warp
  static constexpr int kGT = kWarps * kG;                         // and in all
  static constexpr int kSlots = kVariant == kSvdpp ? 8 / kM : 1;  // slots a lane holds
  static constexpr int kBlock = kVariant == kSvdpp ? 4 / kM : 1;  // skipped together
  static constexpr int kChunk = kGT * kSlots;                     // slots the registers hold

  Stream st;
  int n, width, K, total;
  State s;
  const int* __restrict__ slots;
  float mu, lr, reg;
  uint32_t ys, red;
  int lane, warp, kb, gg;
  // the stream: batch a holds examples [base, base + 32), batch b the next
  int au, ai, am, bu_, bi_, bm, base;
  float ar, br, asq, bsq;
  // examples g and g + 1, and the user and item example g - 1 wrote
  int u, i, meta, u1, i1, meta1, pu, pi;
  float r, r1, sq, sq1;
  Vals<kM> prev;

  // y at offset 0 of the block's shared memory (indexed on the shared
  // array itself, so the compiler addresses it as shared), or global
  __device__ __forceinline__ float y_ld(int off) const {
    if constexpr (kYs)
      return reinterpret_cast<const float*>(smem4)[off];
    else
      return s.y[off];
  }
  __device__ __forceinline__ void y_st(int off, float v) const {
    if constexpr (kYs)
      reinterpret_cast<float*>(smem4)[off] = v;
    else
      s.y[off] = v;
  }

  // Example g. cur: its values; n1: example g + 1's, read before examples
  // g - 1 and g stored; n2: filled here with example g + 2's; sl and nsl:
  // the slots of examples g and g + 1 (nsl filled here). The three value
  // slots and the slot rows take turns from one call to the next, so no
  // register is copied out of a load still in flight.
  __device__ __forceinline__ void example(int g, Vals<kM>& cur, Vals<kM>& n1, Vals<kM>& n2,
                                          int (&sl)[kSlots], int (&nsl)[kSlots]) {
    // the head: example g + 2's stream entry and values, example g + 1's
    // slots; all issued before example g stores anything
    const int n2g = g + 2;
    if (n2g - base == 32) {
      base += 32;
      au = bu_;
      ai = bi_;
      ar = br;
      am = bm;
      asq = bsq;
      load_batch<kVariant>(base + 32, lane, total, n, st, bu_, bi_, br, bm, bsq);
    }
    const int src = n2g & 31;
    const int u2 = __shfl_sync(kFull, au, src), i2 = __shfl_sync(kFull, ai, src);
    const float r2 = __shfl_sync(kFull, ar, src);
    const int meta2 = kVariant == kSvdpp ? __shfl_sync(kFull, am, src) : 0;
    const float sq2 = kVariant == kSvdpp ? __shfl_sync(kFull, asq, src) : 0.f;
    if (n2g < total) fetch_vals<kVariant, kKP>(n2, s, u2, i2, K, kb);
    if constexpr (kVariant == kSvdpp)
      if (g + 1 < total)
        fetch_slots<kGT, kSlots, kBlock>(nsl, slots + u1 * width + gg, meta1 & kCountMask);

    // the implicit sum (SVD++)
    const int cnt = meta & kCountMask;
    const int nv = cnt > gg ? (cnt - gg + kGT - 1) / kGT : 0;  // this lane's slots
    float imp[kM], yv[kSlots][kM];
    int off[kSlots];  // y offset of each slot's row at factor kb
#pragma unroll
    for (int m = 0; m < kM; ++m) imp[m] = 0.f;
    if constexpr (kVariant == kSvdpp) {
      float part[kM];
#pragma unroll
      for (int m = 0; m < kM; ++m) part[m] = 0.f;
#pragma unroll
      for (int b = 0; b < kSlots / kBlock; ++b) {
        if (kGT * kBlock * b >= cnt) continue;
#pragma unroll
        for (int t = b * kBlock; t < (b + 1) * kBlock; ++t) {
          off[t] = (sl[t] & kItemMask) * K + kb;
#pragma unroll
          for (int m = 0; m < kM; ++m)
            yv[t][m] = t < nv && kb + kKP * m < K ? y_ld(off[t] + kKP * m) : 0.f;
        }
#pragma unroll
        for (int m = 0; m < kM; ++m) {
          float v[kBlock];
#pragma unroll
          for (int t = 0; t < kBlock; ++t) v[t] = yv[b * kBlock + t][m];
          part[m] = add(part[m], tree_sum(v));
        }
      }
      // lists longer than the registers hold: chunk by chunk
      for (int c0 = kChunk; c0 < cnt; c0 += kChunk) {
        const int* row = slots + u * width + c0 + gg;
        for (int t = 0; t < kSlots && c0 + kGT * t < cnt; ++t) {
          const bool ok = c0 + gg + kGT * t < cnt;
          const int o = ok ? (row[kGT * t] & kItemMask) * K + kb : 0;
#pragma unroll
          for (int m = 0; m < kM; ++m)
            part[m] = add(part[m], ok && kb + kKP * m < K ? y_ld(o + kKP * m) : 0.f);
        }
      }
#pragma unroll
      for (int m = 0; m < kM; ++m) part[m] = butterfly<kKP>(part[m]);
      if constexpr (kWarps > 1) {
        // the warps' partials, added in warp order by every warp
        if (lane < kKP)
#pragma unroll
          for (int m = 0; m < kM; ++m) sts(red + 4u * ((warp * kM + m) * kKP + kb), part[m]);
        fit_sync<kWarps>();
#pragma unroll
        for (int m = 0; m < kM; ++m) {
          part[m] = lds(red + 4u * (m * kKP + kb));
#pragma unroll
          for (int w = 1; w < kWarps; ++w)
            part[m] = add(part[m], lds(red + 4u * ((w * kM + m) * kKP + kb)));
        }
      }
#pragma unroll
      for (int m = 0; m < kM; ++m) imp[m] = mul(part[m], sq);
    }

    // err, from the dot over the KP factor lanes of each group
    float dot = 0.f;
    if constexpr (kVariant != kBaseline) {
      float term = 0.f;
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        const float pt = kVariant == kSvdpp ? add(cur.p[m], imp[m]) : cur.p[m];
        const float tm = kb + kKP * m < K ? mul(cur.q[m], pt) : 0.f;
        term = m == 0 ? tm : add(term, tm);
      }
      dot = butterfly_below<kKP>(term);
    }
    float est = add(add(mu, cur.bu), cur.bi);
    if constexpr (kVariant != kBaseline) est = add(est, dot);
    const float err = sub(r, est);
    Vals<kM> nw;  // example g's new values
    nw.bu = step(cur.bu, err, lr, reg);
    nw.bi = step(cur.bi, err, lr, reg);
    // every lane stores the same bits: no predicate, no divergence
    s.bu[u] = nw.bu;
    s.bi[i] = nw.bi;
    if constexpr (kVariant != kBaseline) {
      const int pu_ = u * K + kb, qi_ = i * K + kb;
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        const float pt = kVariant == kSvdpp ? add(cur.p[m], imp[m]) : cur.p[m];
        nw.p[m] = step(cur.p[m], mul(err, cur.q[m]), lr, reg);
        nw.q[m] = step(cur.q[m], mul(err, pt), lr, reg);
        if (kb + kKP * m < K) {  // every group the same bits
          s.p[pu_ + kKP * m] = nw.p[m];
          s.q[qi_ + kKP * m] = nw.q[m];
        }
      }
    }

    if constexpr (kVariant == kSvdpp) {
      // every y read of this example precedes its y stores: through the
      // warps' meeting above (kWarps > 1) or here
      if constexpr (kWarps == 1) __syncwarp();
      float eq[kM];
#pragma unroll
      for (int m = 0; m < kM; ++m) eq[m] = mul(mul(err, sq), cur.q[m]);
      // slots held in registers: each row at its item's first slot, one
      // update; an item listed mult > 1 times gets the rest below
#pragma unroll
      for (int b = 0; b < kSlots / kBlock; ++b) {
        if (kGT * kBlock * b >= cnt) continue;
#pragma unroll
        for (int t = b * kBlock; t < (b + 1) * kBlock; ++t) {
          const bool first = t < nv && sl[t] >= (1 << kItemBits);
#pragma unroll
          for (int m = 0; m < kM; ++m) {
            const float v = add(yv[t][m], mul(lr, sub(eq[m], mul(reg, yv[t][m]))));
            if (first && kb + kKP * m < K) y_st(off[t] + kKP * m, v);
          }
        }
      }
      if (meta >> 30) {  // a list that repeats an item (rare)
#pragma unroll
        for (int t = 0; t < kSlots; ++t) {
          const int mult = sl[t] >> kItemBits;
          if (!(kGT * t < cnt && t < nv && mult > 1)) continue;
#pragma unroll
          for (int m = 0; m < kM; ++m) {
            if (kb + kKP * m >= K) continue;
            const float upd = mul(lr, sub(eq[m], mul(reg, yv[t][m])));
            float v = add(yv[t][m], upd);
            for (int c = 1; c < mult; ++c) v = add(v, upd);
            y_st(off[t] + kKP * m, v);
          }
        }
      }
      // the rest of a long list, re-read: no row of it was written above
      for (int c0 = kChunk; c0 < cnt; c0 += kChunk) {
        const int* row = slots + u * width + c0 + gg;
        for (int t = 0; t < kSlots && c0 + kGT * t < cnt; ++t) {
          if (c0 + gg + kGT * t >= cnt) continue;
          const int slt = row[kGT * t];
          const int mult = slt >> kItemBits;
          if (mult <= 0) continue;
          const int o = (slt & kItemMask) * K + kb;
#pragma unroll
          for (int m = 0; m < kM; ++m) {
            if (kb + kKP * m >= K) continue;
            const float y0 = y_ld(o + kKP * m);
            const float upd = mul(lr, sub(eq[m], mul(reg, y0)));
            float v = add(y0, upd);
            for (int c = 1; c < mult; ++c) v = add(v, upd);
            y_st(o + kKP * m, v);
          }
        }
      }
    }

    // example g + 1's values were read before examples g - 1 and g
    // stored: theirs replace them where they wrote the same row
    forward<kVariant>(n1, u1, i1, pu, pi, prev);
    forward<kVariant>(n1, u1, i1, u, i, nw);
    // this example's stores before the next one's loads (SVD++: lanes
    // and warps read y rows others wrote; baseline and SVD read only
    // addresses each lane itself stored, with the same bits as every
    // other lane, so program order suffices)
    if constexpr (kVariant == kSvdpp) fit_sync<kWarps>();
    pu = u;
    pi = i;
    prev = nw;
    u = u1;
    i = i1;
    r = r1;
    meta = meta1;
    sq = sq1;
    u1 = u2;
    i1 = i2;
    r1 = r2;
    meta1 = meta2;
    sq1 = sq2;
  }

  __device__ __forceinline__ void run() {
    if (total == 0) return;
    load_batch<kVariant>(0, lane, total, n, st, au, ai, ar, am, asq);
    load_batch<kVariant>(32, lane, total, n, st, bu_, bi_, br, bm, bsq);
    base = 0;
    u = __shfl_sync(kFull, au, 0);
    i = __shfl_sync(kFull, ai, 0);
    r = __shfl_sync(kFull, ar, 0);
    meta = __shfl_sync(kFull, am, 0);
    sq = __shfl_sync(kFull, asq, 0);
    u1 = __shfl_sync(kFull, au, 1);
    i1 = __shfl_sync(kFull, ai, 1);
    r1 = __shfl_sync(kFull, ar, 1);
    meta1 = __shfl_sync(kFull, am, 1);
    sq1 = __shfl_sync(kFull, asq, 1);
    pu = pi = -1;
    Vals<kM> v0, v1, v2;
    int s0[kSlots], s1[kSlots], s2[kSlots];
    fetch_vals<kVariant, kKP>(v0, s, u, i, K, kb);
    if (total > 1) fetch_vals<kVariant, kKP>(v1, s, u1, i1, K, kb);
    if constexpr (kVariant == kSvdpp)
      fetch_slots<kGT, kSlots, kBlock>(s0, slots + u * width + gg, meta & kCountMask);
    for (int g = 0; g < total; g += 3) {
      example(g, v0, v1, v2, s0, s1);
      if (g + 1 < total) example(g + 1, v1, v2, v0, s1, s2);
      if (g + 2 < total) example(g + 2, v2, v0, v1, s2, s0);
    }
  }
};

// copy the placed arrays between global and shared memory, all threads;
// work's pointers then point at the shared copies
__device__ void copy_placed(State& work, const State& glob, int mask, int U, int I, int K,
                            float* smem, bool in) {
  size_t off = 0;  // floats
  auto one = [&](int bit, float* g, float*& w, size_t count) {
    if (!(mask & bit)) return;
    float* d = smem + off;
    off += align16(4 * count) / 4;
    for (size_t x = threadIdx.x; x < count; x += blockDim.x) {
      if (in)
        d[x] = g[x];
      else
        g[x] = d[x];
    }
    w = d;
  };
  one(kY, glob.y, work.y, (size_t)I * K);
  one(kQ, glob.q, work.q, (size_t)I * K);
  one(kP, glob.p, work.p, (size_t)U * K);
  one(kBi, glob.bi, work.bi, (size_t)I);
  one(kBu, glob.bu, work.bu, (size_t)U);
}

// warps of the fit
template <int kVariant>
__host__ __device__ constexpr int fit_warps() {
  return kVariant == kSvdpp ? 4 : 1;
}

template <int kVariant, int kKP, int kM, bool kYs>
__global__ void __launch_bounds__(kThreads, 1)
neighbors_sgd_kernel(Stream st, int n, State glob, int U, int I, const int* __restrict__ slots,
                     int width, int K, int total, float mu, float lr, float reg, int mask) {
  constexpr int kWarps = fit_warps<kVariant>();
  float* smem = reinterpret_cast<float*>(smem4);
  State work = glob;
  copy_placed(work, glob, mask, U, I, K, smem, true);
  __syncthreads();
  const uint32_t ys = static_cast<uint32_t>(__cvta_generic_to_shared(smem4));
  if (threadIdx.x < 32 * kWarps) {
    Fit<kVariant, kKP, kM, kWarps, kYs> f;
    f.st = st;
    f.n = n;
    f.width = width;
    f.K = K;
    f.total = total;
    f.s = work;
    f.slots = slots;
    f.mu = mu;
    f.lr = lr;
    f.reg = reg;
    f.ys = ys;
    f.red = ys + (uint32_t)placed_bytes(mask, U, I, K);
    f.lane = threadIdx.x & 31;
    f.warp = threadIdx.x >> 5;
    f.kb = f.lane % kKP;
    f.gg = f.warp * (32 / kKP) + f.lane / kKP;
    f.run();
  }
  __syncthreads();
  copy_placed(work, glob, mask, U, I, K, smem, false);
}

// SVD++'s slot step: the table's width is a multiple of its slot groups
// (4 warps x 32 / KP) x its skip block (4 / kM slots)
__host__ __device__ constexpr int slot_step(int K) {
  return (K <= 1 ? 128 : K <= 2 ? 64 : K <= 4 ? 32 : K <= 8 ? 16 : K <= 16 ? 8 : 4) *
         (K <= 32 ? 4 : K <= 64 ? 2 : 1);
}

struct Args {
  Stream st;
  int n;
  State state;
  int U, I;
  const int* slots;
  int width, K, total;
  float mu, lr, reg;
  int mask;
};

template <int kVariant, int kKP, int kM, bool kYs>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem =
      placed_bytes(a.mask, a.U, a.I, a.K) + (kVariant == kSvdpp ? kRedBytes : 0);
  // raised once per instantiation, to the most any launch has asked
  static size_t smem_set = 0;
  if (smem > smem_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(neighbors_sgd_kernel<kVariant, kKP, kM, kYs>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  neighbors_sgd_kernel<kVariant, kKP, kM, kYs><<<1, kThreads, smem, stream>>>(
      a.st, a.n, a.state, a.U, a.I, a.slots, a.width, a.K, a.total, a.mu, a.lr, a.reg, a.mask);
  return (int)cudaGetLastError();
}

// the instantiation of K's lane layout (KP lanes a row, kM factors a
// lane) and of y's place
template <int kVariant, bool kYs>
int launch_k(const Args& a, cudaStream_t stream) {
  if (a.K <= 1) return launch<kVariant, 1, 1, kYs>(a, stream);
  if (a.K <= 2) return launch<kVariant, 2, 1, kYs>(a, stream);
  if (a.K <= 4) return launch<kVariant, 4, 1, kYs>(a, stream);
  if (a.K <= 8) return launch<kVariant, 8, 1, kYs>(a, stream);
  if (a.K <= 16) return launch<kVariant, 16, 1, kYs>(a, stream);
  if (a.K <= 32) return launch<kVariant, 32, 1, kYs>(a, stream);
  if (a.K <= 64) return launch<kVariant, 32, 2, kYs>(a, stream);
  return launch<kVariant, 32, 4, kYs>(a, stream);
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
// meta [n] int32 (each example's list count, bit 30 set where the list
// repeats an item), sqs [n] f32 (each example's |I_u|^-1/2) and slots
// [U, width] int32 (item | mult << 24 of each list slot; width a
// multiple of slot_step(K) and at least the longest list). Unused
// pointers may be null. K <= 128; epochs * n, U * K, I * K and U * width
// below 2^31 - 64. smem_mask: the arrays to keep in shared memory during
// the fit (bits bu 1, bi 2, p 4, q 8, y 16), at most the device's opt-in
// bytes. Launches one block on `stream` and returns the CUDA error code
// of the launch.
int neighbors_sgd_fit(const int* users, const int* items, const float* ratings,
                      const int* meta, const float* sqs, int n, float* bu, float* bi, float* p,
                      float* q, float* y, const int* slots, int U, int I, int width, int K,
                      int epochs, int variant, float mu, float lr, float reg, int smem_mask,
                      void* stream) {
  // every index is 32-bit
  const long long lim = (1LL << 31) - 64;
  if (n < 0 || epochs < 0 || (long long)n * epochs >= lim || U < 1 || I < 1 || K < 0 ||
      K > 128 || (long long)U * K >= lim || (long long)I * K >= lim ||
      (long long)U * width >= lim || smem_mask < 0 || smem_mask > 31)
    return (int)cudaErrorInvalidValue;
  if (variant != kBaseline && (p == nullptr || q == nullptr || K < 1))
    return (int)cudaErrorInvalidValue;
  if (variant == kSvdpp &&
      (y == nullptr || slots == nullptr || meta == nullptr || sqs == nullptr || width < 1 ||
       width % slot_step(K) != 0))
    return (int)cudaErrorInvalidValue;
  // nothing placed that the variant does not have
  const int have =
      kBu | kBi | (variant != kBaseline ? kP | kQ : 0) | (variant == kSvdpp ? kY : 0);
  if (smem_mask & ~have) return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (placed_bytes(smem_mask, U, I, K) + kRedBytes > (size_t)optin)
    return (int)cudaErrorInvalidValue;
  const Args a{{users, items, ratings, meta, sqs}, n, {bu, bi, p, q, y}, U, I, slots, width, K,
               n * epochs, mu, lr, reg, smem_mask};
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kBaseline: return launch<kBaseline, 1, 1, false>(a, cs);
    case kSvd: return launch_k<kSvd, false>(a, cs);
    case kSvdpp:
      return smem_mask & kY ? launch_k<kSvdpp, true>(a, cs) : launch_k<kSvdpp, false>(a, cs);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The shared memory the placed arrays may take on the current device: its
// opt-in bytes a block, less SVD++'s room for partial sums.
int neighbors_sgd_smem_limit(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) *bytes -= kRedBytes;
  return (int)err;
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

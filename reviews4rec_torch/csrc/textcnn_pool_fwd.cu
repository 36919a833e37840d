// TextCNN forward: out[b, f] = max_s relu(sum_w x_pad[b, s + w, :] . K[w*E:(w+1)*E, f] + bias[f])
// over the T + W - 1 window starts s of the doc zero-padded by W - 1 words
// on both ends, and idx[b, f] = the LOWEST start that reaches the max. An
// optional per-row (start, len) word span is zeroed before the conv, as
// `_input_mask` does; len 0 masks nothing.
//
// Replaces three Pallas kernels of reviews4rec_tpu/ops/textcnn_pallas.py:
// `_paired_kernel` (:153, E = 64, W <= 3), `_kernel` (:47, any E and W)
// and, as the row-gathered instantiation below, `_gathered_paired_kernel`
// (:945); as the word-gathered instantiation it is the forward of
// `textcnn_pool_embed` (:768, through `_paired_call` :262 or
// `_forward_generic` :347). Unlike `_paired_kernel`, which keeps the even start of an exact
// tie inside one 256-start chunk, this kernel returns the true first
// argmax, as `_kernel` does.
//
// Bounds at the serving shape (B=256, T=1000, E=64, F=100, W=3, f32):
// - bytes: x, K, bias in and out, idx out, 4*(B*T*E + W*E*F + F) +
//   8*B*F = 65.8 MB, 0.020 ms at 3.35 TB/s;
// - f32 on the CUDA cores: 2*B*(T+W-1)*W*E*F = 9.85 GFLOP, 0.147 ms at
//   67 TFLOP/s, a floor no CUDA-core design passes;
// - 3xTF32 on the tensor cores: 3 products a term of the op's own work,
//   3 * 9.85 = 29.6 GFLOP, 0.0597 ms at the 495 TFLOP/s of dense TF32,
//   bound by operations. This kernel pads F to 104 (13 n8 tiles) and
//   so issues 3*2*256*1002*192*104 = 30.7 GFLOP, 4% over that.
//
// Precision. One TF32 rounding keeps 11 significant bits, about 5e-4 of
// each product: that moves `out` by 1e-3 and flips winning starts, which
// route the gradient. So each operand is split as hi = rna_tf32(a) and
// lo = rna_tf32(a - hi), and each k-step adds a_lo*b_hi and a_hi*b_lo,
// then a_hi*b_hi, into one f32 accumulator (3xTF32; a_lo*b_lo, about
// 2^-24 of the product, is dropped). The error stays near f32 rounding;
// integer inputs are exact in TF32, their lo parts are 0, and such sums
// stay exact (tests/test_torch_tf32_split.py emulates the split).
//
// Design, and why:
// - Tensor cores through `mma.sync.aligned.m16n8k8` TF32 (inline PTX):
//   M = window starts, N = filters, K = W*E. The A operand of tap w for
//   starts s..s+15 is rows s+w..s+w+15 of the x tile in shared memory:
//   the W taps are W row offsets into one tile, so no [T, W*E] window
//   matrix exists and each word crosses HBM once per filter chunk.
// - A warp owns 16 starts (one m16 tile) by up to 13 n8 tiles (104
//   filters): 52 f32 accumulators, 39 mma a k-step in one block of code
//   (no branch inside, so the scheduler interleaves them). One block
//   covers all F <= 104 filters of a batch row, so x is read once per
//   row and F=100 pads to 104, not 128. Each A fragment, loaded and
//   split once, feeds all 13 n-tiles.
// - K is staged once per block in shared memory in B-fragment order and
//   split once: [k-step][n-tile][lane] 16-byte slots (b0 hi, b1 hi, b0
//   lo, b1 lo), one conflict-free 16-byte load per lane and n-tile and
//   no split in the loop. Fixed slot offsets read past nt into the next
//   k-step or a few spare slots; those n-tiles are never used.
// - x tiles of 128 starts (8 warps x 16), 128 + W - 1 word rows, in a
//   2-stage ring filled by `cp.async`: 16-byte `.cg` copies where
//   E % 4 == 0 and x is 16-byte aligned, else 4-byte `.ca` copies. The
//   zero-fill form (src-size 0) writes the padding words, the skip span,
//   the E tail up to a multiple of 8 and rows outside the table without
//   reading anything. The next tile's copies are issued before this
//   tile's mma and waited for with `cp.async.wait_group`, so loads
//   overlap math. Row pitch E8 + 4 floats (E8 = E padded to 8): the
//   lanes of an A-fragment load (row g = lane/4, column lane%4) then
//   fall in 32 distinct banks, since g * pitch mod 32 = 4 * g * odd.
//   A fragments are split in registers (two integer operations and a
//   subtraction per value), 16 values a k-step for 39 mma.
// - Persistent blocks: grid (min(B, SMs / chunks), filter chunks), each
//   block walking batch rows b, b + gridDim.x, ...
//   as one flat sequence of (row, tile) items, so the next row's first
//   tile loads during this row's last one and K is staged once.
// - Epilogue per tile: bias, ReLU, the mask s < T + W - 1 and a running
//   max per accumulator column with strict >, starts rising within a
//   thread's registers. At the end of a row the 8 lanes that share a
//   column merge with __shfl_xor and the warps through the tile's ring
//   stage, the lower start winning on equal values. Every start's sum
//   runs the same mma sequence in the same k order, so windows of equal
//   content give bit-equal values and the tie goes to the lower start.
// - Near-ties (plain-x form only): each column also keeps its second
//   value, the largest of a start other than the winner's, equal values
//   included, merged across lanes and warps with the max (the loser's
//   best or either side's second), and written to `second` when the
//   caller passes it. The 3xTF32 sums sit up to about 1.4e-6 from
//   float64 at NARRE's shape (B = 2560, T = 100), against about 1e-7
//   for f32 sums: enough to order two windows of a near-tie the other
//   way, and so route that (b, f)'s gradient to the window exact
//   arithmetic does not pick. With `refine` each near-tie (out -
//   second at most 1e-5 x max(1, out), out > 0, and out not relu(bias),
//   the value every all-zero window gives exactly) goes on a list in
//   global memory (`ties`) as its row ends. Once every block has listed
//   its rows' near-ties (the blocks are all resident, so they can wait for
//   each other), the blocks share the list out, one entry at a time to a
//   block: K's column and every window's value in f32 (a thread a window,
//   from the row's words staged in a ring stage no tile needs any more),
//   then in float64 the windows within the same tolerance of that f32
//   maximum; idx becomes the first start of the largest float64 value.
//   About 50 of the 256,000 (b, f) of a NARRE tower launch are listed, so
//   a block takes at most one or two. (A pass at each row's end cost 8-15%
//   of the launch at NARRE's shape: a barrier a row, and a block waiting on
//   its own near-ties; one after each block's last row, 10%: the busiest
//   block's tail.) `ops/textcnn.py::refine_ties` is its plain version.
//   The rows and ids forms keep no second value and refine nothing:
//   their code is unchanged.
// - Registers: 52 accumulators, 26 running maxima and 26 starts, the A
//   fragments and the B slots in flight: 205-212 a thread, no spills
//   (ptxas at sm_90a), so 8 warps fit the SM's 64K registers; the
//   plain-x form's 26 second values add to that (PERF.md keeps ptxas's
//   count).
//
// Shared memory at the serving shape: K 24 k-steps x 13 n-tiles x 32
// lanes x 16 B = 159,744 B; x ring 2 x 130 rows x 68 floats = 70,720 B;
// bias 416 B: 230,880 B of the 232,448 a block may have (the ids form
// adds 2 x 130 staged ids, 1,040 B), so one block of 256 threads per SM. Waves: 132 persistent blocks for B = 256 rows, 124
// blocks take 2 rows and 8 take 1, 97% of the row slots busy (one block
// per row, 64 filters a block, would give 512 blocks on the 396 slots
// of three blocks an SM: 65%). Shapes that do not
// fit (large W*E) take fewer filters a block (more chunks in grid.y) and
// then fewer warps: the host picks the first of 8, 4, 2, 1 warps, and for
// it the fewest chunks, that fits (at W = 3, F = 100: 8 warps up to
// E = 176, 4 up to 304, 2 up to 480, then 1; chip_smoke.py checks one
// E of each).
//
// What bounds it. `mma.sync` TF32 does not reach the 495 TFLOP/s of
// `wgmma`: chip_smoke.py times a stream of independent mma
// (mma_sync_rate.cu) at this kernel's 8 warps a block and prints the
// time the 3xTF32 products alone take at that rate; PERF.md keeps the
// reading. The kernel spends the rest on the fragment loads, the A split
// and the per-tile epilogue around them, issued by the warps that issue
// the mma. The rows form's warpgroup body (below) lifts that ceiling at
// the entity towers' shape.
//
// Three sources of x, one body (template parameter kSrc); only the tile
// loader and the row's validity differ:
// - plain x, `textcnn_pool_fwd_f32`: a [B, T, E] doc tensor;
// - rows, `textcnn_pool_fwd_rows_f32`: table[rows[b]] of a whole
//   [N, T, E] entity doc table;
// - ids, `textcnn_pool_fwd_ids_f32`: table[ids[b, t]] of a [V, E] word
//   table, word by word.
//
// Row-gathered variant. The per-row DMA pipeline of
// `_gathered_paired_kernel` has no counterpart: the tile loader reads
// rows[b] and copies from that row. The arithmetic and launch configuration are the plain kernel's,
// so the two agree bitwise on table[rows], tie rule included. A row
// outside [0, N) is zero-filled and writes NaN to its out and -1 to its
// idx, so a bad id shows in the loss instead of reading foreign memory.
// What it saves is the [B, T, E] copy table[rows] that the plain kernel
// needs: 65.5 MB written and read back, at least 39 us at 3.35 TB/s.
//
// The rows form's warpgroup body (`textcnn_pool_fwd_rows_wgmma_kernel`),
// which the rows entry takes at (E, W) = (64, 3) and 96 < F <= 104, the
// shape of every deepconn and deepconn++ entity tower (training, serving
// and the factorized ranking call), where the table is 16-byte aligned;
// every other rows shape keeps the body above. Same op, same 3xTF32
// split and order of products, same tie rule, skip span and bad-row
// output; its sums may differ from the `mma.sync` body's in the last bits
// (chip_smoke.py prints whether they do).
// - Products: `wgmma.mma_async.m64n104k8` TF32 (wgmma_tf32.cuh), a
//   warpgroup's 64 starts by all 104 filters (F padded) a k-step, three
//   products into one f32 accumulator per k-step (lo*hi, hi*lo, hi*hi, in
//   `tile_mma`'s k order). A comes from registers, split there: tap w is
//   a row offset of w into the x tile, which a descriptor cannot take
//   inside a swizzled tile and registers can. B, K's hi and lo copies, is
//   staged once a block, split, in the no-swizzle K-major layout, and
//   read by descriptor: no B fragment passes through a register.
// - The k-loop is straight-line code (24 k-steps at E = 64, W = 3): each
//   k-step's A fragments are registers of their own, and a k-step's
//   products run while the next one's A is loaded and split (a commit
//   and a wait for all but the newest group a k-step).
// - Warp roles: two consumer warpgroups take tiles t % 2 of each batch
//   row (64 starts each, so 128 a pair, as the body above); one producer
//   warp keeps the rows' x tiles in flight in a ring of 4 stages (the
//   next tile of each warpgroup lands while both run their products)
//   with a full and an empty mbarrier each. The producer's 16-byte
//   `cp.async` copies (the zero-fill form for a padding word, the skip
//   span or a row outside [0, N)) arrive on the full barrier as they
//   land (`cp.async.mbarrier.arrive`): no copy is issued by a thread
//   that issues products. (A bulk copy a word row, `cp.async.bulk`, took
//   7% longer a launch on the H100.) The pitch is the body above's,
//   E + 4 floats.
// - Epilogue a tile: bias, ReLU, the mask s < T + W - 1 and the running
//   max per accumulator column (strict >, rising starts within a
//   thread); at a row's end lanes merge by shuffle and the 8 warps of
//   both warpgroups by a shared-memory atomicMax on a packed key a filter
//   (the value's bits, then the start's complement: the lower start wins
//   on equal values). One warpgroup's epilogue runs under the other's
//   products.
// - Blocks: persistent, one an SM, walking batch rows as the body above.
//   Shared memory at E = 64, W = 3: K 2 x 79,872 B, the ring 4 x 66 x
//   272 B, the barriers 64 B, the keys 832 B: 232,448 B, all a block
//   may have.
//   ptxas's registers and spills, and the time a launch beside the body
//   above, are printed by chip_smoke.py and kept in PERF.md.
//
// Word-gathered variant (the fused word gather, `hp.pallas_fuse_gather`):
// the block stages the ids of a tile's starts + W - 1 word positions in
// shared memory once per tile (-1 for a padding position), and each tile
// row is one run of `cp.async` copies of table[id] (E floats, 256 B at
// E = 64) into the same x ring, a padding position or an id outside
// [0, V) zero-filled as the plain loader fills padding. The mma, the ring
// and the argmax are the plain kernel's, so the two agree bitwise on
// table[ids]. A batch row holding an id outside [0, V) writes NaN to its
// out and -1 to its idx (the block checks the row's T ids at its end).
// Bytes at the serving shape: 1.0 MB of ids and the 8921 x 64 table
// (2.3 MB, which stays in L2) in place of 65.5 MB of x a tower; the
// operations, and so the bound, are the plain kernel's.
//
// 16-bit operands, `textcnn_pool_fwd_bf16` and `textcnn_pool_fwd_f16`:
// the forward of the JAX package's XLA TextCNN branch at
// `compute_dtype="bfloat16"` or `"float16"`
// (reviews4rec_tpu/models/layers.py:174-187), which casts x and K to that
// type and accumulates in f32. It is not a Pallas kernel there; here it is
// a kernel of its own, with a body of its own (below the f32 one), a
// template on the 16-bit type T16 (__nv_bfloat16 or __half) that changes
// only the mma instruction's operand type: the f16 `mma.sync` has the
// bf16 one's shape, fragment layout and `ldmatrix` loads, so the tiling,
// pitches, ring and merge below hold for both. What is said of bf16
// below holds for f16.
// - x [B, T, E] and K [W*E, F] are read as T16, bias in f32; out is f32
//   and idx int32.
// - One `mma.sync.aligned.m16n8k16` bf16 (or f16) pass with f32
//   accumulation per k-step (a bf16 product, 8 + 8 significant bits, is
//   exact in f32, and so is an f16 one, 11 + 11), where the f32 body makes
//   three TF32 passes of half the depth.
// - The body: persistent blocks, two an SM and filter chunk, each walking
//   whole batch rows as one flat sequence of (row, tile) items, so no
//   row is split across blocks and the first-argmax merge stays inside
//   the block (lanes by shuffle, warps through a ring stage, the lower
//   start winning on equal values). A block's 8 warps are 2 filter
//   groups (7 n8 tiles, 56 filters, each) of 4 warps that take 32 starts
//   each (two m16 tiles, so each B fragment feeds two mma): tiles of 128
//   starts. That holds a thread to 128 registers, so two blocks (16
//   warps) share an SM and one's loads and merges run under the other's
//   mma. At the serving shape every block takes one row.
// - x tiles (128 + W - 1 word rows of E16 bf16) in a 3-stage ring filled
//   by 16-byte `cp.async.cg` copies (zero-fill for the padding words, the
//   skip span, the E tail and rows past T), so tile it + 2 loads while
//   tile it runs its mma; E % 8 != 0 (or x not 16-byte aligned) takes
//   2-byte copies into the same ring. A thread's first (row, chunk) of a
//   tile and its stride are computed once: no division per copy.
// - K staged once a block as [w*E16 + e][filter] bf16 by 8-byte
//   `cp.async` copies along its rows (coalesced, one division a row);
//   B fragments by `ldmatrix.x4.trans` (two n8 tiles a load; a warp's
//   7th by `.x2`), A fragments by `ldmatrix.x4` at row offset w of the x tile,
//   so the W taps share one tile. Row pitches of 8 x an odd number of
//   bf16 put the 8 rows of each `ldmatrix` in 8 distinct bank groups.
// - The running max takes the raw window sums: relu(fl(sum + bias))
//   rises with the sum, so bias and ReLU are applied once a row, to the
//   max: out is bitwise the max over starts of relu(fl(sum + bias)). idx
//   is the first start of the largest sum, or 0 where out is 0 (every
//   start then gives 0). It can differ from the first start reaching out
//   only where two different sums round to the same value once the bias
//   is added: a near-tie within an ulp of out.
// - What it reaches: PERF.md keeps chip_smoke.py's device time a launch
//   against the bound below. Every warp reloads K's B fragments from
//   shared memory for each 32 starts it takes, the running max costs
//   about a third of the mma loop, and blocks spend a sizeable part of
//   their time before their first mma (the first tiles and K arriving,
//   all SMs at once). `wgmma` (K read from shared memory by descriptor,
//   accumulators of 64 starts a warpgroup) is the next step.
// - Bound at the serving shape (B=256, T=1000, E=64, F=100, W=3): bytes
//   2*B*T*E + 2*W*E*F + 4*F + 8*B*F = 33.3 MB, 0.0099 ms at 3.35 TB/s;
//   operations 2*B*(T+W-1)*W*E*F = 9.85 GFLOP, 0.0100 ms at the 989
//   TFLOP/s of dense bf16 (and of dense fp16): about even, so either may
//   bound it.
//   chip_smoke.py computes both from the run's shapes.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma_tf32.cuh"

namespace {

constexpr int kMaxWarps = 8;
constexpr int kStartsPerWarp = 16;  // one m16 tile
constexpr int kMaxNTiles = 13;      // n8 tiles a block: 104 filters
constexpr int kStages = 2;
constexpr int kMaxWindow = 8;
// a (b, f) whose out - second is at most kTieTol * max(1, out) is a
// near-tie, which `refine` recomputes in float64 (ops/textcnn.py's TIE_TOL)
constexpr float kTieTol = 1e-5f;

// where a tile's word rows come from
enum Source { kPlain = 0, kRows = 1, kIds = 2 };

__host__ __device__ constexpr int pad8(int e) { return (e + 7) & ~7; }
__host__ __device__ constexpr int row_pitch(int e) { return pad8(e) + 4; }

// 16-byte K slots of one block: [k-step][n-tile][lane] (b0 hi, b1 hi,
// b0 lo, b1 lo), then kMaxNTiles - nt spare n-tiles, so that the fixed
// offsets of the last k-step's unused n-tiles stay inside K
__host__ __device__ constexpr int k_slots(int e, int window, int nt) {
  return (window * pad8(e) / 8 * nt + kMaxNTiles - nt) * 32;
}

// floats of one stage of the x ring: the tile's word rows, or the merge
// of the warps' (value, start, second value) per filter, which it takes
// at a row's end
__host__ __device__ constexpr int stage_floats(int e, int window, int nt, int warps) {
  return (warps * kStartsPerWarp + window - 1) * row_pitch(e) > 3 * warps * nt * 8
             ? (warps * kStartsPerWarp + window - 1) * row_pitch(e)
             : 3 * warps * nt * 8;
}

// bytes of shared memory one block takes: K, the x ring, the bias and,
// for the ids source, a ring of each tile's word ids
size_t smem_bytes(int e, int window, int nt, int warps, bool ids) {
  return 16 * (size_t)k_slots(e, window, nt) +
         sizeof(float) * ((size_t)kStages * stage_floats(e, window, nt, warps) + nt * 8) +
         (ids ? sizeof(int) * kStages * (warps * kStartsPerWarp + window - 1) : 0);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// copy `bytes` (0 or the full size) and zero-fill the rest of the 16 or 4
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most `kPending` of this thread's groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// round to TF32, to nearest with ties away from zero: the bits of
// `cvt.rna.tf32.f32` in two integer operations (the tensor cores read
// only the 19 high bits of an operand, so the compiler may drop the mask
// where the value only feeds an mma)
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + lo exactly in f32 before lo's own rounding
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

// d += a * b on the tensor cores: a 16x8 (row), b 8x8 (col), d 16x8 f32.
// Not volatile: the scheduler may interleave independent accumulators;
// the mma into one accumulator keep their order through d.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc = the sums of one warp's 16 starts (tile rows from xw) by the 13
// n8 tiles of filters whose K slots start at kp0, in 3xTF32: per k-step
// a_lo*b_hi, a_hi*b_lo, a_hi*b_hi
template <int W>
__device__ __forceinline__ void tile_mma(float (&acc)[kMaxNTiles][4], const float* xw,
                                         const uint4* kp0, int pitch, int kcs, int nt, int g,
                                         int tq) {
#pragma unroll
  for (int j = 0; j < kMaxNTiles; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    for (int kc = 0; kc < kcs; ++kc) {
      // A: rows w + {g, g+8}, columns kc*8 + {tq, tq+4}
      const float* ap = xw + (size_t)(w + g) * pitch + kc * 8 + tq;
      uint32_t a_hi[4], a_lo[4];
      split_tf32(ap[0], a_hi[0], a_lo[0]);
      split_tf32(ap[8 * pitch], a_hi[1], a_lo[1]);
      split_tf32(ap[4], a_hi[2], a_lo[2]);
      split_tf32(ap[8 * pitch + 4], a_hi[3], a_lo[3]);
      // no branch on nt, so the mma form one block for the scheduler,
      // and fixed slot offsets: n-tiles past nt read the next k-step's
      // slots (or the spare ones) and are never used
      const uint4* kp = kp0 + (size_t)(w * kcs + kc) * nt * 32;
#pragma unroll
      for (int j = 0; j < kMaxNTiles; ++j) {
        const uint4 bv = kp[j * 32];  // b0 hi, b1 hi, b0 lo, b1 lo
        mma_tf32(acc[j], a_lo, bv.x, bv.y);
        mma_tf32(acc[j], a_hi, bv.z, bv.w);
        mma_tf32(acc[j], a_hi, bv.x, bv.y);
      }
    }
  }
}

// kSrc == kRows: x is a [N, T, E] table and batch row b reads x[rows[b]].
// kSrc == kIds: x is a [N, E] word table, `rows` holds ids [B, T] and word
// t of batch row b is x[rows[b * T + t]].
// Block: blockDim.x / 32 warps of 16 starts each; filters
// [blockIdx.y * nt * 8, + nt * 8).
// kSrc == kPlain also keeps, per (b, f), the largest value of a start
// other than idx's (equal values included) and writes it to `second`
// where that is not null; with `refine`, idx of a near-tie is the first
// start of the largest window value recomputed in float64.
template <int W, int kSrc>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
textcnn_pool_fwd_kernel(const float* __restrict__ x, const int* __restrict__ rows,
                        const float* __restrict__ k, const float* __restrict__ bias,
                        const int* __restrict__ skip, float* __restrict__ out,
                        int* __restrict__ idx, float* __restrict__ second,
                        int* __restrict__ ties, int N, int B, int T, int E, int F, int nt,
                        int vec16, int refine) {
  constexpr bool kSecond = kSrc == kPlain;
  __shared__ int tie_max;  // f32 bits of a column's largest window value
  __shared__ int tie_take;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;   // fragment row group
  const int tq = lane & 3;   // fragment column in the group
  const int e8 = pad8(E);
  const int kcs = e8 / 8;    // k-steps per tap
  const int pitch = row_pitch(E);
  const int warps = nthreads / 32;
  const int starts = warps * kStartsPerWarp;  // per tile
  const int tile_rows = starts + W - 1;
  const int t_out = T + W - 1;
  const int n_tiles = (t_out + starts - 1) / starts;
  const int nf = nt * 8;
  const int f0 = blockIdx.y * nf;

  extern __shared__ uint4 smem16[];
  uint4* kq = smem16;  // k_slots(E, W, nt) slots
  // the ring: kStages stages of `stage` floats, [tile_rows][pitch] each
  float* xs = reinterpret_cast<float*>(kq + k_slots(E, W, nt));
  const int stage = stage_floats(E, W, nt, warps);
  float* bs = xs + (size_t)kStages * stage;  // [nf]
  // kIds: kStages stages of tile_rows word ids (-1 = zero-fill)
  int* id_ring = reinterpret_cast<int*>(bs + nf);

  // K in B-fragment order, b0 = K[kc*8 + tq][8j + g] and b1 four k later
  // (zero past E, F and in the spare n-tiles), copied into the hi words
  // of each slot here and split in place below by the same thread
  const int n_slots = k_slots(E, W, nt);
  for (int i = tid; i < n_slots; i += nthreads) {
    const int l = i & 31;
    const int j = (i >> 5) % nt;
    const int kstep = (i >> 5) / nt;
    const int w = kstep / kcs;
    const int e = (kstep - w * kcs) * 8 + (l & 3);
    const int f = f0 + 8 * j + (l >> 2);
    float* slot = reinterpret_cast<float*>(kq + i);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool ok = w < W && e + 4 * h < E && f < F;
      cp_async4(slot + h, ok ? k + (size_t)(w * E + e + 4 * h) * F + f : k, ok ? 4 : 0);
    }
  }
  cp_async_commit();
  for (int i = tid; i < nf; i += nthreads) bs[i] = f0 + i < F ? bias[f0 + i] : 0.f;

  const int nrows = (B - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int items = nrows * n_tiles;

  // the loader's view of its current batch row, refreshed on a new row
  int ld_r = -1, ld_src = 0, ld_lo = 0, ld_hi = 0;
  bool ld_ok = true;
  auto load_tile = [&](int it) {
    const int r = it / n_tiles;
    const int tile = it - r * n_tiles;
    if (r != ld_r) {
      ld_r = r;
      const int b = blockIdx.x + r * gridDim.x;
      ld_src = b;
      if constexpr (kSrc == kRows) {
        ld_src = rows[b];
        ld_ok = ld_src >= 0 && ld_src < N;
      }
      ld_lo = skip != nullptr ? skip[2 * b] : 0;
      ld_hi = skip != nullptr ? ld_lo + skip[2 * b + 1] : 0;
    }
    const float* xb = x + (size_t)(ld_ok ? ld_src : 0) * T * E;
    float* dst = xs + (size_t)(it % kStages) * stage;
    const int word0 = tile * starts - (W - 1);
    int* ids_st = id_ring + (it % kStages) * tile_rows;
    if constexpr (kSrc == kIds) {
      // the stage's ids were last read when its previous tile was issued,
      // before the barrier that opened this item
      const int* ib = rows + (size_t)ld_src * T;
      for (int i = tid; i < tile_rows; i += nthreads) {
        const int word = word0 + i;
        ids_st[i] = word >= 0 && word < T && (word < ld_lo || word >= ld_hi) ? ib[word] : -1;
      }
      __syncthreads();
    }
    // the source of (tile row, column c), or null to zero-fill it
    auto src_of = [&](int row, int c) -> const float* {
      if constexpr (kSrc == kIds) {
        const int id = ids_st[row];
        return id >= 0 && id < N && c < E ? x + (size_t)id * E + c : nullptr;
      } else {
        const int word = word0 + row;
        return ld_ok && word >= 0 && word < T && (word < ld_lo || word >= ld_hi) && c < E
                   ? xb + (size_t)word * E + c
                   : nullptr;
      }
    };
    if (vec16) {
      const int per_row = e8 / 4;
      for (int i = tid; i < tile_rows * per_row; i += nthreads) {
        const int row = i / per_row;
        const int c = 4 * (i - row * per_row);
        const float* src = src_of(row, c);
        cp_async16(dst + row * pitch + c, src ? src : x, src ? 16 : 0);
      }
    } else {
      for (int i = tid; i < tile_rows * e8; i += nthreads) {
        const int row = i / e8;
        const int c = i - row * e8;
        const float* src = src_of(row, c);
        cp_async4(dst + row * pitch + c, src ? src : x, src ? 4 : 0);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < items) load_tile(s);
    cp_async_commit();
  }
  cp_async_wait<kStages - 1>();  // this thread's K copies have landed
  for (int i = tid; i < n_slots; i += nthreads) {
    uint4 v = kq[i];
    split_tf32(__uint_as_float(v.x), v.x, v.z);
    split_tf32(__uint_as_float(v.y), v.y, v.w);
    kq[i] = v;
  }

  float best[kMaxNTiles][2];
  int best_s[kMaxNTiles][2];
  float sec[kSecond ? kMaxNTiles : 1][2];
#pragma unroll
  for (int j = 0; j < kMaxNTiles; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      best[j][c] = -1.f;  // every valid start gives relu(.) >= 0
      best_s[j][c] = 0;
      if constexpr (kSecond) sec[j][c] = -1.f;
    }

  // one listed near-tie (row b, filter f) by the whole block, in
  // `scratch` (`stage` floats of the ring): K's column, every window's
  // f32 value (a thread a window, from the row's words staged chunk by
  // chunk with the skip span zeroed), then in float64 only the windows
  // within kTieTol of the f32 maximum (f32 sums sit far closer to exact
  // than the 3xTF32 ones): idx becomes the first start of the largest
  // float64 value among them. Called by every thread after a barrier.
  auto refine_tie = [&](float* scratch, int b, int f) {
    const int span = W * E;
    const int xpitch = E + 1;  // starts a thread apart fall in distinct banks
    float* kcol = scratch;
    float* vals = kcol + span;
    double* v64 = reinterpret_cast<double*>(
        (reinterpret_cast<uintptr_t>(vals + t_out) + 7) & ~(uintptr_t)7);
    float* xw = reinterpret_cast<float*>(v64 + t_out);
    const int cw = (int)((scratch + stage - xw) / xpitch) - (W - 1);  // windows a chunk
    const int chunks = cw > 0 ? (t_out + cw - 1) / cw : 0;
    {
      const float bf = __ldg(bias + f);
      const int lo = skip != nullptr ? skip[2 * b] : 0;
      const int hi = skip != nullptr ? lo + skip[2 * b + 1] : 0;
      // words c0 - (W - 1) .. c0 + n - 1 of row b into xw, 0 outside the
      // doc and inside the skip span: asynchronous copies, all in flight
      // at once (with K's column on the first chunk), then waited for
      auto stage_words = [&](int c0, int n) {
        for (int j = tid; j < (n + W - 1) * E; j += nthreads) {
          const int rw = j / E;
          const int e = j - rw * E;
          const int p = c0 - (W - 1) + rw;
          const bool in = p >= 0 && p < T && (p < lo || p >= hi);
          cp_async4(xw + rw * xpitch + e, in ? x + ((size_t)b * T + p) * E + e : x, in ? 4 : 0);
        }
        if (c0 == 0)
          for (int q = tid; q < span; q += nthreads) cp_async4(kcol + q, k + (size_t)q * F + f, 4);
        cp_async_commit();
        cp_async_wait<0>();
      };
      if (chunks == 0) return;
      if (tid == 0) tie_max = 0;
      for (int c = 0; c < chunks; ++c) {
        const int c0 = c * cw;
        const int n = min(cw, t_out - c0);
        __syncthreads();
        stage_words(c0, n);
        __syncthreads();
        for (int sw = tid; sw < n; sw += nthreads) {
          // four partial sums over e mod 4, so that the loads run ahead
          float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
          for (int w = 0; w < W; ++w) {
            const float* xr = xw + (sw + w) * xpitch;
            const float* kr = kcol + w * E;
            int e = 0;
            for (; e + 4 <= E; e += 4) {
              a0 = fmaf(xr[e], kr[e], a0);
              a1 = fmaf(xr[e + 1], kr[e + 1], a1);
              a2 = fmaf(xr[e + 2], kr[e + 2], a2);
              a3 = fmaf(xr[e + 3], kr[e + 3], a3);
            }
            for (; e < E; ++e) a0 = fmaf(xr[e], kr[e], a0);
          }
          const float v = fmaxf((a0 + a1) + (a2 + a3) + bf, 0.f);
          vals[c0 + sw] = v;
          atomicMax(&tie_max, __float_as_int(v));  // v >= 0: the bits order as the values
        }
      }
      __syncthreads();
      const float vmax = __int_as_float(tie_max);
      const float cut = vmax - kTieTol * fmaxf(vmax, 1.f);
      for (int c = 0; c < chunks; ++c) {
        const int c0 = c * cw;
        const int n = min(cw, t_out - c0);
        if (chunks > 1) {
          __syncthreads();
          stage_words(c0, n);
          __syncthreads();
        }
        // a warp a window: lane l sums offsets l, l + 32, ... of the
        // window's W*E products, a fixed xor butterfly adds the lanes up
        // (windows of equal content get the same bits)
        for (int sw = warp; sw < n; sw += warps) {
          double v = -1.0;
          if (vals[c0 + sw] >= cut) {
            double acc = 0.0;
            for (int q = lane; q < span; q += 32) {
              const int w = q / E;
              acc = fma((double)xw[(sw + w) * xpitch + (q - w * E)], (double)kcol[q], acc);
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
            v = fmax(acc + (double)bf, 0.0);
          }
          if (lane == 0) v64[c0 + sw] = v;
        }
      }
      __syncthreads();
      if (tid < 32) {
        // the largest float64 value, then its first start
        double best = -1.0;
        for (int sw = tid; sw < t_out; sw += 32) best = fmax(best, v64[sw]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          best = fmax(best, __shfl_xor_sync(0xffffffffu, best, off));
        int first = t_out;
        for (int sw = tid; sw < t_out; sw += 32)
          if (v64[sw] == best) {
            first = sw;
            break;
          }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          first = min(first, __shfl_xor_sync(0xffffffffu, first, off));
        if (tid == 0) idx[(size_t)b * F + f] = first;
      }
    }
    __syncthreads();  // the scratch is free again
  };

  const uint4* kl = kq + lane;
  for (int it = 0; it < items; ++it) {
    cp_async_wait<kStages - 2>();  // item it has landed, for this thread
    __syncthreads();               // for every thread; item it-1's stage is free
    if (it + kStages - 1 < items) load_tile(it + kStages - 1);
    cp_async_commit();

    const int r = it / n_tiles;
    const int tile = it - r * n_tiles;
    float* xt = xs + (size_t)(it % kStages) * stage;

    float acc[kMaxNTiles][4];
    tile_mma<W>(acc, xt + (size_t)warp * kStartsPerWarp * pitch, kl, pitch, kcs, nt, g, tq);

    // running max over this thread's two starts g and g + 8, in order
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int s = tile * starts + warp * kStartsPerWarp + g + 8 * half;
      if (s >= t_out) continue;
#pragma unroll
      for (int j = 0; j < kMaxNTiles; ++j) {
        if (j >= nt) continue;
        const float2 bj = reinterpret_cast<const float2*>(bs)[4 * j + tq];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float v = fmaxf(acc[j][2 * half + c] + (c ? bj.y : bj.x), 0.f);
          if constexpr (kSecond) sec[j][c] = fmaxf(sec[j][c], fminf(v, best[j][c]));
          if (v > best[j][c]) {
            best[j][c] = v;
            best_s[j][c] = s;
          }
        }
      }
    }

    if (tile != n_tiles - 1) continue;

    // end of batch row: merge the 8 lanes of each column, then the warps
    // in this tile's stage, once every warp is done reading it
    __syncthreads();
    float* merge_v = xt;  // [warps][nf]
    int* merge_i = reinterpret_cast<int*>(xt + warps * nf);
    float* merge_sec = xt + 2 * warps * nf;
#pragma unroll
    for (int j = 0; j < kMaxNTiles; ++j) {
      if (j < nt) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float v = best[j][c];
          int s = best_s[j][c];
          float sv = 0.f;
          if constexpr (kSecond) sv = sec[j][c];
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            const float ov = __shfl_xor_sync(0xffffffffu, v, off);
            const int os = __shfl_xor_sync(0xffffffffu, s, off);
            if constexpr (kSecond) {
              // the second of two halves: the loser's best or the
              // winner's second
              const float osv = __shfl_xor_sync(0xffffffffu, sv, off);
              sv = fmaxf(fmaxf(sv, osv), fminf(v, ov));
            }
            if (ov > v || (ov == v && os < s)) {
              v = ov;
              s = os;
            }
          }
          if (g == 0) {
            merge_v[warp * nf + 8 * j + 2 * tq + c] = v;
            merge_i[warp * nf + 8 * j + 2 * tq + c] = s;
            if constexpr (kSecond) merge_sec[warp * nf + 8 * j + 2 * tq + c] = sv;
          }
          best[j][c] = -1.f;
          best_s[j][c] = 0;
          if constexpr (kSecond) sec[j][c] = -1.f;
        }
      }
    }
    __syncthreads();
    const int b = blockIdx.x + r * gridDim.x;
    bool row_ok = true;
    if constexpr (kSrc == kRows) row_ok = rows[b] >= 0 && rows[b] < N;
    if constexpr (kSrc == kIds) {
      int bad = 0;
      for (int t = tid; t < T; t += nthreads) {
        const int id = rows[(size_t)b * T + t];
        bad |= id < 0 || id >= N;
      }
      row_ok = !__syncthreads_or(bad);
    }
    for (int col = tid; col < nf; col += nthreads) {
      const int f = f0 + col;
      if (f >= F) continue;
      float v = merge_v[col];
      int s = merge_i[col];
      float sv = 0.f;
      if constexpr (kSecond) sv = merge_sec[col];
      for (int ow = 1; ow < warps; ++ow) {
        const float ov = merge_v[ow * nf + col];
        const int os = merge_i[ow * nf + col];
        if constexpr (kSecond) sv = fmaxf(fmaxf(sv, merge_sec[ow * nf + col]), fminf(v, ov));
        if (ov > v || (ov == v && os < s)) {
          v = ov;
          s = os;
        }
      }
      out[(size_t)b * F + f] = row_ok ? v : __int_as_float(0x7fc00000);  // NaN
      idx[(size_t)b * F + f] = row_ok ? s : -1;
      if constexpr (kSecond) {
        if (second != nullptr) second[(size_t)b * F + f] = sv;
        // a near-tie, unless its max is the all-zero window's value
        // (equal content: every such window gives relu(bias) exactly)
        if (refine && v > 0.f && v - sv <= kTieTol * fmaxf(v, 1.f) && v != fmaxf(bs[col], 0.f)) {
          const int slot = atomicAdd(&ties[0], 1);
          ties[4 + 2 * slot] = b;
          ties[5 + 2 * slot] = f;
        }
      }
    }
    // the next copies into this stage follow the next item's barrier
  }
  if constexpr (kSecond) {
    if (refine) {
      // the launch's near-ties, shared out over every block once all have
      // listed theirs: the blocks are all resident (one a multiprocessor,
      // no more than the card has), so the wait ends; ties[0] counts the
      // list, ties[1] the blocks done listing, ties[2] hands out entries,
      // and the last block to leave (ties[3]) sets all four back to 0
      const int blocks = (int)(gridDim.x * gridDim.y);
      __threadfence();  // this thread's entries, before the block counts itself done
      __syncthreads();  // every tile read: the ring is free
      if (tid == 0) {
        atomicAdd(&ties[1], 1);
        while (*reinterpret_cast<volatile int*>(&ties[1]) < blocks) __nanosleep(32);
        __threadfence();
        tie_max = atomicAdd(&ties[0], 0);  // the list's length, for the loop below
      }
      __syncthreads();
      const int listed = tie_max;
      for (;;) {
        __syncthreads();
        if (tid == 0) tie_take = atomicAdd(&ties[2], 1);
        __syncthreads();
        const int t = tie_take;
        if (t >= listed) break;
        refine_tie(xs, __ldcg(&ties[4 + 2 * t]), __ldcg(&ties[5 + 2 * t]));
      }
      if (tid == 0 && atomicAdd(&ties[3], 1) == blocks - 1) {
        ties[0] = ties[1] = ties[2] = ties[3] = 0;
        __threadfence();
      }
    }
  }
}

struct Config {
  int warps, nt, chunks;
  size_t smem;
};

// the first of 8, 4, 2, 1 warps, and for it the fewest
// filter chunks, whose block fits in `max_smem`; nt = 0 if none does
Config choose(int E, int F, int W, bool ids, int max_smem) {
  const int total = (F + 7) / 8;
  for (int warps = kMaxWarps; warps >= 1; warps /= 2)
    for (int chunks = 1; chunks <= total; ++chunks) {
      const int nt = (total + chunks - 1) / chunks;
      if (nt > kMaxNTiles) continue;
      const size_t smem = smem_bytes(E, W, nt, warps, ids);
      if (smem <= (size_t)max_smem) return {warps, nt, (total + nt - 1) / nt, smem};
    }
  return {1, 0, 0, smem_bytes(E, W, 1, 1, ids)};
}

template <int W, int kSrc>
int launch(const float* x, const int* rows, const float* k, const float* bias,
           const int* skip, float* out, int* idx, float* second, int* ties, int N, int B, int T,
           int E, int F, int refine, cudaStream_t stream) {
  int dev = 0, max_smem = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // the kernel's static shared memory (the near-tie list) comes out of
  // the same per-block total; read once per instantiation
  static int static_smem = -1;
  if (static_smem < 0) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, textcnn_pool_fwd_kernel<W, kSrc>);
    if (err != cudaSuccess) return (int)err;
    static_smem = (int)attr.sharedSizeBytes;
  }
  const Config cfg = choose(E, F, W, kSrc == kIds, max_smem - static_smem);
  if (cfg.nt == 0) return (int)cudaErrorInvalidConfiguration;
  // raised once per instantiation, not on every launch (nor inside a
  // CUDA-graph capture after a first launch)
  static size_t smem_set = 0;
  if (cfg.smem > smem_set) {
    err = cudaFuncSetAttribute(textcnn_pool_fwd_kernel<W, kSrc>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)cfg.smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = cfg.smem;
  }
  // one persistent block per SM and filter chunk: at the serving shape
  // the block's shared memory and registers fill the SM
  int blocks = sms / cfg.chunks;
  blocks = blocks < 1 ? 1 : (blocks > B ? B : blocks);
  const int vec16 = E % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  textcnn_pool_fwd_kernel<W, kSrc><<<dim3(blocks, cfg.chunks), cfg.warps * 32, cfg.smem,
                                     stream>>>(x, rows, k, bias, skip, out, idx, second, ties,
                                               N, B, T, E, F, cfg.nt, vec16, refine);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// The rows form on warpgroup products (`textcnn_pool_fwd_rows_f32` at the
// shapes `wg_takes` names): the same op, tie rule and row checks as the
// body above, its products issued by `wgmma` (wgmma_tf32.cuh)
// ---------------------------------------------------------------------

constexpr int kWgStarts = 64;   // window starts of a warpgroup's tile
constexpr int kWgStages = 4;    // x tiles in flight: two a warpgroup
constexpr int kWgConsumers = 2;  // warpgroups of products
constexpr int kWgThreads = kWgConsumers * 128 + 32;  // and one producer warp
constexpr int kWgNT = wg::kN / 8;  // n8 tiles of filters

// bytes of one of K's two copies (hi, lo): per k-step 13 n8 tiles of two
// 128-byte core matrices
__host__ __device__ constexpr size_t wg_k_bytes(int e, int window) {
  return (size_t)window * (e / 8) * kWgNT * 256;
}
// bytes of one x tile: the tile's starts + W - 1 word rows, E + 4 floats
// a row (pitch as the body above: A-fragment loads in 32 distinct banks)
__host__ __device__ constexpr size_t wg_stage_bytes(int e, int window) {
  return 4 * (size_t)(kWgStarts + window - 1) * row_pitch(e);
}
// K (hi, lo), the x ring, a full and an empty mbarrier a stage, then a
// row's merge: one packed (value, start) key a filter
size_t wg_smem_bytes(int e, int window) {
  return 2 * wg_k_bytes(e, window) + kWgStages * wg_stage_bytes(e, window) + 16 * kWgStages +
         8 * wg::kN;
}

// the key of (v, start) that orders as the merge's rule: the larger v,
// then the lower start; 0 for a thread's empty max (v = -1), which every
// start's relu(.) >= 0 passes
__device__ __forceinline__ unsigned long long merge_key(float v, int start) {
  return v < 0.f ? 0ull
                 : (unsigned long long)__float_as_uint(v) << 32 | (uint32_t)~(uint32_t)start;
}

// Whether the rows form at (E, F, W) takes the warpgroup body: its k-loop
// is straight-line code for (E, W) = (64, 3), the shape of every entity
// tower (deepconn, deepconn++), F fills its 13 n8 tiles (96 < F <= 104)
// and its shared memory fits `max_smem`. ops/textcnn.py's `fwd_body`
// is its mirror; chip_smoke.py holds the two to each other.
bool wg_takes(int E, int F, int W, int max_smem) {
  return E == 64 && W == 3 && F > 96 && F <= wg::kN &&
         wg_smem_bytes(E, W) <= (size_t)max_smem;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// arrive once this thread's `cp.async` copies so far have landed (one of
// the arrivals the barrier counts)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}
// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
}
// the consumer warpgroups' own barrier (the producer warp never joins it)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kWgConsumers * 128) : "memory");
}

// acc = the sums of one warpgroup's 64 starts (this thread's A rows from
// xa: tile row g of its warp, column tq) by the 104 filters, in 3xTF32 as
// `tile_mma`: per k-step a_lo*b_hi, a_hi*b_lo, a_hi*b_hi, in its k order.
// Straight-line code, so each k-step's fragments are registers of their
// own and one k-step's products run while the next one's A is loaded.
template <int W, int kKcs>
__device__ __forceinline__ void wg_tile(float (&acc)[wg::kAcc], const float* xa, uint32_t khi,
                                        uint32_t klo, uint64_t* empty) {
  constexpr int pitch = row_pitch(8 * kKcs);
  wg::pin(acc);
#pragma unroll
  for (int ks = 0; ks < W * kKcs; ++ks) {
    const float* ap = xa + (ks / kKcs) * pitch + (ks % kKcs) * 8;
    uint32_t hi[4], lo[4];
    split_tf32(ap[0], hi[0], lo[0]);
    split_tf32(ap[8 * pitch], hi[1], lo[1]);
    split_tf32(ap[4], hi[2], lo[2]);
    split_tf32(ap[8 * pitch + 4], hi[3], lo[3]);
    const uint64_t bh = wg::desc(khi + ks * kWgNT * 256, 128, 256);
    const uint64_t bl = wg::desc(klo + ks * kWgNT * 256, 128, 256);
    wg::fence();
    wg::mma(acc, lo, bh, ks > 0);
    wg::mma(acc, hi, bl, 1);
    wg::mma(acc, hi, bh, 1);
    wg::commit();
    if (ks == W * kKcs - 1) mbar_arrive(empty);  // every A load of the tile is done
    wg::wait<1>();
  }
  wg::wait<0>();
  wg::pin(acc);
}

// Block: two consumer warpgroups and a producer warp; persistent blocks
// walk batch rows blockIdx.x, + gridDim.x, ..., each row as tiles of 64
// starts, tile t to warpgroup t % 2. Every item (row, tile) goes through
// stage item % kWgStages of the ring: the producer's copies arrive on the
// stage's `full` barrier, the 128 threads of the warpgroup that took it
// arrive on its `empty` one once the tile's last k-step is issued (every
// A fragment of the tile is then in registers).
template <int W, int kKcs>
__global__ void __launch_bounds__(kWgThreads, 1)
textcnn_pool_fwd_rows_wgmma_kernel(const float* __restrict__ table, const int* __restrict__ rows,
                                   const float* __restrict__ k, const float* __restrict__ bias,
                                   const int* __restrict__ skip, float* __restrict__ out,
                                   int* __restrict__ idx, int N, int B, int T, int F) {
  constexpr int E = 8 * kKcs;
  constexpr int pitch = row_pitch(E);
  constexpr int tile_rows = kWgStarts + W - 1;
  constexpr int stage = tile_rows * pitch;  // floats
  extern __shared__ uint4 smem16[];
  char* sm = reinterpret_cast<char*>(smem16);
  float* k_hi = reinterpret_cast<float*>(sm);
  float* k_lo = reinterpret_cast<float*>(sm + wg_k_bytes(E, W));
  float* ring = reinterpret_cast<float*>(sm + 2 * wg_k_bytes(E, W));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kWgStages * stage);
  uint64_t* empty = full + kWgStages;
  unsigned long long* merge = reinterpret_cast<unsigned long long*>(empty + kWgStages);

  const int tid = threadIdx.x;
  const int t_out = T + W - 1;
  const int n_tiles = (t_out + kWgStarts - 1) / kWgStarts;
  const int nrows = (B - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;

  if (tid == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kWgConsumers * 128) {
    // the producer warp: 16-byte `cp.async` copies of the tile's word
    // rows, the zero-fill form for a word outside the doc, inside the
    // skip span or of a row outside [0, N); each lane's copies arrive on
    // the stage's full barrier as they land
    const int lane = tid & 31;
    const int items = nrows * n_tiles;
    for (int it = 0; it < items; ++it) {
      const int r = it / n_tiles;
      const int tile = it - r * n_tiles;
      const int b = blockIdx.x + r * gridDim.x;
      const int src = rows[b];
      const bool ok = src >= 0 && src < N;
      const int lo = skip != nullptr ? skip[2 * b] : 0;
      const int hi = skip != nullptr ? lo + skip[2 * b + 1] : 0;
      const int s = it % kWgStages;
      if (it >= kWgStages) mbar_wait(&empty[s], (it / kWgStages - 1) & 1);
      float* dst = ring + s * stage;
      const float* xb = table + (size_t)(ok ? src : 0) * T * E;
      const int word0 = tile * kWgStarts - (W - 1);
      constexpr int per_row = E / 4;  // 16-byte pieces of a word row
#pragma unroll 4
      for (int i = lane; i < tile_rows * per_row; i += 32) {
        const int row = i / per_row;
        const int c = 4 * (i - row * per_row);
        const int word = word0 + row;
        const bool in = ok && word >= 0 && word < T && (word < lo || word >= hi);
        cp_async16(dst + row * pitch + c, in ? xb + (size_t)word * E + c : table, in ? 16 : 0);
      }
      cp_async_arrive(&full[s]);
    }
    cp_async_wait<0>();  // no copy outlives its thread
    return;
  }

  // K in both copies, in B's core-matrix order: thread i writes float i
  // of a copy (conflict-free), K[kk][f] with kk = ks*8 + c*4 + q and
  // f = 8j + r for offset ((ks*13 + j)*2 + c)*32 + r*4 + q; zero past F
  {
    constexpr int n = W * E * wg::kN;
    constexpr int kBatch = 8;  // loads in flight a thread
    for (int i0 = tid; i0 < n; i0 += kBatch * kWgConsumers * 128) {
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kWgConsumers * 128;
        const int q = i & 3, r = (i >> 2) & 7, c = (i >> 5) & 1;
        const int j = (i >> 6) % kWgNT, ks = (i >> 6) / kWgNT;
        const int f = 8 * j + r;
        v[u] = i < n && f < F ? __ldg(k + (size_t)(ks * 8 + c * 4 + q) * F + f) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kWgConsumers * 128;
        if (i < n) {
          uint32_t h, l;
          split_tf32(v[u], h, l);
          k_hi[i] = __uint_as_float(h);
          k_lo[i] = __uint_as_float(l);
        }
      }
    }
  }
  for (int f = tid; f < wg::kN; f += kWgConsumers * 128) merge[f] = 0;
  // K's writes before the wgmma of the async proxy read them
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  consumers_sync();

  const int wgi = tid >> 7;  // this warpgroup
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int wq = warp & 3;  // the warp's 16 rows of the warpgroup's 64
  float bj[kWgNT][2];
  float best[kWgNT][2];
  int best_s[kWgNT][2];
#pragma unroll
  for (int j = 0; j < kWgNT; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int f = 8 * j + 2 * tq + c;
      bj[j][c] = f < F ? __ldg(bias + f) : 0.f;
      best[j][c] = -1.f;  // every valid start gives relu(.) >= 0
      best_s[j][c] = 0;
    }
  const uint32_t khi = smem_addr(k_hi), klo = smem_addr(k_lo);

  for (int r = 0; r < nrows; ++r) {
    for (int tile = wgi; tile < n_tiles; tile += kWgConsumers) {
      const int it = r * n_tiles + tile;
      const int s = it % kWgStages;
      mbar_wait(&full[s], (it / kWgStages) & 1);
      float acc[wg::kAcc];
      wg_tile<W, kKcs>(acc, ring + s * stage + (wq * 16 + g) * pitch + tq, khi, klo, &empty[s]);
      // running max over this thread's two starts g and g + 8, in order
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int st = tile * kWgStarts + wq * 16 + g + 8 * half;
        if (st >= t_out) continue;
#pragma unroll
        for (int j = 0; j < kWgNT; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float v = fmaxf(acc[4 * j + 2 * half + c] + bj[j][c], 0.f);
            if (v > best[j][c]) {
              best[j][c] = v;
              best_s[j][c] = st;
            }
          }
      }
    }

    // end of batch row: merge the 8 lanes of each column by shuffle, then
    // the 8 warps of both warpgroups by atomicMax on the column's packed
    // key; the lower start wins on equal values
#pragma unroll
    for (int j = 0; j < kWgNT; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float v = best[j][c];
        int st = best_s[j][c];
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, v, off);
          const int os = __shfl_xor_sync(0xffffffffu, st, off);
          if (ov > v || (ov == v && os < st)) {
            v = ov;
            st = os;
          }
        }
        if (g == 0) atomicMax(&merge[8 * j + 2 * tq + c], merge_key(v, st));
        best[j][c] = -1.f;
        best_s[j][c] = 0;
      }
    consumers_sync();
    const int b = blockIdx.x + r * gridDim.x;
    const bool row_ok = rows[b] >= 0 && rows[b] < N;
    for (int f = tid; f < wg::kN; f += kWgConsumers * 128) {
      const unsigned long long key = merge[f];
      merge[f] = 0;
      if (f >= F) continue;
      out[(size_t)b * F + f] = row_ok ? __uint_as_float((uint32_t)(key >> 32))
                                      : __int_as_float(0x7fc00000);  // NaN
      idx[(size_t)b * F + f] = row_ok ? (int)~(uint32_t)key : -1;
    }
    consumers_sync();  // the keys are 0 again for the next row
  }
}

// the warpgroup body's launch: one persistent block an SM (or a row)
int launch_rows_wg(const float* table, const int* rows, const float* k, const float* bias,
                   const int* skip, float* out, int* idx, int N, int B, int T, int E, int F,
                   int W, int sms, cudaStream_t stream) {
  const size_t smem = wg_smem_bytes(E, W);
  static bool smem_set = false;  // raised once, not inside a graph capture
  if (!smem_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(textcnn_pool_fwd_rows_wgmma_kernel<3, 8>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const int blocks = B < sms ? B : sms;
  textcnn_pool_fwd_rows_wgmma_kernel<3, 8><<<blocks, kWgThreads, smem, stream>>>(
      table, rows, k, bias, skip, out, idx, N, B, T, F);
  return (int)cudaGetLastError();
}

// whether a rows launch at (E, F, W) takes the warpgroup body on this
// card (`wg_takes` on its shared memory), given a 16-byte aligned table
// (its copies are of 16 bytes); sets `sms`
bool rows_wg_shape(int E, int F, int W, int* sms) {
  int dev = 0, max_smem = 0;
  static int static_smem = -1;  // the kernel's own, out of the same total
  if (static_smem < 0) {
    cudaFuncAttributes attr;
    if (cudaFuncGetAttributes(&attr, textcnn_pool_fwd_rows_wgmma_kernel<3, 8>) != cudaSuccess)
      return false;
    static_smem = (int)attr.sharedSizeBytes;
  }
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return false;
  return wg_takes(E, F, W, max_smem - static_smem);
}

template <int kSrc>
int dispatch(const float* x, const int* rows, const float* k, const float* bias,
             const int* skip, float* out, int* idx, float* second, int* ties, int N, int B,
             int T, int E, int F, int W, int refine, void* stream) {
  if (N <= 0 || B <= 0 || T <= 0 || E <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  if (refine && ties == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (kSrc == kRows) {
    int sms = 0;
    if (rows_wg_shape(E, F, W, &sms) && reinterpret_cast<uintptr_t>(x) % 16 == 0)
      return launch_rows_wg(x, rows, k, bias, skip, out, idx, N, B, T, E, F, W, sms, s);
  }
  switch (W) {
    case 1:
      return launch<1, kSrc>(x, rows, k, bias, skip, out, idx, second, ties, N, B, T, E, F,
                               refine, s);
    case 2:
      return launch<2, kSrc>(x, rows, k, bias, skip, out, idx, second, ties, N, B, T, E, F,
                               refine, s);
    case 3:
      return launch<3, kSrc>(x, rows, k, bias, skip, out, idx, second, ties, N, B, T, E, F,
                               refine, s);
    case 4:
      return launch<4, kSrc>(x, rows, k, bias, skip, out, idx, second, ties, N, B, T, E, F,
                               refine, s);
    case 5:
      return launch<5, kSrc>(x, rows, k, bias, skip, out, idx, second, ties, N, B, T, E, F,
                               refine, s);
    case 6:
      return launch<6, kSrc>(x, rows, k, bias, skip, out, idx, second, ties, N, B, T, E, F,
                               refine, s);
    case 7:
      return launch<7, kSrc>(x, rows, k, bias, skip, out, idx, second, ties, N, B, T, E, F,
                               refine, s);
    case 8:
      return launch<8, kSrc>(x, rows, k, bias, skip, out, idx, second, ties, N, B, T, E, F,
                               refine, s);
    default: return (int)cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------
// 16-bit operands (`textcnn_pool_fwd_bf16`, `textcnn_pool_fwd_f16`): one
// body, T16 = __nv_bfloat16 or __half; the two differ only in the mma
// instruction's operand type
// ---------------------------------------------------------------------

constexpr int kH16WarpTiles = 7;  // n8 tiles a warp: 56 filters
constexpr int kH16MaxNTiles = 2 * kH16WarpTiles;  // a block: two filter groups of warps
constexpr int kH16Stages = 3;     // the x ring
constexpr int kH16MTiles = 2;     // m16 tiles of starts a warp
constexpr int kH16StartsPerWarp = 16 * kH16MTiles;

// the block's warps: wn() filter groups of wm() warps that take
// consecutive ranges of starts
__host__ __device__ constexpr int h16_groups_n(int nt) { return nt > kH16WarpTiles ? 2 : 1; }

__host__ __device__ constexpr int pad16(int e) { return (e + 15) & ~15; }
// pitches in 16-bit elements, each 8 x an odd number: a row is then an odd
// number of 16-byte units, and the 8 rows an `ldmatrix` reads fall in 8
// distinct 16-byte bank groups
__host__ __device__ constexpr int h16_x_pitch(int e) { return pad16(e) + 8; }
__host__ __device__ constexpr int h16_k_pitch(int nt) {
  return h16_groups_n(nt) == 1 ? kH16WarpTiles * 8 : 2 * kH16WarpTiles * 8 + 8;
}

// bytes of one stage of the 16-bit x ring: the tile's word rows, or the
// merge of the warps' (value, start) per filter at a row's end
__host__ __device__ constexpr size_t h16_stage_bytes(int e, int window, int nt, int warps) {
  return 2 * (size_t)(warps / h16_groups_n(nt) * kH16StartsPerWarp + window - 1) *
                     h16_x_pitch(e) >
                 8 * (size_t)(warps / h16_groups_n(nt)) * nt * 8
             ? 2 * (size_t)(warps / h16_groups_n(nt) * kH16StartsPerWarp + window - 1) *
                   h16_x_pitch(e)
             : 8 * (size_t)(warps / h16_groups_n(nt)) * nt * 8;
}
// bytes of K staged as [W*E16][k pitch] 16-bit values: every warp's 7
// n-tiles lie inside a row
__host__ __device__ constexpr size_t h16_k_bytes(int e, int window, int nt) {
  return 2 * (size_t)window * pad16(e) * h16_k_pitch(nt);
}
// bytes of shared memory of one 16-bit block: K, the x ring, the bias
size_t h16_smem_bytes(int e, int window, int nt, int warps) {
  return ((h16_k_bytes(e, window, nt) + 15) & ~(size_t)15) +
         kH16Stages * ((h16_stage_bytes(e, window, nt, warps) + 15) & ~(size_t)15) +
         4 * (size_t)nt * 8;
}

// d += a * b: a 16x16 T16 (row), b 16x8 T16 (col), d 16x8 f32. The f16
// form has the bf16 one's shape and fragment layout.
template <typename T16>
__device__ __forceinline__ void mma_16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  if constexpr (std::is_same<T16, __half>::value) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    static_assert(std::is_same<T16, __nv_bfloat16>::value, "bf16 or f16 operands");
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}
// four 8x8 16-bit matrices from shared memory, lane l giving row l % 8 of
// matrix l / 8; .trans hands each lane a column pair instead of a row pair
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes));
}

// Persistent blocks: grid (blocks, filter chunks), block x walking batch
// rows x, x + gridDim.x, ... as one flat sequence of (row, tile) items,
// tiles of warps x 16 window starts. x and k are T16 bit patterns.
template <typename T16, int W>
__global__ void __launch_bounds__(kMaxWarps * 32, 2)
textcnn_pool_fwd_16_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ k,
                           const float* __restrict__ bias, const int* __restrict__ skip,
                           float* __restrict__ out, int* __restrict__ idx, int B, int T,
                           int E, int F, int nt, int vec, int kvec) {
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int warps = nthreads / 32;
  const int wgm = warps / h16_groups_n(nt);  // warps a filter group
  const int wm = warp % wgm;                 // this warp's range of starts
  const int wn = warp / wgm;                 // and its filter group
  const int e16 = pad16(E);
  const int kcs = e16 / 16;  // k-steps a tap
  const int xp = h16_x_pitch(E);
  const int kp = h16_k_pitch(nt);
  const int starts = wgm * kH16StartsPerWarp;  // a tile
  const int tile_rows = starts + W - 1;
  const int t_out = T + W - 1;
  const int n_tiles = (t_out + starts - 1) / starts;
  const int nf = nt * 8;
  const int f0 = blockIdx.y * nf;

  extern __shared__ uint4 smem16[];
  uint16_t* ks = reinterpret_cast<uint16_t*>(smem16);  // [W*E16][kp]
  char* ring = reinterpret_cast<char*>(smem16) + ((h16_k_bytes(E, W, nt) + 15) & ~(size_t)15);
  const size_t stage = (h16_stage_bytes(E, W, nt, warps) + 15) & ~(size_t)15;
  float* bs = reinterpret_cast<float*>(ring + kH16Stages * stage);  // [nf]

  // K as [w*E16 + e][f]: rows of 4-filter (8-byte) copies, zero past E,
  // F and the chunk, and the slack past its end
  for (int r = warp; r < W * e16; r += warps) {
    const int w = r / e16;
    const int e = r - w * e16;
    uint16_t* dst = ks + (size_t)r * kp;
    if (kvec) {
      for (int c = 4 * lane; c < kp; c += 128) {
        const bool ok = e < E && f0 + c < F;
        cp_async8(dst + c, ok ? k + (size_t)(w * E + e) * F + f0 + c : k, ok ? 8 : 0);
      }
    } else {
      for (int c = lane; c < kp; c += 32) {
        const bool ok = e < E && f0 + c < F && c < nf;
        dst[c] = ok ? k[(size_t)(w * E + e) * F + f0 + c] : (uint16_t)0;
      }
    }
  }
  cp_async_commit();
  for (int i = tid; i < nf; i += nthreads) bs[i] = f0 + i < F ? bias[f0 + i] : 0.f;

  const int nrows = (B - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int items = nrows * n_tiles;
  // this thread's first (row, chunk) of a tile's copies and its stride,
  // without a division per copy
  const int cpr = vec ? e16 / 8 : e16;  // copies a word row: 16 bytes or one value
  const int first_row = tid / cpr, first_c = tid - first_row * cpr;
  const int dr = nthreads / cpr, dc = nthreads - dr * cpr;

  auto load_tile = [&](int it) {
    const int r = it / n_tiles;
    const int tile = it - r * n_tiles;
    const int b = blockIdx.x + r * gridDim.x;
    const int lo = skip != nullptr ? skip[2 * b] : 0;
    const int hi = skip != nullptr ? lo + skip[2 * b + 1] : 0;
    const uint16_t* xb = x + (size_t)b * T * E;
    uint16_t* dst = reinterpret_cast<uint16_t*>(ring + (it % kH16Stages) * stage);
    const int word0 = tile * starts - (W - 1);
    int row = first_row, c = first_c;
    while (row < tile_rows) {
      const int word = word0 + row;
      const bool in = word >= 0 && word < T && (word < lo || word >= hi);
      if (vec) {
        const bool ok = in && 8 * c < E;
        cp_async16(reinterpret_cast<float*>(dst + row * xp + 8 * c),
                   reinterpret_cast<const float*>(ok ? xb + (size_t)word * E + 8 * c : x),
                   ok ? 16 : 0);
      } else {
        dst[row * xp + c] = in && c < E ? xb[(size_t)word * E + c] : (uint16_t)0;
      }
      row += dr;
      c += dc;
      if (c >= cpr) {
        c -= cpr;
        ++row;
      }
    }
  };

#pragma unroll
  for (int st = 0; st < kH16Stages - 1; ++st) {
    if (st < items) load_tile(st);
    cp_async_commit();
  }

  float best[kH16WarpTiles][2];
  int best_s[kH16WarpTiles][2];
#pragma unroll
  for (int j = 0; j < kH16WarpTiles; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      best[j][c] = __int_as_float(0xff800000);  // -inf: the raw sums, before bias and ReLU
      best_s[j][c] = 0;
    }

  // ldmatrix row addresses: A, row lane % 16 of the warp's 16 starts and
  // k half lane / 16; B, k row (lane / 8 & 1) * 8 + lane % 8 of the
  // k-step and n-tile pair half lane / 16
  const uint32_t ks_base = smem_addr(ks);
  const uint32_t a_off = 2u * ((wm * kH16StartsPerWarp + (lane & 15)) * xp + (lane >> 4) * 8);
  const uint32_t b_off = 2u * ((((lane >> 3) & 1) * 8 + (lane & 7)) * kp + (lane >> 4) * 8 +
                               wn * kH16WarpTiles * 8);

  for (int it = 0; it < items; ++it) {
    cp_async_wait<kH16Stages - 2>();  // item it has landed, for this thread
    __syncthreads();                 // for every thread; item it-1's stage is free
    if (it + kH16Stages - 1 < items) load_tile(it + kH16Stages - 1);
    cp_async_commit();

    const int r = it / n_tiles;
    const int tile = it - r * n_tiles;
    char* xt = ring + (it % kH16Stages) * stage;
    const uint32_t xt_base = smem_addr(xt);

    float acc[kH16MTiles][kH16WarpTiles][4];
#pragma unroll
    for (int mt = 0; mt < kH16MTiles; ++mt)
#pragma unroll
      for (int j = 0; j < kH16WarpTiles; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][j][q] = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      for (int kc = 0; kc < kcs; ++kc) {
        // A: the warp's two m16 tiles of starts + w, k = kc*16 ..; the
        // taps share one tile
        uint32_t a[kH16MTiles][4];
#pragma unroll
        for (int mt = 0; mt < kH16MTiles; ++mt)
          ldsm_x4(a[mt], xt_base + a_off + 2u * ((w + 16 * mt) * xp + kc * 16));
        const uint32_t bk = ks_base + b_off + 2u * ((w * e16 + kc * 16) * kp);
        // B: the warp's n-tiles 2jp and 2jp + 1 a load, each fragment
        // feeding both m16 tiles; fixed offsets, no branch on nt (tiles
        // past nt read finite values that are never used)
#pragma unroll
        for (int jp = 0; jp < kH16WarpTiles / 2; ++jp) {
          uint32_t bq[4];
          ldsm_x4_trans(bq, bk + 2u * (jp * 16));
#pragma unroll
          for (int mt = 0; mt < kH16MTiles; ++mt) {
            mma_16<T16>(acc[mt][2 * jp], a[mt], bq[0], bq[1]);
            mma_16<T16>(acc[mt][2 * jp + 1], a[mt], bq[2], bq[3]);
          }
        }
        uint32_t bl[2];
        ldsm_x2_trans(bl, bk + 2u * ((kH16WarpTiles - 1) * 8));
#pragma unroll
        for (int mt = 0; mt < kH16MTiles; ++mt)
          mma_16<T16>(acc[mt][kH16WarpTiles - 1], a[mt], bl[0], bl[1]);
      }
    }

    // running max of the raw sums over this thread's starts g, g + 8,
    // g + 16, g + 24, in order; relu(fl(sum + bias)) rises with the sum,
    // so bias and ReLU wait for the row's end
#pragma unroll
    for (int h = 0; h < 2 * kH16MTiles; ++h) {
      const int mt = h >> 1, half = h & 1;
      const int s = tile * starts + wm * kH16StartsPerWarp + g + 8 * h;
      if (s >= t_out) continue;
#pragma unroll
      for (int j = 0; j < kH16WarpTiles; ++j) {
        if (wn * kH16WarpTiles + j >= nt) continue;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float v = acc[mt][j][2 * half + c];
          if (v > best[j][c]) {
            best[j][c] = v;
            best_s[j][c] = s;
          }
        }
      }
    }

    if (tile != n_tiles - 1) continue;

    // end of batch row: merge the 8 lanes of each column, then the warps
    // in this tile's stage, once every warp is done reading it; the lower
    // start wins on equal values
    __syncthreads();
    float* merge_v = reinterpret_cast<float*>(xt);  // [wgm][nf]
    int* merge_i = reinterpret_cast<int*>(merge_v + wgm * nf);
#pragma unroll
    for (int j = 0; j < kH16WarpTiles; ++j) {
      const int jn = wn * kH16WarpTiles + j;  // the block's n-tile
      if (jn < nt) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float v = best[j][c];
          int s = best_s[j][c];
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            const float ov = __shfl_xor_sync(0xffffffffu, v, off);
            const int os = __shfl_xor_sync(0xffffffffu, s, off);
            if (ov > v || (ov == v && os < s)) {
              v = ov;
              s = os;
            }
          }
          if (g == 0) {
            merge_v[wm * nf + 8 * jn + 2 * tq + c] = v;
            merge_i[wm * nf + 8 * jn + 2 * tq + c] = s;
          }
          best[j][c] = __int_as_float(0xff800000);
          best_s[j][c] = 0;
        }
      }
    }
    __syncthreads();
    const int b = blockIdx.x + r * gridDim.x;
    for (int col = tid; col < nf; col += nthreads) {
      const int f = f0 + col;
      if (f >= F) continue;
      float v = merge_v[col];
      int s = merge_i[col];
      for (int ow = 1; ow < wgm; ++ow) {
        const float ov = merge_v[ow * nf + col];
        const int os = merge_i[ow * nf + col];
        if (ov > v || (ov == v && os < s)) {
          v = ov;
          s = os;
        }
      }
      // out = relu(fl(max sum + bias)), the max over starts of
      // relu(fl(sum + bias)); where it is 0 every start gives 0 and the
      // first start wins
      const float o = fmaxf(v + bs[col], 0.f);
      out[(size_t)b * F + f] = o;
      idx[(size_t)b * F + f] = o > 0.f ? s : 0;
    }
    // the next copies into this stage follow the next item's barrier
  }
}

// the first of 8, 4, 2, 1 warps, and for it the fewest filter chunks,
// whose 16-bit block fits in `max_smem`; nt = 0 if none does
Config choose_16(int E, int F, int W, int max_smem) {
  const int total = (F + 7) / 8;
  for (int warps = kMaxWarps; warps >= 1; warps /= 2)
    for (int chunks = 1; chunks <= total; ++chunks) {
      const int nt = (total + chunks - 1) / chunks;
      if (nt > kH16MaxNTiles || warps < h16_groups_n(nt)) continue;
      const size_t smem = h16_smem_bytes(E, W, nt, warps);
      if (smem <= (size_t)max_smem) return {warps, nt, (total + nt - 1) / nt, smem};
    }
  return {1, 0, 0, h16_smem_bytes(E, W, 1, 1)};
}

template <typename T16, int W>
int launch_16(const uint16_t* x, const uint16_t* k, const float* bias, const int* skip,
              float* out, int* idx, int B, int T, int E, int F, cudaStream_t stream) {
  int dev = 0, max_smem = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const Config cfg = choose_16(E, F, W, max_smem);
  if (cfg.nt == 0 || cfg.chunks > 65535) return (int)cudaErrorInvalidConfiguration;
  static size_t smem_set = 0;
  if (cfg.smem > smem_set) {
    err = cudaFuncSetAttribute(textcnn_pool_fwd_16_kernel<T16, W>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)cfg.smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = cfg.smem;
  }
  // two persistent blocks per SM and filter chunk
  int blocks = 2 * sms / cfg.chunks;
  blocks = blocks < 1 ? 1 : (blocks > B ? B : blocks);
  const int vec = E % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int kvec = F % 4 == 0 && reinterpret_cast<uintptr_t>(k) % 8 == 0;
  textcnn_pool_fwd_16_kernel<T16, W><<<dim3(blocks, cfg.chunks), cfg.warps * 32, cfg.smem,
                                        stream>>>(x, k, bias, skip, out, idx, B, T, E, F,
                                                  cfg.nt, vec, kvec);
  return (int)cudaGetLastError();
}

template <typename T16>
int dispatch_16(const void* xv, const void* kv, const float* bias, const int* skip, float* out,
                int* idx, int B, int T, int E, int F, int W, void* stream) {
  if (B <= 0 || T <= 0 || E <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  const uint16_t* x = static_cast<const uint16_t*>(xv);
  const uint16_t* k = static_cast<const uint16_t*>(kv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 1: return launch_16<T16, 1>(x, k, bias, skip, out, idx, B, T, E, F, s);
    case 2: return launch_16<T16, 2>(x, k, bias, skip, out, idx, B, T, E, F, s);
    case 3: return launch_16<T16, 3>(x, k, bias, skip, out, idx, B, T, E, F, s);
    case 4: return launch_16<T16, 4>(x, k, bias, skip, out, idx, B, T, E, F, s);
    case 5: return launch_16<T16, 5>(x, k, bias, skip, out, idx, B, T, E, F, s);
    case 6: return launch_16<T16, 6>(x, k, bias, skip, out, idx, B, T, E, F, s);
    case 7: return launch_16<T16, 7>(x, k, bias, skip, out, idx, B, T, E, F, s);
    case 8: return launch_16<T16, 8>(x, k, bias, skip, out, idx, B, T, E, F, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The least shared memory a block needs at this E and W (one warp, one
// n8 tile of filters); the caller reports it when a launch is refused.
size_t textcnn_pool_fwd_smem_bytes(int e, int window) {
  return smem_bytes(e, window, 1, 1, true);
}

int textcnn_pool_fwd_max_window() { return kMaxWindow; }

// x [B, T, E], k [W*E, F], bias [F], skip [B, 2] or null, all contiguous;
// out [B, F] f32 and idx [B, F] int32; second [B, F] f32 or null: the
// largest value of a start other than idx's, -1 where there is none.
// With refine != 0, idx of each near-tie (out > 0, out - second <=
// 1e-5 * max(1, out), out != relu(bias[f])) is the first start of the
// largest window value recomputed in float64; `ties` is then int32
// [4 + 2 * B * F] whose first four are 0 (the launch leaves them 0),
// else null. Launches on `stream` and returns the CUDA error code of the
// launch (0 on success).
int textcnn_pool_fwd_f32(const float* x, const float* k, const float* bias, const int* skip,
                         float* out, int* idx, float* second, int* ties, int B, int T, int E,
                         int F, int W, int refine, void* stream) {
  return dispatch<kPlain>(x, nullptr, k, bias, skip, out, idx, second, ties, B, B, T, E, F, W,
                          refine, stream);
}

// The row-gathered forward: table [N, T, E] and rows [B] int32 in place of
// x; batch row b reads table[rows[b]]. skip, out and idx are per batch row
// as above.
int textcnn_pool_fwd_rows_f32(const float* table, const int* rows, const float* k,
                              const float* bias, const int* skip, float* out, int* idx,
                              int N, int B, int T, int E, int F, int W, void* stream) {
  return dispatch<kRows>(table, rows, k, bias, skip, out, idx, nullptr, nullptr, N, B, T, E, F,
                         W, 0, stream);
}

// 1 where a rows launch at (E, F, W) on a 16-byte aligned table takes
// the warpgroup body on this card, else 0 (the `mma.sync` body).
int textcnn_pool_fwd_rows_wgmma(int e, int f, int w) {
  int sms = 0;
  return rows_wg_shape(e, f, w, &sms) ? 1 : 0;
}

// The word-gathered forward: a word table [V, E] and ids [B, T] int32 in
// place of x; word t of batch row b is table[ids[b, t]]. No skip span
// (the fused path is taken only without one). out and idx as above; a
// row holding an id outside [0, V) gets NaN and -1.
int textcnn_pool_fwd_ids_f32(const float* table, const int* ids, const float* k,
                             const float* bias, float* out, int* idx, int V, int B, int T,
                             int E, int F, int W, void* stream) {
  return dispatch<kIds>(table, ids, k, bias, nullptr, out, idx, nullptr, nullptr, V, B, T, E, F,
                        W, 0, stream);
}

// bf16 operands: x [B, T, E] and k [W*E, F] as bf16 (bit patterns),
// bias [F] f32, skip [B, 2] int32 or null, all contiguous; out [B, F] f32
// and idx [B, F] int32. W <= 8.
int textcnn_pool_fwd_bf16(const void* x, const void* k, const float* bias, const int* skip,
                          float* out, int* idx, int B, int T, int E, int F, int W,
                          void* stream) {
  return dispatch_16<__nv_bfloat16>(x, k, bias, skip, out, idx, B, T, E, F, W, stream);
}

// f16 operands: as `textcnn_pool_fwd_bf16`, x and k as f16 bit patterns.
int textcnn_pool_fwd_f16(const void* x, const void* k, const float* bias, const int* skip,
                         float* out, int* idx, int B, int T, int E, int F, int W,
                         void* stream) {
  return dispatch_16<__half>(x, k, bias, skip, out, idx, B, T, E, F, W, stream);
}

// The least shared memory a 16-bit block needs at this E and W (the same
// for both types).
size_t textcnn_pool_fwd_16_smem_bytes(int e, int window) {
  return h16_smem_bytes(e, window, 1, 1);
}

const char* textcnn_pool_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Flash-attention forward for Hopper (sm_90a): non-causal, segment-masked,
// with optional attention-probability dropout from a counter hash.
//
// Replaces the TPU kernel `_attn_kernel` of
// glearning_benchmark_tpu/ops/pallas_attention.py (launched by
// `_fwd_kernels` through `flash_attention`). Same function, same inputs and
// outputs:
//   q, k, v  [B, L, H, D] (f32 or bf16, last dim contiguous, any other
//            strides: q/k/v are read straight out of the fused qkv
//            projection, no transpose copy)
//   seg      [B, L] int32, 0 = padding; query i may attend key j iff
//            seg[i] == seg[j] and seg[j] != 0
//   o        [B, L, H, D] in q's dtype; pad queries get exact zeros
//   lse      [B, H, L] f32, m + log(l); -1e30 on rows that attend nothing
// Dropout: keep(bh, row, col) = triple32(seed, bh_offset + bh, row, col) >=
// thresh, bit-identical to `dropout_keep_reference` (`_hash_u32`), rescale
// 1/(1-p); the softmax normaliser l sums the UNdropped probabilities.
// bh_offset places a data-parallel rank's rows in the global batch*head
// index space (0 on one process).
//
// What bounds it on an H100. Per allowed (query, key) pair: 4*D FLOPs (q.k
// and p.v) and one exp. With O and LSE written in full (pad rows too), the
// least time is set by bytes at the served rows (AGTT-ZINC [256, 1024, 4,
// 16]: about 9% of the tokens valid, so writing O is most of it) and at the
// packed training rows; on dense rows by the exps on the SFU (16 per SM per
// clock). chip_smoke.py computes both from its inputs. Tensor-core FLOPs are
// never the limit at head dims 4-64; at 128 on dense rows they come near the
// exps.
//
// Five designs, by head dim and input type (ops/flash_attention.py `design`
// names a launch's): bf16 at head dims 4-32 warp-level mma.sync (below);
// bf16 at 64, 128 and 256 warpgroup wgmma fed by TMA (`attn_fwd_kernel_wgmma`,
// further below; a view whose pointer or strides TMA cannot take runs the
// mma.sync design at 64 and 128, the wide route at 256); bf16 at 320, 384,
// 448 and 512 (257-511 zero-padded to the next multiple of 64 by the
// wrapper) wgmma over column halves of O fed by cp.async
// (`attn_fwd_kernel_wgmma_halves`, the wgmma_chunks design; any view); f32
// up to 64 the FP32 pipe a row a thread; f32 at 128 and every head dim the
// others do not take (f32 above 64, bf16 above 512), the wide route.
//
// Design, bf16 at head dims 4-32 (mma.sync). Nothing of the Pallas grid
// carries over (a sequential key axis with VMEM carries, Z=8 folded
// batch*head rows). One block of 4 warps owns 64 query rows of one
// batch*head, 16 a warp: the M of mma.sync.m16n8k16 (bf16 in, f32
// accumulate).
//   - A tile with no valid query (most tiles of the served rows) writes its
//     zeros and LSE and leaves before it scans any segment ids.
//   - Otherwise the block finds the keys its rows may attend
//     (`other_axis_range`) and walks them in tiles of 64, K and V staged in
//     shared memory as bf16 by cp.async, double-buffered (plain loads where
//     pointer or strides do not fit the pieces), rows padded by 8 bf16 so
//     that ldmatrix is free of bank conflicts. Each warp holds its q rows
//     as A fragments in registers; head dims 4 and 8 are zero-padded to the
//     mma depth 16 in registers and shared memory only, never in HBM.
//   - Per 16 keys a warp skips the keys unless one lies in its segment-id
//     range; computes S = q k^T by mma (K through ldmatrix); scales S in the
//     f32 accumulator (never folded into a bf16 q), masks it, takes the row
//     max across the quad (two shuffles), rescales acc and l, and forms
//     p = ex2.approx(x - m) on allowed pairs only (a row whose chunk is all
//     masked keeps m = -1e30, so p is selected to 0, not computed from it),
//     l += p, then the dropout hash, all in the accumulator registers;
//   - acc += P~ V with P~ straight from registers as the A operand (the
//     accumulators of two n-tiles are the A fragment of one 16-deep k-step)
//     and V through ldmatrix.trans: no round trip through shared memory.
//     P~ is not bf16: one bf16 rounding (2^-9) on top of O's own rounding
//     breaks the elementwise 4e-3 against the f32 plain version where
//     p v cancels, and hi + lo (about 2^-17) can still miss it, so P~ is
//     split into three bf16 terms hi + mid + lo (`kSplitTerms`, exact for
//     the f32 value) and each is multiplied; tests/test_torch_fwd_wgmma.py
//     emulates the splits on its cancelling-sum case.
//   - Epilogue: l summed across the quad in a fixed order, O = acc / l cast
//     to bf16 and staged in shared memory, then stored in 16-byte pieces
//     (8 at D = 4), pad rows as exact zeros; LSE = m + log l in f32.
// A row's result depends on its own sequence alone (no atomics, fixed
// order), so it is the same in batches of any size.
//
// Why mma.sync and not wgmma/TMA at head dims 4-32. wgmma's unit is a 64-row
// warpgroup tile fed from shared memory, and TMA pays off on large tiles. At
// head dims 4-16 every product is one 16-deep k-step and the tensor cores idle most
// of the time anyway: what limits the kernel is the elementwise work
// between the products (mask, max, exp, hash) and the bytes. Warp-level
// mma lets each warp skip the keys its own 16 rows may not attend and keeps
// P in registers between the two products.
//
// Head dims. 4, 8, 16, 32, 64 and 128 have instances (`with_head_dim`), and
// 256 in the wgmma design, 320, 384, 448 and 512 in the wgmma_chunks
// design; the wrapper zero-pads any other head dim up to 128 to the next
// of them (bf16 129-255 to 256, 257-511 to the next multiple of 64) and
// hands the kernel the scale of the true one. At 128 the mma.sync route's two double-buffered
// tiles take 69,632 bytes, past the 48 KB of static shared memory, so that
// route keeps them in dynamic shared memory there (`MmaTiles`,
// `launch_dyn`).
//
// Design, bf16 at head dims 64, 128 and 256 (wgmma; `attn_fwd_kernel_wgmma`).
// There the products dominate: per allowed pair 4 D FLOPs against one exp,
// and mma.sync (a warp's 16 x 8 tiles, loads, products and softmax one after
// the other in each warp) ran at 2-2.5x SDPA on dense rows and at 16x above
// 128 on the FP32 pipe. A block owns 64 query rows a consumer warpgroup of
// one batch*head, and has one producer warpgroup:
//   - one producer warp (its warpgroup gives its registers to the consumers,
//     setmaxnreg) loads the block's q once and then K and V tiles of 64 keys
//     (32 at 256) with TMA into a ring of kFwdStages stages, each with a full
//     and an empty mbarrier; the tensor maps cover the strided [B, L, H, D]
//     view (row stride 3 H D in the fused qkv), built on the host at each
//     launch (`tma_map`), one box a column group of 8 so that each tile lands
//     in wgmma's core-matrix layout without swizzle (flash_attn_common.cuh);
//     the producer also stages the tile's key segment ids and their range;
//   - two consumer warpgroups (three at head dim 64, `fwd_consumers`): S =
//     q k^T is a wgmma with both operands in shared memory (K-major), P~ V a
//     wgmma with P~ from registers (the S accumulator is the A fragment) and
//     V read MN-major; P~ goes in as three bf16 terms hi + mid + lo
//     (`kSplitTerms`, each rounded: `split_bf16x2`), as in the mma.sync
//     design;
//   - overlap: each consumer issues the next tile's q k^T before this tile's
//     P~ V, waits for the q k^T only (wgmma.wait_group 1), and runs the next
//     tile's max, exp, hash under this tile's P~ V; the split into bf16 terms
//     waits for P~ V (its A registers);
//   - what bounds it once the products overlap is the per-pair integer and
//     FP32 work (the dropout hash alone is about a quarter of the dense head
//     dim 64 rows), so: no mask where a tile's keys and the warpgroup's rows
//     share one segment (`FULL`); the scale folded into the exp's FMA; the
//     1 / (1 - p_drop) applied once to O; acc rescaled only where a row's max
//     moved; the hash's last step skipped where the keep threshold has 16 low
//     zero bits (`hash_keep`, its own instance, `FwdDrop`);
//   - a query tile with no valid row writes its zeros and LSE and leaves;
//     the producer walks only the keys of `other_axis_range`, and a tile
//     whose key segment ids miss a consumer's range issues no wgmma there;
//   - epilogue: l summed across the quad in a fixed order, O = acc / l staged
//     in the consumer's q tile (16-byte chunks swizzled by row) and stored in
//     16-byte pieces; pad rows exact zeros. No atomics: the same bits on two
//     runs and in batches of any size.
//
// Design, bf16 at head dims 257-512 (wgmma_chunks;
// `attn_fwd_kernel_wgmma_halves`, instances at 320, 384, 448 and 512). The
// wide route ran at 228x the bound at 320, and the design at 256 does not
// stretch: its O accumulator of 64 rows a warpgroup takes D / 2 registers
// a thread (160 at 320, 256 at 512) beside S and P~'s split terms. As the
// dQ kernel at these head dims (flash_attn_bwd_dq.cu), a block is two
// warpgroups on the same 64 query rows, each holding one column half of O
// (D / 4 accumulator registers a thread: 80 at 320, 128 at 512). q sits in
// shared memory for the block's life; K, V and the key segment ids stream
// through a two-stage cp.async ring of 32-key tiles filled by the same
// threads one tile ahead (any view; plain loads where a pointer or stride
// does not fit 16-byte pieces). Per tile that holds an allowed pair for the
// block:
//   - each warpgroup forms the whole S = q k^T (D / 16 k-steps of
//     m64n32k16, both operands in shared memory) and its online softmax
//     (`fwd_softmax`: the mask, or none where the tile's keys and the
//     block's rows share one segment; the max, alpha, p, l, the dropout
//     keep), the same products and arithmetic in both, so m and l agree;
//   - acc is rescaled where a row's max moved, and P~ goes into P~ V as
//     three bf16 terms straight from the S accumulator (the A fragment),
//     m64n(D/2)k16 on the warpgroup's column half of V (MN-major).
// Epilogue: O = acc (1 / (1 - p_drop)) / l staged in the q tile, 16-byte
// stores, LSE from warpgroup 0; pad rows exact zeros; no atomics: the same
// bits on two runs. 205-245 registers a thread, 0 B spilled, 123,136 /
// 147,712 / 172,288 / 196,864 B of dynamic shared memory at 320 / 384 /
// 448 / 512: one block, eight warps an SM. Chosen by measurement
// (tools/kernel_ab.py, PERF.md §6; packed [16, 1024, 8, 320] and
// [8, 1024, 8, 384], p 26/256, every variant timed in turns with this one
// in one call): each warpgroup forming S of half the tile's keys and
// trading row maxima and P~ through shared memory ran 1.09x / 1.06x this
// design's time, column halves on grid z (a block one warpgroup) 1.65x /
// 1.62x, 64-key tiles at 320 1.19x, a three-stage ring 0.99x / 1.03x
// (1.20x at 448), and the next tile's q k^T and softmax under this tile's
// P~ V (three stages) 0.96x / 1.21x (1.41x at 448; it spills there).
// Nothing overlaps within a block: at 320, without the ring's copies it
// ran 0.79x, without q k^T 0.84x, without P~ V 0.86x, without the softmax
// 0.90x. Above 512 the wide route remains.
//
// f32 (the FP32-pipe route) up to head dim 64. Tensor cores take no f32
// input, and TF32 would not hold f32 accuracy. One block of 128 threads
// takes 128 query rows, one per thread, with q, the output accumulator and
// (m, l) in f32 registers, and loops over key tiles of 64 staged in shared
// memory as f32 (every thread reads the same key: broadcasts), in
// online-softmax chunks of 16 keys; it skips tiles and query blocks the
// mask rules out the same way.
//
// f32 at head dim 128 and every head dim above 128, bf16 above 512: the
// wide FP32-pipe route (`attn_fwd_kernel_wide`, flash_attn_common.cuh
// `kWideRows`). A block owns 32 query rows and one chunk of 128 columns of
// O (grid z = ceil(D / 128)); a row is held by 4 threads, 32 columns each,
// so that no thread keeps a full-width row (one row a thread spilled 440
// bytes at 128): lane i of each of the four warps, warp w holding columns
// [32 w, 32 w + 32) of the chunk. Key tiles of 16 are staged as f32 one
// column chunk at a time: S is summed over every chunk of K (the four
// warps' parts through shared memory in a fixed order, `wide_reduce`), then the online softmax takes the tile and the V chunk of the
// block's columns is staged for P~ V. Above 128 this recomputes S once per
// column chunk (ceil(D / 128) times), the price of holding any head dim in
// fixed registers; the head dim is a run-time argument, so any head dim
// runs unpadded. LSE is written by the blocks of chunk 0.
//
// The wrapper names each launch's design (ops/flash_attention.py `design`,
// the `Design` codes of flash_attn_common.cuh); the entry point runs it, or
// returns cudaErrorInvalidValue where this source has no instance of it.

#include <cuda.h>  // CUtensorMap and its enums; the library links no -lcuda

#include "flash_attn_common.cuh"

namespace {

using namespace flash;  // constants, hash, the tensor-core building blocks
using bf16 = __nv_bfloat16;

constexpr int kChunk = 16;  // f32 route: keys per online-softmax step

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* seg;
  void* o;
  float* lse;
  int64_t q_sb, q_sl, q_sh;
  int64_t k_sb, k_sl, k_sh;
  int64_t v_sb, v_sl, v_sh;
  int B, L, H;
  float scale_log2;  // softmax scale * log2(e)
  int dropout;       // 0: p_drop == 0
  uint32_t seed;
  uint32_t keep_thresh;
  float keep_scale;    // 1 / (1 - p_drop)
  uint32_t bh_offset;  // added to batch*head in the dropout hash
};

// Rows [r0, r0 + n) of one head of O (row stride `stride` elements; rows at
// or beyond L are skipped) stored in pieces of 16 bytes (8 at D = 4): from
// the shared tile `src` (row stride LD), or zeros where src is nullptr.
// Thread t of `nthreads` takes every nthreads-th piece.
template <int D, int LD>
__device__ __forceinline__ void store_rows(bf16* o, int64_t stride, int r0,
                                           int n, int L, const bf16* src,
                                           int t, int nthreads) {
  constexpr int kPiece = D >= 8 ? 8 : D;  // bf16 a store
  constexpr int kPer = D / kPiece;
  for (int c = t; c < n * kPer; c += nthreads) {
    const int r = c / kPer;
    const int part = c - r * kPer;
    if (r0 + r >= L) continue;
    bf16* dst = o + static_cast<int64_t>(r0 + r) * stride + part * kPiece;
    if constexpr (kPiece == 8) {
      *reinterpret_cast<uint4*>(dst) =
          src != nullptr ? *reinterpret_cast<const uint4*>(src + r * LD + part * kPiece)
                         : make_uint4(0, 0, 0, 0);
    } else {
      *reinterpret_cast<uint2*>(dst) =
          src != nullptr ? *reinterpret_cast<const uint2*>(src + r * LD)
                         : make_uint2(0, 0);
    }
  }
}

// The bf16 route (see the header note). DROP: p_drop > 0 (a template
// argument, so that the pair loop has no branch).
template <int D, bool DROP>
__global__ void __launch_bounds__(kMmaThreads)
    attn_fwd_kernel_mma(const Params p, const int vec) {
  constexpr int DP = D < 16 ? 16 : D;  // mma depth: D padded to 16
  constexpr int KD = DP / 16;          // k-steps of q.k
  constexpr int NT = (D + 7) / 8;      // n-tiles of 8 head columns of O
  constexpr int LD = mma_ld(D);        // shared row stride: no bank conflicts
  auto& ks = mma_tiles<LD>().a;        // [2][kMmaTile][LD]
  auto& vs = mma_tiles<LD>().b;
  __shared__ int32_t segs[2][kMmaTile];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int tile0 = blockIdx.y * kMmaRows;
  const int32_t* seg_b = p.seg + static_cast<int64_t>(b) * p.L;
  const int64_t o_sl = static_cast<int64_t>(p.H) * D;  // O is contiguous
  bf16* ob = static_cast<bf16*>(p.o) + static_cast<int64_t>(b) * p.L * o_sl + h * D;
  float* lse_bh = p.lse + static_cast<int64_t>(bh) * p.L;

  // a query tile with no valid row: zeros and -1e30, nothing else
  const int blk_row = tile0 + tid;
  const int32_t blk_seg = (tid < kMmaRows && blk_row < p.L) ? seg_b[blk_row] : 0;
  if (!__syncthreads_or(blk_seg != 0)) {
    store_rows<D, LD>(ob, o_sl, tile0, kMmaRows, p.L, nullptr, tid, kMmaThreads);
    if (tid < kMmaRows && blk_row < p.L) lse_bh[blk_row] = kNegInf;
    return;
  }

  // the warp's segment-id range, the block's key range
  const int row0 = tile0 + warp * 16;  // the warp's first row
  const int32_t my_seg =
      (lane < 16 && row0 + lane < p.L) ? seg_b[row0 + lane] : 0;
  int32_t wlo, whi;
  warp_seg_range(my_seg, &wlo, &whi);
  int k_first, k_last;
  other_axis_range(seg_b, p.L, blk_seg, &k_first, &k_last);
  const int kend = k_last + 1;
  const int ntiles = (kend - k_first + kMmaTile - 1) / kMmaTile;  // <= 0: none

  const bf16* qp = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;

  // this thread's two rows (g and g+8 of the warp's 16) and their q
  int rows[2];
  int32_t sq[2];
  const bf16* qr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rows[i] = row0 + g + 8 * i;
    sq[i] = rows[i] < p.L ? seg_b[rows[i]] : 0;
    qr[i] = sq[i] != 0 ? qp + static_cast<int64_t>(rows[i]) * p.q_sl : nullptr;
  }
  uint32_t qa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) load_a_frag<D>(qa[kk], qr[0], qr[1], kk * 16);
  uint32_t hrow[2];  // the dropout hash's (batch*head, row) terms
#pragma unroll
  for (int i = 0; i < 2; ++i)
    hrow[i] = ((static_cast<uint32_t>(bh) + p.bh_offset) * kHashBh) ^
              (static_cast<uint32_t>(rows[i]) * kHashRow);
  // opaque to the compiler: kept in registers, not recomputed per pair
  asm volatile("" : "+r"(hrow[0]), "+r"(hrow[1]));
  float acc[NT][4];  // unnormalised O: rows g (e 0, 1) and g+8 (e 2, 3)
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running max of the log2-scaled logits
  float l[2] = {0.f, 0.f};          // this thread's part of the undropped sum

  if constexpr (D < 16) {  // padded columns stay zero: cp.async never writes them
    for (int e = tid; e < 2 * kMmaTile * (16 - D); e += kMmaThreads) {
      const int r = e / (16 - D);
      const int c = D + e - r * (16 - D);
      ks[r / kMmaTile][r % kMmaTile][c] = __ushort_as_bfloat16(0);
      vs[r / kMmaTile][r % kMmaTile][c] = __ushort_as_bfloat16(0);
    }
  }
  auto stage = [&](int t, int buf) {
    const int s0 = k_first + t * kMmaTile;
    stage_rows<D, LD>(&ks[buf][0][0], kp, p.k_sl, s0, kend, vec);
    stage_rows<D, LD>(&vs[buf][0][0], vp, p.v_sl, s0, kend, vec);
    if (tid < kMmaTile)
      cp_async<4>(&segs[buf][tid], seg_b + (s0 + tid < kend ? s0 + tid : 0),
                  s0 + tid < kend);
    cp_async_commit();
  };

  if (ntiles > 0) stage(0, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < ntiles) {
      stage(t + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int s0 = k_first + t * kMmaTile;
#pragma unroll 1
    for (int c = 0; c < kMmaTile; c += 16) {
      const int32_t sk_l = lane < 16 ? segs[buf][c + lane] : 0;
      if (!__any_sync(0xffffffffu, sk_l != 0 && sk_l >= wlo && sk_l <= whi))
        continue;  // no allowed pair for this warp among these 16 keys
      float s[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t kb[4];
        ldsm_x4(kb, &ks[buf][c + (lane & 7) + ((lane >> 4) << 3)]
                       [kk * 16 + ((lane >> 3) & 1) * 8]);
        mma_bf16(s[0], qa[kk], kb[0], kb[1]);
        mma_bf16(s[1], qa[kk], kb[2], kb[3]);
      }
      // log2-scaled logits on allowed pairs, -1e30 elsewhere; the row max
      // over the thread's 4 keys a row, then across the quad. A pad row
      // (sq 0) may match pad keys here: it is zeroed at the end.
      bool allow[2][4];
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          allow[n][e] = segs[buf][c + n * 8 + 2 * tg + (e & 1)] == sq[i];
          s[n][e] = allow[n][e] ? s[n][e] * p.scale_log2 : kNegInf;
          mx[i] = fmaxf(mx[i], s[n][e]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float alpha = ex2_approx(m[i] - mx[i]);  // 1 while both -1e30
        m[i] = mx[i];
        l[i] *= alpha;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          acc[n][2 * i] *= alpha;
          acc[n][2 * i + 1] *= alpha;
        }
      }
      // p on allowed pairs only (never exp2(-1e30 - m) of a masked key), l
      // sums it undropped, P~ = p keep/(1-p)
      const uint32_t col0 = static_cast<uint32_t>(s0 + c + 2 * tg);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          float pr = allow[n][e] ? ex2_approx(s[n][e] - m[i]) : 0.f;
          l[i] += pr;
          if constexpr (DROP) {
            const uint32_t col = col0 + n * 8 + (e & 1);
            const uint32_t hv = hash_finish(p.seed, hrow[i] ^ (col * kHashCol));
            pr = hv >= p.keep_thresh ? pr * p.keep_scale : 0.f;
          }
          s[n][e] = pr;
        }
      }
      SplitA<kSplitTerms> pa;
      split_bf16x2(s[0][0], s[0][1], pa, 0);
      split_bf16x2(s[0][2], s[0][3], pa, 1);
      split_bf16x2(s[1][0], s[1][1], pa, 2);
      split_bf16x2(s[1][2], s[1][3], pa, 3);
#pragma unroll
      for (int n2 = 0; n2 < (NT + 1) / 2; ++n2) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, &vs[buf][c + (lane & 7) + ((lane >> 3) & 1) * 8]
                             [n2 * 16 + (lane >> 4) * 8]);
        mma_bf16_split(acc[2 * n2], pa, vb[0], vb[1]);
        if (2 * n2 + 1 < NT) mma_bf16_split(acc[2 * n2 + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // buf is restaged at t + 2; after the last tile, ks is free
  }

  // l across the quad, in a fixed order; O = acc / l through the warp's 16
  // rows of ks[0] (free now), then 16-byte stores; LSE in f32
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  bf16* os = &ks[0][warp * 16][0];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool live = sq[i] != 0 && l[i] > 0.f;  // pad rows: exact zeros
    const float inv = live ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = n * 8 + 2 * tg;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(os + (g + 8 * i) * LD + col) =
            __floats2bfloat162_rn(live ? acc[n][2 * i] * inv : 0.f,
                                  live ? acc[n][2 * i + 1] * inv : 0.f);
    }
    if (tg == 0 && rows[i] < p.L)
      lse_bh[rows[i]] = live ? (m[i] + log2f(l[i])) * kLn2 : kNegInf;
  }
  __syncwarp();
  store_rows<D, LD>(ob, o_sl, row0, 16, p.L, os, lane, 32);
}

// ---------------------------------------------------------------------------
// the wgmma route (bf16 at head dims 64, 128 and 256; see the header note)
// ---------------------------------------------------------------------------

constexpr int kFwdStages = 4;      // K/V tiles in the ring
constexpr int kProducerRegs = 24;  // setmaxnreg: the producer warpgroup's registers
// Consumer warpgroups of 64 query rows a block: three at head dim 64, where
// a consumer needs the fewest registers and the softmax's latency wants the
// most warps, two above.
__host__ __device__ constexpr int fwd_consumers(int d) { return d <= 64 ? 3 : 2; }
__host__ __device__ constexpr int fwd_rows(int d) { return 64 * fwd_consumers(d); }
__host__ __device__ constexpr int fwd_threads(int d) { return 128 * (fwd_consumers(d) + 1); }
// setmaxnreg: each consumer thread's registers, what the producer leaves
__host__ __device__ constexpr int fwd_consumer_regs(int d) {
  return fwd_consumers(d) == 3 ? 160 : 240;
}
static_assert(128 * kProducerRegs + 3 * 128 * 160 <= 65536 &&
                  128 * kProducerRegs + 2 * 128 * 240 <= 65536,
              "a block's registers fit the SM's 65,536");
// keys a tile: 32 at head dim 256, where the O accumulator takes 128
// registers a thread
__host__ __device__ constexpr int fwd_keys(int d) { return d > 128 ? 32 : 64; }

// The block's shared memory. q and each K and V tile in wgmma's core-matrix
// layout [D / 8][rows][8] (flash_attn_common.cuh); after the key loop each
// consumer's q tile stages its rows of O.
template <int D>
struct FwdSmem {
  static constexpr int KN = fwd_keys(D);
  bf16 q[fwd_consumers(D)][64 * D];
  bf16 k[kFwdStages][KN * D];
  bf16 v[kFwdStages][KN * D];
  int32_t seg[kFwdStages][KN];      // the tile's key segment ids (0 beyond the range)
  int32_t lo[kFwdStages];           // their least non-zero id
  int32_t hi[kFwdStages];           // and their largest
  int32_t uni[kFwdStages];          // the id every key of the tile has, else 0
  uint64_t full[kFwdStages];        // the tile has landed (TMA bytes and the producer's ids)
  uint64_t empty[kFwdStages];       // every consumer warp is done with it
  uint64_t q_full;
};
// dynamic shared bytes of a launch: the struct and room to align it to 128
template <int D>
__host__ __device__ constexpr size_t fwd_smem_bytes() {
  return sizeof(FwdSmem<D>) + 128;
}

// The three TMA maps of a launch (q, k, v), kernel parameters in constant
// space (__grid_constant__): TMA reads them by address.
struct FwdMaps {
  CUtensorMap q, k, v;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// one arrival that also announces `bytes` of TMA transfers to the phase
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}
// A box of the [B, L, H, D] map at (column c0, head h, row r, batch b) into
// shared memory; its bytes complete a transaction on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int h, int r, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(h), "r"(r),
      "r"(b)
      : "memory");
}
// `n` threads (whole warps of this consumer warpgroup) meet at barrier `id`
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// max, or sum, of this thread's KN / 4 elements of row i of an S tile
// (element 4 n + 2 i + c), in four chains
template <int KN, bool MAX>
__device__ __forceinline__ float row_reduce(const float (&s)[KN / 2], int i) {
  static_assert(KN % 32 == 0, "four chains of whole n-tile pairs");
  auto op = [](float a, float b) { return MAX ? fmaxf(a, b) : a + b; };
  float r0 = s[2 * i], r1 = s[2 * i + 1], r2 = s[4 + 2 * i], r3 = s[5 + 2 * i];
#pragma unroll
  for (int n = 2; n < KN / 8; n += 2) {
    r0 = op(r0, s[4 * n + 2 * i]);
    r1 = op(r1, s[4 * n + 2 * i + 1]);
    r2 = op(r2, s[4 * n + 4 + 2 * i]);
    r3 = op(r3, s[4 * n + 5 + 2 * i]);
  }
  return op(op(r0, r1), op(r2, r3));
}

// The softmax of one S tile of the consumer's 64 rows in its accumulator
// registers (element 4 n + 2 i + c: this thread's row i, key 8 n + 2 t + c):
// logits of allowed pairs (-1e30 elsewhere; FULL: the tile's keys and the
// warpgroup's rows share one segment, nothing is masked), the new row max
// m of the log2-scaled logits (across the quad), alpha = 2^(m_old - m_new)
// for acc and l, then p = 2^(s scale - m) on allowed pairs only, l += p
// undropped, and P~ = p keep in place of S (the 1 / (1 - p_drop) of the kept
// ones is applied to O once, in the epilogue).
template <int KN, bool DROP, bool SHORT, bool FULL>
__device__ __forceinline__ void fwd_softmax(float (&s)[KN / 2], float (&m)[2], float (&l)[2],
                                            float (&alpha)[2], const int32_t* segs,
                                            const int32_t (&sq)[2], const uint32_t (&hrow)[2],
                                            uint32_t col0, const Params& p) {
  const int tg = threadIdx.x & 3;
  if constexpr (!FULL) {
#pragma unroll
    for (int n = 0; n < KN / 8; ++n) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int32_t sk = segs[8 * n + 2 * tg + c];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = 4 * n + 2 * i + c;
          s[e] = sk == sq[i] ? s[e] : kNegInf;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = row_reduce<KN, true>(s, i);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // a row with no allowed key so far keeps m far below any logit: its p
    // are selected to 0 and its alpha is 0 or 1 on a zero acc and l
    const float m_new = fmaxf(m[i], mx * p.scale_log2);
    alpha[i] = ex2_approx(m[i] - m_new);
    m[i] = m_new;
  }
  const uint32_t hcol = (col0 + 2 * tg) * kHashCol;
#pragma unroll
  for (int n = 0; n < KN / 8; ++n) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int e = 4 * n + 2 * i + c;
        // a masked pair holds exactly -1e30: p is selected to 0, never
        // computed from it
        const float pr = FULL || s[e] != kNegInf
                             ? ex2_approx(fmaf(s[e], p.scale_log2, -m[i]))
                             : 0.f;
        s[e] = pr;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + row_reduce<KN, false>(s, i);
  if constexpr (DROP) {
#pragma unroll
    for (int n = 0; n < KN / 8; ++n) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const uint32_t hc = hcol + static_cast<uint32_t>(8 * n + c) * kHashCol;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = 4 * n + 2 * i + c;
          s[e] = hash_keep<SHORT>(p.seed, hrow[i] ^ hc, p.keep_thresh) ? s[e] : 0.f;
        }
      }
    }
  }
}

// One consumer warpgroup of the wgmma route (`wg` of the block's
// fwd_consumers(D)): 64 query rows, 16 a warp. SHORT: hash_keep's short form.
template <int D, bool DROP, bool SHORT>
__device__ __forceinline__ void fwd_consumer(const Params& p, FwdSmem<D>& sm, const int wg,
                                             const int tile0, const int k_first,
                                             const int ntiles) {
  constexpr int KN = fwd_keys(D);
  constexpr int KD = D / 16;               // k-steps of q k^T
  constexpr int OW = D > 128 ? 128 : D;    // columns of O one P~ V product covers
  constexpr int NH = D / OW;               // products a k-step
  constexpr int NS = kSplitTerms;          // bf16 terms of P~
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int32_t* seg_b = p.seg + static_cast<int64_t>(b) * p.L;
  const int64_t o_sl = static_cast<int64_t>(p.H) * D;  // O is contiguous
  bf16* ob = static_cast<bf16*>(p.o) + static_cast<int64_t>(b) * p.L * o_sl + h * D;
  float* lse_bh = p.lse + static_cast<int64_t>(bh) * p.L;
  const int warp = (tid >> 5) & 3;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int wrow0 = tile0 + 64 * wg;  // the warpgroup's first row
  int32_t wlo, whi;  // the warpgroup's segment-id range (whi 0: no valid row)
  int32_t wuni;      // the id every row of the warpgroup has, else 0
  {
    int32_t lo = INT32_MAX, hi = 0;
    bool pad = false;
#pragma unroll
    for (int j = lane; j < 64; j += 32) {
      const int32_t s = wrow0 + j < p.L ? seg_b[wrow0 + j] : 0;
      pad |= s == 0;
      if (s != 0) {
        lo = min(lo, s);
        hi = max(hi, s);
      }
    }
    wlo = __reduce_min_sync(0xffffffffu, lo);
    whi = __reduce_max_sync(0xffffffffu, hi);
    wuni = !__any_sync(0xffffffffu, pad) && wlo == whi ? wlo : 0;
  }
  int rows[2];
  int32_t sq[2];     // this thread's rows' segment ids; -1 on a pad row (pairs with no key)
  uint32_t hrow[2];  // the dropout hash's (batch*head, row) terms
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rows[i] = wrow0 + 16 * warp + g + 8 * i;
    const int32_t s = rows[i] < p.L ? seg_b[rows[i]] : 0;
    sq[i] = s != 0 ? s : -1;
    hrow[i] = ((static_cast<uint32_t>(bh) + p.bh_offset) * kHashBh) ^
              (static_cast<uint32_t>(rows[i]) * kHashRow);
  }
  asm volatile("" : "+r"(hrow[0]), "+r"(hrow[1]));

  float acc[NH][OW / 2];  // unnormalised O (wgmma layout, columns OW hh + ...)
#pragma unroll
  for (int hh = 0; hh < NH; ++hh)
#pragma unroll
    for (int e = 0; e < OW / 2; ++e) acc[hh][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running max of the log2-scaled logits
  float l[2] = {0.f, 0.f};          // this thread's part of the undropped sum
  float alpha[2] = {1.f, 1.f};      // rescale of acc before the next P~ V
  float sc[KN / 2];                 // S, then P~, of the tile in hand
  SplitA<NS> pa[KN / 16];           // P~ as the A fragments of P~ V
  const bf16* qs = sm.q[wg];

  // the tile's stage is free once every warp of the warpgroup is done with it
  auto release = [&](int t) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[t % kFwdStages]);
  };
  // the next tile below `limit` whose key ids meet this warpgroup's range
  // (-1: none); tiles that do not are released unread
  int u = 0;
  auto next_live = [&](int limit) -> int {
    for (; u < limit; ++u) {
      const int st = u % kFwdStages;
      mbar_wait(&sm.full[st], (u / kFwdStages) & 1);
      if (whi != 0 && sm.hi[st] >= wlo && sm.lo[st] <= whi) return u++;
      release(u);
    }
    return -1;
  };
  auto issue_s = [&](int t) {
    const bf16* kt = sm.k[t % kFwdStages];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      Wgmma<KN>::ss(sc, desc_kmajor<64>(qs, kk), desc_kmajor<KN>(kt, kk), kk > 0);
    wgmma_commit();
  };
  auto softmax = [&](int t) {
    const int st = t % kFwdStages;
    const uint32_t col0 = static_cast<uint32_t>(k_first + t * KN);
    if (wuni != 0 && sm.uni[st] == wuni)  // the same for the whole warpgroup
      fwd_softmax<KN, DROP, SHORT, true>(sc, m, l, alpha, sm.seg[st], sq, hrow, col0, p);
    else
      fwd_softmax<KN, DROP, SHORT, false>(sc, m, l, alpha, sm.seg[st], sq, hrow, col0, p);
  };
  auto split = [&]() {
#pragma unroll
    for (int kk = 0; kk < KN / 16; ++kk) {
      split_bf16x2(sc[8 * kk], sc[8 * kk + 1], pa[kk], 0);
      split_bf16x2(sc[8 * kk + 2], sc[8 * kk + 3], pa[kk], 1);
      split_bf16x2(sc[8 * kk + 4], sc[8 * kk + 5], pa[kk], 2);
      split_bf16x2(sc[8 * kk + 6], sc[8 * kk + 7], pa[kk], 3);
    }
  };

  // acc *= alpha (where a row of the warp moved its max), then acc += P~ V
  // of tile t (committed, not waited)
  auto issue_pv = [&](int t) {
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int hh = 0; hh < NH; ++hh)
#pragma unroll
        for (int e = 0; e < OW / 2; ++e) acc[hh][e] *= alpha[(e >> 1) & 1];
    }
    const bf16* vt = sm.v[t % kFwdStages];
    wgmma_fence();
#pragma unroll
    for (int term = 0; term < NS; ++term)
#pragma unroll
      for (int kk = 0; kk < KN / 16; ++kk)
#pragma unroll
        for (int hh = 0; hh < NH; ++hh)
          Wgmma<OW>::rs_t(acc[hh], pa[kk].t[term],
                          desc_mnmajor<KN>(vt + hh * (OW / 8) * KN * 8, kk));
    wgmma_commit();
  };
  auto wait_pv = [&](int t) {
    wgmma_wait<0>();
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) fence_regs(acc[hh]);
    release(t);
  };
  // q k^T of tile t alone, then its softmax and split
  auto first_s = [&](int t) {
    issue_s(t);
    wgmma_wait<0>();
    fence_regs(sc);
    softmax(t);
    split();
  };

  // Each path below issues and waits for a fixed sequence of wgmma groups,
  // and every one ends with none in flight: ptxas can follow the groups and
  // need not serialise the products.
  mbar_wait(&sm.q_full, 0);
  int t = next_live(ntiles);
  if (t >= 0) first_s(t);
  while (t >= 0) {
    // the next live tile within the ring (tile t holds its stage until its
    // P~ V is done)
    const int nx = next_live(min(ntiles, t + kFwdStages));
    if (nx >= 0) {
      // its q k^T goes in before this tile's P~ V, and its softmax runs
      // under that P~ V; the split waits for the P~ V (its A registers)
      issue_s(nx);
      issue_pv(t);
      wgmma_wait<1>();
      fence_regs(sc);
      softmax(nx);
      wait_pv(t);
      split();
      t = nx;
    } else {  // none within the ring: finish tile t, then look further
      issue_pv(t);
      wait_pv(t);
      t = next_live(ntiles);
      if (t >= 0) first_s(t);
    }
  }

  // l across the quad, in a fixed order; O = acc / l staged in this
  // warpgroup's q tile (16-byte chunk c of row r at chunk c ^ (r & 7): the
  // quad's stores and the row reads meet no bank twice), then 16-byte
  // stores; LSE in f32
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  bf16* os = sm.q[wg];
  named_sync(1 + wg, 128);  // every warp's products have read q
  fence_proxy_async();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool live = sq[i] > 0 && l[i] > 0.f;  // pad rows: exact zeros
    const float inv = live ? p.keep_scale / l[i] : 0.f;
    const int r = 16 * warp + g + 8 * i;
#pragma unroll
    for (int hh = 0; hh < NH; ++hh)
#pragma unroll
      for (int n = 0; n < OW / 8; ++n) {
        const int col = hh * OW + 8 * n + 2 * tg;
        *reinterpret_cast<__nv_bfloat162*>(os + r * D + ((((col >> 3) ^ (r & 7))) << 3) +
                                           (col & 7)) =
            __floats2bfloat162_rn(acc[hh][4 * n + 2 * i] * inv,
                                  acc[hh][4 * n + 2 * i + 1] * inv);
      }
    if (tg == 0 && rows[i] < p.L)
      lse_bh[rows[i]] = live ? (m[i] + log2f(l[i])) * kLn2 : kNegInf;
  }
  named_sync(1 + wg, 128);
  for (int c = tid & 127; c < 64 * (D / 8); c += 128) {
    const int r = c / (D / 8);
    const int cc = c - r * (D / 8);
    if (wrow0 + r < p.L)
      *reinterpret_cast<uint4*>(ob + static_cast<int64_t>(wrow0 + r) * o_sl + cc * 8) =
          *reinterpret_cast<const uint4*>(os + r * D + ((cc ^ (r & 7)) << 3));
  }
}

// The dropout forms of a wgmma instance: none, the hash, the hash's short
// form (hash_keep; a keep threshold with 16 low zero bits). One instance
// each, so that each holds one consumer loop in its registers.
enum FwdDrop : int { kNoDrop = 0, kDrop = 1, kDropShort = 2 };
__host__ __device__ constexpr int fwd_drop(int dropout, uint32_t keep_thresh) {
  return !dropout ? kNoDrop : (keep_thresh & 0xFFFFu) == 0 ? kDropShort : kDrop;
}

template <int D, int DROP>
__global__ void __launch_bounds__(fwd_threads(D), 1)
    attn_fwd_kernel_wgmma(const Params p, const __grid_constant__ FwdMaps maps) {
  constexpr int NC = fwd_consumers(D);
  constexpr int ROWS = fwd_rows(D);
  constexpr int KN = fwd_keys(D);
  extern __shared__ __align__(128) unsigned char fwd_smem_raw[];
  FwdSmem<D>& sm = *reinterpret_cast<FwdSmem<D>*>(
      fwd_smem_raw + ((128 - (smem_u32(fwd_smem_raw) & 127)) & 127));

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int tile0 = blockIdx.y * ROWS;
  const int32_t* seg_b = p.seg + static_cast<int64_t>(b) * p.L;
  const int64_t o_sl = static_cast<int64_t>(p.H) * D;  // O is contiguous
  bf16* ob = static_cast<bf16*>(p.o) + static_cast<int64_t>(b) * p.L * o_sl + h * D;
  float* lse_bh = p.lse + static_cast<int64_t>(bh) * p.L;

  // a query tile with no valid row: zeros and -1e30, nothing else
  const int blk_row = tile0 + tid;
  const int32_t blk_seg = (tid < ROWS && blk_row < p.L) ? seg_b[blk_row] : 0;
  if (!__syncthreads_or(blk_seg != 0)) {
    store_rows<D, D>(ob, o_sl, tile0, ROWS, p.L, nullptr, tid, fwd_threads(D));
    if (tid < ROWS && blk_row < p.L) lse_bh[blk_row] = kNegInf;
    return;
  }
  int k_first, k_last;
  other_axis_range(seg_b, p.L, blk_seg, &k_first, &k_last);
  const int kend = k_last + 1;
  const int ntiles = (kend - k_first + KN - 1) / KN;  // >= 1: the block has a valid row

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(&sm.full[s], 33);                   // the producer's 32 lanes and its tx
      mbar_init(&sm.empty[s], 4 * NC);   // lane 0 of every consumer warp
    }
    mbar_init(&sm.q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid >> 7;
  const int lane = tid & 31;
  if (wg == NC) {
    // the producer: its warpgroup's registers go to the consumers, its first
    // warp loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid - 128 * NC >= 32) return;
    if (lane == 0) mbar_arrive_tx(&sm.q_full, NC * 64 * D * sizeof(bf16));
    __syncwarp();
    for (int c = lane; c < NC * (D / 8); c += 32) {
      const int w = c / (D / 8);
      const int cg = c - w * (D / 8);
      tma_load(&sm.q[w][cg * 64 * 8], &maps.q, &sm.q_full, cg * 8, h, tile0 + 64 * w, b);
    }
    for (int t = 0; t < ntiles; ++t) {
      const int st = t % kFwdStages;
      if (t >= kFwdStages) mbar_wait(&sm.empty[st], ((t / kFwdStages) - 1) & 1);
      const int s0 = k_first + t * KN;
      if (lane == 0) mbar_arrive_tx(&sm.full[st], 2 * KN * D * sizeof(bf16));
      __syncwarp();
      // rows past L arrive as zeros (TMA's out-of-bounds fill); rows in
      // [kend, L) carry segment id 0 here and so pair with no query
      for (int c = lane; c < 2 * (D / 8); c += 32) {
        const bool is_v = c >= D / 8;
        const int cg = is_v ? c - D / 8 : c;
        tma_load((is_v ? sm.v[st] : sm.k[st]) + cg * KN * 8, is_v ? &maps.v : &maps.k,
                 &sm.full[st], cg * 8, h, s0, b);
      }
      int32_t lo = INT32_MAX, hi = 0;
      bool pad = false;
#pragma unroll
      for (int j = lane; j < KN; j += 32) {
        const int32_t s = s0 + j < kend ? seg_b[s0 + j] : 0;
        sm.seg[st][j] = s;
        pad |= s == 0;
        if (s != 0) {
          lo = min(lo, s);
          hi = max(hi, s);
        }
      }
      lo = __reduce_min_sync(0xffffffffu, lo);
      hi = __reduce_max_sync(0xffffffffu, hi);
      pad = __any_sync(0xffffffffu, pad);
      if (lane == 0) {
        sm.lo[st] = lo;
        sm.hi[st] = hi;
        sm.uni[st] = !pad && lo == hi ? lo : 0;
      }
      mbar_arrive(&sm.full[st]);  // each lane's stores are released by its arrival
    }
    return;
  }

  // the consumers: the producer's registers are theirs
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(fwd_consumer_regs(D)));
  fwd_consumer<D, DROP != kNoDrop, DROP == kDropShort>(p, sm, wg, tile0, k_first, ntiles);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (libcuda), reached through the runtime's entry-point
// query so that the library does not link -lcuda; nullptr where it is missing.
EncodeTiled tma_encoder() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(ptr)
               : nullptr;
  }();
  return fn;
}

// Whether TMA can read a [B, L, H, D] bf16 view at `ptr` (strides in
// elements): a 16-byte aligned base and strides (ops/flash_attention.py
// `tma_ok` holds the wrapper to the same rule and more).
bool tma_aligned(const void* ptr, int64_t sb, int64_t sl, int64_t sh) {
  const int64_t bits = static_cast<int64_t>(reinterpret_cast<uintptr_t>(ptr)) |
                       (2 * sb) | (2 * sl) | (2 * sh);
  return bits % 16 == 0;
}

// The view as a 4-d map (D, H, L, B) with boxes of 8 columns x `rows` rows:
// one box lands as one column group of the core-matrix layout.
bool tma_map(CUtensorMap* map, const void* ptr, int64_t sb, int64_t sl, int64_t sh, int B,
             int L, int H, int D, int rows) {
  const EncodeTiled encode = tma_encoder();
  if (encode == nullptr || !tma_aligned(ptr, sb, sl, sh)) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(L), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(2 * sh),
                                 static_cast<cuuint64_t>(2 * sl),
                                 static_cast<cuuint64_t>(2 * sb)};
  const cuuint32_t box[4] = {8, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launch the wgmma design at head dim D: the maps, then the kernel.
template <int D>
int launch_wgmma(const Params& p, cudaStream_t stream) {
  FwdMaps maps;
  if (!tma_map(&maps.q, p.q, p.q_sb, p.q_sl, p.q_sh, p.B, p.L, p.H, D, 64) ||
      !tma_map(&maps.k, p.k, p.k_sb, p.k_sl, p.k_sh, p.B, p.L, p.H, D, fwd_keys(D)) ||
      !tma_map(&maps.v, p.v, p.v_sb, p.v_sl, p.v_sh, p.B, p.L, p.H, D, fwd_keys(D)))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(p.B * p.H, (p.L + fwd_rows(D) - 1) / fwd_rows(D));
  constexpr size_t smem = fwd_smem_bytes<D>();
  switch (fwd_drop(p.dropout, p.keep_thresh)) {
    case kNoDrop:
      launch_dyn(attn_fwd_kernel_wgmma<D, kNoDrop>, grid, fwd_threads(D), smem, stream, p, maps);
      break;
    case kDrop:
      launch_dyn(attn_fwd_kernel_wgmma<D, kDrop>, grid, fwd_threads(D), smem, stream, p, maps);
      break;
    default:
      launch_dyn(attn_fwd_kernel_wgmma<D, kDropShort>, grid, fwd_threads(D), smem, stream, p,
                 maps);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// the wgmma_chunks route (bf16 at head dims 320, 384, 448 and 512; see the
// header note)
// ---------------------------------------------------------------------------

constexpr int kChunksThreads = 256;  // two warpgroups on the block's 64 query rows
constexpr int kChunksKeys = 32;      // keys a tile
constexpr int kChunksStages = 2;     // K/V tiles in the ring
// Dynamic shared bytes of a launch: q of the block's rows resident, the K/V
// ring and the tiles' key segment ids.
template <int D>
__host__ __device__ constexpr size_t chunks_smem() {
  return (kMmaRows * D + kChunksStages * 2 * kChunksKeys * D) * sizeof(bf16) +
         kChunksStages * kChunksKeys * sizeof(int32_t);
}

// Two warpgroups on the block's 64 query rows, warpgroup w holding columns
// [w D / 2, w D / 2 + D / 2) of O (D / 4 accumulator registers a thread).
// Both form the whole S = q k^T of a tile (the same products on the same
// operands: the same bits) and its softmax, and each runs P~ V on its half
// of V's columns; m and l are therefore the same in both.
template <int D, int DROP>
__global__ void __launch_bounds__(kChunksThreads, 1)
    attn_fwd_kernel_wgmma_halves(const Params p, const int vec) {
  constexpr int KN = kChunksKeys;
  constexpr int KD = D / 16;    // k-steps of q k^T
  constexpr int HALF = D / 2;   // columns of O a warpgroup holds
  constexpr int NS = kSplitTerms;
  constexpr bool DROPS = DROP != kNoDrop;
  constexpr bool SHORT = DROP == kDropShort;
  extern __shared__ __align__(128) unsigned char fwd_smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(fwd_smem_raw);  // [D / 8][64][8]
  bf16* ks = qs + kMmaRows * D;                      // kChunksStages x [D / 8][KN][8]
  bf16* vs = ks + kChunksStages * KN * D;
  int32_t* segs = reinterpret_cast<int32_t*>(vs + kChunksStages * KN * D);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wg = warp >> 2;     // the warpgroup: columns [HALF wg, HALF wg + HALF)
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int tile0 = blockIdx.y * kMmaRows;
  const int32_t* seg_b = p.seg + static_cast<int64_t>(b) * p.L;
  const int64_t o_sl = static_cast<int64_t>(p.H) * D;  // O is contiguous
  bf16* ob = static_cast<bf16*>(p.o) + static_cast<int64_t>(b) * p.L * o_sl + h * D;
  float* lse_bh = p.lse + static_cast<int64_t>(bh) * p.L;

  // a query tile with no valid row: zeros and -1e30, nothing else
  const int blk_row = tile0 + tid;
  const int32_t blk_seg = (tid < kMmaRows && blk_row < p.L) ? seg_b[blk_row] : 0;
  if (!__syncthreads_or(blk_seg != 0)) {
    store_rows<D, D>(ob, o_sl, tile0, kMmaRows, p.L, nullptr, tid, kChunksThreads);
    if (tid < kMmaRows && blk_row < p.L) lse_bh[blk_row] = kNegInf;
    return;
  }
  // the block's segment-id range and the id all its rows share (else 0),
  // the same in every warp; the block's key range
  int32_t blo, bhi, buni;
  {
    int32_t lo = INT32_MAX, hi = 0;
    bool pad = false;
#pragma unroll
    for (int j = lane; j < kMmaRows; j += 32) {
      const int32_t s = tile0 + j < p.L ? seg_b[tile0 + j] : 0;
      pad |= s == 0;
      if (s != 0) {
        lo = min(lo, s);
        hi = max(hi, s);
      }
    }
    blo = __reduce_min_sync(0xffffffffu, lo);
    bhi = __reduce_max_sync(0xffffffffu, hi);
    buni = !__any_sync(0xffffffffu, pad) && blo == bhi ? blo : 0;
  }
  int k_first, k_last;
  other_axis_range(seg_b, p.L, blk_seg, &k_first, &k_last);
  const int kend = k_last + 1;
  const int ntiles = (kend - k_first + KN - 1) / KN;  // >= 1: the block has a valid row

  int rows[2];
  int32_t sq[2];     // this thread's rows' segment ids; -1 on a pad row (pairs with no key)
  uint32_t hrow[2];  // the dropout hash's (batch*head, row) terms
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rows[i] = tile0 + 16 * (warp & 3) + g + 8 * i;
    const int32_t s = rows[i] < p.L ? seg_b[rows[i]] : 0;
    sq[i] = s != 0 ? s : -1;
    hrow[i] = ((static_cast<uint32_t>(bh) + p.bh_offset) * kHashBh) ^
              (static_cast<uint32_t>(rows[i]) * kHashRow);
  }
  asm volatile("" : "+r"(hrow[0]), "+r"(hrow[1]));

  const bf16* qp = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  auto stage = [&](int t) {
    const int buf = t % kChunksStages;
    const int s0 = k_first + t * KN;
    stage_tile<D, KN, kChunksThreads>(ks + buf * KN * D, kp, p.k_sl, s0, kend, vec);
    stage_tile<D, KN, kChunksThreads>(vs + buf * KN * D, vp, p.v_sl, s0, kend, vec);
    if (tid < KN)
      cp_async<4>(&segs[buf * KN + tid], seg_b + (s0 + tid < kend ? s0 + tid : 0),
                  s0 + tid < kend);
  };
  stage_tile<D, kMmaRows, kChunksThreads>(qs, qp, p.q_sl, tile0, p.L, vec);
  stage(0);
  cp_async_commit();

  float acc[HALF / 2];  // this warpgroup's half of the unnormalised O (wgmma layout)
#pragma unroll
  for (int e = 0; e < HALF / 2; ++e) acc[e] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running max of the log2-scaled logits
  float l[2] = {0.f, 0.f};          // this thread's part of the undropped sum
  float alpha[2];
  const int half0 = wg * (HALF / 8) * KN * 8;  // this warpgroup's columns of a V tile

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) stage(t + 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    const int buf = t % kChunksStages;
    const int32_t* seg_t = segs + buf * KN;
    const int32_t sk_t = tid < KN ? seg_t[tid] : 0;  // the id this thread staged
    // keys of the tile whose ids lie in the block's range; all of them in
    // the id every row of the block has: nothing is masked (FULL)
    const int hits = __syncthreads_count(sk_t != 0 && sk_t >= blo && sk_t <= bhi);
    if (hits == 0) continue;  // no allowed pair for the block among these keys
    const bf16* kt = ks + buf * KN * D;
    const bf16* vt = vs + buf * KN * D;
    const uint32_t col0 = static_cast<uint32_t>(k_first + t * KN);

    float sc[KN / 2];  // S, then P~
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      Wgmma<KN>::ss(sc, desc_kmajor<kMmaRows>(qs, kk), desc_kmajor<KN>(kt, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    if (buni != 0 && hits == KN)
      fwd_softmax<KN, DROPS, SHORT, true>(sc, m, l, alpha, seg_t, sq, hrow, col0, p);
    else
      fwd_softmax<KN, DROPS, SHORT, false>(sc, m, l, alpha, seg_t, sq, hrow, col0, p);
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int e = 0; e < HALF / 2; ++e) acc[e] *= alpha[(e >> 1) & 1];
    }
    SplitA<NS> pa[KN / 16];
#pragma unroll
    for (int kk = 0; kk < KN / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split_bf16x2(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1], pa[kk], r);
    wgmma_fence();
    fence_regs(acc);
#pragma unroll
    for (int term = 0; term < NS; ++term)
#pragma unroll
      for (int kk = 0; kk < KN / 16; ++kk)
        Wgmma<HALF>::rs_t(acc, pa[kk].t[term], desc_mnmajor<KN>(vt + half0, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();  // buf is restaged at t + kChunksStages
  }
  cp_async_wait<0>();

  // l across the quad, in a fixed order; O = acc / l staged in the q tile
  // (free: every product is done; 16-byte chunk c of row r at chunk
  // c ^ (r & 7)), then 16-byte stores; LSE in f32 from warpgroup 0
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  bf16* os = qs;
  __syncthreads();
  fence_proxy_async();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool live = sq[i] > 0 && l[i] > 0.f;  // pad rows: exact zeros
    const float inv = live ? p.keep_scale / l[i] : 0.f;
    const int r = 16 * (warp & 3) + g + 8 * i;
#pragma unroll
    for (int n = 0; n < HALF / 8; ++n) {
      const int col = wg * HALF + 8 * n + 2 * tg;
      *reinterpret_cast<__nv_bfloat162*>(os + r * D + (((col >> 3) ^ (r & 7)) << 3) +
                                         (col & 7)) =
          __floats2bfloat162_rn(acc[4 * n + 2 * i] * inv, acc[4 * n + 2 * i + 1] * inv);
    }
    if (wg == 0 && tg == 0 && rows[i] < p.L)
      lse_bh[rows[i]] = live ? (m[i] + log2f(l[i])) * kLn2 : kNegInf;
  }
  __syncthreads();
  for (int c = tid; c < kMmaRows * (D / 8); c += kChunksThreads) {
    const int r = c / (D / 8);
    const int cc = c - r * (D / 8);
    if (tile0 + r < p.L)
      *reinterpret_cast<uint4*>(ob + static_cast<int64_t>(tile0 + r) * o_sl + cc * 8) =
          *reinterpret_cast<const uint4*>(os + r * D + ((cc ^ (r & 7)) << 3));
  }
}

// Launch the wgmma_chunks design at head dim D (q, k, v staged by cp.async
// where their pointers and strides fit 16-byte pieces, else by plain loads:
// any view).
template <int D>
int launch_chunks(const Params& p, cudaStream_t stream) {
  const int vec = rows_vectorizable(p.q, p.q_sb, p.q_sl, p.q_sh, D) &&
                  rows_vectorizable(p.k, p.k_sb, p.k_sl, p.k_sh, D) &&
                  rows_vectorizable(p.v, p.v_sb, p.v_sl, p.v_sh, D);
  const dim3 grid(p.B * p.H, (p.L + kMmaRows - 1) / kMmaRows);
  constexpr size_t smem = chunks_smem<D>();
  switch (fwd_drop(p.dropout, p.keep_thresh)) {
    case kNoDrop:
      launch_dyn(attn_fwd_kernel_wgmma_halves<D, kNoDrop>, grid, kChunksThreads, smem, stream,
                 p, vec);
      break;
    case kDrop:
      launch_dyn(attn_fwd_kernel_wgmma_halves<D, kDrop>, grid, kChunksThreads, smem, stream, p,
                 vec);
      break;
    default:
      launch_dyn(attn_fwd_kernel_wgmma_halves<D, kDropShort>, grid, kChunksThreads, smem,
                 stream, p, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

// The f32 route (see the header note): one query row per thread.
template <int D>
__global__ void __launch_bounds__(kF32Rows, f32_min_blocks(D))
    attn_fwd_kernel_f32(const Params p) {
  constexpr int T = f32_tile(D);  // keys per shared-memory tile
  __shared__ __align__(16) float ks[T][D];
  __shared__ __align__(16) float vs[T][D];
  __shared__ int32_t segs[T];

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int row = blockIdx.y * kF32Rows + threadIdx.x;
  const bool in_range = row < p.L;
  const int32_t* seg_b = p.seg + static_cast<int64_t>(b) * p.L;
  const int32_t sq = in_range ? seg_b[row] : 0;

  float qr[D];
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = 0.f;
    acc[d] = 0.f;
  }
  if (sq != 0) {
    const float* qp = static_cast<const float*>(p.q) + b * p.q_sb +
                      row * p.q_sl + h * p.q_sh;
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = qp[d] * p.scale_log2;
  }
  float m = kNegInf;  // running max of the log2-scaled logits
  float l = 0.f;      // running sum of undropped probabilities

  // keys outside [k_first, k_last] can be attended by no row of the block
  int k_first, k_last;
  other_axis_range(seg_b, p.L, sq, &k_first, &k_last);
  const int kend = k_last + 1;

  const float* kp = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vp = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  for (int s0 = k_first; s0 < kend; s0 += T) {
    for (int j = threadIdx.x; j < T; j += kF32Rows)
      segs[j] = (s0 + j < kend) ? seg_b[s0 + j] : 0;
    __syncthreads();
    bool mine = false;
    if (sq != 0) {
#pragma unroll
      for (int j = 0; j < T; ++j) mine |= (segs[j] == sq);
    }
    if (__syncthreads_or(mine)) {
      for (int e = threadIdx.x; e < T * D; e += kF32Rows) {
        const int j = e / D;
        const int d = e - j * D;
        const bool ok = s0 + j < kend;
        const int64_t r = s0 + j;
        ks[j][d] = ok ? kp[r * p.k_sl + d] : 0.f;
        vs[j][d] = ok ? vp[r * p.v_sl + d] : 0.f;
      }
      __syncthreads();
      if (mine) {
        // online softmax over chunks of kChunk keys: only kChunk logits
        // live in registers at a time
#pragma unroll 1
        for (int c = 0; c < T; c += kChunk) {
          float s[kChunk];
          float m_new = m;
          bool any = false;
#pragma unroll
          for (int j = 0; j < kChunk; ++j) {
            float dot = 0.f;
#pragma unroll
            for (int d = 0; d < D; ++d) dot = fmaf(qr[d], ks[c + j][d], dot);
            const bool allow = segs[c + j] == sq;
            any |= allow;
            s[j] = allow ? dot : kNegInf;
            m_new = fmaxf(m_new, s[j]);
          }
          if (!any) continue;  // no key of the chunk is allowed for this row
          if (m_new > m) {
            const float alpha = exp2f(m - m_new);
            l *= alpha;
#pragma unroll
            for (int d = 0; d < D; ++d) acc[d] *= alpha;
            m = m_new;
          }
#pragma unroll
          for (int j = 0; j < kChunk; ++j) {
            float pj = (segs[c + j] == sq) ? exp2f(s[j] - m) : 0.f;
            l += pj;
            if (p.dropout) {
              const uint32_t hv = hash_u32(p.seed, static_cast<uint32_t>(bh) + p.bh_offset,
                                           static_cast<uint32_t>(row),
                                           static_cast<uint32_t>(s0 + c + j));
              pj = hv >= p.keep_thresh ? pj * p.keep_scale : 0.f;
            }
#pragma unroll
            for (int d = 0; d < D; ++d) acc[d] = fmaf(pj, vs[c + j][d], acc[d]);
          }
        }
      }
    }
    __syncthreads();  // tiles are overwritten by the next iteration
  }

  if (!in_range) return;
  const float safe_l = l > 0.f ? l : 1.f;
  float* op = static_cast<float*>(p.o) +
              ((static_cast<int64_t>(b) * p.L + row) * p.H + h) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) op[d] = acc[d] / safe_l;
  p.lse[static_cast<int64_t>(bh) * p.L + row] =
      l > 0.f ? (m + log2f(l)) * kLn2 : kNegInf;
}

// The wide route (see the header note): 32 query rows a block (a row a
// lane), one chunk of 128 columns of O (grid z), 32 columns a warp.
template <typename T>
__global__ void __launch_bounds__(128) attn_fwd_kernel_wide(const Params p, const int D) {
  __shared__ __align__(16) float tile[kWideTile][kWideChunk];  // K chunks, then V chunk z
  __shared__ float red_s[kWideSplit][kWideTile][kWideRows];
  __shared__ int32_t segs[kWideTile];

  const int nc = gridDim.z;
  const int z = blockIdx.z;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int row = blockIdx.y * kWideRows + (threadIdx.x & 31);
  const bool in_range = row < p.L;
  const int32_t* seg_b = p.seg + static_cast<int64_t>(b) * p.L;
  const int32_t sq = in_range ? seg_b[row] : 0;
  const int32_t sq_match = sq != 0 ? sq : -1;  // a pad row attends nothing
  const T* qrow = sq != 0 ? static_cast<const T*>(p.q) + b * p.q_sb + row * p.q_sl + h * p.q_sh
                          : nullptr;

  float qr[kWideCols], acc[kWideCols];
#pragma unroll
  for (int i = 0; i < kWideCols; ++i) acc[i] = 0.f;
  if (nc == 1) load_wide(qr, qrow, 0, D);
  float m = kNegInf;  // running max of the log2-scaled logits
  float l = 0.f;      // running sum of undropped probabilities

  int k_first, k_last;
  other_axis_range(seg_b, p.L, threadIdx.x < kWideRows ? sq : 0, &k_first, &k_last);
  const int kend = k_last + 1;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  for (int s0 = k_first; s0 < kend; s0 += kWideTile) {
    const int i = threadIdx.x;
    if (i < kWideTile) segs[i] = s0 + i < kend ? seg_b[s0 + i] : 0;
    __syncthreads();
    bool mine = false;
#pragma unroll
    for (int j = 0; j < kWideTile; ++j) mine |= segs[j] == sq_match;
    if (!__syncthreads_or(mine)) continue;  // no allowed pair in the block
    float sc[kWideTile];
#pragma unroll
    for (int j = 0; j < kWideTile; ++j) sc[j] = 0.f;
    for (int chunk = 0; chunk < nc; ++chunk) {
      if (chunk > 0) __syncthreads();  // the previous chunk is read
      stage_wide(tile, kp, p.k_sl, s0, kend, chunk, D);
      if (nc > 1) load_wide(qr, qrow, chunk, D);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kWideTile; ++j) sc[j] += wide_dot(qr, tile[j]);
    }
    wide_reduce(sc, red_s);  // syncs: K is read, the tile takes V
    stage_wide(tile, vp, p.v_sl, s0, kend, z, D);
    // log2-scaled logits on allowed pairs, -1e30 elsewhere; the tile's max
    float m_new = m;
#pragma unroll
    for (int j = 0; j < kWideTile; ++j) {
      sc[j] = segs[j] == sq_match ? sc[j] * p.scale_log2 : kNegInf;
      m_new = fmaxf(m_new, sc[j]);
    }
    __syncthreads();
    if (m_new > m) {
      const float alpha = exp2f(m - m_new);
      l *= alpha;
#pragma unroll
      for (int i = 0; i < kWideCols; ++i) acc[i] *= alpha;
      m = m_new;
    }
#pragma unroll
    for (int j = 0; j < kWideTile; ++j) {
      if (segs[j] != sq_match) continue;
      float pj = exp2f(sc[j] - m);
      l += pj;
      if (p.dropout) {
        const uint32_t hv = hash_u32(p.seed, static_cast<uint32_t>(bh) + p.bh_offset,
                                     static_cast<uint32_t>(row),
                                     static_cast<uint32_t>(s0 + j));
        pj = hv >= p.keep_thresh ? pj * p.keep_scale : 0.f;
      }
      wide_axpy(acc, pj, tile[j]);
    }
    __syncthreads();  // the tile is restaged by the next iteration
  }

  if (!in_range) return;
  const float inv = l > 0.f ? 1.f / l : 0.f;  // pad rows: exact zeros
  store_wide(static_cast<T*>(p.o) + ((static_cast<int64_t>(b) * p.L + row) * p.H + h) * D,
             acc, z, D, inv);
  if (z == 0 && threadIdx.x < kWideRows)
    p.lse[static_cast<int64_t>(bh) * p.L + row] = l > 0.f ? (m + log2f(l)) * kLn2 : kNegInf;
}

// The instance of `design` at (head dim D, dropout: 0 none, else the hash;
// 2 the wgmma design's short-hash instance), nullptr where this source has
// none; the wide route is `wide_kernel`.
template <int D>
const void* kernel_of(int design, int dropout) {
  if constexpr (D > kWgmmaWide) {
    if (design == kDesignWgmmaChunks)
      return dropout == kDropShort
                 ? reinterpret_cast<const void*>(attn_fwd_kernel_wgmma_halves<D, kDropShort>)
             : dropout ? reinterpret_cast<const void*>(attn_fwd_kernel_wgmma_halves<D, kDrop>)
                       : reinterpret_cast<const void*>(attn_fwd_kernel_wgmma_halves<D, kNoDrop>);
    return nullptr;
  } else if constexpr (D >= 64) {
    if (design == kDesignWgmma)
      return dropout == kDropShort ? reinterpret_cast<const void*>(attn_fwd_kernel_wgmma<D, kDropShort>)
             : dropout ? reinterpret_cast<const void*>(attn_fwd_kernel_wgmma<D, kDrop>)
                       : reinterpret_cast<const void*>(attn_fwd_kernel_wgmma<D, kNoDrop>);
  }
  if constexpr (D <= 128) {
    if (design == kDesignMma)
      return dropout ? reinterpret_cast<const void*>(attn_fwd_kernel_mma<D, true>)
                     : reinterpret_cast<const void*>(attn_fwd_kernel_mma<D, false>);
    if constexpr (D < 128)
      if (design == kDesignF32) return reinterpret_cast<const void*>(attn_fwd_kernel_f32<D>);
  }
  return nullptr;
}
// the dynamic shared bytes a launch of `design` at head dim D asks for
template <int D>
size_t dyn_smem_of(int design) {
  if constexpr (D > kWgmmaWide) {
    if (design == kDesignWgmmaChunks) return chunks_smem<D>();
  } else if constexpr (D >= 64) {
    if (design == kDesignWgmma) return fwd_smem_bytes<D>();
  }
  if constexpr (D <= 128)
    if (design == kDesignMma) return mma_dyn_smem<mma_ld(D)>();
  return 0;
}
const void* wide_kernel(int is_bf16) {
  return is_bf16 ? reinterpret_cast<const void*>(attn_fwd_kernel_wide<bf16>)
                 : reinterpret_cast<const void*>(attn_fwd_kernel_wide<float>);
}

template <int D>
int launch(const Params& p, int design, cudaStream_t stream) {
  if (kernel_of<D>(design, p.dropout) == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (D > kWgmmaWide) {
    return launch_chunks<D>(p, stream);
  } else if constexpr (D >= 64) {
    if (design == kDesignWgmma) return launch_wgmma<D>(p, stream);
  }
  if constexpr (D <= 128) {
    if (design == kDesignMma) {
      const int vec = rows_vectorizable(p.k, p.k_sb, p.k_sl, p.k_sh, D) &&
                      rows_vectorizable(p.v, p.v_sb, p.v_sl, p.v_sh, D);
      const dim3 grid(p.B * p.H, (p.L + kMmaRows - 1) / kMmaRows);
      constexpr size_t smem = mma_dyn_smem<mma_ld(D)>();
      if (p.dropout)
        launch_dyn(attn_fwd_kernel_mma<D, true>, grid, kMmaThreads, smem, stream, p, vec);
      else
        launch_dyn(attn_fwd_kernel_mma<D, false>, grid, kMmaThreads, smem, stream, p, vec);
    } else if constexpr (D < 128) {
      const dim3 grid(p.B * p.H, (p.L + kF32Rows - 1) / kF32Rows);
      attn_fwd_kernel_f32<D><<<grid, kF32Rows, 0, stream>>>(p);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

int dispatch_d(int head_dim, int is_bf16, int design, const Params& p, cudaStream_t stream) {
  if (!design_takes(design, is_bf16)) return static_cast<int>(cudaErrorInvalidValue);
  if (design == kDesignWide) {
    const dim3 grid(p.B * p.H, (p.L + kWideRows - 1) / kWideRows, wide_chunks(head_dim));
    if (is_bf16)
      attn_fwd_kernel_wide<bf16><<<grid, 128, 0, stream>>>(p, head_dim);
    else
      attn_fwd_kernel_wide<float><<<grid, 128, 0, stream>>>(p, head_dim);
    return static_cast<int>(cudaGetLastError());
  }
  return with_chunks_head_dim(head_dim, design, [&](auto d) {
    return launch<decltype(d)::value>(p, design, stream);
  });
}

}  // namespace

// Plain C entry point (bound with ctypes). Returns cudaGetLastError() after
// the launch; the launch is asynchronous on `stream`.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              const void* seg, void* o, void* lse,
                              int64_t q_sb, int64_t q_sl, int64_t q_sh,
                              int64_t k_sb, int64_t k_sl, int64_t k_sh,
                              int64_t v_sb, int64_t v_sl, int64_t v_sh,
                              int B, int L, int H, int head_dim, int is_bf16,
                              int design, float scale, int dropout, uint32_t seed,
                              uint32_t keep_thresh, float keep_scale,
                              uint32_t bh_offset, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.seg = static_cast<const int32_t*>(seg);
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.q_sb = q_sb; p.q_sl = q_sl; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_sl = k_sl; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_sl = v_sl; p.v_sh = v_sh;
  p.B = B;
  p.L = L;
  p.H = H;
  p.scale_log2 = scale * kLog2e;
  p.dropout = dropout;
  p.seed = seed;
  p.keep_thresh = keep_thresh;
  p.keep_scale = keep_scale;
  p.bh_offset = bh_offset;
  return dispatch_d(head_dim, is_bf16, design, p, static_cast<cudaStream_t>(stream));
}

// The resources of the instance of `design` a launch at (head_dim,
// is_bf16, dropout; 2: the wgmma design's short-hash instance, `FwdDrop`)
// runs: out[4] = static shared bytes, dynamic shared
// bytes, registers a thread, local (spilled) bytes a thread. Returns a
// cudaError_t.
extern "C" int flash_attn_fwd_attrs(int head_dim, int is_bf16, int design, int dropout,
                                    int* out) {
  if (!design_takes(design, is_bf16)) return static_cast<int>(cudaErrorInvalidValue);
  if (design == kDesignWide) return func_attrs(wide_kernel(is_bf16), 0, out);
  return with_chunks_head_dim(head_dim, design, [&](auto d) {
    constexpr int D = decltype(d)::value;
    const void* fn = kernel_of<D>(design, dropout);
    if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return func_attrs(fn, static_cast<int>(dyn_smem_of<D>(design)), out);
  });
}

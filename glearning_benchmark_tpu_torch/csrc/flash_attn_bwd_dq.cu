// Flash-attention backward, dQ, for Hopper (sm_90a): non-causal,
// segment-masked, with the forward's attention-probability dropout
// regenerated from the counter hash.
//
// Replaces the TPU kernel `_bwd_dq_kernel` of
// glearning_benchmark_tpu/ops/pallas_attention.py (launched by `_flash_bwd`).
// Same function:
//   P  = exp(scale q.k - LSE) on allowed pairs, 0 elsewhere
//   dP = dO.v, times keep/(1-p) under dropout
//   dS = P (dP - delta),   dQ = scale * sum_keys dS k
// with delta = rowsum(dO * O) over the stored (dropped, rounded) O. The
// reference sums delta in plain jnp outside its kernels; here it is this
// kernel's prologue, written to delta [B, H, L] f32 for the dK/dV kernel,
// which therefore runs after this one on the same stream. Pad queries
// (seg 0) get dQ = 0 exactly. The keep decision is
// hash_u32(seed, bh_offset + bh, query row, key col) >= keep_thresh, as in
// the forward.
//
// What bounds it on an H100. Per allowed pair 6*D FLOPs (q.k, dO.v, dS k),
// one exp2 and, under dropout, one hash. At the packed AGTT-ZINC training
// rows ([49, 256, 4, 16]) the least time is set by bytes (~3 us) and what
// the kernel reaches by the per-pair elementwise work and the launch; at
// head dim 128 on the mfu_bench rows ([64, 1024, 8, 128], 2-5 segments a
// row) by bytes (0.19 ms) with the tensor-core FLOPs close behind, so there
// the products have to run at the tensor cores' rate (PERF.md).
//
// Five designs, by head dim and input type (ops/flash_attention.py
// `design` names a launch's; `launch` runs it, or refuses a design this
// source has no instance of):
//
// bf16 at head dims 4-32: warp-level mma.sync. One block of 4 warps owns 64
// query rows of one batch*head, 16 a warp (the M of m16n8k16, bf16 in, f32
// accumulate), q and dO as A fragments in registers (head dims 4 and 8
// zero-padded to the mma depth 16 in registers and shared memory only). The
// block loops over key tiles of 64 inside its segment range
// (`other_axis_range`), K and V staged by cp.async, double-buffered, rows
// padded by 8 bf16 for conflict-free ldmatrix. Per 16 keys a warp skips
// them unless one lies in its segment-id range; S = q k^T and dP = dO v^T by
// mma; P = exp2(S scale log2e - LSE log2e), the mask, the dropout hash and
// dS = P (dP - delta) in the accumulator registers; dQ += dS K with dS
// straight from registers as the A operand (the accumulators of two
// n-tiles are the A fragment of one k-step) and K through ldmatrix.trans;
// dS goes in as three bf16 terms hi + mid + lo (`kSplitTerms`, exact for
// the f32 value). At these head dims every product is one 16-deep k-step, the tensor cores
// idle most of the time, and the elementwise work between the products
// bounds the kernel: warp-level mma lets each warp skip what its 16 rows
// may not attend.
//
// bf16 at head dims 64, 128 and 256 (129-255 zero-padded to 256 by the
// wrapper): warpgroup wgmma (sm_90a). There the products dominate, and
// mma.sync (a warp's 16 x 8 tiles, full-width accumulators in a warp, 208
// registers, a few warps an SM) ran at 8x the bound at 128, and the wide
// route at 228x at 256. A block is one warpgroup (two at 256, `dq_groups`)
// owning 64 query rows each; q and dO of those rows sit in shared memory
// for the block's life, and K, V and the key segment ids stream through a
// two-stage cp.async ring shared by the block's warpgroups (16-byte
// pieces, each tile in wgmma's core-matrix layout, `stage_tile`; plain
// loads where a pointer or stride does not fit). Per key tile of 64 that
// holds an allowed pair for the warpgroup (the tile is skipped otherwise;
// 32 keys at head dims 64 and 256, `dq_keys`):
//   - S = q k^T and dP = dO v^T: wgmma m64n64k16, both operands from shared
//     memory (K-major), D / 16 k-steps each, committed as one group;
//   - P, the mask, the dropout keep (hash_u32 at (bh_offset + b h, query,
//     key)) and dS = P (dP - delta) in the 64 accumulator registers;
//   - dQ += dS K: wgmma m64nDk16 with dS as the A operand from registers
//     (the accumulator layout is mma.sync's, so two n-tiles are one k-step's
//     A fragment) and K read MN-major from the same shared tile.
// dS is not bf16: rounding it would cost 2^-9 relative where gradients
// cancel, beyond the elementwise 4e-3 the kernel is held to, so it goes in
// as three bf16 terms hi + mid + lo (`kSplitTerms`), three
// products; the tensor cores have the room. The dQ accumulator (D / 2
// registers a thread) is the block's only full-width state, so at 64 and
// 128 two blocks fit an SM and one block's loads and elementwise work run
// under the other's products. At 256 the accumulator takes 128 registers
// (two m64n128 products a k-step, `OW`), S and dP 16 each at 32 keys, and
// the block 202 registers a thread (221 with dropout), 0 B spilled; q and
// dO of the block's 128 rows take 128 KB and a K/V stage 32 KB, so one
// block holds an SM (196,864 B), and its two warpgroups share each K/V
// tile: eight warps an SM. No producer warp and no TMA: the ring is filled by the same
// threads one tile ahead, and strided views (dO, q of the fused qkv) are
// read as they are. Chosen by measurement at 256 (PERF.md §6, dense
// [16, 1024, 8, 256], each pair of times from one call): the ring's
// copies cost 15% there (a probe that stopped them ran 0.820 ms against
// 0.964), but a TMA ring (three stages, warp 0 issuing the forward's boxes
// of 8 columns into an mbarrier a stage) ran 1.262 ms against 0.968, and
// pipelining it (the next tile's S and dP under this tile's dQ products)
// 1.464; launching a batch*head's tiles together for L2 ran 1.006 against
// 0.966.
//
// bf16 at head dims 257-512 (the wgmma_chunks design; the wrapper
// zero-pads to its instances at 320, 384, 448 and 512, the next multiple of
// 64): warpgroup wgmma over column halves (`attn_bwd_dq_kernel_wgmma_halves`).
// The wide route ran at 374x the bound at 320, and the design at 256 does
// not stretch: the dQ accumulator of a whole row (D / 2 registers a thread,
// 160 at 320) beside S and dP would pass 255 registers, and q and dO of
// its 128 rows (160 KB at 320) beside a K/V ring pass the 227 KB a block
// may hold. A block is two warpgroups on 64 query rows, each holding one
// column half of dQ (D / 4 accumulator registers a thread). q and dO of
// the rows sit in shared memory; K, V and the key segment ids stream
// through a two-stage cp.async ring of 32-key tiles (16 at 448 and 512,
// where 32-key stages would pass 227 KB). Per tile that holds an allowed
// pair for the block:
//   - warpgroup 0 forms S = q k^T and P (the mask, the exp), warpgroup 1
//     dP = dO v^T and the keep (the hash), each over the whole head dim
//     (D / 16 k-steps of m64n32k16, m64n16k16 at 16 keys), and each hands
//     the other its values through shared memory (P and dP keep/(1-p):
//     KN / 2 a thread; the accumulator layouts of the two warpgroups agree);
//   - both form dS = P (dP keep/(1-p) - delta) from the same values in the
//     same order, as three bf16 terms, and run dQ += dS K on their half of
//     the columns (m64n(D/2)k16, K read MN-major from the column half of
//     the shared tile).
// delta is summed over the whole head dim by both warpgroups (a quarter of
// D a lane, the halves through shared memory) and written once. Registers
// a thread with dropout (without) and dynamic shared memory at 320 / 384 /
// 448 / 512 (PERF.md §6, chip_smoke.py phase 11): 176 (166) / 198 (190) /
// 194 / 194, 180,480 / 213,248 / 180,352 / 204,928 B, 0 B spilled: one
// block, eight warps an SM. Chosen by measurement (packed
// [16, 1024, 8, 320] and [8, 1024, 8, 384], p 26/256, each pair of times
// from one call): column chunks on grid z instead (a block one warpgroup
// holding half of dQ's columns, S and dP formed again in the blocks of
// both chunks, four warps an SM) ran 1.4813 ms against 0.9468 at 320 and
// 0.7932 against 0.6301 at 384; 16-key tiles ran 0.9291 against 0.7803
// at 320 and 0.4117 against 0.4220 at 384 (2% faster there; the 32-key
// tiles stay wherever they fit). Above 512 the wide route remains: q and
// dO of 64 rows alone take 128 KB at 512, and a 16-key ring beside them
// leaves no room for a wider head dim.
//
// f32 at head dims 4-64: the FP32 pipe, a query row a thread. A block of
// 128 threads owns 128 query rows with q, dO and the dQ accumulator of its
// row in f32 registers and loops over key tiles of 64 staged in shared
// memory as f32 (every thread reads the same key: broadcasts) inside its
// segment range. At 64 it takes 255 registers and spills 112 bytes a
// thread; chip_smoke.py phase 11 times it against the wide route on the
// same inputs, which is why both stay (PERF.md §6).
//
// f32 at head dim 128 and above, bf16 above 512: the wide FP32-pipe route
// (`attn_bwd_dq_kernel_wide`, flash_attn_common.cuh
// `kWideRows`). A block owns 32 query rows and one chunk of 128 dQ columns
// (grid z = ceil(D / 128)); a row is held by 4 threads, lane i of each
// warp, warp w holding columns [32 w, 32 w + 32), so that no thread keeps a
// full-width row (the f32 design kept q, dO and dQ of one row a thread and
// spilled 1,144 bytes at 128). Key tiles of 16 are staged in shared memory
// as f32, one column chunk at a time; S and dP are summed over every chunk
// (the four warps' parts through shared memory in a fixed order,
// `wide_reduce`) before the chunk of dQ is updated. Above 128 this
// recomputes S and dP once per column chunk (ceil(D / 128) times), the
// price of holding any head dim in fixed registers; the head dim is a run-
// time argument, so any head dim runs unpadded. Tensor cores take no f32
// input and TF32 would not hold f32 accuracy.
//
// All routes: dQ is accumulated unscaled and multiplied by `scale` once
// before the cast; delta is summed in the prologue over dO and O.

#include "flash_attn_common.cuh"

namespace {

using namespace flash;
using bf16 = __nv_bfloat16;

// DROP: p_drop > 0 (a template argument, so that the pair loop has no branch)
template <int D, bool DROP>
__global__ void __launch_bounds__(kMmaThreads)
    attn_bwd_dq_kernel_mma(const BwdParams p, const int vec) {
  constexpr int DP = D < 16 ? 16 : D;  // mma depth: D padded to 16
  constexpr int KD = DP / 16;          // k-steps of q.k and dO.v
  constexpr int NT = (D + 7) / 8;      // n-tiles of 8 head columns of dQ
  constexpr int LD = mma_ld(D);        // shared row stride: no bank conflicts
  auto& ks = mma_tiles<LD>().a;        // [2][kMmaTile][LD]
  auto& vs = mma_tiles<LD>().b;
  __shared__ int32_t segs[2][kMmaTile];
  __shared__ float delta_s[kMmaRows];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int row0 = blockIdx.y * kMmaRows + warp * 16;  // the warp's first row
  const int32_t* seg_b = p.seg + static_cast<int64_t>(b) * p.L;
  const bf16* qp = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* gp = static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;

  // delta = rowsum(dO * O): two lanes a row (lanes l and l+16, half of D each)
  {
    const int r = row0 + (lane & 15);
    float acc = 0.f;
    if (r < p.L) {
      const bf16* gr = gp + static_cast<int64_t>(r) * p.do_sl;
      const bf16* orow = static_cast<const bf16*>(p.o) +
                         ((static_cast<int64_t>(b) * p.L + r) * p.H + h) * D;
      const int d0 = (lane >> 4) * (D / 2);
#pragma unroll
      for (int d = d0; d < d0 + D / 2; ++d)
        acc = fmaf(to_f32(gr[d]), to_f32(orow[d]), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 16);
    if (lane < 16) {
      delta_s[warp * 16 + lane] = acc;
      if (r < p.L) p.delta[static_cast<int64_t>(bh) * p.L + r] = acc;
    }
  }

  // the warp's segment-id range, the block's key range
  const int32_t my_seg =
      (lane < 16 && row0 + lane < p.L) ? seg_b[row0 + lane] : 0;
  int32_t wlo, whi;
  warp_seg_range(my_seg, &wlo, &whi);
  const int blk_row = blockIdx.y * kMmaRows + tid;
  int k_first, k_last;
  other_axis_range(seg_b, p.L,
                   (tid < kMmaRows && blk_row < p.L) ? seg_b[blk_row] : 0,
                   &k_first, &k_last);
  const int kend = k_last + 1;
  const int ntiles = (kend - k_first + kMmaTile - 1) / kMmaTile;  // <= 0: none

  // this thread's two rows (g and g+8 of the warp's 16) and their q, dO
  int rows[2];
  int32_t sq[2];
  float lse2[2], dlt[2];
  const bf16* qr[2];
  const bf16* gr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rows[i] = row0 + g + 8 * i;
    const bool in = rows[i] < p.L;
    sq[i] = in ? seg_b[rows[i]] : 0;
    lse2[i] = sq[i] != 0
                  ? p.lse[static_cast<int64_t>(bh) * p.L + rows[i]] * kLog2e
                  : 0.f;
    dlt[i] = delta_s[warp * 16 + g + 8 * i];  // this warp's lanes wrote it
    qr[i] = sq[i] != 0 ? qp + static_cast<int64_t>(rows[i]) * p.q_sl : nullptr;
    gr[i] = in ? gp + static_cast<int64_t>(rows[i]) * p.do_sl : nullptr;
  }
  uint32_t qa[KD][4], da[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    load_a_frag<D>(qa[kk], qr[0], qr[1], kk * 16);
    load_a_frag<D>(da[kk], gr[0], gr[1], kk * 16);
  }
  uint32_t hrow[2];  // the dropout hash's (batch*head, row) terms
#pragma unroll
  for (int i = 0; i < 2; ++i)
    hrow[i] = ((static_cast<uint32_t>(bh) + p.bh_offset) * kHashBh) ^
              (static_cast<uint32_t>(rows[i]) * kHashRow);
  // opaque to the compiler: kept in registers, not recomputed per pair
  asm volatile("" : "+r"(hrow[0]), "+r"(hrow[1]));
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

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
      float s[2][4], dp[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t kb[4], vb[4];
        const int r = c + (lane & 7) + ((lane >> 4) << 3);
        const int col = kk * 16 + ((lane >> 3) & 1) * 8;
        ldsm_x4(kb, &ks[buf][r][col]);
        ldsm_x4(vb, &vs[buf][r][col]);
        mma_bf16(s[0], qa[kk], kb[0], kb[1]);
        mma_bf16(s[1], qa[kk], kb[2], kb[3]);
        mma_bf16(dp[0], da[kk], vb[0], vb[1]);
        mma_bf16(dp[1], da[kk], vb[2], vb[3]);
      }
      float ds[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = c + n * 8 + 2 * tg + (e & 1);
          const int i = e >> 1;
          // a pad row (sq 0) may match pad keys here: it is zeroed at the end
          const bool allow = segs[buf][j] == sq[i];
          const float pr =
              allow ? ex2_approx(fmaf(s[n][e], p.scale_log2, -lse2[i])) : 0.f;
          float dpv = dp[n][e];
          if constexpr (DROP) {
            const uint32_t hv = hash_finish(
                p.seed, hrow[i] ^ (static_cast<uint32_t>(s0 + j) * kHashCol));
            dpv = hv >= p.keep_thresh ? dpv * p.keep_scale : 0.f;
          }
          ds[n][e] = pr * (dpv - dlt[i]);
        }
      }
      SplitA<kSplitTerms> sa;
      split_bf16x2(ds[0][0], ds[0][1], sa, 0);
      split_bf16x2(ds[0][2], ds[0][3], sa, 1);
      split_bf16x2(ds[1][0], ds[1][1], sa, 2);
      split_bf16x2(ds[1][2], ds[1][3], sa, 3);
#pragma unroll
      for (int n2 = 0; n2 < (NT + 1) / 2; ++n2) {
        uint32_t kb[4];
        ldsm_x4_trans(kb, &ks[buf][c + (lane & 7) + ((lane >> 3) & 1) * 8]
                             [n2 * 16 + (lane >> 4) * 8]);
        mma_bf16_split(acc[2 * n2], sa, kb[0], kb[1]);
        if (2 * n2 + 1 < NT) mma_bf16_split(acc[2 * n2 + 1], sa, kb[2], kb[3]);
      }
    }
    __syncthreads();  // buf is restaged at t + 2
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= p.L) continue;
    bf16* dqp = static_cast<bf16*>(p.dq) +
                ((static_cast<int64_t>(b) * p.L + rows[i]) * p.H + h) * D;
    const bool pad = sq[i] == 0;  // dQ = 0 exactly
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = n * 8 + 2 * tg;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(dqp + col) = __floats2bfloat162_rn(
            pad ? 0.f : acc[n][2 * i] * p.scale,
            pad ? 0.f : acc[n][2 * i + 1] * p.scale);
    }
  }
}


// The wgmma route (see the header note): the block's shape and shared
// bytes at head dim D, and the instance.
// Consumer warpgroups of 64 query rows a block: two at head dim 256, where
// the block's shared memory (q and dO of its rows resident, the K/V ring)
// lets one block an SM and one warpgroup would leave the SM four warps; the
// two share each K and V tile. One below.
__host__ __device__ constexpr int dq_groups(int d) { return d > 128 ? 2 : 1; }
__host__ __device__ constexpr int dq_rows(int d) { return 64 * dq_groups(d); }
__host__ __device__ constexpr int dq_threads(int d) { return 128 * dq_groups(d); }
// Keys a tile: 64 at head dim 128; 32 at 64, where the smaller tiles let
// three blocks share an SM (timed on the card: faster there, slower at 128),
// and at 256, where S and dP then take 16 registers each beside the 128 of
// the dQ accumulator.
__host__ __device__ constexpr int dq_keys(int d) { return d == 128 ? 64 : 32; }
constexpr int kDqStages = 2;   // tiles in the ring
template <int D>
__host__ __device__ constexpr size_t dq_wgmma_smem() {
  return (2 * dq_rows(D) * D + kDqStages * 2 * dq_keys(D) * D) * sizeof(bf16) +
         kDqStages * dq_keys(D) * sizeof(int32_t);
}

template <int D, bool DROP>
__global__ void __launch_bounds__(dq_threads(D))
    attn_bwd_dq_kernel_wgmma(const BwdParams p, const int vec) {
  constexpr int NG = dq_groups(D);
  constexpr int NT = dq_threads(D);
  constexpr int NW = NT / 32;           // warps
  constexpr int ROWS = dq_rows(D);
  constexpr int KN = dq_keys(D);
  constexpr int KD = D / 16;            // k-steps of S and dP
  constexpr int OW = D > 128 ? 128 : D; // columns of dQ one dS K product covers
  constexpr int NH = D / OW;            // products a k-step
  extern __shared__ __align__(128) unsigned char wg_smem[];
  bf16* qs = reinterpret_cast<bf16*>(wg_smem);  // NG x [D / 8][64][8]
  bf16* dos = qs + ROWS * D;
  bf16* ks = dos + ROWS * D;                    // kDqStages x [D / 8][KN][8]
  bf16* vs = ks + kDqStages * KN * D;
  int32_t* segs = reinterpret_cast<int32_t*>(vs + kDqStages * KN * D);
  __shared__ float delta_s[ROWS];
  __shared__ int32_t wlo_s[NW], whi_s[NW];
  __shared__ int live_s[kDqStages][NG];  // NG 2: the tile meets warpgroup g's ids

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wg = warp >> 2;                // the warpgroup: the block's rows [64 wg, 64 wg + 64)
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int blk0 = blockIdx.y * ROWS;      // the block's first row
  const int row0 = blk0 + warp * 16;       // the warp's first row
  const int32_t* seg_b = p.seg + static_cast<int64_t>(b) * p.L;
  const bf16* qp = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* gp = static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;

  // delta = rowsum(dO * O): two lanes a row (lanes l and l+16, half of D each)
  {
    const int r = row0 + (lane & 15);
    float acc = 0.f;
    if (r < p.L) {
      const bf16* gr = gp + static_cast<int64_t>(r) * p.do_sl;
      const bf16* orow = static_cast<const bf16*>(p.o) +
                         ((static_cast<int64_t>(b) * p.L + r) * p.H + h) * D;
      const int d0 = (lane >> 4) * (D / 2);
      if (vec) {  // 16-byte loads (O is contiguous), the same order of terms
#pragma unroll
        for (int d = d0; d < d0 + D / 2; d += 8) {
          const uint4 gv = *reinterpret_cast<const uint4*>(gr + d);
          const uint4 ov = *reinterpret_cast<const uint4*>(orow + d);
          const uint32_t gw[4] = {gv.x, gv.y, gv.z, gv.w};
          const uint32_t ow[4] = {ov.x, ov.y, ov.z, ov.w};
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            const float2 gf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&gw[w]));
            const float2 of = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ow[w]));
            acc = fmaf(gf.x, of.x, acc);
            acc = fmaf(gf.y, of.y, acc);
          }
        }
      } else {
#pragma unroll 8
        for (int d = d0; d < d0 + D / 2; ++d)
          acc = fmaf(to_f32(gr[d]), to_f32(orow[d]), acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 16);
    if (lane < 16) {
      delta_s[warp * 16 + lane] = acc;
      if (r < p.L) p.delta[static_cast<int64_t>(bh) * p.L + r] = acc;
    }
  }

  // the segment-id ranges of the block and of each warpgroup (a key tile
  // outside one is skipped there) and the block's key range
  const int32_t my_seg = (lane < 16 && row0 + lane < p.L) ? seg_b[row0 + lane] : 0;
  int32_t wlo, whi;
  warp_seg_range(my_seg, &wlo, &whi);
  if (lane == 0) {
    wlo_s[warp] = wlo;
    whi_s[warp] = whi;
  }
  int k_first, k_last;
  other_axis_range(seg_b, p.L, (tid < ROWS && blk0 + tid < p.L) ? seg_b[blk0 + tid] : 0,
                   &k_first, &k_last);  // syncs: wlo_s, whi_s, delta_s are visible
  int32_t glo[NG], ghi[NG];
#pragma unroll
  for (int gg = 0; gg < NG; ++gg) {
    glo[gg] = min(min(wlo_s[4 * gg], wlo_s[4 * gg + 1]), min(wlo_s[4 * gg + 2], wlo_s[4 * gg + 3]));
    ghi[gg] = max(max(whi_s[4 * gg], whi_s[4 * gg + 1]), max(whi_s[4 * gg + 2], whi_s[4 * gg + 3]));
  }
  const int kend = k_last + 1;
  const int ntiles = (kend - k_first + KN - 1) / KN;  // <= 0: none

  // this thread's two rows (g and g+8 of the warp's 16)
  int rows[2];
  int32_t sq[2], sq_match[2];
  float lse2[2], dlt[2];
  uint32_t hrow[2];  // the dropout hash's (batch*head, row) terms
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rows[i] = row0 + g + 8 * i;
    sq[i] = rows[i] < p.L ? seg_b[rows[i]] : 0;
    sq_match[i] = sq[i] != 0 ? sq[i] : -1;  // a pad row pairs with no key
    lse2[i] = sq[i] != 0 ? p.lse[static_cast<int64_t>(bh) * p.L + rows[i]] * kLog2e : 0.f;
    dlt[i] = delta_s[warp * 16 + g + 8 * i];
    hrow[i] = ((static_cast<uint32_t>(bh) + p.bh_offset) * kHashBh) ^
              (static_cast<uint32_t>(rows[i]) * kHashRow);
  }
  asm volatile("" : "+r"(hrow[0]), "+r"(hrow[1]));
  float acc[NH][OW / 2];  // dQ of the warp's 16 rows, unscaled (wgmma layout, columns OW hh + ...)
#pragma unroll
  for (int hh = 0; hh < NH; ++hh)
#pragma unroll
    for (int i = 0; i < OW / 2; ++i) acc[hh][i] = 0.f;

  auto stage = [&](int t) {
    const int buf = t % kDqStages;
    const int s0 = k_first + t * KN;
    stage_tile<D, KN, NT>(ks + buf * KN * D, kp, p.k_sl, s0, kend, vec);
    stage_tile<D, KN, NT>(vs + buf * KN * D, vp, p.v_sl, s0, kend, vec);
    if (tid < KN)
      cp_async<4>(&segs[buf * KN + tid], seg_b + (s0 + tid < kend ? s0 + tid : 0),
                  s0 + tid < kend);
  };
#pragma unroll
  for (int gg = 0; gg < NG; ++gg) {
    stage_tile<D, 64, NT>(qs + gg * 64 * D, qp, p.q_sl, blk0 + 64 * gg, p.L, vec);
    stage_tile<D, 64, NT>(dos + gg * 64 * D, gp, p.do_sl, blk0 + 64 * gg, p.L, vec);
  }
  if (ntiles > 0) stage(0);
  cp_async_commit();
  const bf16* qw = qs + wg * 64 * D;     // this warpgroup's rows
  const bf16* dow = dos + wg * 64 * D;

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) stage(t + 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    const int buf = t % kDqStages;
    const int32_t* seg_t = segs + buf * KN;
    const int32_t sk_t = tid < KN ? seg_t[tid] : 0;  // the ids this thread staged
    bool live = true;  // the tile meets this warpgroup's ids
    if constexpr (NG == 1) {
      if (!__syncthreads_or(sk_t != 0 && sk_t >= glo[0] && sk_t <= ghi[0]))
        continue;  // no allowed pair for the block among these keys
    } else {
      static_assert(KN == 32, "warp 0 stages the tile's ids and reads them");
      if (warp == 0) {
#pragma unroll
        for (int gg = 0; gg < NG; ++gg) {
          const unsigned hit =
              __ballot_sync(0xffffffffu, sk_t != 0 && sk_t >= glo[gg] && sk_t <= ghi[gg]);
          if (lane == 0) live_s[buf][gg] = hit != 0;
        }
      }
      __syncthreads();
      bool any = false;
#pragma unroll
      for (int gg = 0; gg < NG; ++gg) any |= live_s[buf][gg] != 0;
      if (!any) continue;  // no allowed pair for the block among these keys
      live = live_s[buf][wg] != 0;
    }
    if (live) {
      const bf16* kt = ks + buf * KN * D;
      const bf16* vt = vs + buf * KN * D;
      const int s0 = k_first + t * KN;

      float sc[KN / 2], dp[KN / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        Wgmma<KN>::ss(sc, desc_kmajor<64>(qw, kk), desc_kmajor<KN>(kt, kk), kk > 0);
        Wgmma<KN>::ss(dp, desc_kmajor<64>(dow, kk), desc_kmajor<KN>(vt, kk), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      // dS in place of S; each of this thread's keys read once for its two rows
#pragma unroll
      for (int n = 0; n < KN / 8; ++n) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = n * 8 + 2 * tg + c;  // key in the tile
          const int32_t sk = seg_t[j];
          const uint32_t hk = static_cast<uint32_t>(s0 + j) * kHashCol;
#pragma unroll
          for (int i = 0; i < 2; ++i) {      // this thread's row
            const int e = 4 * n + 2 * i + c;
            const float pr =
                sk == sq_match[i] ? ex2_approx(fmaf(sc[e], p.scale_log2, -lse2[i])) : 0.f;
            float dpv = dp[e];
            if constexpr (DROP) {
              const uint32_t hv = hash_finish(p.seed, hrow[i] ^ hk);
              dpv = hv >= p.keep_thresh ? dpv * p.keep_scale : 0.f;
            }
            sc[e] = pr * (dpv - dlt[i]);
          }
        }
      }
      SplitA<kSplitTerms> sa[KN / 16];
#pragma unroll
      for (int kk = 0; kk < KN / 16; ++kk) {
        split_bf16x2(sc[8 * kk], sc[8 * kk + 1], sa[kk], 0);
        split_bf16x2(sc[8 * kk + 2], sc[8 * kk + 3], sa[kk], 1);
        split_bf16x2(sc[8 * kk + 4], sc[8 * kk + 5], sa[kk], 2);
        split_bf16x2(sc[8 * kk + 6], sc[8 * kk + 7], sa[kk], 3);
      }
      wgmma_fence();
#pragma unroll
      for (int hh = 0; hh < NH; ++hh) fence_regs(acc[hh]);
#pragma unroll
      for (int term = 0; term < kSplitTerms; ++term)
#pragma unroll
        for (int kk = 0; kk < KN / 16; ++kk)
#pragma unroll
          for (int hh = 0; hh < NH; ++hh)
            Wgmma<OW>::rs_t(acc[hh], sa[kk].t[term],
                            desc_mnmajor<KN>(kt + hh * (OW / 8) * KN * 8, kk));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int hh = 0; hh < NH; ++hh) fence_regs(acc[hh]);
    }
    __syncthreads();  // buf is restaged at t + kDqStages
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= p.L) continue;
    bf16* dqp = static_cast<bf16*>(p.dq) +
                ((static_cast<int64_t>(b) * p.L + rows[i]) * p.H + h) * D;
    const bool pad = sq[i] == 0;  // dQ = 0 exactly
#pragma unroll
    for (int hh = 0; hh < NH; ++hh)
#pragma unroll
      for (int n = 0; n < OW / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(dqp + hh * OW + n * 8 + 2 * tg) =
            __floats2bfloat162_rn(pad ? 0.f : acc[hh][4 * n + 2 * i] * p.scale,
                                  pad ? 0.f : acc[hh][4 * n + 2 * i + 1] * p.scale);
  }
}

// The wgmma_chunks design at head dims 320-512 (see the header note): two
// warpgroups on the block's 64 query rows, each holding one column half of
// dQ (D / 2 columns: D / 4 accumulator registers a thread); warpgroup 0
// forms S = q k^T and P (the mask, the exp), warpgroup 1 dP = dO v^T and
// the keep (the hash), each over the whole head dim, and each hands the
// other its values through shared memory. Shared bytes of a launch: q and
// dO of the block's rows resident, the K/V ring and the exchange (P, dP
// keep/(1-p): KN / 2 values a thread of a warpgroup each).
constexpr int kDqHalvesThreads = 256;
// Keys a tile: 32 up to 384; 16 above, where a ring of 32-key tiles beside
// q and dO would pass a block's 227 KB.
__host__ __device__ constexpr int dq_halves_keys(int d) { return d > 384 ? 16 : 32; }
template <int D>
__host__ __device__ constexpr size_t dq_halves_smem() {
  return (2 * kMmaRows * D + kDqStages * 2 * dq_halves_keys(D) * D) * sizeof(bf16) +
         kDqStages * dq_halves_keys(D) * sizeof(int32_t) +
         2 * (dq_halves_keys(D) / 2) * 128 * sizeof(float);
}

template <int D, bool DROP>
__global__ void __launch_bounds__(kDqHalvesThreads)
    attn_bwd_dq_kernel_wgmma_halves(const BwdParams p, const int vec) {
  constexpr int NT = kDqHalvesThreads;
  constexpr int KN = dq_halves_keys(D);
  constexpr int KD = D / 16;    // k-steps of S and dP
  constexpr int HALF = D / 2;   // columns of dQ a warpgroup holds
  constexpr int NE = KN / 2;    // elements of S (dP) a thread holds
  extern __shared__ __align__(128) unsigned char wg_smem[];
  bf16* qs = reinterpret_cast<bf16*>(wg_smem);  // [D / 8][64][8]
  bf16* dos = qs + kMmaRows * D;
  bf16* ks = dos + kMmaRows * D;                // kDqStages x [D / 8][KN][8]
  bf16* vs = ks + kDqStages * KN * D;
  int32_t* segs = reinterpret_cast<int32_t*>(vs + kDqStages * KN * D);
  float* xp = reinterpret_cast<float*>(segs + kDqStages * KN);  // [NE][128]: P
  float* xd = xp + NE * 128;                                    // dP keep/(1-p)
  __shared__ float dpart[2][kMmaRows];  // delta, by the half of D summed
  __shared__ int32_t wlo_s[4], whi_s[4];

  const int tid = threadIdx.x;
  const int tl = tid & 127;       // the thread in its warpgroup
  const int warp = tid >> 5;
  const int wg = warp >> 2;       // the warpgroup: columns [HALF wg, HALF wg + HALF)
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int blk0 = blockIdx.y * kMmaRows;     // the block's first row
  const int row0 = blk0 + (warp & 3) * 16;    // the warp's first row
  const int32_t* seg_b = p.seg + static_cast<int64_t>(b) * p.L;
  const bf16* qp = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* gp = static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;

  // delta = rowsum(dO * O): four lanes a row (lanes l and l+16 of the two
  // warpgroups' warps, a quarter of D each), the halves through shared memory
  {
    const int r = row0 + (lane & 15);
    float acc = 0.f;
    if (r < p.L) {
      const bf16* gr = gp + static_cast<int64_t>(r) * p.do_sl;
      const bf16* orow = static_cast<const bf16*>(p.o) +
                         ((static_cast<int64_t>(b) * p.L + r) * p.H + h) * D;
      const int d0 = wg * HALF + (lane >> 4) * (HALF / 2);
      if (vec) {  // 16-byte loads (O is contiguous)
#pragma unroll
        for (int d = d0; d < d0 + HALF / 2; d += 8) {
          const uint4 gv = *reinterpret_cast<const uint4*>(gr + d);
          const uint4 ov = *reinterpret_cast<const uint4*>(orow + d);
          const uint32_t gw[4] = {gv.x, gv.y, gv.z, gv.w};
          const uint32_t ow[4] = {ov.x, ov.y, ov.z, ov.w};
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            const float2 gf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&gw[w]));
            const float2 of = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ow[w]));
            acc = fmaf(gf.x, of.x, acc);
            acc = fmaf(gf.y, of.y, acc);
          }
        }
      } else {
#pragma unroll 8
        for (int d = d0; d < d0 + HALF / 2; ++d)
          acc = fmaf(to_f32(gr[d]), to_f32(orow[d]), acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 16);
    if (lane < 16) dpart[wg][(warp & 3) * 16 + lane] = acc;
  }

  // the block's segment-id range (a key tile outside it is skipped) and key range
  const int32_t my_seg = (lane < 16 && row0 + lane < p.L) ? seg_b[row0 + lane] : 0;
  int32_t wlo, whi;
  warp_seg_range(my_seg, &wlo, &whi);
  if (lane == 0 && wg == 0) {
    wlo_s[warp] = wlo;
    whi_s[warp] = whi;
  }
  int k_first, k_last;
  other_axis_range(seg_b, p.L, (tid < kMmaRows && blk0 + tid < p.L) ? seg_b[blk0 + tid] : 0,
                   &k_first, &k_last);  // syncs: wlo_s, whi_s, dpart are visible
  const int32_t blo = min(min(wlo_s[0], wlo_s[1]), min(wlo_s[2], wlo_s[3]));
  const int32_t bhi = max(max(whi_s[0], whi_s[1]), max(whi_s[2], whi_s[3]));
  const int kend = k_last + 1;
  const int ntiles = (kend - k_first + KN - 1) / KN;  // <= 0: none
  if (tid < kMmaRows && blk0 + tid < p.L)
    p.delta[static_cast<int64_t>(bh) * p.L + blk0 + tid] = dpart[0][tid] + dpart[1][tid];

  // this thread's two rows (g and g+8 of the warp's 16)
  int rows[2];
  int32_t sq[2], sq_match[2];
  float lse2[2], dlt[2];
  uint32_t hrow[2];  // the dropout hash's (batch*head, row) terms
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rows[i] = row0 + g + 8 * i;
    sq[i] = rows[i] < p.L ? seg_b[rows[i]] : 0;
    sq_match[i] = sq[i] != 0 ? sq[i] : -1;  // a pad row pairs with no key
    lse2[i] = sq[i] != 0 ? p.lse[static_cast<int64_t>(bh) * p.L + rows[i]] * kLog2e : 0.f;
    const int rr = (warp & 3) * 16 + g + 8 * i;
    dlt[i] = dpart[0][rr] + dpart[1][rr];
    hrow[i] = ((static_cast<uint32_t>(bh) + p.bh_offset) * kHashBh) ^
              (static_cast<uint32_t>(rows[i]) * kHashRow);
  }
  asm volatile("" : "+r"(hrow[0]), "+r"(hrow[1]));
  float acc[HALF / 2];  // this warpgroup's half of dQ, unscaled (wgmma layout)
#pragma unroll
  for (int i = 0; i < HALF / 2; ++i) acc[i] = 0.f;

  auto stage = [&](int t) {
    const int buf = t % kDqStages;
    const int s0 = k_first + t * KN;
    stage_tile<D, KN, NT>(ks + buf * KN * D, kp, p.k_sl, s0, kend, vec);
    stage_tile<D, KN, NT>(vs + buf * KN * D, vp, p.v_sl, s0, kend, vec);
    if (tid < KN)
      cp_async<4>(&segs[buf * KN + tid], seg_b + (s0 + tid < kend ? s0 + tid : 0),
                  s0 + tid < kend);
  };
  stage_tile<D, kMmaRows, NT>(qs, qp, p.q_sl, blk0, p.L, vec);
  stage_tile<D, kMmaRows, NT>(dos, gp, p.do_sl, blk0, p.L, vec);
  if (ntiles > 0) stage(0);
  cp_async_commit();
  // this warpgroup's operand of the first products, and its half of K
  const bf16* xw = wg == 0 ? qs : dos;
  const int half0 = wg * (HALF / 8) * KN * 8;

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) stage(t + 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    const int buf = t % kDqStages;
    const int32_t* seg_t = segs + buf * KN;
    const int32_t sk_t = tid < KN ? seg_t[tid] : 0;
    if (!__syncthreads_or(sk_t != 0 && sk_t >= blo && sk_t <= bhi))
      continue;  // no allowed pair for the block among these keys
    const bf16* kt = ks + buf * KN * D;
    const bf16* vt = vs + buf * KN * D;
    const int s0 = k_first + t * KN;

    // warpgroup 0: S = q k^T; warpgroup 1: dP = dO v^T
    float x[NE];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      Wgmma<KN>::ss(x, desc_kmajor<kMmaRows>(xw, kk), desc_kmajor<KN>(wg == 0 ? kt : vt, kk),
                    kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(x);

    // warpgroup 0: P in place of S; warpgroup 1: dP keep/(1-p); each into
    // the exchange
    if (wg == 0) {
#pragma unroll
      for (int n = 0; n < KN / 8; ++n) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int32_t sk = seg_t[n * 8 + 2 * tg + c];
#pragma unroll
          for (int i = 0; i < 2; ++i) {      // this thread's row
            const int e = 4 * n + 2 * i + c;
            x[e] = sk == sq_match[i] ? ex2_approx(fmaf(x[e], p.scale_log2, -lse2[i])) : 0.f;
            xp[e * 128 + tl] = x[e];
          }
        }
      }
    } else {
#pragma unroll
      for (int n = 0; n < KN / 8; ++n) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const uint32_t hk = static_cast<uint32_t>(s0 + n * 8 + 2 * tg + c) * kHashCol;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = 4 * n + 2 * i + c;
            if constexpr (DROP) {
              const uint32_t hv = hash_finish(p.seed, hrow[i] ^ hk);
              x[e] = hv >= p.keep_thresh ? x[e] * p.keep_scale : 0.f;
            }
            xd[e * 128 + tl] = x[e];
          }
        }
      }
    }
    __syncthreads();  // the exchange is written

    // both: dS = P (dP keep/(1-p) - delta) in x
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const float pr = wg == 0 ? x[e] : xp[e * 128 + tl];
      const float dpk = wg == 0 ? xd[e * 128 + tl] : x[e];
      x[e] = pr * (dpk - dlt[(e >> 1) & 1]);
    }
    SplitA<kSplitTerms> sa[KN / 16];
#pragma unroll
    for (int kk = 0; kk < KN / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split_bf16x2(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1], sa[kk], r);
    wgmma_fence();
    fence_regs(acc);
#pragma unroll
    for (int term = 0; term < kSplitTerms; ++term)
#pragma unroll
      for (int kk = 0; kk < KN / 16; ++kk)
        Wgmma<HALF>::rs_t(acc, sa[kk].t[term], desc_mnmajor<KN>(kt + half0, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();  // buf is restaged at t + kDqStages; the exchange is read
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= p.L) continue;
    bf16* dqp = static_cast<bf16*>(p.dq) +
                ((static_cast<int64_t>(b) * p.L + rows[i]) * p.H + h) * D + wg * HALF;
    const bool pad = sq[i] == 0;  // dQ = 0 exactly
#pragma unroll
    for (int n = 0; n < HALF / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dqp + n * 8 + 2 * tg) =
          __floats2bfloat162_rn(pad ? 0.f : acc[4 * n + 2 * i] * p.scale,
                                pad ? 0.f : acc[4 * n + 2 * i + 1] * p.scale);
  }
}

// The f32 route (see the header note): one query row per thread.
template <int D>
__global__ void __launch_bounds__(kF32Rows, f32_min_blocks(D))
    attn_bwd_dq_kernel_f32(const BwdParams p) {
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

  float qr[D];   // q * scale * log2(e)
  float dor[D];  // dO
  float acc[D];  // unscaled dQ
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = 0.f;
    dor[d] = 0.f;
    acc[d] = 0.f;
  }
  float delta = 0.f;
  float lse2 = 0.f;
  if (in_range) {
    const float* gp = static_cast<const float*>(p.dout) + b * p.do_sb +
                      row * p.do_sl + h * p.do_sh;
    const float* op = static_cast<const float*>(p.o) +
                      ((static_cast<int64_t>(b) * p.L + row) * p.H + h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dor[d] = gp[d];
      delta = fmaf(dor[d], op[d], delta);
    }
    p.delta[static_cast<int64_t>(bh) * p.L + row] = delta;
  }
  if (sq != 0) {
    const float* qp = static_cast<const float*>(p.q) + b * p.q_sb +
                      row * p.q_sl + h * p.q_sh;
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = qp[d] * p.scale_log2;
    lse2 = p.lse[static_cast<int64_t>(bh) * p.L + row] * kLog2e;
  }

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
#pragma unroll 2
        for (int j = 0; j < T; ++j) {
          if (segs[j] != sq) continue;  // sq != 0, so a pad key never matches
          float dot = 0.f;
          float dp = 0.f;
#pragma unroll
          for (int d = 0; d < D; ++d) {
            dot = fmaf(qr[d], ks[j][d], dot);
            dp = fmaf(dor[d], vs[j][d], dp);
          }
          const float pj = exp2f(dot - lse2);
          if (p.dropout) {
            const uint32_t hv = hash_u32(p.seed, static_cast<uint32_t>(bh) + p.bh_offset,
                                         static_cast<uint32_t>(row),
                                         static_cast<uint32_t>(s0 + j));
            dp = hv >= p.keep_thresh ? dp * p.keep_scale : 0.f;
          }
          const float ds = pj * (dp - delta);
#pragma unroll
          for (int d = 0; d < D; ++d) acc[d] = fmaf(ds, ks[j][d], acc[d]);
        }
      }
    }
    __syncthreads();  // tiles are overwritten by the next iteration
  }

  if (!in_range) return;
  float* dqp = static_cast<float*>(p.dq) +
               ((static_cast<int64_t>(b) * p.L + row) * p.H + h) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) dqp[d] = acc[d] * p.scale;
}

// The wide route (see the header note): 32 query rows a block (a row a
// lane), one chunk of 128 dQ columns (grid z), 32 columns a warp.
template <typename T>
__global__ void __launch_bounds__(128) attn_bwd_dq_kernel_wide(const BwdParams p, const int D) {
  __shared__ __align__(16) float ks[kWideTile][kWideChunk];
  __shared__ __align__(16) float vs[kWideTile][kWideChunk];
  __shared__ float red_s[kWideSplit][kWideTile][kWideRows];
  __shared__ float red_dp[kWideSplit][kWideTile][kWideRows];
  __shared__ float red_delta[kWideSplit][1][kWideRows];
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
  const int32_t sq_match = sq != 0 ? sq : -1;  // a pad row pairs with no key
  const T* qrow = sq != 0 ? static_cast<const T*>(p.q) + b * p.q_sb + row * p.q_sl + h * p.q_sh
                          : nullptr;
  const T* grow = in_range
                      ? static_cast<const T*>(p.dout) + b * p.do_sb + row * p.do_sl + h * p.do_sh
                      : nullptr;

  // delta = rowsum(dO * O) over the whole head dim: the four warps' parts
  float delta[1] = {0.f};
  if (in_range) {
    const T* orow = static_cast<const T*>(p.o) +
                    ((static_cast<int64_t>(b) * p.L + row) * p.H + h) * D;
    for (int chunk = 0; chunk < nc; ++chunk) {
      const int c0 = wide_col0(chunk);
#pragma unroll
      for (int i = 0; i < kWideCols; ++i)
        if (c0 + i < D) delta[0] = fmaf(to_f32(grow[c0 + i]), to_f32(orow[c0 + i]), delta[0]);
    }
  }
  wide_reduce(delta, red_delta);
  if (z == 0 && threadIdx.x < kWideRows && in_range)
    p.delta[static_cast<int64_t>(bh) * p.L + row] = delta[0];
  const float lse2 = sq != 0 ? p.lse[static_cast<int64_t>(bh) * p.L + row] * kLog2e : 0.f;

  float qr[kWideCols], dor[kWideCols], acc[kWideCols];
#pragma unroll
  for (int i = 0; i < kWideCols; ++i) acc[i] = 0.f;
  if (nc == 1) {
    load_wide(qr, qrow, 0, D);
    load_wide(dor, grow, 0, D);
  }

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
    float sc[kWideTile], dp[kWideTile];
#pragma unroll
    for (int j = 0; j < kWideTile; ++j) sc[j] = dp[j] = 0.f;
    for (int c = 0; c < nc; ++c) {
      const int chunk = (z + 1 + c) % nc;  // chunk z last: it stays staged
      if (c > 0) __syncthreads();          // the previous chunk is read
      stage_wide(ks, kp, p.k_sl, s0, kend, chunk, D);
      stage_wide(vs, vp, p.v_sl, s0, kend, chunk, D);
      if (nc > 1) {
        load_wide(qr, qrow, chunk, D);
        load_wide(dor, grow, chunk, D);
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kWideTile; ++j) {
        sc[j] += wide_dot(qr, ks[j]);
        dp[j] += wide_dot(dor, vs[j]);
      }
    }
    wide_reduce(sc, red_s);
    wide_reduce(dp, red_dp);
#pragma unroll
    for (int j = 0; j < kWideTile; ++j) {
      if (segs[j] != sq_match) continue;
      const float pj = exp2f(fmaf(sc[j], p.scale_log2, -lse2));
      float dpj = dp[j];
      if (p.dropout) {
        const uint32_t hv = hash_u32(p.seed, static_cast<uint32_t>(bh) + p.bh_offset,
                                     static_cast<uint32_t>(row),
                                     static_cast<uint32_t>(s0 + j));
        dpj = hv >= p.keep_thresh ? dpj * p.keep_scale : 0.f;
      }
      wide_axpy(acc, pj * (dpj - delta[0]), ks[j]);
    }
    __syncthreads();  // the tiles are restaged by the next iteration
  }
  if (in_range)
    store_wide(static_cast<T*>(p.dq) + ((static_cast<int64_t>(b) * p.L + row) * p.H + h) * D,
               acc, z, D, p.scale);
}

// The instance of `design` at (head dim D, dropout), nullptr where this
// source has none; the wide route is `wide_kernel`.
template <int D>
const void* kernel_of(int design, int dropout) {
  if constexpr (D > kWgmmaWide) {
    if (design == kDesignWgmmaChunks)
      return dropout ? reinterpret_cast<const void*>(attn_bwd_dq_kernel_wgmma_halves<D, true>)
                     : reinterpret_cast<const void*>(attn_bwd_dq_kernel_wgmma_halves<D, false>);
    return nullptr;
  } else if constexpr (D >= 64) {
    if (design == kDesignWgmma)
      return dropout ? reinterpret_cast<const void*>(attn_bwd_dq_kernel_wgmma<D, true>)
                     : reinterpret_cast<const void*>(attn_bwd_dq_kernel_wgmma<D, false>);
  } else {
    if (design == kDesignMma)
      return dropout ? reinterpret_cast<const void*>(attn_bwd_dq_kernel_mma<D, true>)
                     : reinterpret_cast<const void*>(attn_bwd_dq_kernel_mma<D, false>);
  }
  if constexpr (D < 128)
    if (design == kDesignF32) return reinterpret_cast<const void*>(attn_bwd_dq_kernel_f32<D>);
  return nullptr;
}
template <int D>
constexpr size_t dyn_smem_of() {
  if constexpr (D > kWgmmaWide) return dq_halves_smem<D>();
  if constexpr (D >= 64) return dq_wgmma_smem<D>();
  return mma_dyn_smem<mma_ld(D)>();
}
const void* wide_kernel(int is_bf16) {
  return is_bf16 ? reinterpret_cast<const void*>(attn_bwd_dq_kernel_wide<bf16>)
                 : reinterpret_cast<const void*>(attn_bwd_dq_kernel_wide<float>);
}

template <int D>
int launch(const BwdParams& p, int design, cudaStream_t stream) {
  if (kernel_of<D>(design, p.dropout) == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (design != kDesignF32) {
    const int vec = rows_vectorizable(p.k, p.k_sb, p.k_sl, p.k_sh, D) &&
                    rows_vectorizable(p.v, p.v_sb, p.v_sl, p.v_sh, D) &&
                    (D < 64 || (rows_vectorizable(p.q, p.q_sb, p.q_sl, p.q_sh, D) &&
                                rows_vectorizable(p.dout, p.do_sb, p.do_sl, p.do_sh, D)));
    constexpr size_t smem = dyn_smem_of<D>();
    if constexpr (D > kWgmmaWide) {
      const dim3 grid(p.B * p.H, (p.L + kMmaRows - 1) / kMmaRows);
      if (p.dropout)
        launch_dyn(attn_bwd_dq_kernel_wgmma_halves<D, true>, grid, kDqHalvesThreads, smem,
                   stream, p, vec);
      else
        launch_dyn(attn_bwd_dq_kernel_wgmma_halves<D, false>, grid, kDqHalvesThreads, smem,
                   stream, p, vec);
    } else if constexpr (D >= 64) {
      const dim3 grid(p.B * p.H, (p.L + dq_rows(D) - 1) / dq_rows(D));
      if (p.dropout)
        launch_dyn(attn_bwd_dq_kernel_wgmma<D, true>, grid, dq_threads(D), smem, stream, p, vec);
      else
        launch_dyn(attn_bwd_dq_kernel_wgmma<D, false>, grid, dq_threads(D), smem, stream, p, vec);
    } else {
      const dim3 grid(p.B * p.H, (p.L + kMmaRows - 1) / kMmaRows);
      if (p.dropout)
        launch_dyn(attn_bwd_dq_kernel_mma<D, true>, grid, kMmaThreads, smem, stream, p, vec);
      else
        launch_dyn(attn_bwd_dq_kernel_mma<D, false>, grid, kMmaThreads, smem, stream, p, vec);
    }
  } else if constexpr (D < 128) {
    const dim3 grid(p.B * p.H, (p.L + kF32Rows - 1) / kF32Rows);
    attn_bwd_dq_kernel_f32<D><<<grid, kF32Rows, 0, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

int dispatch_d(int head_dim, int is_bf16, int design, const BwdParams& p,
               cudaStream_t stream) {
  if (!design_takes(design, is_bf16)) return static_cast<int>(cudaErrorInvalidValue);
  if (design == kDesignWide) {
    const dim3 grid(p.B * p.H, (p.L + kWideRows - 1) / kWideRows, wide_chunks(head_dim));
    if (is_bf16)
      attn_bwd_dq_kernel_wide<bf16><<<grid, 128, 0, stream>>>(p, head_dim);
    else
      attn_bwd_dq_kernel_wide<float><<<grid, 128, 0, stream>>>(p, head_dim);
    return static_cast<int>(cudaGetLastError());
  }
  return with_chunks_head_dim(head_dim, design, [&](auto d) {
    return launch<decltype(d)::value>(p, design, stream);
  });
}

}  // namespace

// Plain C entry point (bound with ctypes). Writes dq and delta. Returns
// cudaGetLastError() after the launch, which is asynchronous on `stream`.
extern "C" int flash_attn_bwd_dq(const flash::BwdParams* params, int head_dim,
                                 int is_bf16, int design, void* stream) {
  flash::BwdParams p = *params;
  p.scale_log2 = p.scale * flash::kLog2e;
  return dispatch_d(head_dim, is_bf16, design, p, static_cast<cudaStream_t>(stream));
}

// The resources of the instance of `design` a launch at (head_dim,
// is_bf16, dropout) runs: out[4] = static shared bytes, dynamic shared
// bytes, registers a thread, local (spilled) bytes a thread. Returns a
// cudaError_t.
extern "C" int flash_attn_bwd_dq_attrs(int head_dim, int is_bf16, int design, int dropout,
                                       int* out) {
  if (!flash::design_takes(design, is_bf16)) return static_cast<int>(cudaErrorInvalidValue);
  if (design == flash::kDesignWide) return flash::func_attrs(wide_kernel(is_bf16), 0, out);
  return flash::with_chunks_head_dim(head_dim, design, [&](auto d) {
    constexpr int D = decltype(d)::value;
    const void* fn = kernel_of<D>(design, dropout);
    if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return flash::func_attrs(
        fn, design == flash::kDesignF32 ? 0 : static_cast<int>(dyn_smem_of<D>()), out);
  });
}

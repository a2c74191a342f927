// Flash-attention backward, dK and dV, for Hopper (sm_90a): non-causal,
// segment-masked, with the forward's attention-probability dropout
// regenerated from the counter hash.
//
// Replaces the TPU kernel `_bwd_dkv_kernel` of
// glearning_benchmark_tpu/ops/pallas_attention.py (launched by `_flash_bwd`).
// Same function:
//   P  = exp(scale q.k - LSE) on allowed pairs, 0 elsewhere
//   dV = sum_queries (P keep/(1-p)) dO
//   dP = dO.v keep/(1-p),  dS = P (dP - delta),  dK = scale * sum_queries dS q
// delta [B, H, L] f32 is an input here: the dQ kernel writes it. Pad keys
// (seg 0) get dK = dV = 0 exactly. The dropout hash sees (bh_offset +
// batch*head, query row, key column) exactly as the forward does, though the block's
// own axis is now the keys. A key's sums are taken by one warp in query
// order: no atomics, and two runs give the same bits.
//
// What bounds it on an H100. Per allowed pair 8*D FLOPs (q.k, dO.v, P dO,
// dS q), one exp2 and, under dropout, one hash. At the packed AGTT-ZINC
// training rows the least time is set by bytes (~3 us) and what the kernel
// reaches by the per-pair elementwise work and the launch; at head dim 128
// on the mfu_bench rows ([64, 1024, 8, 128], 2-5 segments a row) by bytes
// (0.20 ms) with the tensor-core FLOPs close behind, so there the products
// have to run at the tensor cores' rate (PERF.md).
//
// Five designs, by head dim and input type (ops/flash_attention.py
// `design` names a launch's; `launch` runs it, or refuses a design this
// source has no instance of). The Pallas grid
// swaps its axes for this kernel and carries dK/dV in VMEM across the
// sequential query axis; here a block owns keys and loops over queries.
//
// bf16 at head dims 4-32: warp-level mma.sync. One block of 4 warps owns 64
// keys of one batch*head, 16 a warp (the M of m16n8k16), k and v as A
// fragments in registers, dK and dV accumulators in registers (head dims 4
// and 8 zero-padded to the mma depth 16 in registers and shared memory
// only). The block loops over query tiles of 64 inside its segment range;
// q, dO, LSE, delta and the segment ids are staged by cp.async,
// double-buffered, rows padded by 8 bf16 for conflict-free ldmatrix. Per 16
// queries a warp skips them unless one lies in its segment-id range;
// S^T = k q^T and dP^T = v dO^T by mma; P, the mask, keep/(1-p) and
// dS = P (dP - delta) in the accumulator registers; dV += (P keep/(1-p))^T
// dO and dK += dS^T q with the left operands straight from registers and dO
// and q through ldmatrix.trans, each left operand as three bf16 terms hi +
// mid + lo (`kSplitTerms`, exact for the f32 value). At these head dims every product is one
// 16-deep k-step and the elementwise work between the products bounds the
// kernel, so warp-level mma, which skips per warp, fits.
//
// bf16 at head dims 64 and 128: warpgroup wgmma (sm_90a). There the
// products dominate, and mma.sync (full-width dK and dV accumulators and k,
// v fragments in each warp: 255 registers, about 8 warps an SM) ran at 8x
// the bound. One block is one warpgroup owning 64 keys; k and v of those
// keys sit in shared memory for the block's life, and q, dO, LSE, delta and
// the query segment ids stream through a three-stage cp.async ring
// (16-byte pieces, each tile in wgmma's core-matrix layout, `stage_tile`;
// plain loads where a pointer or stride does not fit). Per query tile of 32
// that holds an allowed pair for the block (the tile is skipped otherwise):
//   - S^T = k q^T and dP^T = v dO^T: wgmma m64n32k16, both operands from
//     shared memory (K-major), D / 16 k-steps each;
//   - P, the mask, the dropout keep (hash_u32 at (bh_offset + b h, query,
//     key), as in the forward) and dS in the 32 accumulator registers;
//   - dV += (P keep/(1-p))^T dO and dK += dS^T q: wgmma m64nDk16 with the
//     left operands from registers (the accumulator layout is mma.sync's,
//     so two n-tiles are one k-step's A fragment) and dO and q read
//     MN-major from the same shared tiles.
// P keep/(1-p) and dS are not bf16: each goes in as three bf16 terms hi +
// mid + lo (`kSplitTerms`), three products each. The query
// tile is 32 rather than 64 to keep the registers in bounds: dK and dV take
// D registers a thread (128 at head dim 128), S^T and dP^T 32, the split
// terms 48, and two blocks fit an SM, so one block's loads and elementwise
// work run under the other's products. No producer warp: the ring is filled
// by the same threads two tiles ahead.
//
// bf16 at head dim 256 (129-255 zero-padded to it by the wrapper):
// warpgroup wgmma on two warpgroups (`attn_bwd_dkv_kernel_wgmma_halves`).
// The wide route ran at 200x the bound there. dK and dV of 64 keys x 256
// columns would take 256 registers a thread in one warpgroup, so two
// warpgroups share the block's 64 keys and each holds 128 columns of both
// (128 registers). S^T and dP^T need the whole head dim; each is formed
// once: warpgroup 0 takes S^T = k q^T and P (the mask, the exp), warpgroup
// 1 takes dP^T = v dO^T and the keep (the hash), each on 16 k-steps of
// m64n32k16, and each writes its 16 values a thread to shared memory (P,
// dP keep/(1-p), keep/(1-p): 24 KB; the accumulator layouts of the two
// warpgroups agree, so thread t reads what thread t of the other wrote).
// Both then form P keep/(1-p) and dS from the same values in the same
// order, split them into three bf16 terms and run dV += P~^T dO and dK +=
// dS^T q on their own half of the columns (m64n128k16, dO and q read
// MN-major from the column half of the shared tile). Shared memory: k and v
// resident (64 KB), a three-stage ring of 32-query q/dO tiles (96 KB) and
// the exchange, 189,568 B: one block an SM, eight warps. Registers: 241 a
// thread (244 with dropout), 0 B spilled. The same cp.async ring as at 64
// and 128 (no TMA: strided q and dO views are read as they are), chosen by
// measurement (PERF.md §6, dense [16, 1024, 8, 256], each pair of times
// from one call): the ring's copies cost 28% there (a probe that stopped
// them ran 1.538 ms against 2.132), but a TMA ring (warp 0 issuing the forward's boxes of 8 columns
// into an mbarrier a stage, a transposed dO copied first) ran 2.583 ms
// against 2.229, and pipelining it (the next tile's S^T or dP^T and
// hand-over under this tile's dV and dK products, a double-buffered
// exchange, one barrier a tile) 2.478; launching a batch*head's tiles
// together for L2 ran 2.069 against 2.129. The exchange's barrier costs
// 0.13 ms there, the first products 0.19, the second 0.61.
//
// bf16 at head dims 257-512 (the wgmma_chunks design; the wrapper
// zero-pads to its instances at 320, 384, 448 and 512, the next multiple of
// 64): the kernel of head dim 256 over column chunks. The wide route ran at
// 317x the bound at 320, and the 256 design does not stretch: its two
// warpgroups hold dK and dV of 128 columns each in 241 registers a thread,
// so D / 2 columns a warpgroup (160 at 320) would pass 255, and a third
// warpgroup does not fit the SM's 64K registers. So the outputs are split
// into two column chunks on grid z (D / 2 columns: 160, 192, 224, 256), a
// block holding one, and within it each warpgroup holds a quarter of the
// head dim of both dK and dV (D / 4 registers a thread). Each chunk's
// blocks form S^T and dP^T over the whole head dim again (warpgroup 0 S^T
// and P, warpgroup 1 dP^T and the keep, handed over as at 256), the price
// of the split; the second products run m64n(D/4)k16 on the chunk's
// columns of q and dO. k and v sit in shared memory, q, dO, LSE, delta and
// the query segment ids stream through a two-stage ring of 32-query tiles
// (16 at 448 and 512, where 32-query stages would pass a block's 227 KB).
// Registers a thread with dropout (without) and dynamic shared memory at
// 320 / 384 / 448 / 512 (PERF.md §6, chip_smoke.py phase 11): 212 (209) /
// 231 (228) / 200 (197) / 201 (198), 189,184 / 221,952 / 184,704 / 209,280
// B, 0 B spilled: one block, eight warps an SM. Chosen by measurement
// (packed [16, 1024, 8, 320] and [8, 1024, 8, 384], p 26/256, each pair
// of times from one call): a three-stage ring at 320 (it fits there,
// 230,528 B) ran 1.9283 ms against 1.7916 for two stages, and 16-query
// tiles 1.7959 against 1.4462 at 320 and 0.7216 against 0.6374 at 384.
// Above 512 the wide route remains: k and v of 64 keys alone
// take 128 KB at 512, and a 16-query ring beside them leaves no room for a
// wider head dim.
//
// f32 at head dims 4-64: the FP32 pipe, a key a thread. A block of 128
// threads owns 128 keys with k, v and the dK and dV accumulators of its key
// in f32 registers and loops over query tiles of 64 staged in shared memory
// as f32 (broadcasts) inside its segment range. At 64 it takes 255
// registers and spills 616 bytes a thread; chip_smoke.py phase 11 times it
// against the wide route on the same inputs, which is why both stay
// (PERF.md §6).
//
// f32 at head dim 128 and above, bf16 above 512: the wide FP32-pipe route
// (`attn_bwd_dkv_kernel_wide`, flash_attn_common.cuh
// `kWideRows`). A block owns 32 keys and one chunk of 128 columns of dK and
// dV (grid z = ceil(D / 128)); a key is held by 4 threads, lane i of each
// warp, warp w holding columns [32 w, 32 w + 32), so that no thread keeps a
// full-width row (the f32 design kept k, v, dK and dV of one key a thread
// and spilled 2,184 bytes at 128). Query tiles of 16 are staged in shared
// memory as f32, one column chunk at a time; S^T and dP^T are summed over
// every chunk (the four warps' parts through shared memory in a fixed
// order, `wide_reduce`) before the chunk of dK and dV is updated.
// Above 128 this recomputes S and dP once per column chunk (ceil(D / 128)
// times), the price of holding any head dim in fixed registers; the head
// dim is a run-time argument, so any head dim runs unpadded. Tensor cores
// take no f32 input and TF32 would not hold f32 accuracy.
//
// All routes: delta [B, H, L] f32 is an input (the dQ kernel writes it);
// pad keys (seg 0) get dK = dV = 0 exactly; a key's sums are taken in a
// fixed order with no atomics, so two runs give the same bits. dK is
// accumulated unscaled and multiplied by `scale` once before the cast.

#include "flash_attn_common.cuh"

namespace {

using namespace flash;
using bf16 = __nv_bfloat16;

// DROP: p_drop > 0 (a template argument, so that the pair loop has no branch)
template <int D, bool DROP>
__global__ void __launch_bounds__(kMmaThreads)
    attn_bwd_dkv_kernel_mma(const BwdParams p, const int vec) {
  constexpr int DP = D < 16 ? 16 : D;  // mma depth: D padded to 16
  constexpr int KD = DP / 16;          // k-steps of k.q and v.dO
  constexpr int NT = (D + 7) / 8;      // n-tiles of 8 head columns of dK, dV
  constexpr int LD = mma_ld(D);        // shared row stride: no bank conflicts
  auto& qs = mma_tiles<LD>().a;        // [2][kMmaTile][LD]
  auto& dos = mma_tiles<LD>().b;
  __shared__ float lses[2][kMmaTile];
  __shared__ float deltas[2][kMmaTile];
  __shared__ int32_t segs[2][kMmaTile];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int key0 = blockIdx.y * kMmaRows + warp * 16;  // the warp's first key
  const int32_t* seg_b = p.seg + static_cast<int64_t>(b) * p.L;
  const bf16* qp = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* gp = static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* lse_bh = p.lse + static_cast<int64_t>(bh) * p.L;
  const float* delta_bh = p.delta + static_cast<int64_t>(bh) * p.L;

  // the warp's segment-id range, the block's query range
  const int32_t my_seg =
      (lane < 16 && key0 + lane < p.L) ? seg_b[key0 + lane] : 0;
  int32_t wlo, whi;
  warp_seg_range(my_seg, &wlo, &whi);
  const int blk_key = blockIdx.y * kMmaRows + tid;
  int q_first, q_last;
  other_axis_range(seg_b, p.L,
                   (tid < kMmaRows && blk_key < p.L) ? seg_b[blk_key] : 0,
                   &q_first, &q_last);
  const int qend = q_last + 1;
  const int ntiles = (qend - q_first + kMmaTile - 1) / kMmaTile;  // <= 0: none

  // this thread's two keys (g and g+8 of the warp's 16) and their k, v
  int keys[2];
  int32_t sk[2];
  const bf16* kr[2];
  const bf16* vr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    keys[i] = key0 + g + 8 * i;
    sk[i] = keys[i] < p.L ? seg_b[keys[i]] : 0;
    kr[i] = sk[i] != 0 ? kp + static_cast<int64_t>(keys[i]) * p.k_sl : nullptr;
    vr[i] = sk[i] != 0 ? vp + static_cast<int64_t>(keys[i]) * p.v_sl : nullptr;
  }
  uint32_t ka[KD][4], va[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    load_a_frag<D>(ka[kk], kr[0], kr[1], kk * 16);
    load_a_frag<D>(va[kk], vr[0], vr[1], kk * 16);
  }
  uint32_t hkey[2];  // the dropout hash's (batch*head, key column) terms
#pragma unroll
  for (int i = 0; i < 2; ++i)
    hkey[i] = ((static_cast<uint32_t>(bh) + p.bh_offset) * kHashBh) ^
              (static_cast<uint32_t>(keys[i]) * kHashCol);
  // opaque to the compiler: kept in registers, not recomputed per pair
  asm volatile("" : "+r"(hkey[0]), "+r"(hkey[1]));
  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  if constexpr (D < 16) {  // padded columns stay zero: cp.async never writes them
    for (int e = tid; e < 2 * kMmaTile * (16 - D); e += kMmaThreads) {
      const int r = e / (16 - D);
      const int c = D + e - r * (16 - D);
      qs[r / kMmaTile][r % kMmaTile][c] = __ushort_as_bfloat16(0);
      dos[r / kMmaTile][r % kMmaTile][c] = __ushort_as_bfloat16(0);
    }
  }
  auto stage = [&](int t, int buf) {
    const int l0 = q_first + t * kMmaTile;
    stage_rows<D, LD>(&qs[buf][0][0], qp, p.q_sl, l0, qend, vec);
    stage_rows<D, LD>(&dos[buf][0][0], gp, p.do_sl, l0, qend, vec);
    const int i = tid & (kMmaTile - 1);
    const bool ok = l0 + i < qend;
    const int src = ok ? l0 + i : 0;
    if (tid < kMmaTile) {
      cp_async<4>(&lses[buf][i], lse_bh + src, ok);
      cp_async<4>(&segs[buf][i], seg_b + src, ok);
    } else {
      cp_async<4>(&deltas[buf][i], delta_bh + src, ok);
    }
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
    const int l0 = q_first + t * kMmaTile;
#pragma unroll 1
    for (int c = 0; c < kMmaTile; c += 16) {
      const int32_t sq_l = lane < 16 ? segs[buf][c + lane] : 0;
      if (!__any_sync(0xffffffffu, sq_l != 0 && sq_l >= wlo && sq_l <= whi))
        continue;  // no allowed pair for this warp among these 16 queries
      float s[2][4], dp[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t qb[4], gb[4];
        const int r = c + (lane & 7) + ((lane >> 4) << 3);
        const int col = kk * 16 + ((lane >> 3) & 1) * 8;
        ldsm_x4(qb, &qs[buf][r][col]);
        ldsm_x4(gb, &dos[buf][r][col]);
        mma_bf16(s[0], ka[kk], qb[0], qb[1]);
        mma_bf16(s[1], ka[kk], qb[2], qb[3]);
        mma_bf16(dp[0], va[kk], gb[0], gb[1]);
        mma_bf16(dp[1], va[kk], gb[2], gb[3]);
      }
      float pd[2][4], ds[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = c + n * 8 + 2 * tg + (e & 1);  // query in the tile
          const int i = e >> 1;                        // this thread's key
          // a pad key (sk 0) may match pad queries here: it is zeroed at
          // the end
          const bool allow = segs[buf][j] == sk[i];
          const float pr =
              allow ? ex2_approx(fmaf(s[n][e], p.scale_log2,
                                      -lses[buf][j] * kLog2e))
                    : 0.f;
          float keepf = 1.f;
          if constexpr (DROP) {
            const uint32_t hv = hash_finish(
                p.seed, hkey[i] ^ (static_cast<uint32_t>(l0 + j) * kHashRow));
            keepf = hv >= p.keep_thresh ? p.keep_scale : 0.f;
          }
          pd[n][e] = pr * keepf;
          ds[n][e] = pr * (dp[n][e] * keepf - deltas[buf][j]);
        }
      }
      SplitA<kSplitTerms> pa, sa;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        split_bf16x2(pd[n][0], pd[n][1], pa, 2 * n);
        split_bf16x2(pd[n][2], pd[n][3], pa, 2 * n + 1);
        split_bf16x2(ds[n][0], ds[n][1], sa, 2 * n);
        split_bf16x2(ds[n][2], ds[n][3], sa, 2 * n + 1);
      }
#pragma unroll
      for (int n2 = 0; n2 < (NT + 1) / 2; ++n2) {
        uint32_t qb[4], gb[4];
        const int r = c + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int col = n2 * 16 + (lane >> 4) * 8;
        ldsm_x4_trans(gb, &dos[buf][r][col]);
        ldsm_x4_trans(qb, &qs[buf][r][col]);
        mma_bf16_split(dv[2 * n2], pa, gb[0], gb[1]);
        mma_bf16_split(dk[2 * n2], sa, qb[0], qb[1]);
        if (2 * n2 + 1 < NT) {
          mma_bf16_split(dv[2 * n2 + 1], pa, gb[2], gb[3]);
          mma_bf16_split(dk[2 * n2 + 1], sa, qb[2], qb[3]);
        }
      }
    }
    __syncthreads();  // buf is restaged at t + 2
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (keys[i] >= p.L) continue;
    const int64_t out =
        ((static_cast<int64_t>(b) * p.L + keys[i]) * p.H + h) * D;
    bf16* dkp = static_cast<bf16*>(p.dk) + out;
    bf16* dvp = static_cast<bf16*>(p.dv) + out;
    const bool pad = sk[i] == 0;  // dK = dV = 0 exactly
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = n * 8 + 2 * tg;
      if (col < D) {
        *reinterpret_cast<__nv_bfloat162*>(dkp + col) = __floats2bfloat162_rn(
            pad ? 0.f : dk[n][2 * i] * p.scale,
            pad ? 0.f : dk[n][2 * i + 1] * p.scale);
        *reinterpret_cast<__nv_bfloat162*>(dvp + col) = __floats2bfloat162_rn(
            pad ? 0.f : dv[n][2 * i], pad ? 0.f : dv[n][2 * i + 1]);
      }
    }
  }
}


// The wgmma route (see the header note): shared bytes of a launch at head
// dim D, and the instance.
constexpr int kDkvQueries = 32;  // queries a tile
constexpr int kDkvStages = 3;    // tiles in the ring
template <int D, int STAGES = kDkvStages, int QN = kDkvQueries>
__host__ __device__ constexpr size_t dkv_wgmma_smem() {
  return (2 * kMmaRows * D + STAGES * 2 * QN * D) * sizeof(bf16) +
         STAGES * QN * (2 * sizeof(float) + sizeof(int32_t));
}

template <int D, bool DROP>
__global__ void __launch_bounds__(kMmaThreads)
    attn_bwd_dkv_kernel_wgmma(const BwdParams p, const int vec) {
  constexpr int QN = kDkvQueries;
  constexpr int KD = D / 16;  // k-steps of S^T and dP^T
  extern __shared__ __align__(128) unsigned char wg_smem[];
  bf16* ks = reinterpret_cast<bf16*>(wg_smem);  // [D / 8][64][8]
  bf16* vs = ks + kMmaRows * D;
  bf16* qs = vs + kMmaRows * D;                 // kDkvStages x [D / 8][QN][8]
  bf16* dos = qs + kDkvStages * QN * D;
  float* lses = reinterpret_cast<float*>(dos + kDkvStages * QN * D);  // [stage][QN]
  float* deltas = lses + kDkvStages * QN;
  int32_t* segs = reinterpret_cast<int32_t*>(deltas + kDkvStages * QN);
  __shared__ int32_t wlo_s[4], whi_s[4];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int blk0 = blockIdx.y * kMmaRows;  // the block's first key
  const int key0 = blk0 + warp * 16;       // the warp's first key
  const int32_t* seg_b = p.seg + static_cast<int64_t>(b) * p.L;
  const bf16* qp = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* gp = static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* lse_bh = p.lse + static_cast<int64_t>(bh) * p.L;
  const float* delta_bh = p.delta + static_cast<int64_t>(bh) * p.L;

  // the block's segment-id range (a query tile outside it is skipped) and query range
  const int32_t my_seg = (lane < 16 && key0 + lane < p.L) ? seg_b[key0 + lane] : 0;
  int32_t wlo, whi;
  warp_seg_range(my_seg, &wlo, &whi);
  if (lane == 0) {
    wlo_s[warp] = wlo;
    whi_s[warp] = whi;
  }
  int q_first, q_last;
  other_axis_range(seg_b, p.L, (tid < kMmaRows && blk0 + tid < p.L) ? seg_b[blk0 + tid] : 0,
                   &q_first, &q_last);  // syncs: wlo_s, whi_s are visible
  const int32_t blo = min(min(wlo_s[0], wlo_s[1]), min(wlo_s[2], wlo_s[3]));
  const int32_t bhi = max(max(whi_s[0], whi_s[1]), max(whi_s[2], whi_s[3]));
  const int qend = q_last + 1;
  const int ntiles = (qend - q_first + QN - 1) / QN;  // <= 0: none

  // this thread's two keys (g and g+8 of the warp's 16)
  int keys[2];
  int32_t sk[2], sk_match[2];
  uint32_t hkey[2];  // the dropout hash's (batch*head, key column) terms
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    keys[i] = key0 + g + 8 * i;
    sk[i] = keys[i] < p.L ? seg_b[keys[i]] : 0;
    sk_match[i] = sk[i] != 0 ? sk[i] : -1;  // a pad key pairs with no query
    hkey[i] = ((static_cast<uint32_t>(bh) + p.bh_offset) * kHashBh) ^
              (static_cast<uint32_t>(keys[i]) * kHashCol);
  }
  asm volatile("" : "+r"(hkey[0]), "+r"(hkey[1]));
  float dk[D / 2], dv[D / 2];  // the warp's 16 keys, unscaled (wgmma layout)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  auto stage = [&](int t) {
    const int buf = t % kDkvStages;
    const int l0 = q_first + t * QN;
    stage_tile<D, QN>(qs + buf * QN * D, qp, p.q_sl, l0, qend, vec);
    stage_tile<D, QN>(dos + buf * QN * D, gp, p.do_sl, l0, qend, vec);
    const int i = tid & (QN - 1);
    const bool ok = l0 + i < qend;
    const int src = ok ? l0 + i : 0;
    if (tid < QN) {
      cp_async<4>(&lses[buf * QN + i], lse_bh + src, ok);
      cp_async<4>(&segs[buf * QN + i], seg_b + src, ok);
    } else if (tid < 2 * QN) {
      cp_async<4>(&deltas[buf * QN + i], delta_bh + src, ok);
    }
  };
  stage_tile<D, kMmaRows>(ks, kp, p.k_sl, blk0, p.L, vec);
  stage_tile<D, kMmaRows>(vs, vp, p.v_sl, blk0, p.L, vec);
#pragma unroll
  for (int t = 0; t < kDkvStages - 1; ++t) {
    if (t < ntiles) stage(t);
    cp_async_commit();
  }

  for (int t = 0; t < ntiles; ++t) {
    if (t + kDkvStages - 1 < ntiles) stage(t + kDkvStages - 1);
    cp_async_commit();
    cp_async_wait<kDkvStages - 1>();
    fence_proxy_async();
    const int buf = t % kDkvStages;
    const int32_t* seg_t = segs + buf * QN;
    const int32_t sq_t = tid < QN ? seg_t[tid] : 0;
    if (!__syncthreads_or(sq_t != 0 && sq_t >= blo && sq_t <= bhi))
      continue;  // no allowed pair for the block among these queries
    const bf16* qt = qs + buf * QN * D;
    const bf16* gt = dos + buf * QN * D;
    const float* lse_t = lses + buf * QN;
    const float* delta_t = deltas + buf * QN;
    const int l0 = q_first + t * QN;

    float sc[QN / 2], dp[QN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      Wgmma<QN>::ss(sc, desc_kmajor<kMmaRows>(ks, kk), desc_kmajor<QN>(qt, kk), kk > 0);
      Wgmma<QN>::ss(dp, desc_kmajor<kMmaRows>(vs, kk), desc_kmajor<QN>(gt, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    // P keep/(1-p) in place of S^T, dS in place of dP^T; each of this
    // thread's queries read once for its two keys
#pragma unroll
    for (int n = 0; n < QN / 8; ++n) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = n * 8 + 2 * tg + c;  // query in the tile
        const int32_t sq = seg_t[j];
        const float lse2 = lse_t[j] * kLog2e;
        const float dl = delta_t[j];
        const uint32_t hq = static_cast<uint32_t>(l0 + j) * kHashRow;
#pragma unroll
        for (int i = 0; i < 2; ++i) {      // this thread's key
          const int e = 4 * n + 2 * i + c;
          const float pr =
              sq == sk_match[i] ? ex2_approx(fmaf(sc[e], p.scale_log2, -lse2)) : 0.f;
          float keepf = 1.f;
          if constexpr (DROP) {
            const uint32_t hv = hash_finish(p.seed, hkey[i] ^ hq);
            keepf = hv >= p.keep_thresh ? p.keep_scale : 0.f;
          }
          sc[e] = pr * keepf;
          dp[e] = pr * (dp[e] * keepf - dl);
        }
      }
    }
    SplitA<kSplitTerms> pa[QN / 16], sa[QN / 16];
#pragma unroll
    for (int kk = 0; kk < QN / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split_bf16x2(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1], pa[kk], r);
    wgmma_fence();
    fence_regs(dv);
#pragma unroll
    for (int term = 0; term < kSplitTerms; ++term)
#pragma unroll
      for (int kk = 0; kk < QN / 16; ++kk)
        Wgmma<D>::rs_t(dv, pa[kk].t[term], desc_mnmajor<QN>(gt, kk));
#pragma unroll
    for (int kk = 0; kk < QN / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split_bf16x2(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1], sa[kk], r);
    wgmma_fence();
    fence_regs(dk);
#pragma unroll
    for (int term = 0; term < kSplitTerms; ++term)
#pragma unroll
      for (int kk = 0; kk < QN / 16; ++kk)
        Wgmma<D>::rs_t(dk, sa[kk].t[term], desc_mnmajor<QN>(qt, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    __syncthreads();  // buf is restaged at t + kDkvStages
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (keys[i] >= p.L) continue;
    const int64_t out = ((static_cast<int64_t>(b) * p.L + keys[i]) * p.H + h) * D;
    bf16* dkp = static_cast<bf16*>(p.dk) + out;
    bf16* dvp = static_cast<bf16*>(p.dv) + out;
    const bool pad = sk[i] == 0;  // dK = dV = 0 exactly
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = n * 8 + 2 * tg;
      *reinterpret_cast<__nv_bfloat162*>(dkp + col) = __floats2bfloat162_rn(
          pad ? 0.f : dk[4 * n + 2 * i] * p.scale, pad ? 0.f : dk[4 * n + 2 * i + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvp + col) = __floats2bfloat162_rn(
          pad ? 0.f : dv[4 * n + 2 * i], pad ? 0.f : dv[4 * n + 2 * i + 1]);
    }
  }
}

// The wgmma route at head dim 256 and the wgmma_chunks design above it (see
// the header note): two warpgroups on the block's 64 keys, each holding half
// of the block's columns of dK and dV; warpgroup 0 forms S^T and P,
// warpgroup 1 dP^T and the keep, and each hands the other its half through
// shared memory. Columns a block holds: the whole head dim at 256; above it
// half of it, chunk blockIdx.z of two (D / 2 columns; S^T and dP^T over
// the whole head dim in the blocks of both chunks). Shared bytes of a
// launch: k and v resident, the q/dO ring, and the exchange (P, dP
// keep/(1-p), keep/(1-p): QN / 2 values a thread of a warpgroup each).
constexpr int kDkvHalvesThreads = 256;
__host__ __device__ constexpr int dkv_chunk(int d) { return d > kWgmmaWide ? d / 2 : d; }
// Tiles in the ring: three at 256; two above, where three would pass a
// block's 227 KB at 384 and ran slower at 320 (header note).
__host__ __device__ constexpr int dkv_halves_stages(int d) {
  return d > kWgmmaWide ? 2 : kDkvStages;
}
// Queries a tile: 32 up to 384; 16 above, where a ring of 32-query tiles
// beside k and v would pass a block's 227 KB.
__host__ __device__ constexpr int dkv_halves_queries(int d) {
  return d > 384 ? 16 : kDkvQueries;
}
template <int D>
__host__ __device__ constexpr size_t dkv_halves_smem() {
  return dkv_wgmma_smem<D, dkv_halves_stages(D), dkv_halves_queries(D)>() +
         3 * (dkv_halves_queries(D) / 2) * 128 * sizeof(float);
}

template <int D, bool DROP>
__global__ void __launch_bounds__(kDkvHalvesThreads)
    attn_bwd_dkv_kernel_wgmma_halves(const BwdParams p, const int vec) {
  constexpr int NT = kDkvHalvesThreads;
  constexpr int QN = dkv_halves_queries(D);  // queries a tile
  constexpr int ST = dkv_halves_stages(D);   // tiles in the ring
  constexpr int KD = D / 16;    // k-steps of S^T and dP^T
  constexpr int CW = dkv_chunk(D);   // columns of dK and dV the block holds
  constexpr int HALF = CW / 2;  // columns of dK and dV a warpgroup holds
  constexpr int NE = QN / 2;    // elements of S^T (dP^T) a thread holds
  static_assert(HALF <= 128 && HALF % 16 == 0, "one m64nHALF product a half");
  extern __shared__ __align__(128) unsigned char wg_smem[];
  bf16* ks = reinterpret_cast<bf16*>(wg_smem);  // [D / 8][64][8]
  bf16* vs = ks + kMmaRows * D;
  bf16* qs = vs + kMmaRows * D;                 // ST x [D / 8][QN][8]
  bf16* dos = qs + ST * QN * D;
  float* lses = reinterpret_cast<float*>(dos + ST * QN * D);  // [stage][QN]
  float* deltas = lses + ST * QN;
  int32_t* segs = reinterpret_cast<int32_t*>(deltas + ST * QN);
  float* xp = reinterpret_cast<float*>(segs + ST * QN);  // [NE][128]: P
  float* xd = xp + NE * 128;                                     // dP keep/(1-p)
  float* xk = xd + NE * 128;                                     // keep/(1-p)
  __shared__ int32_t wlo_s[NT / 32], whi_s[NT / 32];

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
  const int blk0 = blockIdx.y * kMmaRows;     // the block's first key
  const int key0 = blk0 + (warp & 3) * 16;    // the warp's first key
  const int32_t* seg_b = p.seg + static_cast<int64_t>(b) * p.L;
  const bf16* qp = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* gp = static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* lse_bh = p.lse + static_cast<int64_t>(bh) * p.L;
  const float* delta_bh = p.delta + static_cast<int64_t>(bh) * p.L;

  // the block's segment-id range (a query tile outside it is skipped) and query range
  const int32_t my_seg = (lane < 16 && key0 + lane < p.L) ? seg_b[key0 + lane] : 0;
  int32_t wlo, whi;
  warp_seg_range(my_seg, &wlo, &whi);
  if (lane == 0) {
    wlo_s[warp] = wlo;
    whi_s[warp] = whi;
  }
  int q_first, q_last;
  other_axis_range(seg_b, p.L,
                   (tid < kMmaRows && blk0 + tid < p.L) ? seg_b[blk0 + tid] : 0, &q_first,
                   &q_last);  // syncs: wlo_s, whi_s are visible
  const int32_t blo = min(min(wlo_s[0], wlo_s[1]), min(wlo_s[2], wlo_s[3]));
  const int32_t bhi = max(max(whi_s[0], whi_s[1]), max(whi_s[2], whi_s[3]));
  const int qend = q_last + 1;
  const int ntiles = (qend - q_first + QN - 1) / QN;  // <= 0: none

  // this thread's two keys (g and g+8 of the warp's 16)
  int keys[2];
  int32_t sk[2], sk_match[2];
  uint32_t hkey[2];  // the dropout hash's (batch*head, key column) terms
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    keys[i] = key0 + g + 8 * i;
    sk[i] = keys[i] < p.L ? seg_b[keys[i]] : 0;
    sk_match[i] = sk[i] != 0 ? sk[i] : -1;  // a pad key pairs with no query
    hkey[i] = ((static_cast<uint32_t>(bh) + p.bh_offset) * kHashBh) ^
              (static_cast<uint32_t>(keys[i]) * kHashCol);
  }
  asm volatile("" : "+r"(hkey[0]), "+r"(hkey[1]));
  float dk[HALF / 2], dv[HALF / 2];  // this warpgroup's half, unscaled (wgmma layout)
#pragma unroll
  for (int i = 0; i < HALF / 2; ++i) dk[i] = dv[i] = 0.f;

  auto stage = [&](int t) {
    const int buf = t % ST;
    const int l0 = q_first + t * QN;
    stage_tile<D, QN, NT>(qs + buf * QN * D, qp, p.q_sl, l0, qend, vec);
    stage_tile<D, QN, NT>(dos + buf * QN * D, gp, p.do_sl, l0, qend, vec);
    const int i = tid & (QN - 1);
    const bool ok = l0 + i < qend;
    const int src = ok ? l0 + i : 0;
    if (tid < QN) {
      cp_async<4>(&lses[buf * QN + i], lse_bh + src, ok);
      cp_async<4>(&segs[buf * QN + i], seg_b + src, ok);
    } else if (tid < 2 * QN) {
      cp_async<4>(&deltas[buf * QN + i], delta_bh + src, ok);
    }
  };
  stage_tile<D, kMmaRows, NT>(ks, kp, p.k_sl, blk0, p.L, vec);
  stage_tile<D, kMmaRows, NT>(vs, vp, p.v_sl, blk0, p.L, vec);
#pragma unroll
  for (int t = 0; t < ST - 1; ++t) {
    if (t < ntiles) stage(t);
    cp_async_commit();
  }
  // this warpgroup's operand of the first products, and its half of q and dO
  const bf16* kvs = wg == 0 ? ks : vs;
  // this warpgroup's first column (chunk blockIdx.z above 256) and its
  // offset in a q/dO tile
  const int chunk = D > kWgmmaWide ? blockIdx.z : 0;
  const int col0 = chunk * CW + wg * HALF;
  const int half0 = (chunk * (CW / 8) + wg * (HALF / 8)) * QN * 8;

  for (int t = 0; t < ntiles; ++t) {
    if (t + ST - 1 < ntiles) stage(t + ST - 1);
    cp_async_commit();
    cp_async_wait<ST - 1>();
    fence_proxy_async();
    const int buf = t % ST;
    const int32_t* seg_t = segs + buf * QN;
    const int32_t sq_t = tid < QN ? seg_t[tid] : 0;
    if (!__syncthreads_or(sq_t != 0 && sq_t >= blo && sq_t <= bhi))
      continue;  // no allowed pair for the block among these queries
    const bf16* qt = qs + buf * QN * D;
    const bf16* gt = dos + buf * QN * D;
    const float* lse_t = lses + buf * QN;
    const float* delta_t = deltas + buf * QN;
    const int l0 = q_first + t * QN;

    // warpgroup 0: S^T = k q^T; warpgroup 1: dP^T = v dO^T
    float x[NE];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      Wgmma<QN>::ss(x, desc_kmajor<kMmaRows>(kvs, kk), desc_kmajor<QN>(wg == 0 ? qt : gt, kk),
                    kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(x);

    // warpgroup 0: P in place of S^T; warpgroup 1: dP^T keep/(1-p), and the
    // keep; each into the exchange
    if (wg == 0) {
#pragma unroll
      for (int n = 0; n < QN / 8; ++n) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = n * 8 + 2 * tg + c;  // query in the tile
          const int32_t sq = seg_t[j];
          const float lse2 = lse_t[j] * kLog2e;
#pragma unroll
          for (int i = 0; i < 2; ++i) {      // this thread's key
            const int e = 4 * n + 2 * i + c;
            x[e] = sq == sk_match[i] ? ex2_approx(fmaf(x[e], p.scale_log2, -lse2)) : 0.f;
            xp[e * 128 + tl] = x[e];
          }
        }
      }
    } else {
#pragma unroll
      for (int n = 0; n < QN / 8; ++n) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const uint32_t hq = static_cast<uint32_t>(l0 + n * 8 + 2 * tg + c) * kHashRow;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = 4 * n + 2 * i + c;
            if constexpr (DROP) {
              const uint32_t hv = hash_finish(p.seed, hkey[i] ^ hq);
              const float keepf = hv >= p.keep_thresh ? p.keep_scale : 0.f;
              x[e] *= keepf;
              xk[e * 128 + tl] = keepf;
            }
            xd[e * 128 + tl] = x[e];
          }
        }
      }
    }
    __syncthreads();  // the exchange is written

    // both: P keep/(1-p) in x, dS = P (dP keep/(1-p) - delta) in y
    float y[NE];
#pragma unroll
    for (int n = 0; n < QN / 8; ++n) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float dl = delta_t[n * 8 + 2 * tg + c];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = 4 * n + 2 * i + c;
          const float pr = wg == 0 ? x[e] : xp[e * 128 + tl];
          const float dpk = wg == 0 ? xd[e * 128 + tl] : x[e];
          x[e] = DROP ? pr * xk[e * 128 + tl] : pr;
          y[e] = pr * (dpk - dl);
        }
      }
    }
    SplitA<kSplitTerms> pa[QN / 16], sa[QN / 16];
#pragma unroll
    for (int kk = 0; kk < QN / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split_bf16x2(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1], pa[kk], r);
    wgmma_fence();
    fence_regs(dv);
#pragma unroll
    for (int term = 0; term < kSplitTerms; ++term)
#pragma unroll
      for (int kk = 0; kk < QN / 16; ++kk)
        Wgmma<HALF>::rs_t(dv, pa[kk].t[term], desc_mnmajor<QN>(gt + half0, kk));
#pragma unroll
    for (int kk = 0; kk < QN / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split_bf16x2(y[8 * kk + 2 * r], y[8 * kk + 2 * r + 1], sa[kk], r);
    wgmma_fence();
    fence_regs(dk);
#pragma unroll
    for (int term = 0; term < kSplitTerms; ++term)
#pragma unroll
      for (int kk = 0; kk < QN / 16; ++kk)
        Wgmma<HALF>::rs_t(dk, sa[kk].t[term], desc_mnmajor<QN>(qt + half0, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    __syncthreads();  // buf is restaged at t + ST; the exchange is read
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (keys[i] >= p.L) continue;
    const int64_t out = ((static_cast<int64_t>(b) * p.L + keys[i]) * p.H + h) * D + col0;
    bf16* dkp = static_cast<bf16*>(p.dk) + out;
    bf16* dvp = static_cast<bf16*>(p.dv) + out;
    const bool pad = sk[i] == 0;  // dK = dV = 0 exactly
#pragma unroll
    for (int n = 0; n < HALF / 8; ++n) {
      const int col = n * 8 + 2 * tg;
      *reinterpret_cast<__nv_bfloat162*>(dkp + col) = __floats2bfloat162_rn(
          pad ? 0.f : dk[4 * n + 2 * i] * p.scale, pad ? 0.f : dk[4 * n + 2 * i + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvp + col) = __floats2bfloat162_rn(
          pad ? 0.f : dv[4 * n + 2 * i], pad ? 0.f : dv[4 * n + 2 * i + 1]);
    }
  }
}

// The f32 route (see the header note): one key per thread.
template <int D>
__global__ void __launch_bounds__(kF32Rows, f32_min_blocks(D))
    attn_bwd_dkv_kernel_f32(const BwdParams p) {
  constexpr int T = f32_tile(D);  // queries per shared-memory tile
  __shared__ __align__(16) float qs[T][D];
  __shared__ __align__(16) float dos[T][D];
  __shared__ float lse2s[T];
  __shared__ float deltas[T];
  __shared__ int32_t segs[T];

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int col = blockIdx.y * kF32Rows + threadIdx.x;
  const bool in_range = col < p.L;
  const int32_t* seg_b = p.seg + static_cast<int64_t>(b) * p.L;
  const int32_t sk = in_range ? seg_b[col] : 0;

  float kr[D];  // k * scale * log2(e)
  float vr[D];
  float dk[D];  // unscaled
  float dv[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    kr[d] = 0.f;
    vr[d] = 0.f;
    dk[d] = 0.f;
    dv[d] = 0.f;
  }
  if (sk != 0) {
    const float* kp = static_cast<const float*>(p.k) + b * p.k_sb +
                      col * p.k_sl + h * p.k_sh;
    const float* vp = static_cast<const float*>(p.v) + b * p.v_sb +
                      col * p.v_sl + h * p.v_sh;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      kr[d] = kp[d] * p.scale_log2;
      vr[d] = vp[d];
    }
  }

  int q_first, q_last;
  other_axis_range(seg_b, p.L, sk, &q_first, &q_last);
  const int qend = q_last + 1;

  const float* qp = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* gp = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* lse_bh = p.lse + static_cast<int64_t>(bh) * p.L;
  const float* delta_bh = p.delta + static_cast<int64_t>(bh) * p.L;
  for (int l0 = q_first; l0 < qend; l0 += T) {
    for (int i = threadIdx.x; i < T; i += kF32Rows)
      segs[i] = (l0 + i < qend) ? seg_b[l0 + i] : 0;
    __syncthreads();
    bool mine = false;
    if (sk != 0) {
#pragma unroll
      for (int i = 0; i < T; ++i) mine |= (segs[i] == sk);
    }
    if (__syncthreads_or(mine)) {
      for (int e = threadIdx.x; e < T * D; e += kF32Rows) {
        const int i = e / D;
        const int d = e - i * D;
        const bool ok = l0 + i < qend;
        const int64_t r = l0 + i;
        qs[i][d] = ok ? qp[r * p.q_sl + d] : 0.f;
        dos[i][d] = ok ? gp[r * p.do_sl + d] : 0.f;
      }
      for (int i = threadIdx.x; i < T; i += kF32Rows) {
        const bool ok = l0 + i < qend;
        lse2s[i] = ok ? lse_bh[l0 + i] * kLog2e : 0.f;
        deltas[i] = ok ? delta_bh[l0 + i] : 0.f;
      }
      __syncthreads();
      if (mine) {
#pragma unroll 2
        for (int i = 0; i < T; ++i) {
          if (segs[i] != sk) continue;  // sk != 0, so a pad query never matches
          float dot = 0.f;
          float dp = 0.f;
#pragma unroll
          for (int d = 0; d < D; ++d) {
            dot = fmaf(kr[d], qs[i][d], dot);
            dp = fmaf(vr[d], dos[i][d], dp);
          }
          const float pi = exp2f(dot - lse2s[i]);
          float pd = pi;  // the dropped probability (dV path)
          if (p.dropout) {
            const uint32_t hv = hash_u32(p.seed, static_cast<uint32_t>(bh) + p.bh_offset,
                                         static_cast<uint32_t>(l0 + i),
                                         static_cast<uint32_t>(col));
            const float keepf = hv >= p.keep_thresh ? p.keep_scale : 0.f;
            pd = pi * keepf;
            dp *= keepf;
          }
          const float ds = pi * (dp - deltas[i]);
#pragma unroll
          for (int d = 0; d < D; ++d) {
            dv[d] = fmaf(pd, dos[i][d], dv[d]);
            dk[d] = fmaf(ds, qs[i][d], dk[d]);
          }
        }
      }
    }
    __syncthreads();  // tiles are overwritten by the next iteration
  }

  if (!in_range) return;
  const int64_t out = ((static_cast<int64_t>(b) * p.L + col) * p.H + h) * D;
  float* dkp = static_cast<float*>(p.dk) + out;
  float* dvp = static_cast<float*>(p.dv) + out;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    dkp[d] = dk[d] * p.scale;
    dvp[d] = dv[d];
  }
}

// The wide route (see the header note): 32 keys a block (a key a lane),
// one chunk of 128 columns of dK and dV (grid z), 32 columns a warp.
template <typename T>
__global__ void __launch_bounds__(128) attn_bwd_dkv_kernel_wide(const BwdParams p, const int D) {
  __shared__ __align__(16) float qs[kWideTile][kWideChunk];
  __shared__ __align__(16) float dos[kWideTile][kWideChunk];
  __shared__ float red_s[kWideSplit][kWideTile][kWideRows];
  __shared__ float red_dp[kWideSplit][kWideTile][kWideRows];
  __shared__ float lse2s[kWideTile];
  __shared__ float deltas[kWideTile];
  __shared__ int32_t segs[kWideTile];

  const int nc = gridDim.z;
  const int z = blockIdx.z;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int key = blockIdx.y * kWideRows + (threadIdx.x & 31);
  const bool in_range = key < p.L;
  const int32_t* seg_b = p.seg + static_cast<int64_t>(b) * p.L;
  const int32_t sk = in_range ? seg_b[key] : 0;
  const int32_t sk_match = sk != 0 ? sk : -1;  // a pad key pairs with no query
  const T* krow = sk != 0 ? static_cast<const T*>(p.k) + b * p.k_sb + key * p.k_sl + h * p.k_sh
                          : nullptr;
  const T* vrow = sk != 0 ? static_cast<const T*>(p.v) + b * p.v_sb + key * p.v_sl + h * p.v_sh
                          : nullptr;

  float kr[kWideCols], vr[kWideCols], dk[kWideCols], dv[kWideCols];
#pragma unroll
  for (int i = 0; i < kWideCols; ++i) dk[i] = dv[i] = 0.f;
  if (nc == 1) {
    load_wide(kr, krow, 0, D);
    load_wide(vr, vrow, 0, D);
  }

  int q_first, q_last;
  other_axis_range(seg_b, p.L, threadIdx.x < kWideRows ? sk : 0, &q_first, &q_last);
  const int qend = q_last + 1;
  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* gp = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* lse_bh = p.lse + static_cast<int64_t>(bh) * p.L;
  const float* delta_bh = p.delta + static_cast<int64_t>(bh) * p.L;
  for (int l0 = q_first; l0 < qend; l0 += kWideTile) {
    const int i = threadIdx.x;
    if (i < kWideTile) {
      const bool ok = l0 + i < qend;
      segs[i] = ok ? seg_b[l0 + i] : 0;
      lse2s[i] = ok ? lse_bh[l0 + i] * kLog2e : 0.f;
      deltas[i] = ok ? delta_bh[l0 + i] : 0.f;
    }
    __syncthreads();
    bool mine = false;
#pragma unroll
    for (int j = 0; j < kWideTile; ++j) mine |= segs[j] == sk_match;
    if (!__syncthreads_or(mine)) continue;  // no allowed pair in the block
    float sc[kWideTile], dp[kWideTile];
#pragma unroll
    for (int j = 0; j < kWideTile; ++j) sc[j] = dp[j] = 0.f;
    for (int c = 0; c < nc; ++c) {
      const int chunk = (z + 1 + c) % nc;  // chunk z last: it stays staged
      if (c > 0) __syncthreads();          // the previous chunk is read
      stage_wide(qs, qp, p.q_sl, l0, qend, chunk, D);
      stage_wide(dos, gp, p.do_sl, l0, qend, chunk, D);
      if (nc > 1) {
        load_wide(kr, krow, chunk, D);
        load_wide(vr, vrow, chunk, D);
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kWideTile; ++j) {
        sc[j] += wide_dot(kr, qs[j]);
        dp[j] += wide_dot(vr, dos[j]);
      }
    }
    wide_reduce(sc, red_s);
    wide_reduce(dp, red_dp);
#pragma unroll
    for (int j = 0; j < kWideTile; ++j) {
      if (segs[j] != sk_match) continue;
      const float pj = exp2f(fmaf(sc[j], p.scale_log2, -lse2s[j]));
      float pd = pj;  // the dropped probability (dV path)
      float dpj = dp[j];
      if (p.dropout) {
        const uint32_t hv = hash_u32(p.seed, static_cast<uint32_t>(bh) + p.bh_offset,
                                     static_cast<uint32_t>(l0 + j),
                                     static_cast<uint32_t>(key));
        const float keepf = hv >= p.keep_thresh ? p.keep_scale : 0.f;
        pd = pj * keepf;
        dpj *= keepf;
      }
      wide_axpy(dv, pd, dos[j]);
      wide_axpy(dk, pj * (dpj - deltas[j]), qs[j]);
    }
    __syncthreads();  // the tiles are restaged by the next iteration
  }
  if (!in_range) return;
  const int64_t out = ((static_cast<int64_t>(b) * p.L + key) * p.H + h) * D;
  store_wide(static_cast<T*>(p.dk) + out, dk, z, D, p.scale);
  store_wide(static_cast<T*>(p.dv) + out, dv, z, D, 1.f);
}

// The instance of `design` at (head dim D, dropout), nullptr where this
// source has none; the wide route is `wide_kernel`.
template <int D>
const void* kernel_of(int design, int dropout) {
  if constexpr (D > 128) {
    if (design == (D > kWgmmaWide ? kDesignWgmmaChunks : kDesignWgmma))
      return dropout ? reinterpret_cast<const void*>(attn_bwd_dkv_kernel_wgmma_halves<D, true>)
                     : reinterpret_cast<const void*>(attn_bwd_dkv_kernel_wgmma_halves<D, false>);
    return nullptr;
  } else if constexpr (D >= 64) {
    if (design == kDesignWgmma)
      return dropout ? reinterpret_cast<const void*>(attn_bwd_dkv_kernel_wgmma<D, true>)
                     : reinterpret_cast<const void*>(attn_bwd_dkv_kernel_wgmma<D, false>);
  } else {
    if (design == kDesignMma)
      return dropout ? reinterpret_cast<const void*>(attn_bwd_dkv_kernel_mma<D, true>)
                     : reinterpret_cast<const void*>(attn_bwd_dkv_kernel_mma<D, false>);
  }
  if constexpr (D < 128)
    if (design == kDesignF32) return reinterpret_cast<const void*>(attn_bwd_dkv_kernel_f32<D>);
  return nullptr;
}
template <int D>
constexpr size_t dyn_smem_of() {
  if constexpr (D > 128) return dkv_halves_smem<D>();
  if constexpr (D >= 64) return dkv_wgmma_smem<D>();
  return mma_dyn_smem<mma_ld(D)>();
}
const void* wide_kernel(int is_bf16) {
  return is_bf16 ? reinterpret_cast<const void*>(attn_bwd_dkv_kernel_wide<bf16>)
                 : reinterpret_cast<const void*>(attn_bwd_dkv_kernel_wide<float>);
}

template <int D>
int launch(const BwdParams& p, int design, cudaStream_t stream) {
  if (kernel_of<D>(design, p.dropout) == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (design != kDesignF32) {
    const int vec = rows_vectorizable(p.q, p.q_sb, p.q_sl, p.q_sh, D) &&
                    rows_vectorizable(p.dout, p.do_sb, p.do_sl, p.do_sh, D) &&
                    (D < 64 || (rows_vectorizable(p.k, p.k_sb, p.k_sl, p.k_sh, D) &&
                                rows_vectorizable(p.v, p.v_sb, p.v_sl, p.v_sh, D)));
    const dim3 grid(p.B * p.H, (p.L + kMmaRows - 1) / kMmaRows, D / dkv_chunk(D));
    constexpr size_t smem = dyn_smem_of<D>();
    if constexpr (D > 128) {
      if (p.dropout)
        launch_dyn(attn_bwd_dkv_kernel_wgmma_halves<D, true>, grid, kDkvHalvesThreads, smem,
                   stream, p, vec);
      else
        launch_dyn(attn_bwd_dkv_kernel_wgmma_halves<D, false>, grid, kDkvHalvesThreads, smem,
                   stream, p, vec);
    } else if constexpr (D >= 64) {
      if (p.dropout)
        launch_dyn(attn_bwd_dkv_kernel_wgmma<D, true>, grid, kMmaThreads, smem, stream, p, vec);
      else
        launch_dyn(attn_bwd_dkv_kernel_wgmma<D, false>, grid, kMmaThreads, smem, stream, p, vec);
    } else {
      if (p.dropout)
        launch_dyn(attn_bwd_dkv_kernel_mma<D, true>, grid, kMmaThreads, smem, stream, p, vec);
      else
        launch_dyn(attn_bwd_dkv_kernel_mma<D, false>, grid, kMmaThreads, smem, stream, p, vec);
    }
  } else if constexpr (D < 128) {
    const dim3 grid(p.B * p.H, (p.L + kF32Rows - 1) / kF32Rows);
    attn_bwd_dkv_kernel_f32<D><<<grid, kF32Rows, 0, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

int dispatch_d(int head_dim, int is_bf16, int design, const BwdParams& p,
               cudaStream_t stream) {
  if (!design_takes(design, is_bf16)) return static_cast<int>(cudaErrorInvalidValue);
  if (design == kDesignWide) {
    const dim3 grid(p.B * p.H, (p.L + kWideRows - 1) / kWideRows, wide_chunks(head_dim));
    if (is_bf16)
      attn_bwd_dkv_kernel_wide<bf16><<<grid, 128, 0, stream>>>(p, head_dim);
    else
      attn_bwd_dkv_kernel_wide<float><<<grid, 128, 0, stream>>>(p, head_dim);
    return static_cast<int>(cudaGetLastError());
  }
  return with_chunks_head_dim(head_dim, design, [&](auto d) {
    return launch<decltype(d)::value>(p, design, stream);
  });
}

}  // namespace

// Plain C entry point (bound with ctypes). Reads delta, writes dk and dv.
// Returns cudaGetLastError() after the launch, which is asynchronous on
// `stream`.
extern "C" int flash_attn_bwd_dkv(const flash::BwdParams* params, int head_dim,
                                  int is_bf16, int design, void* stream) {
  flash::BwdParams p = *params;
  p.scale_log2 = p.scale * flash::kLog2e;
  return dispatch_d(head_dim, is_bf16, design, p, static_cast<cudaStream_t>(stream));
}

// The resources of the instance of `design` a launch at (head_dim,
// is_bf16, dropout) runs: out[4] = static shared bytes, dynamic shared
// bytes, registers a thread, local (spilled) bytes a thread. Returns a
// cudaError_t.
extern "C" int flash_attn_bwd_dkv_attrs(int head_dim, int is_bf16, int design, int dropout,
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

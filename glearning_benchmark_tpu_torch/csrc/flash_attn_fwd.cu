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
// never the limit at head dims 4-64.
//
// Design, bf16 (the tensor-core route). Nothing of the Pallas grid carries
// over (a sequential key axis with VMEM carries, Z=8 folded batch*head
// rows). One block of 4 warps owns 64 query rows of one batch*head, 16 a
// warp: the M of mma.sync.m16n8k16 (bf16 in, f32 accumulate).
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
//     p v cancels, so P~ is split into bf16 hi + lo and both are multiplied
//     (about 2^-17; tests/test_torch_attention.py emulates both ways).
//   - Epilogue: l summed across the quad in a fixed order, O = acc / l cast
//     to bf16 and staged in shared memory, then stored in 16-byte pieces
//     (8 at D = 4), pad rows as exact zeros; LSE = m + log l in f32.
// A row's result depends on its own sequence alone (no atomics, fixed
// order), so it is the same in batches of any size.
//
// Why mma.sync and not wgmma/TMA. wgmma's unit is a 64-row warpgroup tile
// fed from shared memory, and TMA pays off on large tiles. At head dims
// 4-16 every product is one 16-deep k-step and the tensor cores idle most
// of the time anyway: what limits the kernel is the elementwise work
// between the products (mask, max, exp, hash) and the bytes. Warp-level
// mma lets each warp skip the keys its own 16 rows may not attend and keeps
// P in registers between the two products.
//
// f32 (the FP32-pipe route). Tensor cores take no f32 input, and TF32 would
// not hold f32 accuracy. One block of 128 threads takes 128 query rows, one
// per thread, with q, the output accumulator and (m, l) in f32 registers,
// and loops over key tiles of 64 staged in shared memory as f32 (every
// thread reads the same key: broadcasts), in online-softmax chunks of 16
// keys; it skips tiles and query blocks the mask rules out the same way.

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
  constexpr int LD = DP + 8;           // shared row stride: no bank conflicts
  __shared__ __align__(16) bf16 ks[2][kMmaTile][LD];
  __shared__ __align__(16) bf16 vs[2][kMmaTile][LD];
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
      uint32_t ph[4], pl[4];
      split_bf16x2(s[0][0], s[0][1], ph[0], pl[0]);
      split_bf16x2(s[0][2], s[0][3], ph[1], pl[1]);
      split_bf16x2(s[1][0], s[1][1], ph[2], pl[2]);
      split_bf16x2(s[1][2], s[1][3], ph[3], pl[3]);
#pragma unroll
      for (int n2 = 0; n2 < (NT + 1) / 2; ++n2) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, &vs[buf][c + (lane & 7) + ((lane >> 3) & 1) * 8]
                             [n2 * 16 + (lane >> 4) * 8]);
        mma_bf16(acc[2 * n2], ph, vb[0], vb[1]);
        mma_bf16(acc[2 * n2], pl, vb[0], vb[1]);
        if (2 * n2 + 1 < NT) {
          mma_bf16(acc[2 * n2 + 1], ph, vb[2], vb[3]);
          mma_bf16(acc[2 * n2 + 1], pl, vb[2], vb[3]);
        }
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

// The f32 route (see the header note): one query row per thread.
template <int D, int MIN_BLOCKS>
__global__ void __launch_bounds__(kF32Rows, MIN_BLOCKS)
    attn_fwd_kernel_f32(const Params p) {
  __shared__ __align__(16) float ks[kF32Tile][D];
  __shared__ __align__(16) float vs[kF32Tile][D];
  __shared__ int32_t segs[kF32Tile];

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
  for (int s0 = k_first; s0 < kend; s0 += kF32Tile) {
    for (int j = threadIdx.x; j < kF32Tile; j += kF32Rows)
      segs[j] = (s0 + j < kend) ? seg_b[s0 + j] : 0;
    __syncthreads();
    bool mine = false;
    if (sq != 0) {
#pragma unroll
      for (int j = 0; j < kF32Tile; ++j) mine |= (segs[j] == sq);
    }
    if (__syncthreads_or(mine)) {
      for (int e = threadIdx.x; e < kF32Tile * D; e += kF32Rows) {
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
        for (int c = 0; c < kF32Tile; c += kChunk) {
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

template <int D>
void launch(const Params& p, int is_bf16, cudaStream_t stream) {
  if (is_bf16) {
    const int vec = rows_vectorizable(p.k, p.k_sb, p.k_sl, p.k_sh, D) &&
                    rows_vectorizable(p.v, p.v_sb, p.v_sl, p.v_sh, D);
    const dim3 grid(p.B * p.H, (p.L + kMmaRows - 1) / kMmaRows);
    if (p.dropout)
      attn_fwd_kernel_mma<D, true><<<grid, kMmaThreads, 0, stream>>>(p, vec);
    else
      attn_fwd_kernel_mma<D, false><<<grid, kMmaThreads, 0, stream>>>(p, vec);
  } else {
    // head dims up to 16 fit four blocks (16 warps) per SM in registers
    constexpr int kMinBlocks = D <= 16 ? 4 : 1;
    const dim3 grid(p.B * p.H, (p.L + kF32Rows - 1) / kF32Rows);
    attn_fwd_kernel_f32<D, kMinBlocks><<<grid, kF32Rows, 0, stream>>>(p);
  }
}

int dispatch_d(int head_dim, const Params& p, int is_bf16, cudaStream_t stream) {
  switch (head_dim) {
    case 4: launch<4>(p, is_bf16, stream); break;
    case 8: launch<8>(p, is_bf16, stream); break;
    case 16: launch<16>(p, is_bf16, stream); break;
    case 32: launch<32>(p, is_bf16, stream); break;
    case 64: launch<64>(p, is_bf16, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
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
                              float scale, int dropout, uint32_t seed,
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
  return dispatch_d(head_dim, p, is_bf16, static_cast<cudaStream_t>(stream));
}

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
// rows ([49, 256, 4, 16], a few segments of ~91 tokens a row) the least
// time is set by bytes (q, k, v, dO, O read; dQ, delta written: ~3 us);
// the tensor-core FLOPs take well under a microsecond. What this kernel
// reaches there is set by the per-pair elementwise work (mask, exp2,
// hash), by the masked pairs inside the 16 x 16 tiles a warp computes, and
// by the fixed cost of a launch and its prologue (a third of the time at
// those rows; PERF.md), not by tensor-core rate.
//
// Design, bf16 (the tensor-core route). Nothing of the Pallas grid carries
// over (a sequential key axis with a VMEM carry, Z=8 folded batch*head
// rows). One block of 4 warps owns 64 query rows of one batch*head, 16 a
// warp: the M of mma.sync.m16n8k16 (bf16 in, f32 accumulate). Each warp
// keeps its q and dO rows as A fragments in registers (head dims 4 and 8
// zero-padded to the mma depth 16 in registers and shared memory only,
// never in HBM). The block loops over key tiles of 64 inside its segment
// range (`other_axis_range`); K and V are staged in shared memory as bf16
// by cp.async, double-buffered, rows padded by 8 bf16 so that ldmatrix is
// free of bank conflicts. Per 16 keys a warp:
//   - skips the 16 keys unless one of them lies in the warp's segment-id
//     range (a warp with no allowed pair issues no mma for them);
//   - S = q k^T and dP = dO v^T: mma with K and V as B operands (ldmatrix);
//   - P = exp2(S scale log2e - LSE log2e), the segment mask, the dropout
//     hash and dS = P (dP - delta) in the accumulator registers;
//   - dQ += dS K with dS straight from registers as the A operand (the
//     accumulators of two n-tiles are the A fragment of one k-step) and K
//     through ldmatrix.trans: no shared-memory round trip. dS is not bf16:
//     rounding it would cost 2^-9 relative where gradients cancel, beyond
//     the elementwise 4e-3 the kernel is held to. So dS is split into bf16
//     hi + lo and both are multiplied (about 2^-17 relative), at head dims
//     64 and 128 into hi + mid + lo (about 2^-25; `split_terms`); the
//     tensor cores have room for the second product.
// dQ is accumulated unscaled and multiplied by `scale` once before the
// cast. delta is summed by two lanes a row over dO and O in the prologue.
//
// Why mma.sync and not wgmma/TMA. wgmma's unit is a 64-row warpgroup tile
// fed from shared memory, and TMA pays off on large tiles; at head dims
// 4-16 every product is one 16-deep k-step, the tensor cores idle most of
// the time anyway, and what limits the kernel is the elementwise work
// between the products. Warp-level mma lets each warp skip the keys its
// own 16 rows may not attend and keeps P and dS in registers between the
// products.
//
// Head dims. 4, 8, 16, 32, 64 and 128 have instances (`with_head_dim`); the
// wrapper zero-pads any other head dim up to 128 to the next of them and
// hands the kernel the scale of the true one. At 128 the bf16 route's two
// double-buffered tiles take 69,632 bytes, past the 48 KB of static shared
// memory, so that route keeps them in dynamic shared memory there
// (`MmaTiles`, `launch_dyn`); the f32 route's tiles shrink to 32
// rows there (`f32_tile`) and its per-thread arrays of 128 floats spill to
// local memory: right, not fast (PERF.md gives the times).
//
// f32 (the FP32-pipe route). Tensor cores take no f32 input, and TF32
// would not hold f32 accuracy. One block of 128 threads owns 128 query
// rows, one per thread, with q, dO and the dQ accumulator in f32 registers,
// and loops over key tiles of 64 staged in shared memory as f32 (every
// thread reads the same key: broadcasts); a (row, key) pair of different
// segments costs one compare.

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
      SplitA<split_terms(D)> sa;
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

// The instance a launch runs (its dynamic shared bytes: bf16 route).
template <int D>
const void* kernel_of(int is_bf16, int dropout) {
  if (!is_bf16) return reinterpret_cast<const void*>(attn_bwd_dq_kernel_f32<D>);
  return dropout ? reinterpret_cast<const void*>(attn_bwd_dq_kernel_mma<D, true>)
                 : reinterpret_cast<const void*>(attn_bwd_dq_kernel_mma<D, false>);
}

template <int D>
void launch(const BwdParams& p, int is_bf16, cudaStream_t stream) {
  if (is_bf16) {
    const int vec = rows_vectorizable(p.k, p.k_sb, p.k_sl, p.k_sh, D) &&
                    rows_vectorizable(p.v, p.v_sb, p.v_sl, p.v_sh, D);
    const dim3 grid(p.B * p.H, (p.L + kMmaRows - 1) / kMmaRows);
    constexpr size_t smem = mma_dyn_smem<mma_ld(D)>();
    if (p.dropout)
      launch_dyn(attn_bwd_dq_kernel_mma<D, true>, grid, kMmaThreads, smem, stream, p, vec);
    else
      launch_dyn(attn_bwd_dq_kernel_mma<D, false>, grid, kMmaThreads, smem, stream, p, vec);
  } else {
    const dim3 grid(p.B * p.H, (p.L + kF32Rows - 1) / kF32Rows);
    attn_bwd_dq_kernel_f32<D><<<grid, kF32Rows, 0, stream>>>(p);
  }
}

int dispatch_d(int head_dim, const BwdParams& p, int is_bf16,
               cudaStream_t stream) {
  return with_head_dim(head_dim, [&](auto d) {
    launch<decltype(d)::value>(p, is_bf16, stream);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

// Plain C entry point (bound with ctypes). Writes dq and delta. Returns
// cudaGetLastError() after the launch, which is asynchronous on `stream`.
extern "C" int flash_attn_bwd_dq(const flash::BwdParams* params, int head_dim,
                                 int is_bf16, void* stream) {
  flash::BwdParams p = *params;
  p.scale_log2 = p.scale * flash::kLog2e;
  return dispatch_d(head_dim, p, is_bf16, static_cast<cudaStream_t>(stream));
}

// The resources of the instance a launch at (head_dim, is_bf16, dropout)
// runs: out[4] = static shared bytes, dynamic shared bytes, registers a
// thread, local (spilled) bytes a thread. Returns a cudaError_t.
extern "C" int flash_attn_bwd_dq_attrs(int head_dim, int is_bf16, int dropout,
                                       int* out) {
  return flash::with_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    return flash::func_attrs(
        kernel_of<D>(is_bf16, dropout),
        is_bf16 ? static_cast<int>(flash::mma_dyn_smem<flash::mma_ld(D)>()) : 0, out);
  });
}

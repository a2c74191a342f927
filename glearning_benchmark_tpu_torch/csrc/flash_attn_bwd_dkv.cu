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
// training rows the least time is set by bytes (q, k, v, dO, LSE, delta
// read; dK, dV written: ~3 us); the tensor-core FLOPs take well under a
// microsecond. What this kernel reaches there is set by the per-pair
// elementwise work (mask, exp2, hash), by the masked pairs inside the
// 16 x 16 tiles a warp computes, and by the fixed cost of a launch and its
// prologue (a third of the time at those rows; PERF.md), not by
// tensor-core rate.
//
// Design, bf16 (the tensor-core route). The Pallas grid swaps its axes for
// this kernel, (batch*head, key block, query block), and carries dK/dV in
// VMEM across the sequential query axis. Here one block of 4 warps owns 64
// keys of one batch*head, 16 a warp (the M of mma.sync.m16n8k16, bf16 in,
// f32 accumulate), with the warp's k and v rows as A fragments and its dK
// and dV accumulators in registers (head dims 4 and 8 zero-padded to the
// mma depth 16 in registers and shared memory only, never in HBM). The
// block loops over query tiles of 64 inside its segment range; q, dO, LSE,
// delta and the segment ids are staged in shared memory by cp.async,
// double-buffered, q and dO rows as bf16 padded by 8 so that ldmatrix is
// free of bank conflicts. Per 16 queries a warp:
//   - skips them unless one lies in the warp's segment-id range (a warp
//     with no allowed pair issues no mma for them);
//   - S^T = k q^T and dP^T = v dO^T: mma with q and dO as B operands;
//   - P, the mask, keep/(1-p) and dS = P (dP - delta) in the accumulator
//     registers;
//   - dV += (P keep/(1-p))^T dO and dK += dS^T q with the two products'
//     left operands straight from registers (the accumulators of two
//     n-tiles are the A fragment of one k-step) and dO and q through
//     ldmatrix.trans. P keep/(1-p) and dS are not bf16: rounding them would
//     cost 2^-9 relative where gradients cancel, beyond the elementwise
//     4e-3 the kernel is held to. So each is split into bf16 hi + lo and
//     both are multiplied (about 2^-17 relative), at head dims 64 and 128
//     into hi + mid + lo (about 2^-25; `split_terms`); the tensor cores
//     have room for the second product.
// dK is accumulated unscaled and multiplied by `scale` once before the
// cast; dV is not scaled.
//
// Why mma.sync and not wgmma/TMA. wgmma's unit is a 64-row warpgroup tile
// fed from shared memory, and TMA pays off on large tiles; at head dims
// 4-16 every product is one 16-deep k-step, the tensor cores idle most of
// the time anyway, and what limits the kernel is the elementwise work
// between the products. Warp-level mma lets each warp skip the queries
// that may not attend its own 16 keys and keeps P and dS in registers
// between the products.
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
// would not hold f32 accuracy. One block of 128 threads owns 128 keys, one
// per thread, with k, v and the dK, dV accumulators in f32 registers, and
// loops over query tiles of 64 (q, dO, LSE, delta staged in shared memory
// as f32; every thread reads the same query: broadcasts).

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
      SplitA<split_terms(D)> pa, sa;
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

// The instance a launch runs (its dynamic shared bytes: bf16 route).
template <int D>
const void* kernel_of(int is_bf16, int dropout) {
  if (!is_bf16) return reinterpret_cast<const void*>(attn_bwd_dkv_kernel_f32<D>);
  return dropout ? reinterpret_cast<const void*>(attn_bwd_dkv_kernel_mma<D, true>)
                 : reinterpret_cast<const void*>(attn_bwd_dkv_kernel_mma<D, false>);
}

template <int D>
void launch(const BwdParams& p, int is_bf16, cudaStream_t stream) {
  if (is_bf16) {
    const int vec = rows_vectorizable(p.q, p.q_sb, p.q_sl, p.q_sh, D) &&
                    rows_vectorizable(p.dout, p.do_sb, p.do_sl, p.do_sh, D);
    const dim3 grid(p.B * p.H, (p.L + kMmaRows - 1) / kMmaRows);
    constexpr size_t smem = mma_dyn_smem<mma_ld(D)>();
    if (p.dropout)
      launch_dyn(attn_bwd_dkv_kernel_mma<D, true>, grid, kMmaThreads, smem, stream, p, vec);
    else
      launch_dyn(attn_bwd_dkv_kernel_mma<D, false>, grid, kMmaThreads, smem, stream, p, vec);
  } else {
    const dim3 grid(p.B * p.H, (p.L + kF32Rows - 1) / kF32Rows);
    attn_bwd_dkv_kernel_f32<D><<<grid, kF32Rows, 0, stream>>>(p);
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

// Plain C entry point (bound with ctypes). Reads delta, writes dk and dv.
// Returns cudaGetLastError() after the launch, which is asynchronous on
// `stream`.
extern "C" int flash_attn_bwd_dkv(const flash::BwdParams* params, int head_dim,
                                  int is_bf16, void* stream) {
  flash::BwdParams p = *params;
  p.scale_log2 = p.scale * flash::kLog2e;
  return dispatch_d(head_dim, p, is_bf16, static_cast<cudaStream_t>(stream));
}

// The resources of the instance a launch at (head_dim, is_bf16, dropout)
// runs: out[4] = static shared bytes, dynamic shared bytes, registers a
// thread, local (spilled) bytes a thread. Returns a cudaError_t.
extern "C" int flash_attn_bwd_dkv_attrs(int head_dim, int is_bf16, int dropout,
                                        int* out) {
  return flash::with_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    return flash::func_attrs(
        kernel_of<D>(is_bf16, dropout),
        is_bf16 ? static_cast<int>(flash::mma_dyn_smem<flash::mma_ld(D)>()) : 0, out);
  });
}

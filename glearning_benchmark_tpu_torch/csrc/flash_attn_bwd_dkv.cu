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
// delta [B, H, L] f32 is an input here: the dQ kernel writes it.
//
// Design. The Pallas grid swaps its axes for this kernel, (batch*head, key
// block, query block), and carries dK/dV in VMEM across the sequential query
// axis. Here one thread block takes one (batch*head, tile of 128 keys);
// each thread owns one key and keeps k, v and the dK, dV accumulators in
// f32 registers, and the block loops over query tiles of 64 (q, dO, LSE,
// delta staged in shared memory; every thread reads the same query:
// broadcasts). A key's sums are taken by one thread in query order, so
// there are no atomics and two runs give the same bits. The dropout hash
// sees (batch*head, query row, key column) exactly as the forward does,
// though the thread's own index is now the column. dK is accumulated
// unscaled and multiplied by `scale` once before the cast; dV is not
// scaled. Queries outside the block's segment range are not walked, a
// query tile that attends no key of the block is not loaded. Pad keys
// (seg 0) get dK = dV = 0 exactly.
//
// What bounds it. Per allowed pair 8*D FLOPs (q.k, dO.v, P dO, dS q) and
// one exp. At the packed AGTT-ZINC training rows the least time is set by
// bytes; chip_smoke.py computes it from its inputs. Like the other two
// kernels this one runs on the FP32 pipe, reading 2*D shared-memory floats
// per pair, far from that bound; tensor-core products are a later change.

#include "flash_attn_common.cuh"

namespace {

using namespace flash;

template <typename T, int D, int MIN_BLOCKS>
__global__ void __launch_bounds__(kBwdRows, MIN_BLOCKS)
    attn_bwd_dkv_kernel(const BwdParams p) {
  __shared__ __align__(16) float qs[kBwdTile][D];
  __shared__ __align__(16) float dos[kBwdTile][D];
  __shared__ float lse2s[kBwdTile];
  __shared__ float deltas[kBwdTile];
  __shared__ int32_t segs[kBwdTile];

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int col = blockIdx.y * kBwdRows + threadIdx.x;
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
    const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + col * p.k_sl +
                  h * p.k_sh;
    const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + col * p.v_sl +
                  h * p.v_sh;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      kr[d] = to_f32(kp[d]) * p.scale_log2;
      vr[d] = to_f32(vp[d]);
    }
  }

  int q_first, q_last;
  other_axis_range(seg_b, p.L, sk, &q_first, &q_last);
  const int qend = q_last + 1;

  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* gp = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* lse_bh = p.lse + static_cast<int64_t>(bh) * p.L;
  const float* delta_bh = p.delta + static_cast<int64_t>(bh) * p.L;
  for (int l0 = q_first; l0 < qend; l0 += kBwdTile) {
    for (int i = threadIdx.x; i < kBwdTile; i += kBwdRows)
      segs[i] = (l0 + i < qend) ? seg_b[l0 + i] : 0;
    __syncthreads();
    bool mine = false;
    if (sk != 0) {
#pragma unroll
      for (int i = 0; i < kBwdTile; ++i) mine |= (segs[i] == sk);
    }
    if (__syncthreads_or(mine)) {
      for (int e = threadIdx.x; e < kBwdTile * D; e += kBwdRows) {
        const int i = e / D;
        const int d = e - i * D;
        const bool ok = l0 + i < qend;
        const int64_t r = l0 + i;
        qs[i][d] = ok ? to_f32(qp[r * p.q_sl + d]) : 0.f;
        dos[i][d] = ok ? to_f32(gp[r * p.do_sl + d]) : 0.f;
      }
      for (int i = threadIdx.x; i < kBwdTile; i += kBwdRows) {
        const bool ok = l0 + i < qend;
        lse2s[i] = ok ? lse_bh[l0 + i] * kLog2e : 0.f;
        deltas[i] = ok ? delta_bh[l0 + i] : 0.f;
      }
      __syncthreads();
      if (mine) {
#pragma unroll 2
        for (int i = 0; i < kBwdTile; ++i) {
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
            const uint32_t hv = hash_u32(p.seed, static_cast<uint32_t>(bh),
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
  T* dkp = static_cast<T*>(p.dk) + out;
  T* dvp = static_cast<T*>(p.dv) + out;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    dkp[d] = from_f32<T>(dk[d] * p.scale);
    dvp[d] = from_f32<T>(dv[d]);
  }
}

template <typename T, int D>
void launch(const BwdParams& p, cudaStream_t stream) {
  // head dims up to 16 fit four blocks (16 warps) per SM in registers
  constexpr int kMinBlocks = D <= 16 ? 4 : 1;
  const dim3 grid(p.B * p.H, (p.L + kBwdRows - 1) / kBwdRows);
  attn_bwd_dkv_kernel<T, D, kMinBlocks><<<grid, kBwdRows, 0, stream>>>(p);
}

template <typename T>
int dispatch_d(int head_dim, const BwdParams& p, cudaStream_t stream) {
  switch (head_dim) {
    case 4: launch<T, 4>(p, stream); break;
    case 8: launch<T, 8>(p, stream); break;
    case 16: launch<T, 16>(p, stream); break;
    case 32: launch<T, 32>(p, stream); break;
    case 64: launch<T, 64>(p, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes). Reads delta, writes dk and dv.
// Returns cudaGetLastError() after the launch, which is asynchronous on
// `stream`.
extern "C" int flash_attn_bwd_dkv(const flash::BwdParams* params, int head_dim,
                                  int is_bf16, void* stream) {
  flash::BwdParams p = *params;
  p.scale_log2 = p.scale * flash::kLog2e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_d<__nv_bfloat16>(head_dim, p, s)
                 : dispatch_d<float>(head_dim, p, s);
}

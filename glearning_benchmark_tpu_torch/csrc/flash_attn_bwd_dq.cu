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
// kernel's prologue: each thread owns one query row, reads that row of dO
// and O anyway, and writes delta [B, H, L] f32 for the dK/dV kernel, which
// therefore runs after this one on the same stream.
//
// Design. As in flash_attn_fwd.cu, nothing of the Pallas grid carries over
// (a sequential key axis with a VMEM carry, Z=8 folded batch*head rows).
// One thread block takes one (batch*head, tile of 128 query rows); each
// thread keeps its q row, its dO row and its dQ accumulator in f32
// registers and loops over key tiles of 64 staged in shared memory as f32
// (all threads read the same key: broadcasts). No online softmax is
// needed: LSE is an input. dQ is accumulated unscaled and multiplied by
// `scale` once before the cast, as the reference does. Keys outside the
// block's segment range are not walked, a key tile no row may attend is not
// loaded, and a (row, key) pair of different segments costs one compare.
// Pad queries (seg 0) get dQ = 0 exactly.
//
// What bounds it. Per allowed pair 6*D FLOPs (q.k, dO.v, dS k) and one exp.
// At the packed AGTT-ZINC training rows the least time is set by bytes
// (q, k, v, dO, O read; dQ, delta written); chip_smoke.py computes it from
// its inputs. The kernel runs on the FP32 pipe with 2*D shared-memory
// floats read per pair and is far from that bound; tensor-core products are
// a later change.

#include "flash_attn_common.cuh"

namespace {

using namespace flash;

template <typename T, int D, int MIN_BLOCKS>
__global__ void __launch_bounds__(kBwdRows, MIN_BLOCKS)
    attn_bwd_dq_kernel(const BwdParams p) {
  __shared__ __align__(16) float ks[kBwdTile][D];
  __shared__ __align__(16) float vs[kBwdTile][D];
  __shared__ int32_t segs[kBwdTile];

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int row = blockIdx.y * kBwdRows + threadIdx.x;
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
    const T* gp = static_cast<const T*>(p.dout) + b * p.do_sb +
                  row * p.do_sl + h * p.do_sh;
    const T* op = static_cast<const T*>(p.o) +
                  ((static_cast<int64_t>(b) * p.L + row) * p.H + h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dor[d] = to_f32(gp[d]);
      delta = fmaf(dor[d], to_f32(op[d]), delta);
    }
    p.delta[static_cast<int64_t>(bh) * p.L + row] = delta;
  }
  if (sq != 0) {
    const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + row * p.q_sl +
                  h * p.q_sh;
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = to_f32(qp[d]) * p.scale_log2;
    lse2 = p.lse[static_cast<int64_t>(bh) * p.L + row] * kLog2e;
  }

  int k_first, k_last;
  other_axis_range(seg_b, p.L, sq, &k_first, &k_last);
  const int kend = k_last + 1;

  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  for (int s0 = k_first; s0 < kend; s0 += kBwdTile) {
    for (int j = threadIdx.x; j < kBwdTile; j += kBwdRows)
      segs[j] = (s0 + j < kend) ? seg_b[s0 + j] : 0;
    __syncthreads();
    bool mine = false;
    if (sq != 0) {
#pragma unroll
      for (int j = 0; j < kBwdTile; ++j) mine |= (segs[j] == sq);
    }
    if (__syncthreads_or(mine)) {
      for (int e = threadIdx.x; e < kBwdTile * D; e += kBwdRows) {
        const int j = e / D;
        const int d = e - j * D;
        const bool ok = s0 + j < kend;
        const int64_t r = s0 + j;
        ks[j][d] = ok ? to_f32(kp[r * p.k_sl + d]) : 0.f;
        vs[j][d] = ok ? to_f32(vp[r * p.v_sl + d]) : 0.f;
      }
      __syncthreads();
      if (mine) {
#pragma unroll 2
        for (int j = 0; j < kBwdTile; ++j) {
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
            const uint32_t hv = hash_u32(p.seed, static_cast<uint32_t>(bh),
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
  T* dqp = static_cast<T*>(p.dq) +
           ((static_cast<int64_t>(b) * p.L + row) * p.H + h) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) dqp[d] = from_f32<T>(acc[d] * p.scale);
}

template <typename T, int D>
void launch(const BwdParams& p, cudaStream_t stream) {
  // head dims up to 16 fit four blocks (16 warps) per SM in registers
  constexpr int kMinBlocks = D <= 16 ? 4 : 1;
  const dim3 grid(p.B * p.H, (p.L + kBwdRows - 1) / kBwdRows);
  attn_bwd_dq_kernel<T, D, kMinBlocks><<<grid, kBwdRows, 0, stream>>>(p);
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

// Plain C entry point (bound with ctypes). Writes dq and delta. Returns
// cudaGetLastError() after the launch, which is asynchronous on `stream`.
extern "C" int flash_attn_bwd_dq(const flash::BwdParams* params, int head_dim,
                                 int is_bf16, void* stream) {
  flash::BwdParams p = *params;
  p.scale_log2 = p.scale * flash::kLog2e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_d<__nv_bfloat16>(head_dim, p, s)
                 : dispatch_d<float>(head_dim, p, s);
}

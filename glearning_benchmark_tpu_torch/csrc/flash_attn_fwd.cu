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
// Dropout: keep(bh, row, col) = triple32(seed, bh, row, col) >= thresh,
// bit-identical to `dropout_keep_reference` (`_hash_u32`), rescale
// 1/(1-p); the softmax normaliser l sums the UNdropped probabilities.
//
// Design. The Pallas grid walked KV blocks sequentially with carries in
// VMEM scratch and folded Z=8 (batch*head) rows per program to fill TPU
// (8, 128) tiles; none of that carries over. Here one thread block takes
// one (batch*head, tile of 128 query rows); each thread owns one query row
// and keeps its q, its output accumulator and the online-softmax state
// (m, l) in f32 registers. The block loops over KV tiles of 64 keys staged
// in shared memory as f32 (every thread reads the same key, so the reads
// are broadcasts) and runs the online softmax in chunks of 16 keys, so
// only 16 logits live in registers (head dims up to 16 fit four blocks per
// SM). Exponentials are exp2 of log2-scaled logits (one SFU op each).
// Serving rows are mostly padding (a ZINC trail is ~90 of 1024 tokens), so
// the kernel skips what the mask rules out: a block first finds the range
// of segment ids among its queries and the first and last key inside that
// range, and walks only those keys; a KV tile that no row of the block may
// attend is neither loaded nor computed; a query tile with no valid row
// writes zeros and leaves.
//
// What bounds it. Per allowed (query, key) pair: 4*D FLOPs (q.k and p.v)
// and one exp. With O written in full (pad rows too), the least time at
// the served AGTT-ZINC rows is set by bytes, dense rows by the exps on the
// SFU (16 per SM per clock); chip_smoke.py computes both from its inputs.
// This kernel is far from either: it runs the products on the FP32 pipe,
// one query row per thread, reading 2*D floats of shared memory per pair
// (the likely limit, see PERF.md). Tensor-core products (mma/wgmma) over
// several query rows per warp are the way down, in a later change.

#include "flash_attn_common.cuh"

namespace {

using namespace flash;  // constants, to_f32/from_f32, hash_u32

constexpr int kBlockQ = 128;  // query rows per block, one per thread
constexpr int kTileK = 64;    // keys per shared-memory tile
constexpr int kChunk = 16;    // keys per online-softmax step

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
  float keep_scale;  // 1 / (1 - p_drop)
};

template <typename T, int D, int TK, int MIN_BLOCKS>
__global__ void __launch_bounds__(kBlockQ, MIN_BLOCKS)
    attn_fwd_kernel(const Params p) {
  __shared__ __align__(16) float ks[TK][D];
  __shared__ __align__(16) float vs[TK][D];
  __shared__ int32_t segs[TK];
  __shared__ int32_t q_lo, q_hi, k_first, k_last;

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int row = blockIdx.y * kBlockQ + threadIdx.x;
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
    const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + row * p.q_sl +
                  h * p.q_sh;
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = to_f32(qp[d]) * p.scale_log2;
  }
  float m = kNegInf;  // running max of the log2-scaled logits
  float l = 0.f;      // running sum of undropped probabilities

  // The range of segment ids among the block's queries, then the first
  // and last key whose id falls in it: keys outside [k_first, k_last]
  // can be attended by no row of the block.
  if (threadIdx.x == 0) {
    q_lo = INT32_MAX;
    q_hi = 0;
    k_first = p.L;
    k_last = -1;
  }
  __syncthreads();
  if (sq != 0) {
    atomicMin(&q_lo, sq);
    atomicMax(&q_hi, sq);
  }
  __syncthreads();
  const int32_t lo = q_lo, hi = q_hi;
  if (hi != 0) {
    for (int j = threadIdx.x; j < p.L; j += kBlockQ) {
      const int32_t sk = seg_b[j];
      if (sk >= lo && sk <= hi) {
        atomicMin(&k_first, j);
        atomicMax(&k_last, j);
      }
    }
  }
  __syncthreads();
  const int kend = k_last + 1;

  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  for (int s0 = k_first; s0 < kend; s0 += TK) {
    for (int j = threadIdx.x; j < TK; j += kBlockQ)
      segs[j] = (s0 + j < kend) ? seg_b[s0 + j] : 0;
    __syncthreads();
    bool mine = false;
    if (sq != 0) {
#pragma unroll
      for (int j = 0; j < TK; ++j) mine |= (segs[j] == sq);
    }
    if (__syncthreads_or(mine)) {
      for (int e = threadIdx.x; e < TK * D; e += kBlockQ) {
        const int j = e / D;
        const int d = e - j * D;
        const bool ok = s0 + j < kend;
        const int64_t r = s0 + j;
        ks[j][d] = ok ? to_f32(kp[r * p.k_sl + d]) : 0.f;
        vs[j][d] = ok ? to_f32(vp[r * p.v_sl + d]) : 0.f;
      }
      __syncthreads();
      if (mine) {
        // online softmax over chunks of kChunk keys: only kChunk logits
        // live in registers at a time
#pragma unroll 1
        for (int c = 0; c < TK; c += kChunk) {
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
              const uint32_t hv = hash_u32(p.seed, static_cast<uint32_t>(bh),
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
  T* op = static_cast<T*>(p.o) +
          ((static_cast<int64_t>(b) * p.L + row) * p.H + h) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) op[d] = from_f32<T>(acc[d] / safe_l);
  p.lse[static_cast<int64_t>(bh) * p.L + row] =
      l > 0.f ? (m + log2f(l)) * kLn2 : kNegInf;
}

template <typename T, int D>
void launch(const Params& p, cudaStream_t stream) {
  // head dims up to 16 fit four blocks (16 warps) per SM in registers
  constexpr int kMinBlocks = D <= 16 ? 4 : 1;
  const dim3 grid(p.B * p.H, (p.L + kBlockQ - 1) / kBlockQ);
  attn_fwd_kernel<T, D, kTileK, kMinBlocks><<<grid, kBlockQ, 0, stream>>>(p);
}

template <typename T>
int dispatch_d(int head_dim, const Params& p, cudaStream_t stream) {
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
                              void* stream) {
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_d<__nv_bfloat16>(head_dim, p, s)
                 : dispatch_d<float>(head_dim, p, s);
}

// The encoder layer's residual site for Hopper (sm_90a), forward and
// backward: the residual hash dropout, the f32 residual add, LayerNorm in
// f32 and the bf16 copy of its output for the next GEMM, one pass each way.
//
// Replaces no Pallas kernel. It is the port's counterpart of what XLA fuses
// at the JAX package's two residual sites
// (glearning_benchmark_tpu/models/transformer.py:122 and :135:
// `cheap_dropout` on the branch, `(x + y).astype(float32)`, `nn.LayerNorm`,
// and the next `Dense`'s cast to the compute dtype). As separate torch ops
// the site takes a dropout pass, a cast, an add, LayerNorm and a cast back,
// and about as many again backward, each reading and writing [rows, d] in
// device memory; here the forward reads x and y once and writes the f32
// output, its bf16 copy and two floats a row, and the backward recomputes
// the sum from x and y (no pre-norm tensor is kept), reads the two incoming
// gradients and writes the residual's and the branch's gradients.
//
// Same numbers as the composition (ops/residual_norm.py `plain`):
//   - the keep bits are `cheap_dropout`'s blocked bytes over the branch's
//     global word index (csrc/hash_site.cuh, the `Site` the wrapper builds
//     with `blocked_site`): element e of a row is byte e / sq of word
//     e % sq, sq = d / 4; a kept element is y times `inv` in f32, rounded
//     to y's type, then widened, as `cheap_dropout(...).float()`;
//   - the add is one f32 add; the statistics are f32 (mean, then the
//     biased variance about it, rstd = rsqrt(var + eps)); the copy is the
//     f32 output rounded to nearest even, the bits of `out.to(bfloat16)`;
//   - backward, the gradient of the sum is rstd * (g w - mean(g w)
//     - xhat mean(g w xhat)), g the stream's gradient plus the copy's,
//     widened; the branch's gradient is that rounded to y's type, then the
//     dropout's mask and scale (rounded again), as autograd through the
//     composition gives it. Sums run in another order than PyTorch's
//     LayerNorm, so outputs agree to rounding, not bit for bit.
// The LayerNorm weight and bias gradients are per-block partial sums (each
// thread adds its own columns in shared memory, one region a row slot)
// written to a scratch buffer, then one small kernel sums the blocks in a
// fixed order: no atomics, the same bits on every run.
//
// What bounds it on an H100: bytes. At d 1024 with a bf16 branch the
// forward moves 12 bytes an element and the backward 18, about 0.6 ms for
// [64 * 1024, 1024] at 3.35 TB/s; the hash is about 10 integer operations
// an element. Design: a row's elements stay in registers between the
// statistics and the output (no second pass over memory), 8 elements a
// chunk with 16-byte accesses, and every load of a row is issued before
// its arithmetic, so a row's bytes are in flight together. A row takes g
// threads, the least power of two that leaves each at most two chunks
// (up to 256 threads, so d up to 4096, past the widest configuration's
// 2560): rows share a warp up to d 256 (shuffles only) and take several
// warps from d 520 (one shared-memory step a sum). Two chunks a thread keep
// the registers low enough for 12 or more warps an SM; four (one warp a row at d 1024) left 8 and a backward
// 1.42x its bound against 1.25x. The grid is at most as many blocks as fit
// on the card at once, striding over the rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_site.cuh"   // Site, hash1

namespace {

constexpr int kBlock = 128;        // threads a block, unless a row takes more
constexpr int kMaxThreads = 256;   // the most threads a row takes
constexpr int kMaxD = 4096;        // 256 threads x 2 chunks x 8 elements

}  // namespace

// ops/residual_norm.py `_ArgsStruct`, field by field
struct Args {
  Site site;                   // the residual dropout's keep bits and scale
  int32_t dropping;            // 0: no dropout
  int32_t d;                   // row length, a multiple of 8
  int32_t g;                   // threads a row (set by the entry points)
  int64_t rows;
  const float* x;              // [rows, d] the f32 residual stream
  const void* y;               // [rows, d] the branch, f32 or bf16
  const float* w;              // [d] LayerNorm weight
  const float* b;              // [d] LayerNorm bias
  float eps;
  float* out;                  // [rows, d] f32
  __nv_bfloat16* copy;         // [rows, d] its bf16 copy, or null
  float* mean;                 // [rows]
  float* rstd;                 // [rows]
  const float* gout;           // [rows, d] gradient of out, or null
  const __nv_bfloat16* gcopy;  // [rows, d] gradient of the copy, or null
  float* dx;                   // [rows, d] f32
  void* dy;                    // [rows, d] y's type
  float* partial;              // [blocks, 2, d] per-block sums of g * xhat and g
};

namespace {

// 8 elements as loaded: 32 bytes of f32, 16 of bf16
template <typename T> struct Raw;
template <> struct Raw<float> { float4 lo, hi; };
template <> struct Raw<__nv_bfloat16> { uint4 u; };

__device__ __forceinline__ Raw<float> load_raw(const float* p) {
  return {reinterpret_cast<const float4*>(p)[0], reinterpret_cast<const float4*>(p)[1]};
}

__device__ __forceinline__ Raw<__nv_bfloat16> load_raw(const __nv_bfloat16* p) {
  return {*reinterpret_cast<const uint4*>(p)};
}

__device__ __forceinline__ void widen(const Raw<float>& r, float (&v)[8]) {
  v[0] = r.lo.x; v[1] = r.lo.y; v[2] = r.lo.z; v[3] = r.lo.w;
  v[4] = r.hi.x; v[5] = r.hi.y; v[6] = r.hi.z; v[7] = r.hi.w;
}

__device__ __forceinline__ void widen(const Raw<__nv_bfloat16>& r, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

template <typename T>
__device__ __forceinline__ void load8(const T* p, float (&v)[8]) {
  widen(load_raw(p), v);
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// v rounded to T and widened again
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// global index of word 0 of a row of the branch, mod 2^32 (hash_dropout.cu's
// blocked layout: the words of a row are one run of the global tensor's)
__device__ __forceinline__ uint32_t row_base(const Site& s, int64_t row) {
  if (s.naxes == 0) return s.base + static_cast<uint32_t>(row * s.sq);
  uint32_t idx = s.base;
  int64_t r = row;
  for (int ax = s.naxes - 1; ax >= 0; --ax) {
    idx += static_cast<uint32_t>(r % s.size[ax]) * s.gstride[ax];
    r /= s.size[ax];
  }
  return idx;
}

// v = x + dropout(y) for the 8 elements of chunk c of a row, from their
// loaded x and y; returns their keep bits (bit j: element 8c + j)
template <typename T>
__device__ __forceinline__ uint32_t residual(const Args& a, const Raw<float>& xr,
                                             const Raw<T>& yr, int c, uint32_t rb,
                                             float (&v)[8]) {
  float yv[8];
  widen(xr, v);
  widen(yr, yv);
  uint32_t keep = 0xFFu;
  if (a.dropping) {
    const int sq = a.d >> 2;
    int q = (8 * c) / sq;
    int w = 8 * c - q * sq;
    keep = 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j, ++w) {
      while (w >= sq) {
        w -= sq;
        ++q;
      }
      const uint32_t h = hash1(a.site.seed, rb + static_cast<uint32_t>(w));
      if (((h >> (8 * q)) & 0xFFu) >= a.site.thresh) keep |= 1u << j;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      yv[j] = (keep >> j) & 1u ? round_to<T>(__fmul_rn(yv[j], a.site.inv)) : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = __fadd_rn(v[j], yv[j]);
  return keep;
}

// the sum of v over the g threads of a row in a fixed order, on each of them
__device__ __forceinline__ float row_sum(float v, int g, float* red) {
  for (int off = (g < 32 ? g : 32) >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xFFFFFFFFu, v, off);
  if (g > 32) {   // the row's warps, through shared memory
    const int per = g >> 5, first = (threadIdx.x / g) * per;
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    v = 0.0f;
    for (int i = 0; i < per; ++i) v += red[first + i];
    __syncthreads();   // red is free for the next sum
  }
  return v;
}

// A row's loads are all issued before its arithmetic: a row's bytes in
// flight at once hide the memory's latency.
template <typename T, int NC>
__global__ void __launch_bounds__(kMaxThreads)
residual_norm_fwd(const Args a) {
  __shared__ float red[kMaxThreads / 32];
  const int d = a.d, g = a.g, chunks = d >> 3;
  const int lane = threadIdx.x % g, slot = threadIdx.x / g, slots = blockDim.x / g;
  const T* y = static_cast<const T*>(a.y);
  for (int64_t r0 = int64_t(blockIdx.x) * slots; r0 < a.rows; r0 += int64_t(gridDim.x) * slots) {
    const int64_t row = r0 + slot;
    const bool valid = row < a.rows;
    Raw<float> xr[NC];
    Raw<T> yr[NC];
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = lane + k * g;
      if (valid && c < chunks) {
        xr[k] = load_raw(a.x + row * d + 8 * c);
        yr[k] = load_raw(y + row * d + 8 * c);
      }
    }
    const uint32_t rb = valid && a.dropping ? row_base(a.site, row) : 0u;
    float v[NC][8];
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      if (valid && lane + k * g < chunks) {
        residual<T>(a, xr[k], yr[k], lane + k * g, rb, v[k]);
#pragma unroll
        for (int j = 0; j < 8; ++j) s += v[k][j];
      }
    }
    const float mean = row_sum(s, g, red) / static_cast<float>(d);
    float q = 0.0f;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      if (valid && lane + k * g < chunks) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float t = v[k][j] - mean;
          q += t * t;
        }
      }
    }
    const float rs = rsqrtf(row_sum(q, g, red) / static_cast<float>(d) + a.eps);
    if (!valid) continue;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = lane + k * g;
      if (c < chunks) {
        float wv[8], bv[8], o[8];
        load8(a.w + 8 * c, wv);
        load8(a.b + 8 * c, bv);
#pragma unroll
        for (int j = 0; j < 8; ++j) o[j] = (v[k][j] - mean) * rs * wv[j] + bv[j];
        store8(a.out + row * d + 8 * c, o);
        if (a.copy != nullptr) store8(a.copy + row * d + 8 * c, o);
      }
    }
    if (lane == 0) {
      a.mean[row] = mean;
      a.rstd[row] = rs;
    }
  }
}

// The weight's and bias's sums run in shared memory, one region a row slot
// ([slots][2][d]), each thread on its own columns; the block adds its slots
// in order at the end. A row keeps its sum v and its gradient g in
// registers; xhat and g w are formed again where they are used.
template <typename T, int NC>
__global__ void __launch_bounds__(kMaxThreads)
residual_norm_bwd(const Args a) {
  __shared__ float red[kMaxThreads / 32];
  extern __shared__ float4 part4[];
  const int d = a.d, g = a.g, chunks = d >> 3;
  const int lane = threadIdx.x % g, slot = threadIdx.x / g, slots = blockDim.x / g;
  const T* y = static_cast<const T*>(a.y);
  T* dy = static_cast<T*>(a.dy);
  float* part = reinterpret_cast<float*>(part4);
  float* acc = part + slot * 2 * d;      // this slot's sums of g * xhat, then of g
  const float zero[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int c = lane + k * g;
    if (c < chunks) {
      store8(acc + 8 * c, zero);
      store8(acc + d + 8 * c, zero);
    }
  }
  for (int64_t r0 = int64_t(blockIdx.x) * slots; r0 < a.rows; r0 += int64_t(gridDim.x) * slots) {
    const int64_t row = r0 + slot;
    const bool valid = row < a.rows;
    Raw<float> xr[NC], gr[NC];
    Raw<T> yr[NC];
    Raw<__nv_bfloat16> cr[NC];
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = lane + k * g;
      if (valid && c < chunks) {
        const int64_t at = row * d + 8 * c;
        xr[k] = load_raw(a.x + at);
        yr[k] = load_raw(y + at);
        if (a.gout != nullptr) gr[k] = load_raw(a.gout + at);
        if (a.gcopy != nullptr) cr[k] = load_raw(a.gcopy + at);
      }
    }
    const uint32_t rb = valid && a.dropping ? row_base(a.site, row) : 0u;
    const float mean = valid ? a.mean[row] : 0.0f;
    const float rs = valid ? a.rstd[row] : 0.0f;
    float v[NC][8], gv[NC][8];
    uint32_t keep = 0u;
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = lane + k * g;
      if (valid && c < chunks) {
        float wv[8];
        keep |= residual<T>(a, xr[k], yr[k], c, rb, v[k]) << (8 * k);
        if (a.gout != nullptr) {
          widen(gr[k], gv[k]);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) gv[k][j] = 0.0f;
        }
        if (a.gcopy != nullptr) {
          float gc[8];
          widen(cr[k], gc);
#pragma unroll
          for (int j = 0; j < 8; ++j) gv[k][j] += gc[j];
        }
        load8(a.w + 8 * c, wv);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float gw = gv[k][j] * wv[j];
          s1 += gw;
          s2 += gw * ((v[k][j] - mean) * rs);
        }
      }
    }
    const float m1 = row_sum(s1, g, red) / static_cast<float>(d);
    const float m2 = row_sum(s2, g, red) / static_cast<float>(d);
    if (!valid) continue;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = lane + k * g;
      if (c < chunks) {
        float wv[8], sw[8], sb[8], dv[8], dyv[8];
        load8(a.w + 8 * c, wv);
        load8(acc + 8 * c, sw);
        load8(acc + d + 8 * c, sb);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float xh = (v[k][j] - mean) * rs;
          dv[j] = rs * (gv[k][j] * wv[j] - m1 - xh * m2);
          sw[j] += gv[k][j] * xh;
          sb[j] += gv[k][j];
          const float t = round_to<T>(dv[j]);
          dyv[j] = !a.dropping ? t
                 : (keep >> (8 * k + j)) & 1u ? round_to<T>(__fmul_rn(t, a.site.inv)) : 0.0f;
        }
        store8(acc + 8 * c, sw);
        store8(acc + d + 8 * c, sb);
        store8(a.dx + row * d + 8 * c, dv);
        store8(dy + row * d + 8 * c, dyv);
      }
    }
  }
  // the block's sums, column by column, its slots in order
  __syncthreads();
  float* out = a.partial + int64_t(blockIdx.x) * 2 * d;
  for (int i = threadIdx.x; i < 2 * d; i += blockDim.x) {
    float t = 0.0f;
    for (int s = 0; s < slots; ++s) t += part[s * 2 * d + i];
    out[i] = t;
  }
}

// dw, db: the blocks' partial sums added in block order; 32 columns by 16
// strided runs of blocks a block of threads
constexpr int kReduceCols = 32, kReduceRuns = 16;

__global__ void __launch_bounds__(kReduceCols * kReduceRuns)
residual_norm_reduce(const float* partial, int blocks, int d, float* dw, float* db) {
  __shared__ float sm[kReduceRuns][kReduceCols + 1];
  const int col = blockIdx.x * kReduceCols + threadIdx.x;
  float s = 0.0f;
  if (col < 2 * d)
    for (int b = threadIdx.y; b < blocks; b += kReduceRuns) s += partial[int64_t(b) * 2 * d + col];
  sm[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < 2 * d) {
    float t = 0.0f;
    for (int i = 0; i < kReduceRuns; ++i) t += sm[i][threadIdx.x];
    if (col < d) dw[col] = t; else db[col - d] = t;
  }
}

// threads a row, chunks a thread and threads a block at row length d
struct Plan {
  int g, nc, threads;
};

Plan plan(int d) {
  const int chunks = d / 8;
  int g = 1;
  while (g * 2 < chunks && g < kMaxThreads) g *= 2;
  return {g, (chunks + g - 1) / g, g > kBlock ? g : kBlock};
}

size_t bwd_smem(const Plan& p, int d) {
  return size_t(p.threads / p.g) * 2 * d * sizeof(float);
}

template <typename Kernel>
int grid(Kernel kernel, const Plan& p, size_t smem, int64_t rows) {
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, p.threads, smem);
  const int64_t most = int64_t(sms) * (per_sm > 0 ? per_sm : 1);
  const int slots = p.threads / p.g;
  const int64_t want = (rows + slots - 1) / slots;
  return static_cast<int>(want < most ? want : most);
}

// the backward's grid (its shared memory is at most 32 KB, at d 4096)
template <typename T, int NC>
int bwd_grid(const Plan& p, int d, int64_t rows) {
  return grid(residual_norm_bwd<T, NC>, p, bwd_smem(p, d), rows);
}

template <typename T, int NC>
int forward_nc(Args a, const Plan& p, cudaStream_t st) {
  const int blocks = grid(residual_norm_fwd<T, NC>, p, 0, a.rows);
  residual_norm_fwd<T, NC><<<blocks, p.threads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NC>
int backward_nc(Args a, const Plan& p, int capacity, float* dw, float* db, cudaStream_t st) {
  const size_t smem = bwd_smem(p, a.d);
  const int blocks = bwd_grid<T, NC>(p, a.d, a.rows);
  if (blocks > capacity) return cudaErrorInvalidValue;
  residual_norm_bwd<T, NC><<<blocks, p.threads, smem, st>>>(a);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const dim3 threads(kReduceCols, kReduceRuns);
  residual_norm_reduce<<<(2 * a.d + kReduceCols - 1) / kReduceCols, threads, 0, st>>>(
      a.partial, blocks, a.d, dw, db);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int forward_typed(const Args& a, const Plan& p, cudaStream_t st) {
  switch (p.nc) {
    case 1: return forward_nc<T, 1>(a, p, st);
    case 2: return forward_nc<T, 2>(a, p, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int backward_typed(const Args& a, const Plan& p, int capacity, float* dw, float* db,
                   cudaStream_t st) {
  switch (p.nc) {
    case 1: return backward_nc<T, 1>(a, p, capacity, dw, db, st);
    case 2: return backward_nc<T, 2>(a, p, capacity, dw, db, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int capacity_typed(const Plan& p, int d) {
  // as many blocks as any number of rows gets (grid's cap)
  const int64_t rows = int64_t(1) << 40;
  switch (p.nc) {
    case 1: return bwd_grid<T, 1>(p, d, rows);
    case 2: return bwd_grid<T, 2>(p, d, rows);
    default: return 0;
  }
}

bool takes(int d) { return d >= 8 && d % 8 == 0 && d <= kMaxD; }

}  // namespace

// The most blocks the backward launches at row length d for a branch of
// type `dtype` (0 f32, 1 bf16): the rows of its partial-sum buffer. 0 for a
// width or type it does not take.
extern "C" int residual_norm_capacity(int d, int dtype) {
  if (!takes(d)) return 0;
  const Plan p = plan(d);
  switch (dtype) {
    case 0: return capacity_typed<float>(p, d);
    case 1: return capacity_typed<__nv_bfloat16>(p, d);
    default: return 0;
  }
}

// out, copy (if not null), mean and rstd from x, y, w, b and the site.
// Returns the launch's CUDA error (0 on success); cudaErrorInvalidValue for
// a width or type it does not take.
extern "C" int residual_norm_forward(const Args* args, int dtype, void* stream) {
  Args a = *args;
  if (a.rows <= 0) return 0;
  if (!takes(a.d)) return cudaErrorInvalidValue;
  const Plan p = plan(a.d);
  a.g = p.g;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return forward_typed<float>(a, p, st);
    case 1: return forward_typed<__nv_bfloat16>(a, p, st);
    default: return cudaErrorInvalidValue;
  }
}

// dx, dy, and the weight and bias gradients dw, db ([d] f32 each), summed
// through `partial`, which holds `capacity` blocks' rows.
extern "C" int residual_norm_backward(const Args* args, int dtype, int capacity, float* dw,
                                      float* db, void* stream) {
  Args a = *args;
  if (!takes(a.d)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.rows <= 0) {   // no rows: the weight's and bias's sums are 0
    cudaMemsetAsync(dw, 0, a.d * sizeof(float), st);
    cudaMemsetAsync(db, 0, a.d * sizeof(float), st);
    return static_cast<int>(cudaGetLastError());
  }
  const Plan p = plan(a.d);
  a.g = p.g;
  switch (dtype) {
    case 0: return backward_typed<float>(a, p, capacity, dw, db, st);
    case 1: return backward_typed<__nv_bfloat16>(a, p, capacity, dw, db, st);
    default: return cudaErrorInvalidValue;
  }
}

// Hash dropout for Hopper (sm_90a): inverted dropout by a counter hash over
// the global element index, in one pass.
//
// Replaces no Pallas kernel. It is the port's counterpart of the fused XLA
// pass that the JAX package's `_hash1_u32` / `hash_keep_mask` /
// `cheap_dropout` (glearning_benchmark_tpu/ops/attention.py:62-153) compile
// to: elementwise jnp over an iota, which XLA fuses into the consuming
// select, the backward regenerating the mask. Run as separate torch ops the
// same function takes about 44 launches a site and int64 temporaries of
// several times x's size; here it is one launch that reads x once and
// writes the output once, and the backward runs the same kernel on the
// gradient (ops/hash_dropout.py `HashDropoutFunction`), so no mask is kept.
//
// Two layouts of the keep bits, bit-identical to the plain versions in
// ops/attention.py:
//   - blocked bytes (`cheap_dropout_reference`, `hash_keep_mask`): the last
//     axis of length s holds sq = ceil(s / 4) words a row; word w of a row
//     is triple32(seed, idx) over its global word index idx, and byte j of
//     it keeps element w + j * sq of the row where the byte >= thresh
//     (thresh = round(rate * 256)). idx is the word's linear index in the
//     global tensor the caller places x in (batch offset, batch total,
//     `place`), mod 2^32: base + the sum of each leading axis's index times
//     its global stride (`Site::size`, `Site::gstride`, with axes merged on
//     the host where their strides nest; no axis at all when the words of x
//     are one run of the global tensor's, idx = base + word).
//   - one hash an element (`hash_dropout_reference`): element i keeps where
//     triple32(seed, base + i) >= thresh, a full 32-bit threshold.
// A kept element is x times `inv` in f32, rounded to x's type: what
// PyTorch's CUDA true division by a host scalar computes (`x / c` runs as
// x * (1 / c), the reciprocal taken once in f32); a dropped one is +0.
//
// What bounds it on an H100: bytes. Each element is read once and written
// once (2 + 2 bytes in bf16, 4 + 4 in f32), about 3 integer operations an
// element and 10 a word of hash; at 3.35 TB/s the bytes take about 7 times
// the integer work's time at the INT32 issue rate. Design: a grid-stride
// loop, one thread a word of the blocked layout (its hash taken once for
// its four elements, each of the four loads coalesced across the warp, the
// row and word split by one division), or one thread an element. Indices
// are 32-bit where the tensor has fewer than 2^31 elements. Simple first:
// no vector loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_site.cuh"   // Site, hash1

namespace {

constexpr int kThreads = 256;

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__device__ __forceinline__ T drop(T v, bool keep, float inv) {
  return keep ? from_f32<T>(__fmul_rn(to_f32<T>(v), inv)) : from_f32<T>(0.0f);
}

// one thread a word of the blocked-byte layout; I: the index type
template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
hash_dropout_blocked(const Site site, const T* __restrict__ x, T* __restrict__ out) {
  const I sq = static_cast<I>(site.sq);
  const I s = static_cast<I>(site.s);
  const I words = static_cast<I>(site.rows) * sq;
  for (I word = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x; word < words;
       word += static_cast<I>(gridDim.x) * kThreads) {
    const I row = word / sq;
    const I w = word - row * sq;
    uint32_t idx;
    if (site.naxes == 0) {
      idx = site.base + static_cast<uint32_t>(word);
    } else {
      idx = site.base + static_cast<uint32_t>(w);
      I r = row;
      for (int a = site.naxes - 1; a >= 0; --a) {
        const I size = static_cast<I>(site.size[a]);
        const I i = r % size;
        r /= size;
        idx += static_cast<uint32_t>(i) * site.gstride[a];
      }
    }
    const uint32_t h = hash1(site.seed, idx);
    const I row0 = row * s;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const I e = w + static_cast<I>(j) * sq;
      if (e < s) {
        const bool keep = ((h >> (8 * j)) & 0xFFu) >= site.thresh;
        out[row0 + e] = drop(x[row0 + e], keep, site.inv);
      }
    }
  }
}

// one thread an element, a full 32-bit threshold
template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
hash_dropout_elements(const Site site, const T* __restrict__ x, T* __restrict__ out) {
  const I n = static_cast<I>(site.rows) * static_cast<I>(site.s);
  for (I i = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += static_cast<I>(gridDim.x) * kThreads) {
    const bool keep = hash1(site.seed, site.base + static_cast<uint32_t>(i)) >= site.thresh;
    out[i] = drop(x[i], keep, site.inv);
  }
}

template <typename T, typename I>
void launch(const Site& site, const void* x, void* out, cudaStream_t stream) {
  const int64_t work = site.blocked ? site.rows * site.sq : site.rows * site.s;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  // enough blocks to fill every SM (8 blocks of 256 threads each), fewer
  // for a small tensor; the loop strides over the rest
  const int64_t want = (work + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 8LL * sms ? want : 8LL * sms);
  if (site.blocked)
    hash_dropout_blocked<T, I><<<blocks, kThreads, 0, stream>>>(
        site, static_cast<const T*>(x), static_cast<T*>(out));
  else
    hash_dropout_elements<T, I><<<blocks, kThreads, 0, stream>>>(
        site, static_cast<const T*>(x), static_cast<T*>(out));
}

template <typename T>
void launch_typed(const Site& site, const void* x, void* out, cudaStream_t stream) {
  // 32-bit indices where index plus grid stride stays below 2^32
  if (site.rows * site.s < (int64_t(1) << 31))
    launch<T, uint32_t>(site, x, out, stream);
  else
    launch<T, uint64_t>(site, x, out, stream);
}

}  // namespace

// out = dropout(x) over rows * s contiguous elements of type `dtype` (0 f32,
// 1 bf16). Returns the launch's CUDA error (0 on success);
// cudaErrorInvalidValue for a type or a site it does not take.
extern "C" int hash_dropout(const Site* site, const void* x, void* out, int dtype,
                            void* stream) {
  if (site->rows <= 0 || site->s <= 0) return 0;
  if (site->naxes < 0 || site->naxes > kMaxAxes || (!site->blocked && site->naxes != 0))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: launch_typed<float>(*site, x, out, st); break;
    case 1: launch_typed<__nv_bfloat16>(*site, x, out, st); break;
    default: return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

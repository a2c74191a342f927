// Shared by the flash-attention kernels (forward, dQ, dK/dV): constants,
// type conversion, the dropout counter hash, and what the two backward
// kernels have in common (their parameter block and the segment-range scan).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace flash {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// pallas_attention._hash_u32: triple32 finaliser over the absolute
// (batch*head, query row, key column) indices. Every kernel, whatever its
// grid, hands it the same three indices for the same (query, key) pair.
__device__ __forceinline__ uint32_t hash_u32(uint32_t seed, uint32_t bh,
                                             uint32_t row, uint32_t col) {
  uint32_t x = bh * 0x9E3779B1u;
  x ^= row * 0x85EBCA77u;
  x ^= col * 0xC2B2AE3Du;
  x += seed;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// ---------------------------------------------------------------------------
// the backward kernels
// ---------------------------------------------------------------------------

constexpr int kBwdRows = 128;  // rows of the block's own axis, one per thread
constexpr int kBwdTile = 64;   // rows of the other axis per shared-memory tile

// Mirrored field by field by `_BwdParams` (a ctypes.Structure) in
// ops/flash_attention.py. q, k, v, dout are [B, L, H, D] with a contiguous
// last dim and the strides given; o, dq, dk, dv are contiguous [B, L, H, D];
// seg is [B, L] int32; lse and delta are [B, H, L] f32.
struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const int32_t* seg;
  const float* lse;
  float* delta;  // written by the dQ kernel, read by the dK/dV kernel
  void* dq;
  void* dk;
  void* dv;
  int64_t q_sb, q_sl, q_sh;
  int64_t k_sb, k_sl, k_sh;
  int64_t v_sb, v_sl, v_sh;
  int64_t do_sb, do_sl, do_sh;
  int B, L, H;
  float scale;       // softmax scale 1/sqrt(D)
  float scale_log2;  // scale * log2(e); filled in by the C entry point
  int dropout;       // 0: p_drop == 0
  uint32_t seed;
  uint32_t keep_thresh;
  float keep_scale;  // 1 / (1 - p_drop)
};

// `mine` is the calling thread's segment id (0 = pad or out of range). Finds
// the range of non-zero ids among the block's threads and then the first and
// last position of seg_b[0..L) whose id lies inside that range: positions
// outside [first, last] can pair with no row of the block. An empty range
// comes back as first = L, last = -1. Every thread of the block must call.
__device__ __forceinline__ void other_axis_range(const int32_t* seg_b, int L,
                                                 int32_t mine, int* first,
                                                 int* last) {
  __shared__ int32_t lo, hi, r_first, r_last;
  if (threadIdx.x == 0) {
    lo = INT32_MAX;
    hi = 0;
    r_first = L;
    r_last = -1;
  }
  __syncthreads();
  if (mine != 0) {
    atomicMin(&lo, mine);
    atomicMax(&hi, mine);
  }
  __syncthreads();
  const int32_t l = lo, h = hi;
  if (h != 0) {
    for (int j = threadIdx.x; j < L; j += blockDim.x) {
      const int32_t s = seg_b[j];
      if (s >= l && s <= h) {
        atomicMin(&r_first, j);
        atomicMax(&r_last, j);
      }
    }
  }
  __syncthreads();
  *first = r_first;
  *last = r_last;
}

}  // namespace flash

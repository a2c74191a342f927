// Shared by the flash-attention kernels (forward, dQ, dK/dV): constants,
// type conversion, the dropout counter hash, the segment-range scans, the
// backward kernels' parameter block, and the tensor-core building blocks of
// the three kernels' bf16 route (mma.sync, ldmatrix, cp.async, the hi + lo
// bf16 split).
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
// The key mixes the three with xor, so a kernel may hoist the terms it
// holds fixed (kHashBh * bh ^ kHashRow * row, or ... ^ kHashCol * col) and
// finish with hash_finish.
constexpr uint32_t kHashBh = 0x9E3779B1u;
constexpr uint32_t kHashRow = 0x85EBCA77u;
constexpr uint32_t kHashCol = 0xC2B2AE3Du;

__device__ __forceinline__ uint32_t hash_finish(uint32_t seed, uint32_t key) {
  uint32_t x = key + seed;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t hash_u32(uint32_t seed, uint32_t bh,
                                             uint32_t row, uint32_t col) {
  return hash_finish(seed, (bh * kHashBh) ^ (row * kHashRow) ^ (col * kHashCol));
}

// 2^x by the SFU alone (ex2.approx, about 2^-22 relative; subnormal results
// flush to zero): the probabilities of the bf16 route.
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// block shapes of the two routes; the backward kernels' parameters
// ---------------------------------------------------------------------------

// bf16 inputs take the tensor-core route (mma.sync, see the header notes of
// the three sources): a block of 4 warps owns kMmaRows rows of its own
// axis, 16 a warp (the M of m16n8k16), and loops over tiles of kMmaTile rows
// of the other axis, double-buffered in shared memory. f32 inputs take the
// FP32-pipe route (tensor cores take no f32, and TF32 would not hold f32
// accuracy): a block owns kF32Rows rows, one per thread, and loops over
// tiles of kF32Tile rows staged as f32.
constexpr int kMmaRows = 64;   // rows of the block's own axis, 16 per warp
constexpr int kMmaTile = 64;   // rows of the other axis per shared-memory tile
constexpr int kMmaThreads = 128;
constexpr int kF32Rows = 128;  // f32 route: rows of the block's own axis, one per thread
constexpr int kF32Tile = 64;   // f32 route: rows of the other axis per tile

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
  float keep_scale;    // 1 / (1 - p_drop)
  uint32_t bh_offset;  // added to batch*head in the dropout hash: a
                       // data-parallel rank's place in the global batch
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

// ---------------------------------------------------------------------------
// tensor-core building blocks of the bf16 route (sm_80 and later PTX)
// ---------------------------------------------------------------------------

// D += A B for one m16n8k16 tile, bf16 inputs, f32 accumulators. Fragments
// (g = lane / 4, t = lane % 4; two bf16 a register, the lower column in the
// low half): a0 (row g, k 2t..2t+1), a1 (row g+8, same k), a2 (row g,
// k 2t+8..), a3 (row g+8, k 2t+8..); b0 (k 2t..2t+1, col g), b1 (k 2t+8..,
// col g); d0, d1 (row g, cols 2t, 2t+1), d2, d3 (row g+8, same cols). So the
// accumulators of two neighbouring n-tiles are, packed, the A fragment of
// one 16-deep k-step: products chain through registers.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8. Plain: register m holds matrix m's (row g,
// cols 2t..2t+1); .trans: its (rows 2t..2t+1, col g).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* smem) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* smem) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// Asynchronous copy of N bytes (4, 8 or 16) from global to shared memory;
// with ok false the N bytes are filled with zeros and nothing is read.
template <int N>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         bool ok) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(a),
               "l"(gmem), "n"(N), "r"(ok ? N : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t bf16_bits(const __nv_bfloat16* p) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(*p));
}

// (x, y) as two bf16 terms hi + lo, each packed as one A-fragment register:
// hi + lo equals (x, y) to about 2^-17 relative, against 2^-9 for hi alone.
__device__ __forceinline__ void split_bf16x2(float x, float y, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// An A fragment (16 rows x 16 of depth, from column c0) read straight from
// global memory: `r0` and `r1` point at rows g and g+8 (nullptr: a row of
// zeros); columns at and beyond D are zeros (the head dim padded to the mma
// depth in registers only).
template <int D>
__device__ __forceinline__ void load_a_frag(uint32_t (&a)[4],
                                            const __nv_bfloat16* r0,
                                            const __nv_bfloat16* r1, int c0) {
  const int c = c0 + 2 * (threadIdx.x & 3);
  auto pair = [](const __nv_bfloat16* r, int col) -> uint32_t {
    return (r != nullptr && col < D) ? bf16_bits(r + col) | (bf16_bits(r + col + 1) << 16)
                                     : 0u;
  };
  a[0] = pair(r0, c);
  a[1] = pair(r1, c);
  a[2] = pair(r0, c + 8);
  a[3] = pair(r1, c + 8);
}

// Stage rows [r0, r0 + kMmaTile) of a [*, D] bf16 operand (row stride
// `stride` elements) into a shared tile of row stride LD: rows at or beyond
// `rend` become zeros. With `vec`, by cp.async in pieces of 16 bytes (or a
// whole row of 8 bytes at D = 4); else by plain loads and stores (a layout
// whose pointer or strides are not aligned to the piece). Columns D.. of the
// tile are not touched.
template <int D, int LD>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           int64_t stride, int r0, int rend,
                                           bool vec) {
  constexpr int kPiece = D >= 8 ? 8 : D;  // bf16 a copy
  constexpr int kPer = D / kPiece;
  if (vec) {
    for (int c = threadIdx.x; c < kMmaTile * kPer; c += blockDim.x) {
      const int r = c / kPer;
      const int part = c - r * kPer;
      const bool ok = r0 + r < rend;
      const __nv_bfloat16* s =
          ok ? src + static_cast<int64_t>(r0 + r) * stride + part * kPiece : src;
      cp_async<kPiece * 2>(dst + r * LD + part * kPiece, s, ok);
    }
  } else {
    for (int e = threadIdx.x; e < kMmaTile * D; e += blockDim.x) {
      const int r = e / D;
      const int d = e - r * D;
      dst[r * LD + d] = r0 + r < rend
                            ? src[static_cast<int64_t>(r0 + r) * stride + d]
                            : __ushort_as_bfloat16(0);
    }
  }
}

// Whether a [B, L, H, D] bf16 operand at `ptr` with these strides can be
// staged by cp.async in the pieces of stage_rows.
__host__ inline bool rows_vectorizable(const void* ptr, int64_t sb,
                                       int64_t sl, int64_t sh, int head_dim) {
  const int64_t piece = 2 * (head_dim >= 8 ? 8 : head_dim);
  const int64_t bits = static_cast<int64_t>(reinterpret_cast<uintptr_t>(ptr)) |
                       (2 * sb) | (2 * sl) | (2 * sh);
  return bits % piece == 0;
}

// The warp's segment ids: the least non-zero id and the largest id among
// `mine` of lanes 0-15 (lanes 16-31 pass 0). hi = 0: the warp has no row.
__device__ __forceinline__ void warp_seg_range(int32_t mine, int32_t* lo,
                                               int32_t* hi) {
  *lo = __reduce_min_sync(0xffffffffu, mine != 0 ? mine : INT32_MAX);
  *hi = __reduce_max_sync(0xffffffffu, mine);
}

}  // namespace flash

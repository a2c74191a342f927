// Shared by the flash-attention kernels (forward, dQ, dK/dV): constants,
// type conversion, the dropout counter hash, the segment-range scans, the
// backward kernels' parameter block, the tensor-core building blocks of the
// bf16 route (mma.sync, ldmatrix, cp.async, the bf16 split of a second
// product's operand; wgmma and its shared-memory tiles for the kernels at
// head dims 64, 128 and 256, and for the column halves and chunks of the
// wgmma_chunks design at 320, 384, 448 and 512), and the pieces of the wide route (the FP32-pipe kernels of f32
// at head dim 128 and of every head dim above 128 that no wgmma instance
// takes).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <cstddef>
#include <type_traits>

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

// triple32 up to its last step (x ^= x >> 16)
__device__ __forceinline__ uint32_t hash_mix(uint32_t seed, uint32_t key) {
  uint32_t x = key + seed;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  return x;
}

__device__ __forceinline__ uint32_t hash_finish(uint32_t seed, uint32_t key) {
  const uint32_t x = hash_mix(seed, key);
  return x ^ (x >> 16);
}

// The keep decision hash_finish(seed, key) >= thresh. SHORT (thresh a
// multiple of 2^16, as the training rate 26/256 gives): the last step leaves
// the high 16 bits alone, so it cannot move the comparison and is skipped.
template <bool SHORT>
__device__ __forceinline__ bool hash_keep(uint32_t seed, uint32_t key, uint32_t thresh) {
  return (SHORT ? hash_mix(seed, key) : hash_finish(seed, key)) >= thresh;
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

// The head dims with a kernel instance (ops/flash_attention.py HEAD_DIMS);
// the wrappers zero-pad any other head dim up to 128 to the next of them.
// The wide kernels read the head dim at run time and need no padding.
template <typename F>
int with_head_dim(int head_dim, F&& f) {
  switch (head_dim) {
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The kernels' designs, in the order of ops/flash_attention.py DESIGNS.
// `design` there is the one place that chooses a launch's design; an entry
// point runs the design it is given, or returns cudaErrorInvalidValue where
// its source has no instance of it at that head dim and input type.
enum Design : int {
  kDesignMma = 0,
  kDesignWgmma = 1,
  kDesignF32 = 2,
  kDesignWide = 3,
  kDesignWgmmaChunks = 4,  // the bf16 kernels above kWgmmaWide, up to kChunksWide
};

// The wgmma design's instance above 128 (ops/flash_attention.py
// WGMMA_WIDE): the wrappers zero-pad bf16 head dims 129-255 to it.
constexpr int kWgmmaWide = 256;

// The bf16 kernels' wgmma_chunks design (ops/flash_attention.py
// CHUNKS_WIDE, CHUNK_STEP): instances at 320, 384, 448 and 512, to which
// the wrappers zero-pad bf16 head dims 257-511 (the next multiple of 64);
// above kChunksWide the three kernels take the wide route.
constexpr int kChunksWide = 512;

// The head dims with an instance of `design`: with_head_dim's, and
// kWgmmaWide in the wgmma design.
template <typename F>
int with_design_head_dim(int head_dim, int design, F&& f) {
  if (head_dim == kWgmmaWide && design == kDesignWgmma)
    return f(std::integral_constant<int, kWgmmaWide>{});
  return with_head_dim(head_dim, f);
}

// The three kernels' head dims: with_design_head_dim's, and 320, 384, 448
// and 512 in the wgmma_chunks design.
template <typename F>
int with_chunks_head_dim(int head_dim, int design, F&& f) {
  if (design == kDesignWgmmaChunks) {
    switch (head_dim) {
      case 320: return f(std::integral_constant<int, 320>{});
      case 384: return f(std::integral_constant<int, 384>{});
      case 448: return f(std::integral_constant<int, 448>{});
      case kChunksWide: return f(std::integral_constant<int, kChunksWide>{});
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return with_design_head_dim(head_dim, design, f);
}

// Whether `design` takes inputs of this type: the wide route both, the f32
// design f32, the tensor-core designs (mma, wgmma, wgmma_chunks) bf16.
constexpr bool design_takes(int design, int is_bf16) {
  return design == kDesignWide || (design == kDesignF32) == !is_bf16;
}

// bf16 route: shared row stride of a tile, D padded to the mma depth 16 and
// by 8 bf16 more, so that ldmatrix is free of bank conflicts.
__host__ __device__ constexpr int mma_ld(int d) { return (d < 16 ? 16 : d) + 8; }

// f32 route: rows of the other axis per tile. At head dim 128 two f32 tiles
// of 64 rows would take 64 KB, past the 48 KB of static shared memory a
// block may declare; tiles of 32 rows take 32 KB.
__host__ __device__ constexpr int f32_tile(int d) { return d > 64 ? 32 : kF32Tile; }

// f32 route: head dims up to 16 fit four blocks (16 warps) per SM in registers.
__host__ __device__ constexpr int f32_min_blocks(int d) { return d <= 16 ? 4 : 1; }

// The bf16 route's two double-buffered operand tiles ([2][kMmaTile][LD]
// bf16 each: K and V, or q and dO). Where they fit the 48 KB a block may
// declare statically they are static shared memory, as up to head dim 64;
// at head dim 128 they take 69,632 bytes and live in dynamic shared memory
// (Hopper gives a block up to 227 KB of it), which the launch asks for
// (`mma_dyn_smem`, `launch_dyn`).
template <int LD>
struct MmaTiles {
  __nv_bfloat16 a[2][kMmaTile][LD];
  __nv_bfloat16 b[2][kMmaTile][LD];
};

constexpr size_t kStaticSmem = 48 * 1024;

// Dynamic shared bytes a launch of the bf16 route at row stride LD asks for.
template <int LD>
__host__ __device__ constexpr size_t mma_dyn_smem() {
  return sizeof(MmaTiles<LD>) > kStaticSmem ? sizeof(MmaTiles<LD>) : 0;
}

template <int LD>
__device__ __forceinline__ MmaTiles<LD>& mma_tiles() {
  if constexpr (mma_dyn_smem<LD>() == 0) {
    __shared__ __align__(16) MmaTiles<LD> tiles;
    return tiles;
  } else {
    extern __shared__ __align__(16) unsigned char dyn_smem[];
    return *reinterpret_cast<MmaTiles<LD>*>(dyn_smem);
  }
}

// Launch `kernel` with `smem` bytes of dynamic shared memory, first raising
// its limit where they pass the 48 KB a launch may take by default. An
// error of either call is left for cudaGetLastError() after the launch.
template <typename... KArgs, typename... Args>
void launch_dyn(void (*kernel)(KArgs...), dim3 grid, int threads, size_t smem,
                cudaStream_t stream, Args... args) {
  if (smem > kStaticSmem)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  kernel<<<grid, threads, smem, stream>>>(args...);
}

// A kernel instance's resources, as cudaFuncGetAttributes reports them:
// static shared bytes, the dynamic shared bytes its launch asks for,
// registers a thread and local (spilled) bytes a thread. Returns a
// cudaError_t.
inline int func_attrs(const void* fn, int dyn_smem, int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = static_cast<int>(a.sharedSizeBytes);
  out[1] = dyn_smem;
  out[2] = a.numRegs;
  out[3] = static_cast<int>(a.localSizeBytes);
  return 0;
}

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
// comes back as first = L, last = -1. Every thread of the block must call,
// and the block is whole warps. Each reduction is taken in the warps first
// and then by one shared atomic a warp: an atomic a thread on one shared
// word serialises (hundreds of them on long rows).
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
  const int32_t wlo = __reduce_min_sync(0xffffffffu, mine != 0 ? mine : INT32_MAX);
  const int32_t whi = __reduce_max_sync(0xffffffffu, mine);
  if ((threadIdx.x & 31) == 0) {
    atomicMin(&lo, wlo);
    atomicMax(&hi, whi);
  }
  __syncthreads();
  const int32_t l = lo, h = hi;
  int f = L, t = -1;
  if (h != 0) {
    for (int j = threadIdx.x; j < L; j += blockDim.x) {
      const int32_t s = seg_b[j];
      if (s >= l && s <= h) {
        f = min(f, j);
        t = max(t, j);
      }
    }
  }
  f = __reduce_min_sync(0xffffffffu, f);
  t = __reduce_max_sync(0xffffffffu, t);
  if ((threadIdx.x & 31) == 0) {
    atomicMin(&r_first, f);
    atomicMax(&r_last, t);
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

// The A operand of a second product (P~ or dS, f32 in the accumulator
// registers) as kSplitTerms bf16 terms hi + mid + lo, each rounded and
// packed as A-fragment registers. Three rounded terms hold every f32 value
// in (2^-100, 1] exactly (each remainder is exact and the last has at most
// 8 significant bits), so the second products carry P~ and dS at full f32
// precision, as the plain version's products do; only the order of the f32
// sums differs. hi alone (2^-9) breaks the elementwise 4e-3 where a sum
// cancels, and hi + lo (about 2^-17) can still miss it where a sum of terms
// near 1 cancels to 1e-4 of them (the cancelling-sum cases of
// tests/test_torch_wide_heads.py and tests/test_torch_fwd_wgmma.py). Every
// design of the bf16 route takes three terms at every head dim.
constexpr int kSplitTerms = 3;

template <int N>
struct SplitA {
  uint32_t t[N][4];  // t[0] hi, then the smaller terms
};

// Element r of the fragment `a` from (x, y): its N bf16x2 terms.
template <int N>
__device__ __forceinline__ void split_bf16x2(float x, float y, SplitA<N>& a, int r) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    a.t[i][r] = *reinterpret_cast<const uint32_t*>(&h);
    if (i + 1 < N) {
      const float2 hf = __bfloat1622float2(h);
      x -= hf.x;
      y -= hf.y;
    }
  }
}

// acc += (sum of the N terms of a) . b for one m16n8k16 tile, largest first.
template <int N>
__device__ __forceinline__ void mma_bf16_split(float (&acc)[4], const SplitA<N>& a,
                                               uint32_t b0, uint32_t b1) {
#pragma unroll
  for (int i = 0; i < N; ++i) mma_bf16(acc, a.t[i], b0, b1);
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

// ---------------------------------------------------------------------------
// wgmma (sm_90a): the bf16 route at head dims 64, 128 and 256
// ---------------------------------------------------------------------------

// A shared tile of ROWS rows x D bf16 in wgmma's core-matrix layout without
// swizzle: [D / 8][ROWS][8], so that each 8 x 8 core matrix (8 rows of 16
// bytes) is 128 contiguous bytes, which wgmma reads free of bank conflicts.
// One tile serves two ways:
// - K-major (the depth K runs along the head dim: the operands of S = q k^T,
//   dP = dO v^T): the next 8 columns lie ROWS * 16 bytes on (LBO), the next 8
//   rows 128 bytes on (SBO); a 16-deep k-step moves the start 2 * ROWS * 16
//   bytes;
// - MN-major (K runs along the rows, N along the head dim: k in dQ = dS k,
//   q and dO in dK = dS^T q, dV = P~^T dO): the next 8 rows lie 128 bytes on
//   (LBO, the K direction), the next 8 columns ROWS * 16 bytes on (SBO); a
//   k-step of 16 rows moves the start 256 bytes.

// The 64-bit shared-memory matrix descriptor of wgmma: start address, LBO
// and SBO (bytes, 16-byte units in the fields), layout type 0 (no swizzle).
__device__ __forceinline__ uint64_t gmma_desc(const void* smem, uint32_t lbo,
                                              uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  return static_cast<uint64_t>((a & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFFu) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFFu) >> 4) << 32);
}
template <int ROWS>
__device__ __forceinline__ uint64_t desc_kmajor(const __nv_bfloat16* tile, int kstep) {
  return gmma_desc(tile + kstep * 2 * ROWS * 8, ROWS * 16, 128);
}
template <int ROWS>
__device__ __forceinline__ uint64_t desc_mnmajor(const __nv_bfloat16* tile, int kstep) {
  return gmma_desc(tile + kstep * 16 * 8, 128, ROWS * 16);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of wgmma's registers
// across this point (the products run asynchronously to the thread).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// Orders this thread's earlier shared-memory writes (cp.async, stores)
// before later reads by wgmma, which go through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One warpgroup's m64nNk16 product, bf16 in, f32 accumulators in registers
// (N / 2 a thread: element 4 i + e is row 16 warp + g + 8 (e >> 1), column
// 8 i + 2 t + (e & 1), as mma.sync's n-tiles), in the two forms the
// kernels use:
// - ss (N 32, 64 and, for the 16-row tiles above 384, 16: S and dP): D
//   (+)= A B^T with A and B K-major tiles in shared memory (acc 0: D is
//   overwritten);
// - rs_t (N 64, 128 and, for the column chunks above 256, 80-256: the
//   second products): D += A B with A from registers
//   (the A fragment of mma.sync m16n8k16 for the warp's 16 rows) and B an
//   MN-major tile.
template <int N>
struct Wgmma;
template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a, uint64_t b,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(acc));
  }
};
template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(acc));
  }
  static __device__ __forceinline__ void rs_t(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void rs_t(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
// The wgmma_chunks design's widths: ss at N 16 (the 16-row tiles at head
// dims 448 and 512); rs_t at N 80, 96, 112, 128 (the dK/dV halves of the
// column chunks at 320, 384, 448, 512) and 160, 192, 224, 256 (the dQ
// and O halves there)
template <>
struct Wgmma<80> {
  static __device__ __forceinline__ void rs_t(float (&d)[40], const uint32_t (&a)[4],
                                              uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39"
        "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <>
struct Wgmma<96> {
  static __device__ __forceinline__ void rs_t(float (&d)[48], const uint32_t (&a)[4],
                                              uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <>
struct Wgmma<160> {
  static __device__ __forceinline__ void rs_t(float (&d)[80], const uint32_t (&a)[4],
                                              uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
        "}, {%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <>
struct Wgmma<192> {
  static __device__ __forceinline__ void rs_t(float (&d)[96], const uint32_t (&a)[4],
                                              uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void ss(float (&d)[8], uint64_t a, uint64_t b,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(acc));
  }
};
template <>
struct Wgmma<112> {
  static __device__ __forceinline__ void rs_t(float (&d)[56], const uint32_t (&a)[4],
                                              uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55"
        "}, {%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <>
struct Wgmma<224> {
  static __device__ __forceinline__ void rs_t(float (&d)[112], const uint32_t (&a)[4],
                                              uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %117, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n224k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111"
        "}, {%112, %113, %114, %115}, %116, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void rs_t(float (&d)[128], const uint32_t (&a)[4],
                                              uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// Rows [r0, r0 + ROWS) of a [*, D] bf16 operand (row stride `stride`
// elements) into a shared tile in the core-matrix layout above; rows at or
// beyond `rend` become zeros. With `vec`, by cp.async in 16-byte pieces: a
// warp takes 8 rows x 4 pieces, so that each quarter warp writes 128
// contiguous shared bytes and each row's 64 global bytes are whole sectors;
// else by plain loads. Needs the block's THREADS threads, D a multiple of 32
// and ROWS a multiple of 8.
template <int D, int ROWS, int THREADS = 128>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           int64_t stride, int r0, int rend, bool vec) {
  constexpr int kGroups = D / 8;  // 16-byte pieces a row
  constexpr int kTasks = ROWS * kGroups / 32;  // 8 rows x 4 pieces a warp
  constexpr int kWarps = THREADS / 32;
  static_assert(kGroups % 4 == 0 && ROWS % 8 == 0, "tile shape");
  if (vec) {
#pragma unroll
    for (int it = 0; it < (kTasks + kWarps - 1) / kWarps; ++it) {
      const int w = it * kWarps + (threadIdx.x >> 5);
      if (kTasks % kWarps != 0 && w >= kTasks) break;  // the last round's idle warps
      const int lane = threadIdx.x & 31;
      const int r = (w / (kGroups / 4)) * 8 + (lane & 7);
      const int cg = (w % (kGroups / 4)) * 4 + (lane >> 3);
      const bool ok = r0 + r < rend;
      const __nv_bfloat16* s = ok ? src + static_cast<int64_t>(r0 + r) * stride + cg * 8 : src;
      cp_async<16>(dst + (cg * ROWS + r) * 8, s, ok);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * D; e += THREADS) {
      const int r = e / D;
      const int d = e - r * D;
      dst[((d >> 3) * ROWS + r) * 8 + (d & 7)] =
          r0 + r < rend ? src[static_cast<int64_t>(r0 + r) * stride + d]
                        : __ushort_as_bfloat16(0);
    }
  }
}

// ---------------------------------------------------------------------------
// the wide route: f32 at head dim 128 and above; bf16 above kChunksWide
// ---------------------------------------------------------------------------

// What it still serves: every f32 head dim from 128 (tensor cores take no
// f32, and TF32 would not hold f32 accuracy) and the three bf16 kernels
// above 512, where the wgmma_chunks design has no instance (the header
// notes of the three sources). No shipped config runs a head dim above 256.

// A block of 128 threads owns kWideRows rows of its own axis (a row a lane)
// and one chunk of kWideChunk output columns (grid z: chunk z of
// ceil(D / kWideChunk)); warp w holds columns [32 w, 32 w + 32) of the chunk
// of each row, so that a warp's 32 lanes read the same shared address
// (one broadcast wavefront a 16-byte load). A dot product over the head dim
// is the sum of the
// four warps' parts, taken through shared memory in a fixed order
// (`wide_reduce`). The other axis runs in tiles of kWideTile rows, staged in
// shared memory as f32 one column chunk at a time, so that no array a
// thread holds grows with the head dim.
constexpr int kWideRows = 32;
constexpr int kWideSplit = 4;  // warps: column blocks of a chunk
constexpr int kWideCols = 32;
constexpr int kWideChunk = kWideSplit * kWideCols;  // 128
constexpr int kWideTile = 16;

__host__ __device__ constexpr int wide_chunks(int d) {
  return (d + kWideChunk - 1) / kWideChunk;
}

// The first head-dim column of this warp's block in chunk `chunk`.
__device__ __forceinline__ int wide_col0(int chunk) {
  return chunk * kWideChunk + (threadIdx.x >> 5) * kWideCols;
}

// This thread's kWideCols elements of a global row (T = float or bf16) in
// chunk `chunk`, as f32; columns at or beyond D are zeros, and so is every
// element when `row` is nullptr.
template <typename T>
__device__ __forceinline__ void load_wide(float (&dst)[kWideCols], const T* row, int chunk,
                                          int D) {
  const int c0 = wide_col0(chunk);
#pragma unroll
  for (int i = 0; i < kWideCols; ++i)
    dst[i] = (row != nullptr && c0 + i < D) ? to_f32(row[c0 + i]) : 0.f;
}

// Rows [r0, r0 + kWideTile) of chunk `chunk` of a [*, D] operand (row
// stride `stride`) into a shared [kWideTile][kWideChunk] f32 tile: rows at
// or beyond `rend`, and columns at or beyond D, become zeros. All 128
// threads take part.
template <typename T>
__device__ __forceinline__ void stage_wide(float (*dst)[kWideChunk], const T* src,
                                           int64_t stride, int r0, int rend, int chunk,
                                           int D) {
  for (int e = threadIdx.x; e < kWideTile * kWideChunk; e += 128) {
    const int r = e / kWideChunk;
    const int cc = e - r * kWideChunk;
    const int col = chunk * kWideChunk + cc;
    dst[r][cc] = (r0 + r < rend && col < D)
                     ? to_f32(src[static_cast<int64_t>(r0 + r) * stride + col])
                     : 0.f;
  }
}

// This thread's part of the dot product of its kWideCols elements with
// this warp's columns of a shared tile row (f32), in four interleaved sums
// (four independent FMA chains instead of one of 32).
__device__ __forceinline__ float wide_dot(const float (&mine)[kWideCols], const float* row) {
  const float* r = row + (threadIdx.x >> 5) * kWideCols;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < kWideCols / 4; ++k) {
    const float4 t = *reinterpret_cast<const float4*>(r + 4 * k);
    acc[0] = fmaf(mine[4 * k], t.x, acc[0]);
    acc[1] = fmaf(mine[4 * k + 1], t.y, acc[1]);
    acc[2] = fmaf(mine[4 * k + 2], t.z, acc[2]);
    acc[3] = fmaf(mine[4 * k + 3], t.w, acc[3]);
  }
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

// acc += w * (this warp's columns of a shared tile row).
__device__ __forceinline__ void wide_axpy(float (&acc)[kWideCols], float w, const float* row) {
  const float* r = row + (threadIdx.x >> 5) * kWideCols;
#pragma unroll
  for (int k = 0; k < kWideCols / 4; ++k) {
    const float4 t = *reinterpret_cast<const float4*>(r + 4 * k);
    acc[4 * k] = fmaf(w, t.x, acc[4 * k]);
    acc[4 * k + 1] = fmaf(w, t.y, acc[4 * k + 1]);
    acc[4 * k + 2] = fmaf(w, t.z, acc[4 * k + 2]);
    acc[4 * k + 3] = fmaf(w, t.w, acc[4 * k + 3]);
  }
}

// Each x[j] summed over the four warps (their column blocks) in a fixed
// order, the same in every warp: the full dot products of this lane's row.
// `red` is shared scratch; the block syncs once inside.
template <int N>
__device__ __forceinline__ void wide_reduce(float (&x)[N], float (*red)[N][kWideRows]) {
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < N; ++j) red[w][j][lane] = x[j];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < N; ++j)
    x[j] = ((red[0][j][lane] + red[1][j][lane]) + red[2][j][lane]) + red[3][j][lane];
}

// This thread's columns of chunk `chunk` of a global output row, from f32.
template <typename T>
__device__ __forceinline__ void store_wide(T* row, const float (&src)[kWideCols], int chunk,
                                           int D, float mul) {
  const int c0 = wide_col0(chunk);
#pragma unroll
  for (int i = 0; i < kWideCols; ++i)
    if (c0 + i < D) row[c0 + i] = from_f32<T>(src[i] * mul);
}

}  // namespace flash

// The counter hash of the port's dropout sites and the place of one site in
// its global tensor: shared by csrc/hash_dropout.cu and csrc/residual_norm.cu,
// so both draw the same keep bits (ops/hash_dropout.py `Site`).
#pragma once

#include <stdint.h>

constexpr int kMaxAxes = 8;

// ops/hash_dropout.py `_SiteStruct`, field by field
struct Site {
  int64_t rows;             // rows of the last axis: numel / s
  int64_t s;                // length of the last axis
  int64_t sq;               // words a row, ceil(s / 4) (blocked bytes)
  int64_t size[kMaxAxes];   // leading axes after merging, outermost first
  uint32_t gstride[kMaxAxes];  // their global strides in words, mod 2^32
  int32_t naxes;            // 0: word index = base + linear word index
  int32_t blocked;          // 1: blocked bytes; 0: one hash an element
  uint32_t base;            // global index of word (element) 0, mod 2^32
  uint32_t seed;
  uint32_t thresh;          // byte threshold (blocked) or u32 threshold
  float inv;                // kept elements are multiplied by this in f32
};

// triple32 over a global word (element) index
__device__ __forceinline__ uint32_t hash1(uint32_t seed, uint32_t idx) {
  uint32_t x = idx * 0x9E3779B1u + seed;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  return x ^ (x >> 16);
}

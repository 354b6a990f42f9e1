// The counter-based dropout hash shared by the epilogue and flash-attention
// kernels: hash_keep_bits of mxnet_tpu/ops/pallas/flash_attention.py:125.
//
// A uint32 per (seed, batch-head bh, global row gi, global column gj):
// Murmur3's finalizer after a linear pre-mix.  uint32 multiplies wrap by
// definition in C++, so the bits equal the JAX package's and the plain
// PyTorch version's (ops/kernels/dropout_hash.py), whatever the tiling.
// An element is kept where the hash is >= the rate's uint32 threshold.
#pragma once
#include <stdint.h>

// The finalizer, for kernels that hoist the pre-mix's per-row and
// per-column products out of their element loops:
// mxt_keep_hash(seed, bh, gi, gj) ==
//   mxt_keep_mix((gi * 0x9E3779B1u) ^ (gj * 0x85EBCA77u) ^
//                (seed + bh * 0xC2B2AE3Du))
__device__ __forceinline__ uint32_t mxt_keep_mix(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t mxt_keep_hash(uint32_t seed, uint32_t bh,
                                                  uint32_t gi, uint32_t gj) {
  uint32_t h = (gi * 0x9E3779B1u) ^ (gj * 0x85EBCA77u);
  h ^= seed + bh * 0xC2B2AE3Du;
  return mxt_keep_mix(h);
}

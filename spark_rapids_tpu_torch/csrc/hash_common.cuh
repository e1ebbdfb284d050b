// Shared device code of the hash-table kernels (hash_insert.cu,
// hash_probe.cu): the home slot of a 64-bit code carried as two int32
// lanes.  Bit for bit the JAX package's _hash_index with salt 0 (murmur3
// fmix32 over lo ^ hi * 0x85EBCA6B), so a table built by hash_insert is
// probed from the same home slots.

#pragma once

#include <stdint.h>

__device__ __forceinline__ uint32_t fmix_slot(int lo, int hi, uint32_t mask) {
    uint32_t h = (uint32_t)lo ^ ((uint32_t)hi * 0x85EBCA6Bu);
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    h ^= h >> 16;
    return h & mask;
}

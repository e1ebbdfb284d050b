// Shared device code of the hash-table kernels (hash_insert.cu,
// hash_probe.cu): the table layout and the home slot of a code.
//
// Layout.  A table of T slots (T a power of two) is T aligned 8-byte words,
// each the whole 64-bit code (hi << 32) | (lo & 0xFFFFFFFF), so a probe
// step is one load and a claim is one 64-bit atomicCAS.  In memory a word
// is the two int32 lanes lo, hi, so the caller's table_lo and table_hi are
// strided views of the words (ops/kernels.py), with no repack.
//
// The empty word.  An empty slot holds HASH_EMPTY, whose eight bytes are
// equal, so one cudaMemsetAsync clears a table.  Codes span all of int64,
// so one key equals HASH_EMPTY and cannot be told from an empty slot in
// the words.  That key is handled out of band: its slot is the reserved
// slot, its own home slot reserved_slot(mask), which no other key ever
// claims (inserts and probes walk past it as if it held another key).  A
// row with that code goes straight to the reserved slot; the insert raises
// a flag, and occupied[reserved] says whether the key was stored.  The
// probe reads occupied only for that key.  The cost is one slot of T and
// one compare per probe step.
//
// The home slot is bit for bit the JAX package's _hash_index with salt 0
// (murmur3 fmix32 over lo ^ hi * 0x85EBCA6B), as the plain versions
// compute it.

#pragma once

#include <stdint.h>

#define HASH_EMPTY_BYTE 0x80
#define HASH_EMPTY 0x8080808080808080ull

__device__ __forceinline__ uint32_t fmix_slot(int lo, int hi, uint32_t mask) {
    uint32_t h = (uint32_t)lo ^ ((uint32_t)hi * 0x85EBCA6Bu);
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    h ^= h >> 16;
    return h & mask;
}

__device__ __forceinline__ unsigned long long pack_code(int lo, int hi) {
    return ((unsigned long long)(uint32_t)hi << 32) | (uint32_t)lo;
}

// The slot kept for the key equal to HASH_EMPTY.
__device__ __forceinline__ uint32_t reserved_slot(uint32_t mask) {
    return fmix_slot((int)(uint32_t)(HASH_EMPTY & 0xFFFFFFFFull),
                     (int)(uint32_t)(HASH_EMPTY >> 32), mask);
}

// hash_insert for Hopper (sm_90a).
//
// Replaces: spark_rapids_tpu/ops/pallas_kernels.py, hash_insert /
// _hash_insert_kernel.  Open-addressing insert of 64-bit row codes carried
// as two int32 lanes (lo, hi): murmur3 fmix32 home slot, linear probing
// capped at max_probe steps.  Outputs the slot of every row (T for dead
// rows and for rows whose probe chain ran past the cap), the table of
// stored codes (one 8-byte word a slot, hash_common.cuh), an occupied flag
// per slot and a table-wide overflow flag.  Only the SET of stored codes
// is contractual: callers order groups by stored code.
//
// What bounds it on this card: dependent accesses, not bytes or
// operations.  A row reads 9 bytes (lo, hi, live) and writes a 4-byte
// slot, coalesced; each probe step is a load from a random slot of a
// table that fits the 50 MB L2 at the path's sizes (2^21 slots are
// 16 MB), each new key adds an atomic compare-and-swap, and a warp waits
// for the longest of its 32 chains.  At the hash group-by's shape it runs
// at about a fifth of its bytes bound (PERF.md).
//
// Design: the TPU kernel inserted one row at a time and relied on its
// sequential grid for freedom from races.  Here every row inserts in
// parallel, and the earlier design's three costs are gone:
// - one load a step: a slot is one aligned 8-byte word (the whole code),
//   not three int32 arrays (lanes and a state word) in three cache lines;
// - one atomic a claim: atomicCAS(word, HASH_EMPTY, code) claims and
//   publishes at once, so there is no claimed-but-unpublished state to
//   spin on and no fence.  A word changes once, from empty to its code,
//   so a thread that reads a stale empty word learns the truth from its
//   CAS; loads bypass L1 (__ldcg) so staleness stays rare.  Rows of one
//   key walk one probe sequence, so the first claim wins and every later
//   row of that key finds it: each key is stored exactly once;
// - fewer passes: cudaMemsetAsync clears the table (8 B a slot), and one
//   coalesced pass writes occupied (8 B read, 1 B written a slot).
// One row a thread at full occupancy, as in the probe, where four rows a
// thread with their chains advanced in turn measured slower on the card
// (more registers, half the threads, and each warp waits for the longest
// of 128 chains; hash_probe.cu, PERF.md).
// A 16-byte slot with sm_90's 128-bit CAS was the alternative; it doubles
// the bytes of every step for a state word that the reserved slot of the
// one key equal to HASH_EMPTY (hash_common.cuh) makes unnecessary.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_common.cuh"

#define HI_THREADS 256

typedef unsigned long long u64;

// One row a thread, eight blocks an SM (at most 32 registers), so that
// 2048 chains are in flight on every SM.
__global__ void __launch_bounds__(HI_THREADS, 8)
hi_insert_kernel(const int* __restrict__ lo, const int* __restrict__ hi,
                 const uint8_t* __restrict__ live, long long n, int T,
                 int max_probe, int* __restrict__ slot,
                 u64* __restrict__ table, uint8_t* __restrict__ flags) {
    const long long i = (long long)blockIdx.x * HI_THREADS + threadIdx.x;
    if (i >= n) return;
    if (!live[i]) {
        slot[i] = T;
        return;
    }
    const uint32_t mask = (uint32_t)T - 1u;
    const uint32_t rs = reserved_slot(mask);
    const int a = lo[i];
    const int b = hi[i];
    const u64 code = pack_code(a, b);
    if (code == HASH_EMPTY) {  // the out-of-band key
        slot[i] = (int)rs;
        flags[1] = 1;
        return;
    }
    uint32_t p = fmix_slot(a, b, mask);
    for (int step = 0; step < max_probe; ++step) {
        const u64 w = __ldcg(table + p);
        if (w == code) {
            slot[i] = (int)p;
            return;
        }
        if (w == HASH_EMPTY && p != rs) {
            const u64 old = atomicCAS(table + p, HASH_EMPTY, code);
            if (old == HASH_EMPTY || old == code) {
                slot[i] = (int)p;
                return;
            }
        }
        p = (p + 1u) & mask;
    }
    flags[0] = 1;  // overflow: the caller discards the output
    slot[i] = T;
}

// occupied[p] = (word != HASH_EMPTY), and at the reserved slot whether the
// key equal to HASH_EMPTY was inserted.  Four slots a thread (two 16-byte
// loads, one 4-byte store) when T >= 4.
__global__ void hi_occupied_kernel(const u64* __restrict__ table, int T,
                                   const uint8_t* __restrict__ flags,
                                   uint8_t* __restrict__ occ) {
    const uint32_t rs = reserved_slot((uint32_t)T - 1u);
    const bool sent = flags[1] != 0;
    const int stride = gridDim.x * blockDim.x;
    const int start = blockIdx.x * blockDim.x + threadIdx.x;
    if (T < 4) {
        for (int p = start; p < T; p += stride)
            occ[p] = table[p] != HASH_EMPTY || ((uint32_t)p == rs && sent);
        return;
    }
    const ulonglong2* t2 = reinterpret_cast<const ulonglong2*>(table);
    uint32_t* o4 = reinterpret_cast<uint32_t*>(occ);
    for (int q = start; q < T / 4; q += stride) {
        const ulonglong2 a = t2[2 * q];
        const ulonglong2 b = t2[2 * q + 1];
        const u64 w[4] = {a.x, a.y, b.x, b.y};
        uint32_t out = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const bool o = w[k] != HASH_EMPTY
                || ((uint32_t)(4 * q + k) == rs && sent);
            out |= (uint32_t)o << (8 * k);
        }
        o4[q] = out;
    }
}

// T must be a power of two.  table is u64[T] (8-byte aligned), occ bool[T]
// (4-byte aligned), flags bool[2]: overflow, then whether the key equal to
// HASH_EMPTY was inserted.  n may be 0 (the table is still cleared and
// occupied written).  Returns the first CUDA error.
extern "C" int srt_hash_insert(const void* lo, const void* hi,
                               const void* live, long long n, int T,
                               int max_probe, void* slot, void* table,
                               void* occ, void* flags, void* stream) {
    if (T < 1 || (T & (T - 1)) != 0 || max_probe < 1 || n < 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = cudaMemsetAsync(table, HASH_EMPTY_BYTE,
                                      (size_t)T * sizeof(u64), s);
    if (err != cudaSuccess) return (int)err;
    err = cudaMemsetAsync(flags, 0, 2, s);
    if (err != cudaSuccess) return (int)err;
    if (n > 0) {
        const long long blocks = (n + HI_THREADS - 1) / HI_THREADS;
        hi_insert_kernel<<<(unsigned int)blocks, HI_THREADS, 0, s>>>(
            (const int*)lo, (const int*)hi, (const uint8_t*)live, n, T,
            max_probe, (int*)slot, (u64*)table, (uint8_t*)flags);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    int work = T < 4 ? T : T / 4;
    int blocks = (work + HI_THREADS - 1) / HI_THREADS;
    if (blocks > 4096) blocks = 4096;
    hi_occupied_kernel<<<blocks, HI_THREADS, 0, s>>>(
        (const u64*)table, T, (const uint8_t*)flags, (uint8_t*)occ);
    return (int)cudaGetLastError();
}

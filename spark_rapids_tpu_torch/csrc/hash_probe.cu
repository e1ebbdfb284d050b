// hash_probe for Hopper (sm_90a).
//
// Replaces: spark_rapids_tpu/ops/pallas_kernels.py, hash_probe /
// _hash_probe_kernel.  For each live row, the slot of a table built by
// hash_insert.cu that holds the row's 64-bit code (two int32 lanes), or T
// when the code is absent: the walk starts at the fmix32 home slot, steps
// linearly, and stops at a match, at an empty slot (a miss), or after
// max_probe slots (a miss).  Dead rows get T without probing.  This is the
// probe half of the single-key equi-join's hash phase A
// (ops/joins.py hash_join_match); the table is valid only from the CUDA
// insert, whose layout (hash_common.cuh) this walk follows.
//
// What bounds it on this card: dependent reads, not bytes.  A row reads
// 9 bytes (lo, hi, live) and writes a 4-byte slot, coalesced; its probes
// are reads of random slots of a read-only table that fits the L2 at the
// path's sizes (2^20 slots are 8 MB), one after another, and a warp waits
// for the longest of its 32 chains.  In the join half the probe rows miss,
// and a miss walks on to an empty slot.  chip_smoke.py prints the bytes
// bound; at the join's probe batch the kernel runs at about a quarter of
// it (PERF.md).
//
// Design: the TPU kernel walked rows one at a time over a VMEM-resident
// table.  The earlier CUDA design read an occupied byte and only then the
// two lanes, from three arrays: two dependent round trips a step.  Here a
// step is one 8-byte load of the whole code (an empty slot holds
// HASH_EMPTY; the one key equal to it is looked up at its reserved slot
// through occupied).  Chains stay in flight through occupancy: one row a
// thread, eight blocks an SM, so 2048 chains on every SM.  Two other ways
// were built and timed at the path's shapes, and both lost (PERF.md):
// four rows a thread, issuing all four home-slot loads before testing any
// (more registers, half the threads, a warp waits for the longest of 128
// chains), and 4 or 8 lanes a row reading one aligned window of slots with
// one coalesced load and voting with __ballot_sync (fewer loads a row, but
// 4 or 8 times the threads and their instructions).
// The table is read-only here: no atomics, reads through __ldg.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_common.cuh"

#define HP_THREADS 256

typedef unsigned long long u64;

__global__ void __launch_bounds__(HP_THREADS, 8)
hp_probe_kernel(const int* __restrict__ lo, const int* __restrict__ hi,
                const uint8_t* __restrict__ live, long long n, int T,
                int max_probe, const u64* __restrict__ table,
                const uint8_t* __restrict__ occ, int* __restrict__ slot) {
    const long long i = (long long)blockIdx.x * HP_THREADS + threadIdx.x;
    if (i >= n) return;
    int out = T;
    if (live[i]) {
        const uint32_t mask = (uint32_t)T - 1u;
        const uint32_t rs = reserved_slot(mask);
        const int a = lo[i];
        const int b = hi[i];
        const u64 code = pack_code(a, b);
        if (code == HASH_EMPTY) {  // the out-of-band key
            if (__ldg(occ + rs)) out = (int)rs;
        } else {
            uint32_t p = fmix_slot(a, b, mask);
            for (int step = 0; step < max_probe; ++step) {
                const u64 w = __ldg(table + p);
                if (w == code) {
                    out = (int)p;
                    break;
                }
                if (w == HASH_EMPTY && p != rs) break;  // a miss
                p = (p + 1u) & mask;
            }
        }
    }
    slot[i] = out;
}

// T must be a power of two.  table is u64[T] from hash_insert.cu, occ
// bool[T], slot int32[n].  Returns cudaGetLastError().
extern "C" int srt_hash_probe(const void* lo, const void* hi,
                              const void* live, long long n, int T,
                              int max_probe, const void* table,
                              const void* occ, void* slot, void* stream) {
    if (T < 1 || (T & (T - 1)) != 0 || max_probe < 1 || n < 0)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaSuccess;
    const unsigned int blocks =
        (unsigned int)((n + HP_THREADS - 1) / HP_THREADS);
    hp_probe_kernel<<<blocks, HP_THREADS, 0, (cudaStream_t)stream>>>(
        (const int*)lo, (const int*)hi, (const uint8_t*)live, n, T, max_probe,
        (const u64*)table, (const uint8_t*)occ, (int*)slot);
    return (int)cudaGetLastError();
}

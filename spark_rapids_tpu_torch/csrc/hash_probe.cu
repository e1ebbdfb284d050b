// hash_probe for Hopper (sm_90a).
//
// Replaces: spark_rapids_tpu/ops/pallas_kernels.py, hash_probe /
// _hash_probe_kernel.  For each live row, the slot of a table built by
// hash_insert.cu that holds the row's 64-bit code (two int32 lanes), or T
// when the code is absent: the walk starts at the fmix32 home slot, steps
// linearly, and stops at a match, at an unoccupied slot (a miss), or after
// max_probe slots (a miss).  Dead rows get T without probing.  This is the
// probe half of the single-key equi-join's hash phase A
// (ops/joins.py hash_join_match); the table is valid only from the CUDA
// insert, whose linear-probing layout this walk follows.
//
// What bounds it on this card: memory latency.  A row reads 9 bytes (lo,
// hi, live) and writes a 4-byte slot, coalesced; but its probes are
// dependent random reads into a 9-byte-per-slot table (lo, hi, occupied),
// each one a round trip to L2 or device memory before the next can start.
// Counting each input byte once and each output byte once gives the
// bytes bound that chip_smoke.py prints; the chains' latency, not that
// traffic, sets the time.
//
// Design: the TPU kernel walked rows one at a time over a VMEM-resident
// table.  Here one thread probes one row, in a grid-stride loop, with
// thousands of rows in flight per SM to hide the latency of each chain.
// The table is read-only, so there are no atomics; reads go through the
// read-only cache (__ldg).  The occupied byte is read first and the two
// lanes only on an occupied slot, so a miss at an empty home slot costs
// one byte.  At the join's load factor (at most 1/2) most chains end
// within a few slots.  Coalescing the table reads or probing with a warp
// per row is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_common.cuh"

#define HP_THREADS 256

__global__ void __launch_bounds__(HP_THREADS)
hp_probe_kernel(const int* __restrict__ lo, const int* __restrict__ hi,
                const uint8_t* __restrict__ live, long long n, int T,
                int max_probe, const int* __restrict__ tlo,
                const int* __restrict__ thi,
                const uint8_t* __restrict__ occ, int* __restrict__ slot) {
    const uint32_t mask = (uint32_t)T - 1u;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += stride) {
        int out = T;
        if (live[i]) {
            const int a = lo[i];
            const int b = hi[i];
            uint32_t p = fmix_slot(a, b, mask);
            for (int step = 0; step < max_probe; ++step) {
                if (!__ldg(occ + p)) break;  // empty slot: a miss
                if (__ldg(tlo + p) == a && __ldg(thi + p) == b) {
                    out = (int)p;
                    break;
                }
                p = (p + 1u) & mask;
            }
        }
        slot[i] = out;
    }
}

// T must be a power of two.  live and occ are bool tensors (one byte
// each); slot is int32[n].  grid_blocks > 0.  Returns cudaGetLastError().
extern "C" int srt_hash_probe(const void* lo, const void* hi,
                              const void* live, long long n, int T,
                              int max_probe, const void* tlo,
                              const void* thi, const void* occ, void* slot,
                              int grid_blocks, void* stream) {
    if (T < 1 || (T & (T - 1)) != 0 || max_probe < 1 || grid_blocks < 1)
        return (int)cudaErrorInvalidValue;
    if (n <= 0) return (int)cudaSuccess;
    hp_probe_kernel<<<grid_blocks, HP_THREADS, 0, (cudaStream_t)stream>>>(
        (const int*)lo, (const int*)hi, (const uint8_t*)live, n, T,
        max_probe, (const int*)tlo, (const int*)thi, (const uint8_t*)occ,
        (int*)slot);
    return (int)cudaGetLastError();
}

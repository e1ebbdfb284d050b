// hash_insert for Hopper (sm_90a).
//
// Replaces: spark_rapids_tpu/ops/pallas_kernels.py, hash_insert /
// _hash_insert_kernel.  Open-addressing insert of 64-bit row codes carried
// as two int32 lanes (lo, hi): murmur3 fmix32 home slot, linear probing
// capped at max_probe steps.  Outputs the slot of every row (T for dead
// rows and for rows whose probe chain ran past the cap), the stored lanes,
// an occupied flag per slot and a table-wide overflow flag.  Only the SET
// of stored codes is contractual: callers order groups by stored code.
//
// What bounds it on this card: memory latency and atomics, well before
// bandwidth.  A row reads 9 bytes (lo, hi, live) and writes a 4-byte slot,
// but its probes land at random slots of a 12-byte-per-slot table (lanes
// plus the state word), so each probe is a dependent random access and
// each claim an atomic compare-and-swap.
//
// Design: the TPU kernel inserted one row at a time and relied on its
// sequential grid for freedom from races.  Here one thread inserts one row
// in parallel with all others.  No code value can mark a slot empty (join
// codes span all of int64), so each slot carries a separate int32 state
// word: 0 empty, 1 claimed, 2 published.  A thread claims an empty slot
// with atomicCAS(state, 0, 1), writes its lanes, fences, and publishes with
// atomicExch(state, 2).  A thread that meets a claimed slot waits for the
// publish, then compares codes.  Rows of one key walk the same probe
// sequence, so the first claim wins and every later row of that key finds
// it: each key is stored exactly once.  The table and the flag are zeroed
// by a first kernel on the same stream, and a last kernel writes
// occupied = (state == 2).

#include <cuda_runtime.h>
#include <stdint.h>

#define HI_THREADS 256

__device__ __forceinline__ uint32_t fmix_slot(int lo, int hi, uint32_t mask) {
    uint32_t h = (uint32_t)lo ^ ((uint32_t)hi * 0x85EBCA6Bu);
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    h ^= h >> 16;
    return h & mask;
}

__global__ void hi_init_kernel(int* __restrict__ tlo, int* __restrict__ thi,
                               int* __restrict__ state, int T,
                               uint8_t* __restrict__ ovf) {
    const int stride = gridDim.x * blockDim.x;
    for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < T; p += stride) {
        tlo[p] = 0;
        thi[p] = 0;
        state[p] = 0;
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) *ovf = 0;
}

__global__ void __launch_bounds__(HI_THREADS)
hi_insert_kernel(const int* __restrict__ lo, const int* __restrict__ hi,
                 const uint8_t* __restrict__ live, long long n, int T,
                 int max_probe, int* __restrict__ slot, int* tlo, int* thi,
                 int* state, uint8_t* ovf) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    if (!live[i]) {
        slot[i] = T;
        return;
    }
    const int a = lo[i];
    const int b = hi[i];
    const uint32_t mask = (uint32_t)T - 1u;
    uint32_t p = fmix_slot(a, b, mask);
    volatile int* vstate = state;
    volatile int* vlo = tlo;
    volatile int* vhi = thi;
    for (int step = 0; step < max_probe; ++step) {
        int s = vstate[p];
        if (s == 0) {
            s = atomicCAS(&state[p], 0, 1);
            if (s == 0) {
                vlo[p] = a;
                vhi[p] = b;
                __threadfence();
                atomicExch(&state[p], 2);
                slot[i] = (int)p;
                return;
            }
        }
        while (s == 1) s = vstate[p];  // another thread is publishing p
        __threadfence();
        if (vlo[p] == a && vhi[p] == b) {
            slot[i] = (int)p;
            return;
        }
        p = (p + 1u) & mask;
    }
    *ovf = 1;
    slot[i] = T;
}

__global__ void hi_occupied_kernel(const int* __restrict__ state, int T,
                                   uint8_t* __restrict__ occ) {
    const int stride = gridDim.x * blockDim.x;
    for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < T; p += stride)
        occ[p] = state[p] == 2 ? 1 : 0;
}

// T must be a power of two.  state is int32[T] scratch; occ (T) and ovf (1)
// are bool tensors, one byte each.  Returns cudaGetLastError().
extern "C" int srt_hash_insert(const void* lo, const void* hi,
                               const void* live, long long n, int T,
                               int max_probe, void* slot, void* tlo,
                               void* thi, void* state, void* occ, void* ovf,
                               void* stream) {
    if (T < 1 || (T & (T - 1)) != 0 || max_probe < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    int table_blocks = (T + HI_THREADS - 1) / HI_THREADS;
    if (table_blocks > 4096) table_blocks = 4096;
    hi_init_kernel<<<table_blocks, HI_THREADS, 0, s>>>(
        (int*)tlo, (int*)thi, (int*)state, T, (uint8_t*)ovf);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (n > 0) {
        long long row_blocks = (n + HI_THREADS - 1) / HI_THREADS;
        hi_insert_kernel<<<(unsigned int)row_blocks, HI_THREADS, 0, s>>>(
            (const int*)lo, (const int*)hi, (const uint8_t*)live, n, T,
            max_probe, (int*)slot, (int*)tlo, (int*)thi, (int*)state,
            (uint8_t*)ovf);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    hi_occupied_kernel<<<table_blocks, HI_THREADS, 0, s>>>(
        (const int*)state, T, (uint8_t*)occ);
    return (int)cudaGetLastError();
}

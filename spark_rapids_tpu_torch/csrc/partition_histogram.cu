// partition_histogram for Hopper (sm_90a).
//
// Replaces: spark_rapids_tpu/ops/pallas_kernels.py, partition_histogram /
// _hist_kernel.  counts[p] = number of rows i with pids[i] == p and
// mask[i].  A pid outside [0, num_parts) is counted nowhere, as the TPU
// kernel's one-hot equality counts it nowhere.  This sizes every exchange
// of the sharded query path: the send side of each all-to-all
// (parallel/partitioning.py layout_by_partition) and the stats passes of
// the distributed aggregate, the shuffled join and the range sort.
//
// What bounds it on this card: memory bandwidth.  A row is 5 bytes in
// (an int32 pid and a bool mask byte) and the output is num_parts int32
// counts, so at 2^23 rows the bytes bound is about 12.5 us at 3.35 TB/s.
// The arithmetic (a compare and an add per row) is far below the card's
// integer rate.
//
// Design: the TPU kernel walked 1024-row blocks in order on one core,
// accumulating a one-hot sum in its output block.  Blocks here run in
// parallel, so the sum is split three ways:
//   - a grid-stride loop over rows, four rows per step through one
//     16-byte load of pids and one 4-byte load of mask bytes when both
//     pointers are aligned for it (a scalar loop otherwise and for the
//     tail);
//   - a private int32 histogram per warp in shared memory, so that the
//     shared-memory atomics of one warp contend only among its own 32
//     lanes (with a handful of bins, one shared copy per block would
//     serialise all of its warps on the same words);
//   - a block merge of the warp copies, then one global atomicAdd per
//     non-zero bin per block.
// Integer counts are order-free, so the result is exact and the same on
// every run.  The caller zeroes ``out`` (torch.zeros) before the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#define PH_THREADS 256
#define PH_WARPS (PH_THREADS / 32)

template <bool VEC>
__global__ void __launch_bounds__(PH_THREADS)
ph_kernel(const int* __restrict__ pids, const uint8_t* __restrict__ mask,
          long long n, int num_parts, int* __restrict__ out) {
    extern __shared__ int hist[];  // [PH_WARPS][num_parts]
    for (int i = threadIdx.x; i < PH_WARPS * num_parts; i += blockDim.x)
        hist[i] = 0;
    __syncthreads();
    int* mine = hist + (threadIdx.x >> 5) * num_parts;
    const unsigned parts = (unsigned)num_parts;
    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long stride = (long long)gridDim.x * blockDim.x;
    long long done = 0;
    if (VEC) {
        const long long n4 = n >> 2;
        const int4* p4 = reinterpret_cast<const int4*>(pids);
        const uchar4* m4 = reinterpret_cast<const uchar4*>(mask);
        for (long long j = tid; j < n4; j += stride) {
            const int4 p = p4[j];
            const uchar4 m = m4[j];
            if (m.x && (unsigned)p.x < parts) atomicAdd(mine + p.x, 1);
            if (m.y && (unsigned)p.y < parts) atomicAdd(mine + p.y, 1);
            if (m.z && (unsigned)p.z < parts) atomicAdd(mine + p.z, 1);
            if (m.w && (unsigned)p.w < parts) atomicAdd(mine + p.w, 1);
        }
        done = n4 << 2;
    }
    for (long long i = done + tid; i < n; i += stride) {
        const int p = pids[i];
        if (mask[i] && (unsigned)p < parts) atomicAdd(mine + p, 1);
    }
    __syncthreads();
    for (int p = threadIdx.x; p < num_parts; p += blockDim.x) {
        int s = 0;
        for (int w = 0; w < PH_WARPS; ++w) s += hist[w * num_parts + p];
        if (s) atomicAdd(out + p, s);
    }
}

// Shared memory one launch needs for num_parts bins (the wrapper checks it
// against srt_partition_histogram_max_parts before calling).
static size_t ph_smem(int num_parts) {
    return (size_t)PH_WARPS * (size_t)num_parts * sizeof(int);
}

// The largest num_parts whose per-warp histograms fit one block's shared
// memory on the current device.
extern "C" int srt_partition_histogram_max_parts() {
    int dev = 0, optin = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return 0;
    if (cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess)
        return 0;
    return optin / (int)(PH_WARPS * sizeof(int));
}

// pids int32[n], mask bool[n] (one byte each), out int32[num_parts]
// zeroed by the caller.  grid_blocks > 0.  Returns cudaGetLastError()
// (or the error of the shared-memory attribute call).
extern "C" int srt_partition_histogram(const void* pids, const void* mask,
                                       long long n, int num_parts,
                                       void* out, int grid_blocks,
                                       void* stream) {
    if (num_parts < 1 || grid_blocks < 1)
        return (int)cudaErrorInvalidValue;
    if (n <= 0) return (int)cudaSuccess;
    const size_t smem = ph_smem(num_parts);
    const bool vec = ((uintptr_t)pids % 16 == 0) && ((uintptr_t)mask % 4 == 0);
    cudaStream_t s = (cudaStream_t)stream;
    if (vec) {
        if (smem > 48 * 1024) {
            cudaError_t e = cudaFuncSetAttribute(
                ph_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                (int)smem);
            if (e != cudaSuccess) return (int)e;
        }
        ph_kernel<true><<<grid_blocks, PH_THREADS, smem, s>>>(
            (const int*)pids, (const uint8_t*)mask, n, num_parts, (int*)out);
    } else {
        if (smem > 48 * 1024) {
            cudaError_t e = cudaFuncSetAttribute(
                ph_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                (int)smem);
            if (e != cudaSuccess) return (int)e;
        }
        ph_kernel<false><<<grid_blocks, PH_THREADS, smem, s>>>(
            (const int*)pids, (const uint8_t*)mask, n, num_parts, (int*)out);
    }
    return (int)cudaGetLastError();
}

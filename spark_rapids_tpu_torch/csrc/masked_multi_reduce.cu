// masked_multi_reduce for Hopper (sm_90a).
//
// Replaces: spark_rapids_tpu/ops/pallas_kernels.py, masked_multi_reduce /
// _multi_reduce_kernel.  For each of N float64 value columns, the sum of
// values[c][i] over rows where mask[i] && valid[c][i], and the count of
// those rows, in one pass over the inputs.
//
// What bounds it on this card: device-memory bandwidth.  A row costs 8 bytes
// of value plus 1 validity byte per column and 1 mask byte; the arithmetic
// (one f64 add and one int add per live row and column) is far below the
// card's rate.
//
// Design: the TPU kernel carried one running sum through its sequential
// grid.  Hopper's blocks run in parallel and in no order, so here a
// grid-stride loop gives every thread its own f64 partial and i32 count per
// column; a warp-shuffle tree and one shared-memory step reduce them per
// block into a [blocks, N] scratch array, and a second small kernel adds the
// block partials of each column in a fixed order.  The grid size is a
// function of n and the card only, and no float atomics are used, so the
// summation order is fixed and repeated runs give bit-identical sums.
// Values are read only for rows whose mask byte is set, so a selective
// filter (TPC-H q6 keeps ~2% of rows) skips most value sectors.
// Up to MMR_MAX_COLS columns ride one launch; the wrapper splits wider
// requests.  A null validity pointer means "all rows valid".

#include <cuda_runtime.h>
#include <stdint.h>

#define MMR_MAX_COLS 8
#define MMR_THREADS 256

struct MmrCols {
    const double* values[MMR_MAX_COLS];
    const uint8_t* valid[MMR_MAX_COLS];
};

__device__ __forceinline__ double warp_sum_f64(double v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xFFFFFFFFu, v, off);
    return v;
}

__device__ __forceinline__ int warp_sum_i32(int v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xFFFFFFFFu, v, off);
    return v;
}

__global__ void __launch_bounds__(MMR_THREADS)
mmr_partials_kernel(MmrCols cols, int ncols, const uint8_t* __restrict__ mask,
                    long long n, double* __restrict__ psum,
                    int* __restrict__ pcnt) {
    double s[MMR_MAX_COLS];
    int c[MMR_MAX_COLS];
#pragma unroll
    for (int k = 0; k < MMR_MAX_COLS; ++k) {
        s[k] = 0.0;
        c[k] = 0;
    }
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += stride) {
        if (!mask[i]) continue;
#pragma unroll
        for (int k = 0; k < MMR_MAX_COLS; ++k) {
            if (k < ncols) {
                const uint8_t* ok = cols.valid[k];
                if (ok == nullptr || ok[i]) {
                    s[k] += cols.values[k][i];
                    c[k] += 1;
                }
            }
        }
    }

    __shared__ double ws[MMR_MAX_COLS][MMR_THREADS / 32];
    __shared__ int wc[MMR_MAX_COLS][MMR_THREADS / 32];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < MMR_MAX_COLS; ++k) {
        if (k < ncols) {
            double v = warp_sum_f64(s[k]);
            int cc = warp_sum_i32(c[k]);
            if (lane == 0) {
                ws[k][warp] = v;
                wc[k][warp] = cc;
            }
        }
    }
    __syncthreads();
    if (warp == 0) {
        const int nwarps = blockDim.x >> 5;
        for (int k = 0; k < ncols; ++k) {
            double v = lane < nwarps ? ws[k][lane] : 0.0;
            int cc = lane < nwarps ? wc[k][lane] : 0;
            v = warp_sum_f64(v);
            cc = warp_sum_i32(cc);
            if (lane == 0) {
                psum[(long long)blockIdx.x * ncols + k] = v;
                pcnt[(long long)blockIdx.x * ncols + k] = cc;
            }
        }
    }
}

// One block per column: add that column's block partials in a fixed order.
__global__ void __launch_bounds__(MMR_THREADS)
mmr_final_kernel(const double* __restrict__ psum, const int* __restrict__ pcnt,
                 int nblocks, int ncols, double* __restrict__ out_sum,
                 int* __restrict__ out_cnt) {
    const int k = blockIdx.x;
    double s = 0.0;
    int c = 0;
    for (int b = threadIdx.x; b < nblocks; b += blockDim.x) {
        s += psum[(long long)b * ncols + k];
        c += pcnt[(long long)b * ncols + k];
    }
    __shared__ double ws[MMR_THREADS / 32];
    __shared__ int wc[MMR_THREADS / 32];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    s = warp_sum_f64(s);
    c = warp_sum_i32(c);
    if (lane == 0) {
        ws[warp] = s;
        wc[warp] = c;
    }
    __syncthreads();
    if (warp == 0) {
        const int nwarps = blockDim.x >> 5;
        s = lane < nwarps ? ws[lane] : 0.0;
        c = lane < nwarps ? wc[lane] : 0;
        s = warp_sum_f64(s);
        c = warp_sum_i32(c);
        if (lane == 0) {
            out_sum[k] = s;
            out_cnt[k] = c;
        }
    }
}

// values/valid: host arrays of ncols device pointers (valid[k] may be null).
// psum/pcnt: scratch of nblocks * ncols elements.  Returns cudaGetLastError().
extern "C" int srt_masked_multi_reduce(const void* const* values,
                                       const void* const* valid, int ncols,
                                       const void* mask, long long n,
                                       int nblocks, void* psum, void* pcnt,
                                       void* out_sum, void* out_cnt,
                                       void* stream) {
    if (ncols < 1 || ncols > MMR_MAX_COLS || nblocks < 1)
        return (int)cudaErrorInvalidValue;
    MmrCols cols;
    for (int k = 0; k < MMR_MAX_COLS; ++k) {
        cols.values[k] = k < ncols ? (const double*)values[k] : nullptr;
        cols.valid[k] = k < ncols ? (const uint8_t*)valid[k] : nullptr;
    }
    cudaStream_t s = (cudaStream_t)stream;
    mmr_partials_kernel<<<nblocks, MMR_THREADS, 0, s>>>(
        cols, ncols, (const uint8_t*)mask, n, (double*)psum, (int*)pcnt);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    mmr_final_kernel<<<ncols, MMR_THREADS, 0, s>>>(
        (const double*)psum, (const int*)pcnt, nblocks, ncols,
        (double*)out_sum, (int*)out_cnt);
    return (int)cudaGetLastError();
}

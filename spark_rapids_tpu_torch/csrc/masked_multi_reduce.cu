// masked_multi_reduce for Hopper (sm_90a).
//
// Replaces: spark_rapids_tpu/ops/pallas_kernels.py, masked_multi_reduce /
// _multi_reduce_kernel.  For each of N float64 value columns, the sum of
// values[c][i] over rows where mask[i] && valid[c][i], and the count of
// those rows, in one pass over the inputs.
//
// What bounds it on this card: device-memory bytes.  Every mask byte is
// read; a column's validity byte and value only where they are needed.
// Counted the guide's way (each needed byte once) that is n + 8 bytes a
// passing row at TPC-H q6's 2% selectivity.  The card reads 32-byte
// sectors, and q6's passing rows are scattered, so nearly every passing
// row costs a sector of its own: the sector floor (every mask sector, the
// validity sectors holding a masked-in row, the value sectors holding a
// passing row) is 1.4x the bytes bound at the q6 batch and 2.5x at a
// dense 30% mask with validity on two of three columns.  The arithmetic (one f64 add a passing row and column)
// is far below the card's rate.
//
// What held the first kernel back: a grid-stride loop read one mask byte
// a thread a step and branched on it before loading the value, so a thread
// walked ~15 dependent steps at 2^22 rows with ~270 KB of mask in flight
// (the card needs MBs), and a second launch merged the block partials.
// This design:
//   - reads the mask 16 bytes (16 rows) a lane with one uint4 load, a
//     warp covering a 512-row tile, and loads the next tile's mask words
//     before it consumes the current ones; the grid fills the card in one
//     wave (2048 threads an SM for one column), so the whole mask of a
//     q6 batch is requested at once;
//   - turns a lane's 16 mask bytes into a 16-bit row bitmap, ANDed with
//     the validity's when that column's validity shares the mask's 16-byte
//     alignment (else validity bytes are read per masked-in row);
//   - hands each lane the bits of rows 32 j + lane (j < 16) with shuffles
//     and loads only its passing rows, four loads in flight before their
//     adds: a sector with no passing row is never requested, and a warp's
//     loads of one step fall on neighbouring rows;
//   - merges in the same launch: each block writes its per-column
//     partials and takes a ticket with one acquire-release atomicAdd; the
//     last block adds every block's partials in block order (read past
//     L1) and resets the ticket for the next launch on its stream.
// The rows before the mask's first 16-byte boundary and after its last
// full 16-byte word (at most 15 each) go through block 0's first warp, one
// row a lane.  No float atomics: the summation order depends only on n,
// the column count, the mask's address mod 16 and the card (the grid), so
// repeated runs give bit-identical sums.  The same data in a view at
// another alignment may differ in the last bits; the engine's masks are
// fresh allocations (512-byte aligned), where the order depends on n
// alone.  Up to MMR_MAX_COLS columns ride
// one launch; the wrapper splits wider requests.  A null validity pointer
// means "all rows valid".

#include <cuda_runtime.h>
#include <stdint.h>

#define MMR_MAX_COLS 8
#define MMR_THREADS 256
#define MMR_WARPS (MMR_THREADS / 32)
#define MMR_TILE_WORDS 32            // 16-byte mask words a warp tile
#define MMR_TILE_ROWS (16 * MMR_TILE_WORDS)
#define MMR_IN_FLIGHT 4              // value loads a lane issues at once
#define FULL 0xFFFFFFFFu

struct MmrArgs {
    const double* values[MMR_MAX_COLS];
    const uint8_t* valid[MMR_MAX_COLS];
    const uint8_t* mask;
    long long n;
    long long head;       // rows before the first 16-byte-aligned mask byte
    long long nvec;       // full 16-byte mask words after the head
    int ncols;
    unsigned valid_vec;   // bit k: valid[k] shares the mask's alignment
    double* psum;         // [gridDim.x, ncols] block partials
    int* pcnt;
    unsigned* ticket;     // 0 before the launch; 0 again after it
    double* out_sum;      // [ncols]
    int* out_cnt;
};

__device__ __forceinline__ double warp_sum_f64(double v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(FULL, v, off);
    return v;
}

__device__ __forceinline__ int warp_sum_i32(int v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(FULL, v, off);
    return v;
}

// Bit k set iff byte k of w is nonzero (4 bits).
__device__ __forceinline__ unsigned nonzero4(unsigned w) {
    unsigned x = (((w & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | w) & 0x80808080u;
    // bytes' flags at bits 0, 8, 16, 24 -> bits 28..31, no carries
    return ((x >> 7) * 0x10204080u) >> 28;
}

// Bit k set iff byte k of the 16 bytes is nonzero (16 bits, row order).
__device__ __forceinline__ unsigned bits16(uint4 q) {
    return nonzero4(q.x) | (nonzero4(q.y) << 4) | (nonzero4(q.z) << 8)
        | (nonzero4(q.w) << 12);
}

__device__ __forceinline__ uint4 load_word(const uint4* p, long long w,
                                           long long nvec) {
    return w < nvec ? __ldcs(p + w) : make_uint4(0u, 0u, 0u, 0u);
}

// Add one tile of a column: rows [0, 512) of v; b16 holds this lane's own
// 16 rows' pass bits (rows 16 lane .. 16 lane + 15).  With per_row, b16 is
// the mask's alone and the validity byte of each masked-in row is read
// here.  Returns the rows counted.
__device__ __forceinline__ int add_tile(const double* __restrict__ v,
                                        const uint8_t* __restrict__ ok,
                                        bool per_row, unsigned b16,
                                        int lane, double& s) {
    // the bits of rows 32 j .. 32 j + 31 sit in lanes 2 j and 2 j + 1;
    // lane 2 j holds all 32 after this shuffle
    const unsigned pair = b16 | (__shfl_down_sync(FULL, b16, 1) << 16);
    unsigned mine = 0;  // bit j: row 32 j + lane passes
#pragma unroll
    for (int j = 0; j < 16; ++j)
        mine |= ((__shfl_sync(FULL, pair, 2 * j) >> lane) & 1u) << j;
    int cnt = 0;
    while (mine) {
        double x[MMR_IN_FLIGHT];
#pragma unroll
        for (int q = 0; q < MMR_IN_FLIGHT; ++q) {
            const int j = __ffs(mine) - 1;  // -1 once mine is empty
            mine &= mine - 1;
            const int r = 32 * j + lane;
            bool p = j >= 0;
            if (per_row && p) p = __ldg(ok + r) != 0;
            x[q] = p ? __ldg(v + r) : 0.0;
            cnt += p;
        }
#pragma unroll
        for (int q = 0; q < MMR_IN_FLIGHT; ++q) s += x[q];
    }
    return per_row ? cnt : __popc(b16);
}

// Block partials, the ticket, and the last block's fixed-order merge.
template <int NC>
__device__ __forceinline__ void finish(const MmrArgs& a, double (&s)[NC],
                                       int (&c)[NC]) {
    __shared__ double ws[NC][MMR_WARPS];
    __shared__ int wc[NC][MMR_WARPS];
    __shared__ bool last;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
        const double v = warp_sum_f64(s[k]);
        const int cc = warp_sum_i32(c[k]);
        if (lane == 0) {
            ws[k][warp] = v;
            wc[k][warp] = cc;
        }
    }
    __syncthreads();
    if (warp == 0) {
        for (int k = 0; k < a.ncols; ++k) {
            double v = lane < MMR_WARPS ? ws[k][lane] : 0.0;
            int cc = lane < MMR_WARPS ? wc[k][lane] : 0;
            v = warp_sum_f64(v);
            cc = warp_sum_i32(cc);
            if (lane == 0) {
                a.psum[(long long)blockIdx.x * a.ncols + k] = v;
                a.pcnt[(long long)blockIdx.x * a.ncols + k] = cc;
            }
        }
        if (lane == 0) {
            // release: this block's partials before its ticket; acquire:
            // the other blocks' partials after it
            unsigned prev;
            asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                         : "=r"(prev) : "l"(a.ticket) : "memory");
            last = prev == gridDim.x - 1;
        }
    }
    __syncthreads();
    if (!last) return;
    for (int k = 0; k < a.ncols; ++k) {
        double v = 0.0;
        int cc = 0;
        for (int b = threadIdx.x; b < (int)gridDim.x; b += MMR_THREADS) {
            v += __ldcg(a.psum + (long long)b * a.ncols + k);
            cc += __ldcg(a.pcnt + (long long)b * a.ncols + k);
        }
        v = warp_sum_f64(v);
        cc = warp_sum_i32(cc);
        __syncthreads();  // ws is free again
        if (lane == 0) {
            ws[0][warp] = v;
            wc[0][warp] = cc;
        }
        __syncthreads();
        if (warp == 0) {
            v = lane < MMR_WARPS ? ws[0][lane] : 0.0;
            cc = lane < MMR_WARPS ? wc[0][lane] : 0;
            v = warp_sum_f64(v);
            cc = warp_sum_i32(cc);
            if (lane == 0) {
                a.out_sum[k] = v;
                a.out_cnt[k] = cc;
            }
        }
    }
    if (threadIdx.x == 0) *a.ticket = 0u;
}

// Blocks an SM should hold: the register budget ptxas aims at (one column:
// 32 registers, the whole SM's 2048 threads).
template <int NC>
constexpr int min_blocks() {
    return NC == 1 ? 8 : NC == 4 ? 5 : 3;
}

// NC: the most columns this instance handles (a.ncols <= NC).
template <int NC>
__global__ void __launch_bounds__(MMR_THREADS, (min_blocks<NC>()))
mmr_kernel(const MmrArgs a) {
    double s[NC];
    int c[NC];
#pragma unroll
    for (int k = 0; k < NC; ++k) {
        s[k] = 0.0;
        c[k] = 0;
    }
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;

    // head and tail: at most 15 rows each, one a lane of block 0's warp 0
    if (blockIdx.x == 0 && warp == 0) {
        const long long tail0 = a.head + 16 * a.nvec;
        long long r = -1;
        if (lane < a.head) r = lane;
        else if (lane >= 16 && tail0 + lane - 16 < a.n) r = tail0 + lane - 16;
        if (r >= 0 && a.mask[r]) {
#pragma unroll
            for (int k = 0; k < NC; ++k) {
                if (k < a.ncols
                    && (a.valid[k] == nullptr || a.valid[k][r])) {
                    s[k] += a.values[k][r];
                    c[k] += 1;
                }
            }
        }
    }

    // body: warp tiles of 512 rows, warp-strided, next tile's mask first
    const uint4* m4 = reinterpret_cast<const uint4*>(a.mask + a.head);
    const long long ntiles = (a.nvec + MMR_TILE_WORDS - 1) / MMR_TILE_WORDS;
    const long long stride = (long long)gridDim.x * MMR_WARPS;
    long long t = (long long)blockIdx.x * MMR_WARPS + warp;
    uint4 cur = load_word(m4, t * MMR_TILE_WORDS + lane, a.nvec);
    for (; t < ntiles; t += stride) {
        const uint4 nxt = load_word(m4, (t + stride) * MMR_TILE_WORDS + lane,
                                    a.nvec);
        const unsigned m16 = bits16(cur);
        const long long row0 = a.head + t * MMR_TILE_ROWS;
        const long long word = t * MMR_TILE_WORDS + lane;
#pragma unroll
        for (int k = 0; k < NC; ++k) {
            if (k < a.ncols) {
                const uint8_t* ok = a.valid[k];
                unsigned b16 = m16;
                bool per_row = false;
                if (ok != nullptr) {
                    if ((a.valid_vec >> k) & 1u) {
                        // m16 != 0 only for a word inside the body
                        const uint4 q = m16 ? __ldcs(reinterpret_cast<
                            const uint4*>(ok + a.head) + word)
                            : make_uint4(0u, 0u, 0u, 0u);
                        b16 &= bits16(q);
                    } else {
                        per_row = true;
                    }
                }
                c[k] += add_tile(a.values[k] + row0,
                                 per_row ? ok + row0 : nullptr, per_row,
                                 b16, lane, s[k]);
            }
        }
        cur = nxt;
    }
    finish<NC>(a, s, c);
}

template <int NC>
static int blocks_per_sm() {
    int b = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &b, mmr_kernel<NC>, MMR_THREADS, 0) != cudaSuccess)
        return 0;
    return b;
}

// Resident blocks an SM holds of the instance that serves ncols columns
// (1, up to 4, up to 8), 0 on error: the wrapper sizes a one-wave grid
// from it.
extern "C" int srt_mmr_blocks_per_sm(int ncols) {
    if (ncols < 1 || ncols > MMR_MAX_COLS) return 0;
    return ncols <= 1 ? blocks_per_sm<1>()
        : ncols <= 4 ? blocks_per_sm<4>() : blocks_per_sm<8>();
}

// values/valid: host arrays of ncols device pointers (valid[k] may be
// null).  Rows [0, head) and [head + 16 nvec, n) are the scalar head and
// tail (at most 15 rows each); mask + head is 16-byte aligned when nvec >
// 0.  psum/pcnt: scratch of nblocks * ncols elements; ticket: one
// unsigned that is 0 and is left 0.  Returns cudaGetLastError().
extern "C" int srt_masked_multi_reduce(const void* const* values,
                                       const void* const* valid, int ncols,
                                       const void* mask, long long n,
                                       long long head, long long nvec,
                                       int nblocks, void* psum, void* pcnt,
                                       void* ticket, void* out_sum,
                                       void* out_cnt, void* stream) {
    const long long tail = n - head - 16 * nvec;
    if (ncols < 1 || ncols > MMR_MAX_COLS || nblocks < 1 || head < 0
        || head > 15 || nvec < 0 || tail < 0 || tail > 15
        || (nvec > 0 && ((uintptr_t)mask + head) % 16 != 0))
        return (int)cudaErrorInvalidValue;
    MmrArgs a;
    a.valid_vec = 0u;
    for (int k = 0; k < MMR_MAX_COLS; ++k) {
        a.values[k] = k < ncols ? (const double*)values[k] : nullptr;
        a.valid[k] = k < ncols ? (const uint8_t*)valid[k] : nullptr;
        if (a.valid[k] != nullptr
            && ((uintptr_t)a.valid[k] - (uintptr_t)mask) % 16 == 0)
            a.valid_vec |= 1u << k;
    }
    a.mask = (const uint8_t*)mask;
    a.n = n;
    a.head = head;
    a.nvec = nvec;
    a.ncols = ncols;
    a.psum = (double*)psum;
    a.pcnt = (int*)pcnt;
    a.ticket = (unsigned*)ticket;
    a.out_sum = (double*)out_sum;
    a.out_cnt = (int*)out_cnt;
    cudaStream_t s = (cudaStream_t)stream;
    if (ncols <= 1)
        mmr_kernel<1><<<nblocks, MMR_THREADS, 0, s>>>(a);
    else if (ncols <= 4)
        mmr_kernel<4><<<nblocks, MMR_THREADS, 0, s>>>(a);
    else
        mmr_kernel<8><<<nblocks, MMR_THREADS, 0, s>>>(a);
    return (int)cudaGetLastError();
}

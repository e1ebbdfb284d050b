// Host runtime of the PyTorch engine: staging memory, the columnar frame
// codec of spilled batches (raw, zero-run zrle and the LZ4-class lzb),
// streamed spill-file IO, and a background file prefetcher.  A copy of
// the JAX package's native/host_runtime.cpp, byte for byte in its
// functions, so a frame either package writes the other decodes
// (RapidsDiskStore and the multithreaded-reader pool are the reference's
// counterparts: GpuDeviceManager.scala:216, GpuColumnarBatchSerializer
// .scala:25, GpuParquetScan.scala:973).  Everything here runs on the
// host, around the device work.
//
// Exposed as a flat C ABI consumed from Python through ctypes
// (spark_rapids_tpu_torch/native/__init__.py), which builds it with g++
// on first use.  No external dependencies.  Against the JAX package's file
// it adds one thing: a large frame encodes and decodes its buffers on
// several threads (each buffer whole on one thread, so the frame's bytes
// do not change).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <functional>
#include <map>
#include <mutex>
#include <new>
#include <string>
#include <thread>
#include <vector>

#if defined(__unix__) || defined(__APPLE__)
#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// 1. Host arena allocator (pinned-pool analog).
//
// A growable arena of large slabs with a size-bucketed free list.  Staging
// buffers for device upload/download and shuffle assembly are allocated and
// released in waves; a bump-with-recycling arena avoids malloc churn and
// fragmentation the way the reference's RMM pool does for pinned memory.
// ---------------------------------------------------------------------------

struct ArenaBlock {
    uint8_t *base;
    size_t size;
    size_t used;
};

struct Arena {
    std::mutex mu;
    std::vector<ArenaBlock> blocks;
    // free list: size -> list of (ptr, size) recycled allocations
    std::multimap<size_t, uint8_t *> free_list;
    size_t slab_bytes;
    size_t total_reserved = 0;
    size_t total_allocated = 0;  // live bytes handed out
    size_t high_watermark = 0;
};

static const size_t kAlign = 64;

static size_t align_up(size_t n) { return (n + kAlign - 1) & ~(kAlign - 1); }

void *arena_create(size_t slab_bytes) {
    Arena *a = new (std::nothrow) Arena();
    if (!a) return nullptr;
    a->slab_bytes = slab_bytes < (1u << 20) ? (1u << 20) : slab_bytes;
    return a;
}

void *arena_alloc(void *arena, size_t nbytes) {
    Arena *a = static_cast<Arena *>(arena);
    size_t want = align_up(nbytes ? nbytes : 1);
    std::lock_guard<std::mutex> lock(a->mu);
    // exact-or-larger recycled block (first fit in size order, split never:
    // buffers cluster around repeated sizes so exact reuse dominates)
    auto it = a->free_list.lower_bound(want);
    if (it != a->free_list.end() && it->first <= want * 2) {
        uint8_t *p = it->second;
        a->free_list.erase(it);
        a->total_allocated += want;
        if (a->total_allocated > a->high_watermark)
            a->high_watermark = a->total_allocated;
        return p;
    }
    // bump from the last slab
    if (a->blocks.empty() ||
        a->blocks.back().used + want > a->blocks.back().size) {
        size_t slab = want > a->slab_bytes ? want : a->slab_bytes;
        uint8_t *base = static_cast<uint8_t *>(std::malloc(slab));
        if (!base) return nullptr;
        a->blocks.push_back({base, slab, 0});
        a->total_reserved += slab;
    }
    ArenaBlock &b = a->blocks.back();
    uint8_t *p = b.base + b.used;
    b.used += want;
    a->total_allocated += want;
    if (a->total_allocated > a->high_watermark)
        a->high_watermark = a->total_allocated;
    return p;
}

void arena_free(void *arena, void *ptr, size_t nbytes) {
    Arena *a = static_cast<Arena *>(arena);
    size_t want = align_up(nbytes ? nbytes : 1);
    std::lock_guard<std::mutex> lock(a->mu);
    a->free_list.emplace(want, static_cast<uint8_t *>(ptr));
    a->total_allocated -= want;
}

void arena_stats(void *arena, size_t *reserved, size_t *allocated,
                 size_t *watermark) {
    Arena *a = static_cast<Arena *>(arena);
    std::lock_guard<std::mutex> lock(a->mu);
    *reserved = a->total_reserved;
    *allocated = a->total_allocated;
    *watermark = a->high_watermark;
}

void arena_destroy(void *arena) {
    Arena *a = static_cast<Arena *>(arena);
    for (auto &b : a->blocks) std::free(b.base);
    delete a;
}

// ---------------------------------------------------------------------------
// 2. Columnar frame serializer (JCudfSerialization analog).
//
// Frame layout (little-endian):
//   u32 magic 'TCF1' | u32 ncols | u64 nrows
//   per column: u8 dtype_code | u8 flags (1=validity, 2=offsets)
//               u64 data_len | u64 validity_len | u64 offsets_len
//   then per column, each buffer: u8 codec (0=raw, 1=zrle)
//               u64 encoded_len | bytes
// zrle: runs of zero bytes collapse to (0x00, varint run_len); literal runs
// are (len-prefixed) copies — validity masks and null-heavy payloads are
// mostly zeros/ones, the cheap win the reference gets from nvcomp-LZ4.
// ---------------------------------------------------------------------------

static void put_u32(std::vector<uint8_t> &o, uint32_t v) {
    o.insert(o.end(), reinterpret_cast<uint8_t *>(&v),
             reinterpret_cast<uint8_t *>(&v) + 4);
}
static void put_u64(std::vector<uint8_t> &o, uint64_t v) {
    o.insert(o.end(), reinterpret_cast<uint8_t *>(&v),
             reinterpret_cast<uint8_t *>(&v) + 8);
}
static void put_varint(std::vector<uint8_t> &o, uint64_t v) {
    while (v >= 0x80) {
        o.push_back(static_cast<uint8_t>(v) | 0x80);
        v >>= 7;
    }
    o.push_back(static_cast<uint8_t>(v));
}
static uint64_t get_varint(const uint8_t *&p) {
    uint64_t v = 0;
    int shift = 0;
    while (*p & 0x80) {
        v |= static_cast<uint64_t>(*p++ & 0x7F) << shift;
        shift += 7;
    }
    v |= static_cast<uint64_t>(*p++) << shift;
    return v;
}

// bounded variant: never reads at/past `end`; returns false on truncation
static bool get_varint_bounded(const uint8_t *&p, const uint8_t *end,
                               uint64_t *out) {
    uint64_t v = 0;
    int shift = 0;
    while (p < end && (*p & 0x80)) {
        v |= static_cast<uint64_t>(*p++ & 0x7F) << shift;
        shift += 7;
        if (shift > 63) return false;
    }
    if (p >= end) return false;
    v |= static_cast<uint64_t>(*p++) << shift;
    *out = v;
    return true;
}

// zero-run-length encode; returns false (caller stores raw) when no gain
static bool zrle_encode(const uint8_t *src, size_t n,
                        std::vector<uint8_t> &out) {
    out.clear();
    out.reserve(n / 2);
    size_t i = 0;
    while (i < n) {
        if (src[i] == 0) {
            size_t run = 1;
            while (i + run < n && src[i + run] == 0) run++;
            out.push_back(0x00);
            put_varint(out, run);
            i += run;
        } else {
            size_t lit = 1;
            while (i + lit < n && src[i + lit] != 0) lit++;
            out.push_back(0x01);
            put_varint(out, lit);
            out.insert(out.end(), src + i, src + i + lit);
            i += lit;
        }
        if (out.size() >= n) return false;  // not compressing, bail
    }
    return out.size() < n;
}

// returns 0 on success, <0 on corrupt/truncated input; every run length is
// bounded against both the remaining source and the destination capacity so
// a bad spill/cache file yields an error code, not a heap overflow
static int zrle_decode(const uint8_t *src, size_t encoded_len, uint8_t *dst,
                       size_t n) {
    const uint8_t *p = src;
    const uint8_t *end = src + encoded_len;
    size_t o = 0;
    while (p < end && o < n) {
        uint8_t tag = *p++;
        uint64_t len;
        if (!get_varint_bounded(p, end, &len)) return -1;
        if (len > n - o) return -2;
        if (tag == 0x00) {
            std::memset(dst + o, 0, len);
        } else {
            if (len > static_cast<uint64_t>(end - p)) return -3;
            std::memcpy(dst + o, p, len);
            p += len;
        }
        o += len;
    }
    // a truncated stream that under-fills the destination is corrupt —
    // accepting it would hand back uninitialized tail bytes
    return o == n ? 0 : -5;
}

// ---------------------------------------------------------------------------
// lzb: LZ4-class byte compressor (greedy hash-table match finder, 64 KiB
// window; own framing, no interop needed).  The general-payload codec the
// reference gets from nvcomp-LZ4 (TableCompressionCodec.scala) — zrle stays
// the cheap win for zero-heavy validity masks, lzb catches repetitive data
// and string payloads.
//
// Stream: tokens of u8 (lit_len:4 | match_len:4); lit_len==15 extends by
// varint; literal bytes; u16 LE offset (0 = end marker, stream ends after
// the final literal run); match_len==15 extends by varint; real match
// length = match_len + 4.
// ---------------------------------------------------------------------------
static bool lzb_encode(const uint8_t *src, size_t n,
                       std::vector<uint8_t> &out) {
    out.clear();
    if (n < 16) return false;
    out.reserve(n / 2);
    const uint32_t HBITS = 13;
    // reused across calls: frame_serialize invokes this once per buffer
    // per column, and a fresh 64 KiB table per call would dominate the
    // spill/cache hot path for wide frames
    static thread_local std::vector<int64_t> head;
    head.assign(1u << HBITS, -1);
    auto hash4 = [&](uint32_t v) { return (v * 2654435761u) >> (32 - HBITS); };
    size_t i = 0, anchor = 0;
    while (i + 4 <= n) {
        uint32_t v;
        std::memcpy(&v, src + i, 4);
        uint32_t h = hash4(v);
        int64_t cand = head[h];
        head[h] = static_cast<int64_t>(i);
        if (cand >= 0 && i - cand <= 0xFFFF) {
            uint32_t cv;
            std::memcpy(&cv, src + cand, 4);
            if (cv == v) {
                size_t m = 4;
                while (i + m < n && src[cand + m] == src[i + m]) m++;
                size_t lit = i - anchor;
                size_t ml = m - 4;
                out.push_back(static_cast<uint8_t>(
                    ((lit < 15 ? lit : 15) << 4) | (ml < 15 ? ml : 15)));
                if (lit >= 15) put_varint(out, lit - 15);
                out.insert(out.end(), src + anchor, src + i);
                uint16_t off = static_cast<uint16_t>(i - cand);
                out.push_back(static_cast<uint8_t>(off & 0xFF));
                out.push_back(static_cast<uint8_t>(off >> 8));
                if (ml >= 15) put_varint(out, ml - 15);
                i += m;
                anchor = i;
                if (out.size() >= n) return false;
                continue;
            }
        }
        i++;
    }
    size_t lit = n - anchor;
    out.push_back(static_cast<uint8_t>((lit < 15 ? lit : 15) << 4));
    if (lit >= 15) put_varint(out, lit - 15);
    out.insert(out.end(), src + anchor, src + n);
    out.push_back(0);
    out.push_back(0);  // offset 0 = end marker
    return out.size() < n;
}

// 0 on success, <0 on corrupt input; all lengths/offsets bounded against
// source remainder, destination capacity, and decoded position
static int lzb_decode(const uint8_t *src, size_t encoded_len, uint8_t *dst,
                      size_t n) {
    const uint8_t *p = src;
    const uint8_t *end = src + encoded_len;
    size_t o = 0;
    while (p < end) {
        uint8_t tok = *p++;
        uint64_t lit = tok >> 4;
        if (lit == 15) {
            uint64_t ext;
            if (!get_varint_bounded(p, end, &ext)) return -1;
            lit += ext;
        }
        if (lit > n - o || lit > static_cast<uint64_t>(end - p)) return -2;
        std::memcpy(dst + o, p, lit);
        p += lit;
        o += lit;
        if (end - p < 2) return -3;
        uint16_t off = static_cast<uint16_t>(p[0] | (p[1] << 8));
        p += 2;
        if (off == 0) return o == n ? 0 : -4;  // end marker
        uint64_t ml = tok & 15;
        if (ml == 15) {
            uint64_t ext;
            if (!get_varint_bounded(p, end, &ext)) return -5;
            ml += ext;
        }
        ml += 4;
        if (off > o) return -6;
        if (ml > n - o) return -7;
        for (uint64_t j = 0; j < ml; j++, o++)  // overlap-safe byte copy
            dst[o] = dst[o - off];
    }
    return -8;  // ran out of input before the end marker
}

struct FrameBuf {
    std::vector<uint8_t> bytes;
};

// One buffer's encoding at a codec level: codec 0 (raw), 1 (zrle) or 2
// (lzb), whichever is smallest of those the level tries.
struct EncodedBuf {
    uint8_t codec = 0;
    std::vector<uint8_t> bytes;  // empty for raw: the source is copied
};

static void encode_buf(const uint8_t *src, uint64_t n, int try_compress,
                       EncodedBuf &out, std::vector<uint8_t> &scratch) {
    bool z = try_compress >= 1 && n >= 64 && zrle_encode(src, n, scratch);
    bool l = try_compress >= 2 && n >= 64 && lzb_encode(src, n, out.bytes);
    if (l && (!z || out.bytes.size() < scratch.size())) {
        out.codec = 2;
    } else if (z) {
        out.codec = 1;
        out.bytes.swap(scratch);
    } else {
        out.codec = 0;
        out.bytes.clear();
    }
}

// Frames past this many buffer bytes encode and decode their buffers on
// several threads at once (each buffer whole, on one thread, so the
// bytes are those of the one-thread loop).
static const uint64_t kParallelBytes = 1u << 20;

static unsigned codec_threads(size_t jobs, uint64_t total) {
    if (total < kParallelBytes || jobs < 2) return 1;
    unsigned hw = std::thread::hardware_concurrency();
    unsigned t = hw ? hw : 4;
    if (t > 8) t = 8;
    return static_cast<unsigned>(jobs < t ? jobs : t);
}

// Runs job(i) for i in [0, jobs) on ``threads`` threads (the caller's one
// of them), each taking the next index.
static void run_jobs(size_t jobs, unsigned threads,
                     const std::function<void(size_t)> &job) {
    std::atomic<size_t> next(0);
    auto worker = [&]() {
        for (size_t i; (i = next.fetch_add(1)) < jobs;) job(i);
    };
    std::vector<std::thread> pool;
    for (unsigned t = 1; t < threads; t++) pool.emplace_back(worker);
    worker();
    for (auto &th : pool) th.join();
}

// buffers: 3 per column (data, validity, offsets); null ptr + 0 len = absent
void *frame_serialize(uint64_t nrows, uint32_t ncols,
                      const uint8_t **bufs, const uint64_t *lens,
                      const uint8_t *dtype_codes, int try_compress,
                      uint64_t *out_len) {
    FrameBuf *f = new FrameBuf();
    std::vector<uint8_t> &o = f->bytes;
    put_u32(o, 0x31464354u);  // 'TCF1'
    put_u32(o, ncols);
    put_u64(o, nrows);
    for (uint32_t c = 0; c < ncols; c++) {
        uint8_t flags = 0;
        if (bufs[c * 3 + 1]) flags |= 1;
        if (bufs[c * 3 + 2]) flags |= 2;
        o.push_back(dtype_codes[c]);
        o.push_back(flags);
        put_u64(o, lens[c * 3 + 0]);
        put_u64(o, lens[c * 3 + 1]);
        put_u64(o, lens[c * 3 + 2]);
    }
    // try_compress: 0 = raw, 1 = zrle, 2 = zrle AND lzb, keep the smaller
    std::vector<uint32_t> present;
    uint64_t total = 0;
    for (uint32_t i = 0; i < 3 * ncols; i++) {
        if (bufs[i] && lens[i]) {
            present.push_back(i);
            total += lens[i];
        }
    }
    std::vector<EncodedBuf> enc(present.size());
    unsigned threads = try_compress >= 1
                           ? codec_threads(present.size(), total) : 1;
    run_jobs(present.size(), threads, [&](size_t j) {
        std::vector<uint8_t> scratch;
        encode_buf(bufs[present[j]], lens[present[j]], try_compress, enc[j],
                   scratch);
    });
    size_t size = o.size();
    for (size_t j = 0; j < present.size(); j++)
        size += 9 + (enc[j].codec == 0 ? lens[present[j]]
                                       : enc[j].bytes.size());
    o.reserve(size);
    for (size_t j = 0; j < present.size(); j++) {
        const uint8_t *src = bufs[present[j]];
        uint64_t n = lens[present[j]];
        o.push_back(enc[j].codec);
        if (enc[j].codec == 0) {
            put_u64(o, n);
            o.insert(o.end(), src, src + n);
        } else {
            put_u64(o, enc[j].bytes.size());
            o.insert(o.end(), enc[j].bytes.begin(), enc[j].bytes.end());
        }
    }
    *out_len = o.size();
    return f;
}

const uint8_t *frame_data(void *frame) {
    return static_cast<FrameBuf *>(frame)->bytes.data();
}

void frame_release(void *frame) { delete static_cast<FrameBuf *>(frame); }

// parse header only: fills nrows/ncols and per-buffer lengths so the caller
// can allocate destinations, then frame_deserialize copies/decodes into them
int frame_header(const uint8_t *src, uint64_t src_len, uint64_t *nrows,
                 uint32_t *ncols, uint64_t *lens /*cap 3*max_cols*/,
                 uint8_t *dtype_codes, uint32_t max_cols) {
    if (src_len < 16) return -1;
    uint32_t magic;
    std::memcpy(&magic, src, 4);
    if (magic != 0x31464354u) return -2;
    uint32_t nc;
    std::memcpy(&nc, src + 4, 4);
    if (nc > max_cols) return -3;
    if (src_len < 16 + 26ull * nc) return -4;  // truncated header
    std::memcpy(nrows, src + 8, 8);
    *ncols = nc;
    const uint8_t *p = src + 16;
    for (uint32_t c = 0; c < nc; c++) {
        dtype_codes[c] = p[0];
        std::memcpy(&lens[c * 3 + 0], p + 2, 8);
        std::memcpy(&lens[c * 3 + 1], p + 10, 8);
        std::memcpy(&lens[c * 3 + 2], p + 18, 8);
        p += 26;
    }
    return static_cast<int>(p - src);  // offset where buffer section starts
}

int frame_deserialize(const uint8_t *src, uint64_t src_len,
                      uint8_t **dst_bufs, const uint64_t *lens,
                      uint32_t ncols, int header_off) {
    // walk the buffer headers in order first (the first bad one's code is
    // the answer), then decode the buffers, several at once in a large
    // frame; the lowest failing buffer's code is returned
    const uint8_t *p = src + header_off;
    const uint8_t *end = src + src_len;
    struct Piece {
        uint32_t idx;
        uint8_t codec;
        const uint8_t *data;
        uint64_t enc_len;
    };
    std::vector<Piece> pieces;
    uint64_t total = 0;
    for (uint32_t c = 0; c < ncols; c++) {
        for (int k = 0; k < 3; k++) {
            uint64_t n = lens[c * 3 + k];
            if (!dst_bufs[c * 3 + k] || n == 0) continue;
            if (end - p < 9) return -1;
            uint8_t codec = *p++;
            uint64_t enc_len;
            std::memcpy(&enc_len, p, 8);
            p += 8;
            if (enc_len > static_cast<uint64_t>(end - p)) return -2;
            // raw buffers are written at exactly the header length; a
            // shorter payload is truncation (uninitialized tail)
            if (codec == 0 && enc_len != n) return -3;
            if (codec > 2) return -6;  // unknown codec byte
            pieces.push_back({c * 3 + static_cast<uint32_t>(k), codec, p,
                              enc_len});
            total += n;
            p += enc_len;
        }
    }
    std::vector<int> rc(pieces.size(), 0);
    run_jobs(pieces.size(), codec_threads(pieces.size(), total),
             [&](size_t j) {
        const Piece &q = pieces[j];
        uint8_t *dst = dst_bufs[q.idx];
        uint64_t n = lens[q.idx];
        if (q.codec == 0) {
            std::memcpy(dst, q.data, q.enc_len);
        } else if (q.codec == 1) {
            if (zrle_decode(q.data, q.enc_len, dst, n) != 0) rc[j] = -4;
        } else {
            if (lzb_decode(q.data, q.enc_len, dst, n) != 0) rc[j] = -5;
        }
    });
    for (int r : rc)
        if (r != 0) return r;
    return 0;
}

// ---------------------------------------------------------------------------
// 3. Spill pager: streamed single-file write/read for spilled frames
// (RapidsDiskStore analog; avoids the npz/zip overhead of the Python path).
// ---------------------------------------------------------------------------

int64_t pager_write(const char *path, const uint8_t *data, uint64_t len) {
#if defined(__unix__) || defined(__APPLE__)
    int fd = ::open(path, O_WRONLY | O_CREAT | O_TRUNC, 0600);
    if (fd < 0) return -1;
    uint64_t off = 0;
    while (off < len) {
        ssize_t w = ::write(fd, data + off, len - off);
        if (w <= 0) {
            ::close(fd);
            return -2;
        }
        off += static_cast<uint64_t>(w);
    }
    ::close(fd);
    return static_cast<int64_t>(off);
#else
    FILE *fp = std::fopen(path, "wb");
    if (!fp) return -1;
    size_t w = std::fwrite(data, 1, len, fp);
    std::fclose(fp);
    return w == len ? static_cast<int64_t>(len) : -2;
#endif
}

int64_t pager_read(const char *path, uint8_t *dst, uint64_t cap) {
#if defined(__unix__) || defined(__APPLE__)
    int fd = ::open(path, O_RDONLY);
    if (fd < 0) return -1;
#ifdef POSIX_FADV_SEQUENTIAL
    ::posix_fadvise(fd, 0, 0, POSIX_FADV_SEQUENTIAL);
#endif
    uint64_t off = 0;
    while (off < cap) {
        ssize_t r = ::read(fd, dst + off, cap - off);
        if (r < 0) {
            ::close(fd);
            return -2;
        }
        if (r == 0) break;
        off += static_cast<uint64_t>(r);
    }
    ::close(fd);
    return static_cast<int64_t>(off);
#else
    FILE *fp = std::fopen(path, "rb");
    if (!fp) return -1;
    size_t r = std::fread(dst, 1, cap, fp);
    std::fclose(fp);
    return static_cast<int64_t>(r);
#endif
}

int64_t pager_file_size(const char *path) {
#if defined(__unix__) || defined(__APPLE__)
    struct stat st;
    if (::stat(path, &st) != 0) return -1;
    return static_cast<int64_t>(st.st_size);
#else
    FILE *fp = std::fopen(path, "rb");
    if (!fp) return -1;
    std::fseek(fp, 0, SEEK_END);
    long n = std::ftell(fp);
    std::fclose(fp);
    return n;
#endif
}

// ---------------------------------------------------------------------------
// 4. Multithreaded file prefetcher (the multithreaded-reader strategy's
// CPU thread pool: background threads read whole files into memory while
// the device decodes previous ones).
// ---------------------------------------------------------------------------

struct PrefetchTask {
    std::string path;
    std::vector<uint8_t> data;
    int64_t status = 0;  // >=0 bytes read, <0 error
    bool done = false;
};

struct Prefetcher {
    std::mutex mu;
    std::condition_variable cv_work, cv_done;
    std::deque<size_t> queue;
    // deque, not vector: prefetcher_submit appends while workers hold
    // references to in-flight tasks; vector reallocation would invalidate
    // them (use-after-free under io/multifile.py's sliding-window submits).
    // deque guarantees element addresses are stable under push_back.
    std::deque<PrefetchTask> tasks;
    std::vector<std::thread> threads;
    bool stop = false;

    explicit Prefetcher(int nthreads) {
        for (int i = 0; i < nthreads; i++)
            threads.emplace_back([this] { worker(); });
    }

    void worker() {
        for (;;) {
            PrefetchTask *tp;
            {
                std::unique_lock<std::mutex> lock(mu);
                cv_work.wait(lock, [this] { return stop || !queue.empty(); });
                if (stop && queue.empty()) return;
                size_t idx = queue.front();
                queue.pop_front();
                tp = &tasks[idx];  // element address stable outside the lock
            }
            PrefetchTask &t = *tp;
            int64_t sz = pager_file_size(t.path.c_str());
            if (sz < 0) {
                t.status = -1;
            } else {
                t.data.resize(static_cast<size_t>(sz));
                t.status = pager_read(t.path.c_str(), t.data.data(),
                                      static_cast<uint64_t>(sz));
            }
            {
                std::lock_guard<std::mutex> lock(mu);
                t.done = true;
            }
            cv_done.notify_all();
        }
    }

    ~Prefetcher() {
        {
            std::lock_guard<std::mutex> lock(mu);
            stop = true;
        }
        cv_work.notify_all();
        for (auto &th : threads) th.join();
    }
};

void *prefetcher_create(int nthreads) {
    return new Prefetcher(nthreads > 0 ? nthreads : 4);
}

// submit all paths up front; returns count
int prefetcher_submit(void *pf, const char **paths, int npaths) {
    Prefetcher *p = static_cast<Prefetcher *>(pf);
    {
        std::lock_guard<std::mutex> lock(p->mu);
        size_t base = p->tasks.size();
        for (int i = 0; i < npaths; i++) {
            p->tasks.emplace_back();
            p->tasks.back().path = paths[i];
            p->queue.push_back(base + i);
        }
    }
    p->cv_work.notify_all();
    return npaths;
}

// block until task idx is done; returns byte count (<0 error)
int64_t prefetcher_wait(void *pf, int idx) {
    Prefetcher *p = static_cast<Prefetcher *>(pf);
    std::unique_lock<std::mutex> lock(p->mu);
    p->cv_done.wait(lock, [&] {
        return static_cast<size_t>(idx) < p->tasks.size() &&
               p->tasks[idx].done;
    });
    PrefetchTask &t = p->tasks[idx];
    return t.status;
}

const uint8_t *prefetcher_data(void *pf, int idx) {
    Prefetcher *p = static_cast<Prefetcher *>(pf);
    std::lock_guard<std::mutex> lock(p->mu);
    return p->tasks[idx].data.data();
}

// drop a completed task's buffer
void prefetcher_release(void *pf, int idx) {
    Prefetcher *p = static_cast<Prefetcher *>(pf);
    std::lock_guard<std::mutex> lock(p->mu);
    std::vector<uint8_t>().swap(p->tasks[idx].data);
}

void prefetcher_destroy(void *pf) { delete static_cast<Prefetcher *>(pf); }

}  // extern "C"

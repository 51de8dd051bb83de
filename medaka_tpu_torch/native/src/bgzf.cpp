// BGZF block scan + multi-threaded inflate.
//
// Region fetches in io/bgzf.py previously inflated blocks one at a time
// with Python's zlib, which profiling showed to be ~80% of BAM fetch
// time, paid serially inside each loader worker.  BGZF blocks are
// independently compressed gzip members (SAM spec section 4.1), so a
// span of them can be inflated concurrently.  This kernel scans member
// headers serially (cheap) and inflates the payloads across a small
// thread pool into one caller-provided buffer, with the GIL released.
//
// Reference context: the reference tool chain gets this from htslib's
// bgzf.c thread pool; this is an independent implementation written
// from the SAM specification.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <zlib.h>

extern "C" {

// Scan BGZF members in data[offset, size), stopping once a member would
// start at or beyond `limit` or after `max_blocks` members.  Fills the
// per-block compressed offset, compressed size and uncompressed size.
// Returns the number of members recorded, or -1 on malformed framing.
int64_t mt_bgzf_scan(const uint8_t* data, int64_t size, int64_t offset,
                     int64_t limit, int64_t* coffs, int32_t* bsizes,
                     int32_t* isizes, int64_t max_blocks) {
    int64_t n = 0;
    while (n < max_blocks && offset < limit && offset + 18 <= size) {
        if (data[offset] != 0x1f || data[offset + 1] != 0x8b) return -1;
        if (!(data[offset + 3] & 4)) return -1;  // FEXTRA required
        uint16_t xlen;
        std::memcpy(&xlen, data + offset + 10, 2);
        int64_t pos = offset + 12;
        int64_t end = pos + xlen;
        if (end > size) return -1;
        int32_t bsize = -1;
        while (pos + 4 <= end) {
            uint16_t slen;
            std::memcpy(&slen, data + pos + 2, 2);
            if (data[pos] == 66 && data[pos + 1] == 67 && slen == 2) {
                if (pos + 6 > end) return -1;  // truncated BC payload
                uint16_t bs;
                std::memcpy(&bs, data + pos + 4, 2);
                bsize = static_cast<int32_t>(bs) + 1;
            }
            pos += 4 + slen;
        }
        if (bsize < 26 || offset + bsize > size) return -1;
        uint32_t isize;
        std::memcpy(&isize, data + offset + bsize - 4, 4);
        // BGZF caps the uncompressed payload at 64 KiB; anything larger
        // is corrupt framing, and letting it through would turn the
        // int32 cast / output-offset arithmetic into a buffer overflow
        if (isize > 65536u) return -1;
        coffs[n] = offset;
        bsizes[n] = bsize;
        isizes[n] = static_cast<int32_t>(isize);
        ++n;
        offset += bsize;
    }
    return n;
}

static int inflate_one(const uint8_t* src, int64_t srclen, uint8_t* dst,
                       int32_t dstlen) {
    z_stream zs;
    std::memset(&zs, 0, sizeof zs);
    if (inflateInit2(&zs, -15) != Z_OK) return -1;
    zs.next_in = const_cast<Bytef*>(src);
    zs.avail_in = static_cast<uInt>(srclen);
    zs.next_out = dst;
    zs.avail_out = static_cast<uInt>(dstlen);
    int ret = inflate(&zs, Z_FINISH);
    inflateEnd(&zs);
    if (dstlen == 0)  // empty payload (e.g. the EOF member)
        return (ret == Z_STREAM_END || ret == Z_BUF_ERROR) ? 0 : -1;
    return (ret == Z_STREAM_END && zs.avail_out == 0) ? 0 : -1;
}

// Inflate `n` scanned members concurrently; member i lands at
// out + out_offs[i] (isizes[i] bytes).  Returns 0, or -1 on any
// corrupt member.
int mt_bgzf_inflate_many(const uint8_t* data, int64_t n,
                         const int64_t* coffs, const int32_t* bsizes,
                         const int32_t* isizes, const int64_t* out_offs,
                         uint8_t* out, int nthreads) {
    std::atomic<int64_t> cursor(0);
    std::atomic<int> bad(0);
    auto work = [&]() {
        for (;;) {
            int64_t i = cursor.fetch_add(1, std::memory_order_relaxed);
            if (i >= n || bad.load(std::memory_order_relaxed)) return;
            int64_t c = coffs[i];
            uint16_t xlen;
            std::memcpy(&xlen, data + c + 10, 2);
            int64_t srclen =
                static_cast<int64_t>(bsizes[i]) - 12 - xlen - 8;
            if (srclen < 0 ||
                inflate_one(data + c + 12 + xlen, srclen,
                            out + out_offs[i], isizes[i]) != 0) {
                bad.store(1, std::memory_order_relaxed);
                return;
            }
        }
    };
    int spawn = nthreads < 1 ? 1 : nthreads;
    if (static_cast<int64_t>(spawn) > n) spawn = static_cast<int>(n);
    if (spawn <= 1) {
        work();
    } else {
        std::vector<std::thread> pool;
        pool.reserve(spawn);
        for (int t = 0; t < spawn; ++t) pool.emplace_back(work);
        for (auto& th : pool) th.join();
    }
    return bad.load() ? -1 : 0;
}

}  // extern "C"

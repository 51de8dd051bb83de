// LZF compression (the codec of HDF5 filter 32000, h5py's "lzf").
//
// An LZF stream is a sequence of runs, each opened by a control byte:
//   ctrl < 32:  a literal run of ctrl + 1 bytes follows;
//   ctrl >= 32: a back reference; len = ctrl >> 5 (7 means one more byte
//               is added to it), then a low offset byte; the copy takes
//               len + 2 bytes from distance ((ctrl & 31) << 8 | low) + 1
//               back in the output, so matches are 3..264 bytes long and
//               at most 8192 bytes back.  A copy may overlap its source.
// Written from that description of the format; the compressor is a
// greedy one over a hash of the next three bytes, so its output is a
// valid stream but not byte-equal to liblzf's.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int64_t kMaxLit = 32;
constexpr int64_t kMaxOff = 1 << 13;
constexpr int64_t kMaxRef = (1 << 8) + (1 << 3);  // 264
constexpr int kHashLog = 15;

inline uint32_t hash3(const uint8_t* p) {
  uint32_t v = (uint32_t(p[0]) << 16) | (uint32_t(p[1]) << 8) | p[2];
  return (v * 2654435761u) >> (32 - kHashLog);
}

}  // namespace

extern "C" {

// Compress in[0, n) into out[0, cap).  Returns the compressed size, or 0
// when the stream does not fit in `cap` bytes (or n == 0).
int64_t mt_lzf_compress(const uint8_t* in, int64_t n, uint8_t* out,
                        int64_t cap) {
  if (n <= 0) return 0;
  std::vector<int64_t> table(size_t(1) << kHashLog, -1);
  int64_t op = 0;
  int64_t lit = 0;  // first byte not yet emitted
  auto flush = [&](int64_t end) -> bool {
    while (lit < end) {
      int64_t run = end - lit < kMaxLit ? end - lit : kMaxLit;
      if (op + 1 + run > cap) return false;
      out[op++] = uint8_t(run - 1);
      std::memcpy(out + op, in + lit, size_t(run));
      op += run;
      lit += run;
    }
    return true;
  };
  int64_t ip = 0;
  while (ip + 2 < n) {
    uint32_t h = hash3(in + ip);
    int64_t ref = table[h];
    table[h] = ip;
    int64_t off = ip - ref - 1;
    if (ref >= 0 && off < kMaxOff && in[ref] == in[ip] &&
        in[ref + 1] == in[ip + 1] && in[ref + 2] == in[ip + 2]) {
      int64_t max_len = n - ip < kMaxRef ? n - ip : kMaxRef;
      int64_t len = 3;
      while (len < max_len && in[ref + len] == in[ip + len]) ++len;
      if (!flush(ip)) return 0;
      int64_t l = len - 2;
      if (op + (l < 7 ? 2 : 3) > cap) return 0;
      if (l < 7) {
        out[op++] = uint8_t((l << 5) | (off >> 8));
      } else {
        out[op++] = uint8_t((7 << 5) | (off >> 8));
        out[op++] = uint8_t(l - 7);
      }
      out[op++] = uint8_t(off & 0xff);
      // index the positions inside the match too, so later repeats of
      // them are found
      for (int64_t k = ip + 1; k < ip + len && k + 2 < n; ++k)
        table[hash3(in + k)] = k;
      ip += len;
      lit = ip;
    } else {
      ++ip;
    }
  }
  if (!flush(n)) return 0;
  return op;
}

// Decompress in[0, n) into out[0, cap).  Returns the decompressed size,
// -1 for a corrupt stream (a run reading past the input, a reference
// before the output's start) and -2 when the output needs more than
// `cap` bytes.
int64_t mt_lzf_decompress(const uint8_t* in, int64_t n, uint8_t* out,
                          int64_t cap) {
  int64_t ip = 0, op = 0;
  while (ip < n) {
    int64_t ctrl = in[ip++];
    if (ctrl < kMaxLit) {
      int64_t run = ctrl + 1;
      if (ip + run > n) return -1;
      if (op + run > cap) return -2;
      std::memcpy(out + op, in + ip, size_t(run));
      ip += run;
      op += run;
    } else {
      int64_t len = ctrl >> 5;
      if (ip >= n) return -1;
      if (len == 7) {
        len += in[ip++];
        if (ip >= n) return -1;
      }
      int64_t ref = op - ((ctrl & 0x1f) << 8) - 1 - in[ip++];
      len += 2;
      if (ref < 0) return -1;
      if (op + len > cap) return -2;
      for (int64_t k = 0; k < len; ++k) out[op + k] = out[ref + k];
      op += len;
    }
  }
  return op;
}

}  // extern "C"

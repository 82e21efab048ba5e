// A Zstandard decoder (RFC 8878), decode only, and CRC32C, for the host.
//
// Read by msnv_tpu_torch/training/zstd.py through ctypes: orbax's OCDBT
// checkpoints keep their B-tree nodes and array chunks as zstd frames and
// close every node and manifest with a CRC32C. What it takes:
//   - frames with and without Frame_Content_Size, single segment or with a
//     window descriptor, the optional XXH64 content checksum (verified);
//   - raw, RLE and compressed blocks;
//   - literals raw, RLE, Huffman-coded in 1 or 4 streams, and treeless
//     (the frame's previous Huffman table);
//   - sequences with literal-length, match-length and offset codes in
//     predefined, RLE, FSE-compressed and repeat modes; repeat offsets;
//   - several frames back to back, and skippable frames between them.
// A frame that names a dictionary is refused (orbax writes none). Every
// malformed input raises an error with its reason; nothing reads out of
// the input's bounds.
//
// Build: g++ -O2 -std=c++17 -fPIC -shared -o libmsnv_zstd.so zstd_decode.cc

#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <new>
#include <stdexcept>
#include <vector>

#if !defined(__BYTE_ORDER__) || __BYTE_ORDER__ != __ORDER_LITTLE_ENDIAN__
#error "zstd_decode.cc reads little-endian words with memcpy"
#endif

namespace {

class Error : public std::runtime_error {
 public:
  using std::runtime_error::runtime_error;
};

[[noreturn]] __attribute__((format(printf, 1, 2))) void fail(const char* fmt,
                                                            ...) {
  char buf[320];
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(buf, sizeof buf, fmt, ap);
  va_end(ap);
  throw Error(buf);
}

inline uint32_t rd16(const uint8_t* p) { return p[0] | (p[1] << 8); }
inline uint32_t rd24(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (uint32_t(p[2]) << 16);
}
inline uint32_t rd32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}
inline uint64_t rd64(const uint8_t* p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;
}
inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

constexpr size_t kBlockMax = 128 << 10;
constexpr uint32_t kFrameMagic = 0xFD2FB528u;
constexpr uint32_t kSkippableMagic = 0x184D2A50u;  // low 4 bits free

// ---------------------------------------------------------------- XXH64

constexpr uint64_t P1 = 0x9E3779B185EBCA87ull, P2 = 0xC2B2AE3D27D4EB4Full,
                   P3 = 0x165667B19E3779F9ull, P4 = 0x85EBCA77C2B2AE63ull,
                   P5 = 0x27D4EB2F165667C5ull;
inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) {
  return rotl(acc + in * P2, 31) * P1;
}
inline uint64_t xmerge(uint64_t acc, uint64_t v) {
  return (acc ^ xround(0, v)) * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t n, uint64_t seed) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    for (; p + 32 <= end; p += 32) {
      v1 = xround(v1, rd64(p));
      v2 = xround(v2, rd64(p + 8));
      v3 = xround(v3, rd64(p + 16));
      v4 = xround(v4, rd64(p + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(xmerge(xmerge(xmerge(h, v1), v2), v3), v4);
  } else {
    h = seed + P5;
  }
  h += n;
  for (; p + 8 <= end; p += 8) h = rotl(h ^ xround(0, rd64(p)), 27) * P1 + P4;
  if (p + 4 <= end) {
    h = rotl(h ^ (uint64_t(rd32(p)) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ (*p * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  return h ^ (h >> 32);
}

// --------------------------------------------------------------- CRC32C

struct Crc32cTables {
  uint32_t t[8][256];
  Crc32cTables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
      t[0][i] = c;
    }
    for (int s = 1; s < 8; ++s)
      for (int i = 0; i < 256; ++i)
        t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

uint32_t crc32c_extend(uint32_t crc, const uint8_t* p, size_t n) {
  static const Crc32cTables T;
  crc = ~crc;
  for (; n >= 8; n -= 8, p += 8) {
    uint64_t w = rd64(p) ^ crc;
    crc = T.t[7][w & 0xFF] ^ T.t[6][(w >> 8) & 0xFF] ^
          T.t[5][(w >> 16) & 0xFF] ^ T.t[4][(w >> 24) & 0xFF] ^
          T.t[3][(w >> 32) & 0xFF] ^ T.t[2][(w >> 40) & 0xFF] ^
          T.t[1][(w >> 48) & 0xFF] ^ T.t[0][w >> 56];
  }
  for (; n; --n, ++p) crc = T.t[0][(crc ^ *p) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

// ---------------------------------------------------------------- input

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
  size_t left() const { return size_t(end - p); }
  void need(size_t n, const char* what) const {
    if (left() < n)
      fail("truncated input: %s needs %zu bytes, %zu left", what, n, left());
  }
  uint8_t u8(const char* what) {
    need(1, what);
    return *p++;
  }
  const uint8_t* take(size_t n, const char* what) {
    need(n, what);
    const uint8_t* r = p;
    p += n;
    return r;
  }
};

// Up to 8 bytes at data[byte...], zeros past the end.
inline uint64_t load_le(const uint8_t* data, size_t n, size_t byte) {
  if (byte + 8 <= n) return rd64(data + byte);
  uint8_t tmp[8] = {0};
  if (byte < n) memcpy(tmp, data + byte, n - byte);
  return rd64(tmp);
}

// A little-endian bit stream read from its start (FSE table descriptions).
struct FwdBits {
  const uint8_t* data;
  size_t n;
  size_t pos = 0;  // bits consumed
  uint32_t peek(int k) const {
    uint64_t w = load_le(data, n, pos >> 3) >> (pos & 7);
    return uint32_t(w & ((1ull << k) - 1));
  }
  uint32_t read(int k) {
    uint32_t v = peek(k);
    pos += k;
    return v;
  }
};

// A bit stream read backwards from its end marker (Huffman and FSE
// streams). Positions below the start read as zeros; pos < 0 after a read
// means the stream overflowed.
class BackBits {
 public:
  BackBits(const uint8_t* data, size_t n, const char* what)
      : data_(data), n_(n) {
    if (n == 0) fail("empty %s bit stream", what);
    if (data[n - 1] == 0) fail("%s bit stream has no end marker", what);
    pos_ = int64_t(8 * (n - 1)) + highbit(data[n - 1]);
  }
  // The k bits (k <= 56) just below the position, the highest first.
  uint64_t peek(int k) const {
    int64_t lo = pos_ - k;
    if (lo >= 0) {
      uint64_t w = load_le(data_, n_, size_t(lo) >> 3) >> (lo & 7);
      return w & ((1ull << k) - 1);
    }
    int avail = int(k + lo);  // bits at and above position 0
    if (avail <= 0) return 0;
    return (load_le(data_, n_, 0) & ((1ull << avail) - 1)) << (-lo);
  }
  uint64_t read(int k) {
    if (k == 0) return 0;
    uint64_t v = peek(k);
    pos_ -= k;
    return v;
  }
  void skip(int k) { pos_ -= k; }
  int64_t pos() const { return pos_; }

 private:
  const uint8_t* data_;
  size_t n_;
  int64_t pos_;
};

// --------------------------------------------------------------- output

struct Out {
  uint8_t* p;
  size_t len;
  size_t cap;
  bool grow;
  void append(const uint8_t* src, size_t n) {
    if (n == 0) return;
    reserve(n);
    memcpy(p + len, src, n);
    len += n;
  }
  void reserve(size_t extra) {
    if (extra <= cap - len) return;
    if (!grow)
      fail("decoded data exceeds the %zu-byte output buffer", cap);
    size_t want = len + extra;
    size_t ncap = cap ? cap : 4096;
    while (ncap < want) ncap *= 2;
    uint8_t* q = static_cast<uint8_t*>(realloc(p, ncap));
    if (!q) throw std::bad_alloc();
    p = q;
    cap = ncap;
  }
};

// ------------------------------------------------------------------ FSE

struct FseEntry {
  uint8_t symbol;
  uint8_t nbits;
  uint16_t base;
};

struct Fse {
  int log = -1;  // -1: no table yet
  std::vector<FseEntry> t;
};

void build_fse(Fse& f, const int16_t* norm, int max_symbol, int log) {
  const uint32_t size = 1u << log;
  f.log = log;
  f.t.assign(size, FseEntry{0, 0, 0});
  uint32_t next[256];
  int64_t high = int64_t(size) - 1;
  for (int s = 0; s <= max_symbol; ++s) {
    if (norm[s] == -1) {
      if (high < 0) fail("corrupt FSE table: too many low-probability symbols");
      f.t[high--].symbol = uint8_t(s);
      next[s] = 1;
    } else {
      next[s] = uint32_t(norm[s]);
    }
  }
  const uint32_t step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  uint32_t pos = 0;
  for (int s = 0; s <= max_symbol; ++s)
    for (int i = 0; i < norm[s]; ++i) {
      f.t[pos].symbol = uint8_t(s);
      do pos = (pos + step) & mask;
      while (int64_t(pos) > high);
    }
  if (pos != 0) fail("corrupt FSE table: the spread does not close");
  for (uint32_t u = 0; u < size; ++u) {
    uint32_t s = f.t[u].symbol;
    uint32_t state = next[s]++;
    if (state == 0) fail("corrupt FSE table");
    int nb = log - highbit(state);
    f.t[u].nbits = uint8_t(nb);
    f.t[u].base = uint16_t((state << nb) - size);
  }
}

void build_rle(Fse& f, uint8_t symbol) {
  f.log = 0;
  f.t.assign(1, FseEntry{symbol, 0, 0});
}

// An FSE table description (RFC 8878 4.1.1) at data[0..n): fills `f`,
// returns the bytes it takes.
size_t read_fse(Fse& f, const uint8_t* data, size_t n, int max_symbol,
                int max_log, const char* what) {
  if (n == 0) fail("truncated input: %s table description", what);
  FwdBits b{data, n};
  int log = int(b.read(4)) + 5;
  if (log > max_log)
    fail("%s table: accuracy log %d above %d", what, log, max_log);
  int16_t norm[256] = {0};
  int remaining = (1 << log) + 1, threshold = 1 << log, nb = log + 1;
  int s = 0;
  bool prev0 = false;
  while (remaining > 1 && s <= max_symbol) {
    if (prev0) {
      int n0 = s;
      for (;;) {
        int r = int(b.read(2));
        n0 += r;
        if (r != 3) break;
        if (b.pos > 8 * n) fail("truncated input: %s table description", what);
      }
      if (n0 > max_symbol) fail("%s table: symbol %d above %d", what, n0,
                                max_symbol);
      while (s < n0) norm[s++] = 0;
    }
    const int max = (2 * threshold - 1) - remaining;
    int count;
    uint32_t v = b.peek(nb);
    if (int(v & (threshold - 1)) < max) {
      count = int(v & (threshold - 1));
      b.pos += nb - 1;
    } else {
      count = int(v & (2 * threshold - 1));
      if (count >= threshold) count -= max;
      b.pos += nb;
    }
    count--;
    remaining -= count < 0 ? -count : count;
    norm[s++] = int16_t(count);
    prev0 = count == 0;
    if (remaining < 1) break;
    while (remaining < threshold) {
      nb--;
      threshold >>= 1;
    }
  }
  if (remaining != 1)
    fail("corrupt %s table description (probabilities do not sum)", what);
  size_t bytes = (b.pos + 7) >> 3;
  if (bytes > n) fail("truncated input: %s table description", what);
  build_fse(f, norm, s - 1, log);
  return bytes;
}

// -------------------------------------------------------------- Huffman

struct HufEntry {
  uint8_t symbol;
  uint8_t nbits;
};

struct Huf {
  int max_bits = 0;  // 0: no table yet
  std::vector<HufEntry> t;
};

// A Huffman tree description (RFC 8878 4.2.1) at data[0..n): fills `h`,
// returns the bytes it takes.
size_t read_huffman(Huf& h, const uint8_t* data, size_t n) {
  if (n == 0) fail("truncated input: Huffman tree description");
  uint8_t weights[256] = {0};
  int nw = 0;
  size_t used;
  const uint8_t header = data[0];
  if (header >= 128) {
    nw = header - 127;
    used = 1 + size_t((nw + 1) / 2);
    if (used > n) fail("truncated input: Huffman weights");
    for (int i = 0; i < nw; ++i) {
      uint8_t b = data[1 + i / 2];
      weights[i] = (i & 1) ? (b & 15) : (b >> 4);
    }
  } else {
    used = 1 + size_t(header);
    if (used > n) fail("truncated input: Huffman weights");
    Fse f;
    size_t hs = read_fse(f, data + 1, header, 255, 6, "Huffman weight");
    if (hs >= header) fail("Huffman weights: no bit stream after the table");
    BackBits bits(data + 1 + hs, header - hs, "Huffman weight");
    uint32_t s1 = uint32_t(bits.read(f.log)), s2 = uint32_t(bits.read(f.log));
    if (bits.pos() < 0) fail("Huffman weights: bit stream too short");
    for (;;) {
      if (nw > 253) fail("Huffman weights: more than 255");
      weights[nw++] = f.t[s1].symbol;
      s1 = f.t[s1].base + uint32_t(bits.read(f.t[s1].nbits));
      if (bits.pos() < 0) {
        weights[nw++] = f.t[s2].symbol;
        break;
      }
      weights[nw++] = f.t[s2].symbol;
      s2 = f.t[s2].base + uint32_t(bits.read(f.t[s2].nbits));
      if (bits.pos() < 0) {
        weights[nw++] = f.t[s1].symbol;
        break;
      }
    }
  }
  uint32_t total = 0, rank[13] = {0};
  for (int i = 0; i < nw; ++i) {
    if (weights[i] > 11) fail("Huffman weight %d above 11", weights[i]);
    rank[weights[i]]++;
    total += (1u << weights[i]) >> 1;
  }
  if (total == 0) fail("Huffman tree with no symbols");
  const int max_bits = highbit(total) + 1;
  if (max_bits > 11) fail("Huffman codes longer than 11 bits");
  const uint32_t rest = (1u << max_bits) - total;
  if (rest & (rest - 1)) fail("corrupt Huffman weights (no last weight)");
  const int last = highbit(rest) + 1;
  weights[nw] = uint8_t(last);
  rank[last]++;
  if (rank[1] < 2 || (rank[1] & 1))
    fail("corrupt Huffman weights (odd count of the longest codes)");
  // canonical codes: the lowest weights (longest codes) first
  uint32_t start[13] = {0};
  uint32_t next = 0;
  for (int w = 1; w <= max_bits; ++w) {
    start[w] = next;
    next += rank[w] << (w - 1);
  }
  h.max_bits = max_bits;
  h.t.assign(size_t(1) << max_bits, HufEntry{0, 0});
  for (int s = 0; s <= nw; ++s) {
    const int w = weights[s];
    if (!w) continue;
    const uint32_t len = 1u << (w - 1);
    for (uint32_t i = start[w]; i < start[w] + len; ++i)
      h.t[i] = HufEntry{uint8_t(s), uint8_t(max_bits + 1 - w)};
    start[w] += len;
  }
  return used;
}

// Decodes counts[s] symbols of each of `n` Huffman streams into dst[s].
// The streams advance together, one symbol of each in turn, so that the
// bit-position chains of the streams overlap on the CPU. A stream that
// reads past its start only reads zeros (BackBits), and its final
// position, which must be exactly 0, tells.
void huffman_streams(const Huf& h, BackBits* bits, uint8_t* const* dst,
                     const size_t* counts, int n) {
  const int mb = h.max_bits;
  const HufEntry* t = h.t.data();
  size_t common = counts[0];
  for (int s = 1; s < n; ++s) common = counts[s] < common ? counts[s] : common;
  size_t i = 0;
  if (n == 4) {
    for (; i < common; ++i) {
      const HufEntry e0 = t[bits[0].peek(mb)], e1 = t[bits[1].peek(mb)],
                     e2 = t[bits[2].peek(mb)], e3 = t[bits[3].peek(mb)];
      dst[0][i] = e0.symbol;
      dst[1][i] = e1.symbol;
      dst[2][i] = e2.symbol;
      dst[3][i] = e3.symbol;
      bits[0].skip(e0.nbits);
      bits[1].skip(e1.nbits);
      bits[2].skip(e2.nbits);
      bits[3].skip(e3.nbits);
    }
  }
  for (int s = 0; s < n; ++s) {
    for (size_t j = i; j < counts[s]; ++j) {
      const HufEntry e = t[bits[s].peek(mb)];
      dst[s][j] = e.symbol;
      bits[s].skip(e.nbits);
    }
    if (bits[s].pos() != 0)
      fail("Huffman literal stream %d: %lld bits left over (negative: "
           "overflow)",
           s, static_cast<long long>(bits[s].pos()));
  }
}

// ------------------------------------------------------------ sequences

const uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,
                              9,  10, 11,  12,  13,  14,   15,   16,   18,
                              20, 22, 24,  28,  32,  40,   48,   64,   128,
                              256, 512, 1024, 2048, 4096, 8192, 16384, 32768,
                              65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12,  13,  14,  15,   16,   17,
    18, 19, 20, 21, 22, 23, 24, 25, 26, 27,  28,  29,  30,   31,   32,
    33, 34, 35, 37, 39, 41, 43, 47, 51, 59,  67,  83,  99,   131,  259,
    515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1};

// What a frame's blocks pass on to the next: the tables a treeless or
// repeat mode reuses, and the repeat offsets.
struct FrameState {
  Huf huf;
  Fse ll, of, ml;
  uint32_t rep[3] = {1, 4, 8};
};

void read_table(Cursor& c, int mode, Fse& f, const int16_t* def, int def_max,
                int def_log, int max_symbol, int max_log, const char* what) {
  switch (mode) {
    case 0:
      build_fse(f, def, def_max, def_log);
      break;
    case 1: {
      uint8_t s = c.u8(what);
      if (s > max_symbol)
        fail("%s RLE symbol %d above %d", what, s, max_symbol);
      build_rle(f, s);
      break;
    }
    case 2:
      c.p += read_fse(f, c.p, c.left(), max_symbol, max_log, what);
      break;
    default:
      if (f.log < 0) fail("%s table repeated before any was given", what);
  }
}

void copy_match(Out& out, size_t frame_start, uint64_t offset, uint32_t len) {
  if (offset == 0 || offset > out.len - frame_start)
    fail("match offset %llu reaches before the frame's start (%zu bytes "
         "decoded)",
         static_cast<unsigned long long>(offset), out.len - frame_start);
  out.reserve(len);
  uint8_t* d = out.p + out.len;
  const uint8_t* s = d - offset;
  if (offset >= len) {
    memcpy(d, s, len);
  } else {
    for (uint32_t i = 0; i < len; ++i) d[i] = s[i];
  }
  out.len += len;
}

void compressed_block(Cursor c, FrameState& st, Out& out, size_t frame_start,
                      std::vector<uint8_t>& litbuf) {
  // literals section
  const uint8_t b0 = c.u8("literals header");
  const int type = b0 & 3, fmt = (b0 >> 2) & 3;
  const uint8_t* lit;
  size_t nlit;
  if (type < 2) {
    if (fmt == 1) {
      nlit = (b0 >> 4) + (size_t(c.u8("literals header")) << 4);
    } else if (fmt == 3) {
      const uint8_t* h = c.take(2, "literals header");
      nlit = (b0 >> 4) + (size_t(h[0]) << 4) + (size_t(h[1]) << 12);
    } else {
      nlit = b0 >> 3;
    }
    if (nlit > kBlockMax) fail("literals section of %zu bytes", nlit);
    if (type == 0) {
      lit = c.take(nlit, "raw literals");
    } else {
      memset(litbuf.data(), c.u8("RLE literal"), nlit);
      lit = litbuf.data();
    }
  } else {
    const int hbytes = fmt < 2 ? 3 : fmt + 2;  // 3, 3, 4, 5
    const int sbits = fmt < 2 ? 10 : 6 + 4 * fmt;  // 10, 10, 14, 18
    c.p -= 1;
    const uint8_t* h = c.take(size_t(hbytes), "literals header");
    uint64_t v = 0;
    for (int i = hbytes - 1; i >= 0; --i) v = (v << 8) | h[i];
    v >>= 4;
    nlit = size_t(v & ((1u << sbits) - 1));
    size_t csize = size_t((v >> sbits) & ((1u << sbits) - 1));
    if (nlit > kBlockMax) fail("literals section of %zu bytes", nlit);
    const uint8_t* src = c.take(csize, "Huffman literals");
    if (type == 2) {
      size_t used = read_huffman(st.huf, src, csize);
      src += used;
      csize -= used;
    } else if (st.huf.max_bits == 0) {
      fail("treeless literals before any Huffman table");
    }
    uint8_t* dst = litbuf.data();
    if (fmt == 0) {
      BackBits bits(src, csize, "Huffman literal");
      huffman_streams(st.huf, &bits, &dst, &nlit, 1);
    } else {
      if (csize < 6) fail("truncated input: Huffman jump table");
      size_t sz[4] = {rd16(src), rd16(src + 2), rd16(src + 4), 0};
      if (sz[0] + sz[1] + sz[2] > csize - 6)
        fail("Huffman jump table beyond the literals");
      sz[3] = csize - 6 - sz[0] - sz[1] - sz[2];
      const size_t seg = (nlit + 3) / 4;
      if (3 * seg > nlit) fail("4 Huffman streams for %zu literals", nlit);
      const uint8_t* p = src + 6;
      BackBits bits[4] = {BackBits(p, sz[0], "Huffman literal"),
                          BackBits(p + sz[0], sz[1], "Huffman literal"),
                          BackBits(p + sz[0] + sz[1], sz[2],
                                   "Huffman literal"),
                          BackBits(p + sz[0] + sz[1] + sz[2], sz[3],
                                   "Huffman literal")};
      uint8_t* const out4[4] = {dst, dst + seg, dst + 2 * seg,
                                dst + 3 * seg};
      const size_t counts[4] = {seg, seg, seg, nlit - 3 * seg};
      huffman_streams(st.huf, bits, out4, counts, 4);
    }
    lit = dst;
  }

  // sequences section
  const uint8_t n0 = c.u8("sequences header");
  size_t nseq = n0;
  if (n0 >= 128) {
    if (n0 < 255) {
      nseq = (size_t(n0 - 128) << 8) + c.u8("sequences header");
    } else {
      nseq = rd16(c.take(2, "sequences header")) + 0x7F00;
    }
  }
  size_t litpos = 0;
  if (nseq > 0) {
    const uint8_t modes = c.u8("sequence compression modes");
    if (modes & 3) fail("reserved bits set in the sequence compression modes");
    read_table(c, modes >> 6, st.ll, kLLDefault, 35, 6, 35, 9,
               "literal-length");
    read_table(c, (modes >> 4) & 3, st.of, kOFDefault, 28, 5, 31, 8,
               "offset");
    read_table(c, (modes >> 2) & 3, st.ml, kMLDefault, 52, 6, 52, 9,
               "match-length");
    BackBits bits(c.p, c.left(), "sequence");
    c.p = c.end;
    uint32_t sll = uint32_t(bits.read(st.ll.log));
    uint32_t sof = uint32_t(bits.read(st.of.log));
    uint32_t sml = uint32_t(bits.read(st.ml.log));
    for (size_t i = 0; i < nseq; ++i) {
      const FseEntry ell = st.ll.t[sll], eof = st.of.t[sof], eml = st.ml.t[sml];
      if (eof.symbol > 31) fail("offset code %d", eof.symbol);
      const uint64_t ofv =
          (uint64_t(1) << eof.symbol) + bits.read(eof.symbol);
      const uint32_t ml = kMLBase[eml.symbol] +
                          uint32_t(bits.read(kMLBits[eml.symbol]));
      const uint32_t ll = kLLBase[ell.symbol] +
                          uint32_t(bits.read(kLLBits[ell.symbol]));
      uint64_t offset;
      if (ofv > 3) {
        offset = ofv - 3;
        st.rep[2] = st.rep[1];
        st.rep[1] = st.rep[0];
        st.rep[0] = uint32_t(offset);
      } else {
        const uint32_t idx = uint32_t(ofv) - 1 + (ll == 0 ? 1 : 0);
        if (idx == 0) {
          offset = st.rep[0];
        } else {
          offset = idx == 3 ? uint64_t(st.rep[0]) - 1 : st.rep[idx];
          if (idx > 1) st.rep[2] = st.rep[1];
          st.rep[1] = st.rep[0];
          st.rep[0] = uint32_t(offset);
        }
      }
      if (ll > nlit - litpos)
        fail("sequence takes %u literals, %zu left", ll, nlit - litpos);
      out.append(lit + litpos, ll);
      litpos += ll;
      copy_match(out, frame_start, offset, ml);
      if (i + 1 < nseq) {
        sll = ell.base + uint32_t(bits.read(ell.nbits));
        sml = eml.base + uint32_t(bits.read(eml.nbits));
        sof = eof.base + uint32_t(bits.read(eof.nbits));
      }
      if (bits.pos() < 0) fail("sequence bit stream overflows");
    }
    if (bits.pos() != 0)
      fail("sequence bit stream has %lld bits left over",
           static_cast<long long>(bits.pos()));
  } else if (c.left() != 0) {
    fail("%zu bytes after an empty sequences section", c.left());
  }
  out.append(lit + litpos, nlit - litpos);
}

struct FrameHeader {
  bool has_size = false;
  uint64_t content_size = 0;
  uint64_t window = 0;
  bool checksum = false;
};

FrameHeader frame_header(Cursor& c) {
  FrameHeader h;
  const uint8_t fhd = c.u8("frame header");
  const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, dict_flag = fhd & 3;
  if (fhd & 8) fail("reserved bit set in the frame header");
  h.checksum = (fhd >> 2) & 1;
  if (!single) {
    const uint8_t wd = c.u8("window descriptor");
    const int exponent = wd >> 3, mantissa = wd & 7;
    const uint64_t base = uint64_t(1) << (10 + exponent);
    h.window = base + (base / 8) * mantissa;
  }
  static const int kDictBytes[4] = {0, 1, 2, 4};
  if (dict_flag) {
    const uint8_t* d = c.take(size_t(kDictBytes[dict_flag]), "dictionary id");
    uint32_t id = 0;
    for (int i = kDictBytes[dict_flag] - 1; i >= 0; --i) id = (id << 8) | d[i];
    if (id != 0)
      fail("frame needs dictionary %u; this decoder takes no dictionary", id);
  }
  const int fcs_bytes = fcs_flag == 0 ? single : (1 << fcs_flag);
  if (fcs_bytes) {
    const uint8_t* f = c.take(size_t(fcs_bytes), "frame content size");
    uint64_t v = 0;
    for (int i = fcs_bytes - 1; i >= 0; --i) v = (v << 8) | f[i];
    if (fcs_bytes == 2) v += 256;
    h.has_size = true;
    h.content_size = v;
  }
  if (single) h.window = h.content_size;
  return h;
}

void decode_frame(Cursor& c, Out& out, std::vector<uint8_t>& litbuf) {
  const FrameHeader h = frame_header(c);
  const size_t block_max = h.window < kBlockMax ? size_t(h.window) : kBlockMax;
  const size_t start = out.len;
  FrameState st;
  for (;;) {
    const uint32_t bh = rd24(c.take(3, "block header"));
    const bool last = bh & 1;
    const int type = (bh >> 1) & 3;
    const size_t size = bh >> 3;
    if (type == 3) fail("reserved block type");
    if (size > block_max)
      fail("block of %zu bytes above the frame's maximum of %zu", size,
           block_max);
    if (type == 0) {
      out.append(c.take(size, "raw block"), size);
    } else if (type == 1) {
      const uint8_t b = c.u8("RLE block");
      if (size) {
        out.reserve(size);
        memset(out.p + out.len, b, size);
        out.len += size;
      }
    } else {
      const uint8_t* p = c.take(size, "compressed block");
      const size_t before = out.len;
      compressed_block(Cursor{p, p + size}, st, out, start, litbuf);
      if (out.len - before > block_max)
        fail("block decodes to %zu bytes, above the maximum of %zu",
             out.len - before, block_max);
    }
    if (last) break;
  }
  const size_t got = out.len - start;
  if (h.has_size && got != h.content_size)
    fail("frame declares %llu bytes and decodes to %zu",
         static_cast<unsigned long long>(h.content_size), got);
  if (h.checksum) {
    const uint32_t want = rd32(c.take(4, "content checksum"));
    const uint32_t have = uint32_t(xxh64(out.p + start, got, 0));
    if (want != have)
      fail("content checksum mismatch: frame says %08x, data gives %08x", want,
           have);
  }
}

void decode_all(const uint8_t* src, size_t n, Out& out) {
  if (n == 0) fail("empty input: no zstd frame");
  Cursor c{src, src + n};
  std::vector<uint8_t> litbuf(kBlockMax);
  while (c.left()) {
    const size_t at = size_t(c.p - src);
    const uint32_t magic = rd32(c.take(4, "frame magic"));
    if (magic == kFrameMagic) {
      decode_frame(c, out, litbuf);
    } else if ((magic & 0xFFFFFFF0u) == kSkippableMagic) {
      c.take(rd32(c.take(4, "skippable frame size")), "skippable frame");
    } else {
      fail("not a zstd frame at byte %zu (magic %08x)", at, magic);
    }
  }
}

// The sum of the frames' declared content sizes; -1 when a frame does not
// declare one.
int64_t content_size(const uint8_t* src, size_t n) {
  Cursor c{src, src + n};
  uint64_t total = 0;
  while (c.left()) {
    const uint32_t magic = rd32(c.take(4, "frame magic"));
    if ((magic & 0xFFFFFFF0u) == kSkippableMagic) {
      c.take(rd32(c.take(4, "skippable frame size")), "skippable frame");
      continue;
    }
    if (magic != kFrameMagic) fail("not a zstd frame (magic %08x)", magic);
    const FrameHeader h = frame_header(c);
    if (!h.has_size) return -1;
    total += h.content_size;
    for (;;) {
      const uint32_t bh = rd24(c.take(3, "block header"));
      c.take((bh >> 1 & 3) == 1 ? 1 : bh >> 3, "block");
      if (bh & 1) break;
    }
    if (h.checksum) c.take(4, "content checksum");
  }
  return int64_t(total);
}

void set_error(char* err, size_t errlen, const char* msg) {
  if (err && errlen) snprintf(err, errlen, "%s", msg);
}

}  // namespace

extern "C" {

// Decode every frame of src[0..n) into dst[0..cap). Returns the bytes
// written, or -1 with the reason in err.
int64_t msnv_zstd_decompress_into(const uint8_t* src, size_t n, uint8_t* dst,
                                  size_t cap, char* err, size_t errlen) {
  Out out{dst, 0, cap, false};
  try {
    decode_all(src, n, out);
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return -1;
  }
  return int64_t(out.len);
}

// Decode every frame of src[0..n) into a buffer this library allocates
// (*dst, released with msnv_zstd_free). Returns its length, or -1 with the
// reason in err.
int64_t msnv_zstd_decompress_alloc(const uint8_t* src, size_t n,
                                   uint8_t** dst, char* err, size_t errlen) {
  Out out{nullptr, 0, 0, true};
  *dst = nullptr;
  try {
    decode_all(src, n, out);
  } catch (const std::exception& e) {
    free(out.p);
    set_error(err, errlen, e.what());
    return -1;
  }
  *dst = out.p;
  return int64_t(out.len);
}

// The decoded size that the frames of src[0..n) declare; -1 when one does
// not; -2 with the reason in err when the frames are malformed.
int64_t msnv_zstd_content_size(const uint8_t* src, size_t n, char* err,
                               size_t errlen) {
  try {
    return content_size(src, n);
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return -2;
  }
}

void msnv_zstd_free(void* p) { free(p); }

// CRC32C (Castagnoli) of p[0..n) extending `crc` (0 to start).
uint32_t msnv_crc32c(uint32_t crc, const uint8_t* p, size_t n) {
  return crc32c_extend(crc, p, n);
}

}  // extern "C"

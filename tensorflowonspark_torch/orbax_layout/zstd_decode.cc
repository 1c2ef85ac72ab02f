// A Zstandard decoder (RFC 8878), written for reading the zarr chunks and
// OCDBT nodes of orbax checkpoints without a zstd library.  Plain C ABI,
// consumed through ctypes (orbax_layout/zstd.py):
//
//   int tos_zstd_decompress(src, n, dst, cap, &out_len, &err_off, msg, msg_cap)
//       0: ok, out_len bytes written to dst;
//       1: corrupt or unsupported input, err_off is the byte offset in src
//          where it was found and msg says what;
//       2: dst too small: out_len is the size the frames decode to (the
//          decode went on counting, writing nothing past cap).
//   int64_t tos_zstd_content_size(src, n)
//       the sum of every frame's Frame_Content_Size, or -1 when a frame
//       does not declare one (or the frames cannot be walked).
//
// Every frame in src is decoded in turn (skippable frames are skipped).
// Every read of src and every write of dst is bounds-checked; malformed
// input ends in return code 1, never in a read or write out of bounds.

#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <vector>

namespace {

constexpr size_t kBlockSizeMax = 128 * 1024;
constexpr uint32_t kFrameMagic = 0xFD2FB528u;
constexpr uint32_t kSkippableMask = 0xFFFFFFF0u;
constexpr uint32_t kSkippableMagic = 0x184D2A50u;

struct Failure {
  uint64_t offset;
  char msg[200];
};

[[noreturn]] void fail(uint64_t offset, const char* fmt, ...) {
  Failure f;
  f.offset = offset;
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(f.msg, sizeof(f.msg), fmt, ap);
  va_end(ap);
  throw f;
}

inline int highbit32(uint32_t v) { return 31 - __builtin_clz(v); }  // v > 0

inline uint64_t load_le(const uint8_t* p, size_t avail) {
  // up to 8 little-endian bytes; bytes past `avail` read as zero
  uint64_t v = 0;
  if (avail >= 8) {
    memcpy(&v, p, 8);
    return v;
  }
  for (size_t i = 0; i < avail; ++i) v |= uint64_t(p[i]) << (8 * i);
  return v;
}

// -- bit streams --------------------------------------------------------------

// Forward little-endian bit reader (FSE table descriptions).
struct ForwardBits {
  const uint8_t* p;
  size_t n;
  uint64_t pos = 0;  // bits consumed
  ForwardBits(const uint8_t* p_, size_t n_) : p(p_), n(n_) {}
  uint32_t peek(int k) const {
    size_t byte = size_t(pos >> 3);
    uint64_t w = byte < n ? load_le(p + byte, n - byte) : 0;
    return uint32_t((w >> (pos & 7)) & ((uint64_t(1) << k) - 1));
  }
  void skip(int k) { pos += uint64_t(k); }
  uint32_t read(int k) {
    uint32_t v = peek(k);
    skip(k);
    return v;
  }
};

// Backward bit reader: the stream is read from its last byte towards its
// first, highest bits first, starting below the end mark (the highest set
// bit of the last byte).  A 64-bit container holds the 8 bytes at `ptr`;
// `used` counts its bits consumed from the top.  Bits read past the first
// byte are zeros, and `left()` turns negative (an overflow).
struct BackwardBits {
  const uint8_t* start = nullptr;
  const uint8_t* ptr = nullptr;
  uint64_t c = 0;
  unsigned used = 0;

  void init(const uint8_t* p, size_t n, uint64_t offset) {
    if (n == 0) fail(offset, "empty bitstream");
    uint8_t last = p[n - 1];
    if (last == 0) fail(offset + n - 1, "bitstream without its end mark");
    start = p;
    if (n >= 8) {
      ptr = p + n - 8;
      memcpy(&c, ptr, 8);
      used = 8 - unsigned(highbit32(last));
    } else {  // the bytes sit low in the container, its top counts as consumed
      ptr = p;
      c = load_le(p, n);
      used = unsigned(64 - 8 * n) + 8 - unsigned(highbit32(last));
    }
  }
  int64_t left() const { return int64_t(ptr - start) * 8 + 64 - int64_t(used); }
  void reload() {  // step back whole consumed bytes, never before `start`
    size_t back = used >> 3;
    size_t room = size_t(ptr - start);
    if (back > room) back = room;
    if (back == 0) return;
    ptr -= back;
    used -= unsigned(back * 8);
    memcpy(&c, ptr, 8);
  }
  uint64_t peek(unsigned k) const {  // 1 <= k <= 56, after a reload
    return used < 64 ? (c << used) >> (64 - k) : 0;
  }
  uint64_t read(unsigned k) {  // k <= 56
    if (k == 0) return 0;
    if (used + k > 64) reload();
    uint64_t v = peek(k);
    used += k;
    return v;
  }
};

// -- FSE ------------------------------------------------------------------------

struct FseEntry {
  uint16_t base;  // next state = base + read(nb)
  uint8_t symbol;
  uint8_t nb;
};

struct FseTable {
  int log = -1;  // accuracy log; -1: not built
  FseEntry e[1 << 9];
};

// Reads an FSE table description (RFC 8878 4.1.1) into `norm` (the
// normalised counts, -1 for "less than 1"); returns the bytes it took.
size_t read_ncount(const uint8_t* p, size_t n, uint64_t offset, int max_log,
                   int max_symbol, int16_t* norm, int* log_out, int* nsym_out) {
  if (n == 0) fail(offset, "FSE table description missing");
  ForwardBits br(p, n);
  int log = int(br.read(4)) + 5;
  if (log > max_log)
    fail(offset, "FSE accuracy log %d above the maximum %d", log, max_log);
  int remaining = (1 << log) + 1;
  int threshold = 1 << log;
  int nb_bits = log + 1;
  int sym = 0;
  bool prev0 = false;
  for (int i = 0; i <= max_symbol; ++i) norm[i] = 0;
  while (remaining > 1) {
    if (prev0) {
      uint32_t r;
      do {
        r = br.read(2);
        sym += int(r);
        if (br.pos > uint64_t(n) * 8) fail(offset + n, "FSE table description truncated");
      } while (r == 3);
    }
    if (sym > max_symbol)
      fail(offset + (br.pos >> 3), "FSE table describes symbol %d above %d", sym, max_symbol);
    int max = (2 * threshold - 1) - remaining;
    uint32_t v = br.peek(nb_bits);
    int count;
    if (int(v & uint32_t(threshold - 1)) < max) {
      count = int(v & uint32_t(threshold - 1));
      br.skip(nb_bits - 1);
    } else {
      count = int(v & uint32_t(2 * threshold - 1));
      if (count >= threshold) count -= max;
      br.skip(nb_bits);
    }
    count -= 1;
    remaining -= count < 0 ? -count : count;
    if (remaining < 1) fail(offset + (br.pos >> 3), "FSE probabilities exceed the table");
    norm[sym++] = int16_t(count);
    prev0 = count == 0;
    while (remaining < threshold) {
      nb_bits--;
      threshold >>= 1;
    }
    if (br.pos > uint64_t(n) * 8) fail(offset + n, "FSE table description truncated");
  }
  size_t used = size_t((br.pos + 7) >> 3);
  if (used > n) fail(offset + n, "FSE table description truncated");
  *log_out = log;
  *nsym_out = sym;
  return used;
}

void build_fse(const int16_t* norm, int nsym, int log, FseTable* t, uint64_t offset) {
  int size = 1 << log;
  int high = size - 1;
  uint16_t next[256];
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] == -1) {
      t->e[high--].symbol = uint8_t(s);
      next[s] = 1;
    } else {
      next[s] = uint16_t(norm[s]);
    }
  }
  int step = (size >> 1) + (size >> 3) + 3;
  int mask = size - 1;
  int pos = 0;
  for (int s = 0; s < nsym; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      t->e[pos].symbol = uint8_t(s);
      do pos = (pos + step) & mask;
      while (pos > high);
    }
  }
  if (pos != 0) fail(offset, "FSE distribution does not fill its table");
  for (int u = 0; u < size; ++u) {
    int s = t->e[u].symbol;
    uint32_t ns = next[s]++;
    int nb = log - highbit32(ns);
    t->e[u].nb = uint8_t(nb);
    t->e[u].base = uint16_t((ns << nb) - uint32_t(size));
  }
  t->log = log;
}

void build_rle(uint8_t symbol, FseTable* t) {
  t->e[0] = FseEntry{0, symbol, 0};
  t->log = 0;
}

// -- sequence codes -----------------------------------------------------------

const uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10,  11,  12,   13,   14,   15,   16,
                              17, 18, 19, 20, 21, 22, 23, 24,  25,  26,   27,   28,   29,   30,
                              31, 32, 33, 34, 35, 37, 39, 41,  43,  47,   51,   59,   67,   83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

struct Predefined {
  FseTable ll, ml, of;
  Predefined() {
    build_fse(kLLDefault, 36, 6, &ll, 0);
    build_fse(kMLDefault, 53, 6, &ml, 0);
    build_fse(kOFDefault, 29, 5, &of, 0);
  }
};

const Predefined& predefined() {
  static const Predefined tables;  // thread-safe initialisation
  return tables;
}

// -- Huffman ------------------------------------------------------------------

struct HufEntry {
  uint8_t symbol;
  uint8_t nb;
};

struct HufTable {
  int max_bits = 0;  // 0: none yet
  HufEntry e[1 << 11];
};

// -- XXH64 ----------------------------------------------------------------------

constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                   P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                   P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xxh_round(uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; }
inline uint64_t xxh_merge(uint64_t acc, uint64_t v) { return (acc ^ xxh_round(0, v)) * P1 + P4; }
inline uint64_t rd64(const uint8_t* p) { uint64_t v; memcpy(&v, p, 8); return v; }
inline uint32_t rd32(const uint8_t* p) { uint32_t v; memcpy(&v, p, 4); return v; }

uint64_t xxh64(const uint8_t* p, size_t len) {
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xxh_round(v1, rd64(p));
      v2 = xxh_round(v2, rd64(p + 8));
      v3 = xxh_round(v3, rd64(p + 16));
      v4 = xxh_round(v4, rd64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xxh_merge(h, v1);
    h = xxh_merge(h, v2);
    h = xxh_merge(h, v3);
    h = xxh_merge(h, v4);
  } else {
    h = P5;
  }
  h += uint64_t(len);
  while (p + 8 <= end) {
    h ^= xxh_round(0, rd64(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= uint64_t(rd32(p)) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= uint64_t(*p) * P5;
    h = rotl(h, 11) * P1;
    ++p;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// -- the decoder --------------------------------------------------------------

struct Decoder {
  const uint8_t* src;
  size_t n;
  uint8_t* dst;
  size_t cap;
  size_t pos = 0;         // bytes produced (written, or counted once past cap)
  bool overflow = false;  // dst too small: count from here on, write nothing

  // frame state
  size_t frame_start = 0;
  size_t block_max = kBlockSizeMax;
  uint64_t rep[3] = {1, 4, 8};
  HufTable huf;
  FseTable ll, of, ml;  // the previous block's, for Repeat mode
  uint8_t lit[kBlockSizeMax];
  size_t lit_size = 0;

  Decoder(const uint8_t* s, size_t sn, uint8_t* d, size_t dc) : src(s), n(sn), dst(d), cap(dc) {}

  uint64_t off(const uint8_t* p) const { return uint64_t(p - src); }

  void need(const uint8_t* p, size_t k, const uint8_t* end, const char* what) const {
    if (size_t(end - p) < k) fail(off(end), "truncated input: %s needs %zu bytes, %zu left", what,
                                  k, size_t(end - p));
  }

  void put(const uint8_t* s, size_t len) {
    if (!overflow && len <= cap - pos) memcpy(dst + pos, s, len);
    else overflow = true;
    pos += len;
  }

  void fill(uint8_t b, size_t len) {
    if (!overflow && len <= cap - pos) memset(dst + pos, b, len);
    else overflow = true;
    pos += len;
  }

  void match(uint64_t offset, size_t len, const uint8_t* where) {
    if (offset == 0 || offset > pos - frame_start)
      fail(off(where), "match offset %llu reaches before the frame's first byte (%zu produced)",
           (unsigned long long)offset, pos - frame_start);
    if (!overflow && len <= cap - pos) {
      uint8_t* o = dst + pos;
      const uint8_t* m = o - offset;
      if (offset >= len) {
        memcpy(o, m, len);
      } else {  // overlapping: 8 bytes at a time while the source is 8 behind
        size_t i = 0;
        if (offset >= 8)
          for (; i + 8 <= len; i += 8) memcpy(o + i, m + i, 8);
        for (; i < len; ++i) o[i] = m[i];
      }
    } else {
      overflow = true;
    }
    pos += len;
  }

  // ---- literals -------------------------------------------------------------

  size_t read_huffman_table(const uint8_t* p, const uint8_t* end) {
    need(p, 1, end, "Huffman tree description");
    uint8_t header = p[0];
    uint8_t weights[256];
    int nw;
    size_t used;
    if (header < 128) {  // FSE-compressed weights, `header` bytes
      need(p + 1, header, end, "FSE-compressed Huffman weights");
      used = 1 + size_t(header);
      nw = decode_fse_weights(p + 1, header, weights);
    } else {  // direct: 4 bits a weight
      nw = header - 127;
      size_t bytes = size_t(nw + 1) / 2;
      need(p + 1, bytes, end, "Huffman weights");
      for (int i = 0; i < nw; ++i) {
        uint8_t b = p[1 + i / 2];
        weights[i] = (i & 1) ? (b & 15) : (b >> 4);
      }
      used = 1 + bytes;
    }
    uint32_t total = 0;
    for (int i = 0; i < nw; ++i) {
      if (weights[i] > 11) fail(off(p), "Huffman weight %d above 11", int(weights[i]));
      if (weights[i]) total += uint32_t(1) << (weights[i] - 1);
    }
    if (total == 0) fail(off(p), "Huffman weights all zero");
    int max_bits = highbit32(total) + 1;
    if (max_bits > 11) fail(off(p), "Huffman code length %d above 11", max_bits);
    uint32_t rest = (uint32_t(1) << max_bits) - total;
    if (rest & (rest - 1)) fail(off(p), "Huffman weights do not complete a tree");
    weights[nw] = uint8_t(highbit32(rest) + 1);
    int nsym = nw + 1;
    uint32_t at = 0;
    for (int w = 1; w <= max_bits; ++w) {
      for (int s = 0; s < nsym; ++s) {
        if (weights[s] != w) continue;
        uint32_t len = uint32_t(1) << (w - 1);
        HufEntry e{uint8_t(s), uint8_t(max_bits + 1 - w)};
        for (uint32_t i = 0; i < len; ++i) huf.e[at + i] = e;
        at += len;
      }
    }
    huf.max_bits = max_bits;
    return used;
  }

  int decode_fse_weights(const uint8_t* p, size_t n_in, uint8_t* weights) {
    int16_t norm[256];
    int log, nsym;
    size_t used = read_ncount(p, n_in, off(p), 6, 255, norm, &log, &nsym);
    FseTable t;
    build_fse(norm, nsym, log, &t, off(p));
    BackwardBits br;
    br.init(p + used, n_in - used, off(p + used));
    uint32_t s1 = uint32_t(br.read(log)), s2 = uint32_t(br.read(log));
    int out = 0;
    for (;;) {
      if (out > 252) fail(off(p), "too many Huffman weights");  // at most 255 and the implied one
      weights[out++] = t.e[s1].symbol;
      s1 = t.e[s1].base + uint32_t(br.read(t.e[s1].nb));
      if (br.left() < 0) {
        weights[out++] = t.e[s2].symbol;
        break;
      }
      weights[out++] = t.e[s2].symbol;
      s2 = t.e[s2].base + uint32_t(br.read(t.e[s2].nb));
      if (br.left() < 0) {
        weights[out++] = t.e[s1].symbol;
        break;
      }
    }
    return out;
  }

  // Codes out[from, count) of one stream, a reload every 4 codes (4 codes of
  // <= 11 bits fit in the container after a reload).
  void huffman_codes(BackwardBits& br, uint8_t* out, size_t from, size_t count) const {
    const unsigned mb = unsigned(huf.max_bits);
    const HufEntry* e = huf.e;
    for (size_t i = from; i < count; ++i) {
      if (((i - from) & 3) == 0) br.reload();
      const HufEntry& h = e[br.peek(mb)];
      out[i] = h.symbol;
      br.used += h.nb;
    }
  }

  void huffman_end(BackwardBits& br, const uint8_t* p, size_t len) const {
    br.reload();
    if (br.left() != 0)
      fail(off(p), "Huffman stream of %zu bytes not consumed exactly (%lld bits left)", len,
           (long long)br.left());
  }

  void decode_huffman_stream(const uint8_t* p, size_t len, uint8_t* out, size_t count) {
    BackwardBits br;
    br.init(p, len, off(p));
    huffman_codes(br, out, 0, count);
    huffman_end(br, p, len);
  }

  // The four streams in lockstep while each has 8 bytes behind its
  // container (so a reload never reaches its start), then each to its end.
  void decode_huffman_4(const uint8_t* const* p, const size_t* len, uint8_t* out, size_t seg,
                        size_t last) {
    BackwardBits br[4];
    uint8_t* o[4] = {out, out + seg, out + 2 * seg, out + 3 * seg};
    const size_t count[4] = {seg, seg, seg, last};
    for (int k = 0; k < 4; ++k) br[k].init(p[k], len[k], off(p[k]));
    const unsigned mb = unsigned(huf.max_bits);
    const HufEntry* e = huf.e;
    size_t i = 0;
    const size_t both = last < seg ? last : seg;
    while (i + 4 <= both && br[0].ptr - br[0].start >= 8 && br[1].ptr - br[1].start >= 8 &&
           br[2].ptr - br[2].start >= 8 && br[3].ptr - br[3].start >= 8) {
      for (int k = 0; k < 4; ++k) {
        br[k].ptr -= br[k].used >> 3;
        br[k].used &= 7;
        memcpy(&br[k].c, br[k].ptr, 8);
      }
      for (int j = 0; j < 4; ++j) {
        for (int k = 0; k < 4; ++k) {
          const HufEntry& h = e[(br[k].c << br[k].used) >> (64 - mb)];
          o[k][i + j] = h.symbol;
          br[k].used += h.nb;
        }
      }
      i += 4;
    }
    for (int k = 0; k < 4; ++k) {
      huffman_codes(br[k], o[k], i, count[k]);
      huffman_end(br[k], p[k], len[k]);
    }
  }

  size_t read_literals(const uint8_t* p, const uint8_t* end) {
    need(p, 1, end, "literals section header");
    uint8_t b0 = p[0];
    int type = b0 & 3, sf = (b0 >> 2) & 3;
    if (type < 2) {  // Raw or RLE
      size_t hs, regen;
      if (sf == 0 || sf == 2) {
        hs = 1;
        regen = b0 >> 3;
      } else if (sf == 1) {
        need(p, 2, end, "literals section header");
        hs = 2;
        regen = (b0 >> 4) + (size_t(p[1]) << 4);
      } else {
        need(p, 3, end, "literals section header");
        hs = 3;
        regen = (b0 >> 4) + (size_t(p[1]) << 4) + (size_t(p[2]) << 12);
      }
      if (regen > block_max)
        fail(off(p), "literals of %zu bytes exceed the block maximum %zu", regen, block_max);
      lit_size = regen;
      if (type == 0) {
        need(p + hs, regen, end, "raw literals");
        memcpy(lit, p + hs, regen);
        return hs + regen;
      }
      need(p + hs, 1, end, "RLE literal");
      memset(lit, p[hs], regen);
      return hs + 1;
    }
    // Compressed (2) or Treeless (3)
    size_t hs, regen, comp;
    int streams = sf == 0 ? 1 : 4;
    if (sf < 2) {
      need(p, 3, end, "literals section header");
      uint32_t h = p[0] | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16);
      hs = 3;
      regen = (h >> 4) & 0x3FF;
      comp = (h >> 14) & 0x3FF;
    } else if (sf == 2) {
      need(p, 4, end, "literals section header");
      uint32_t h = p[0] | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) | (uint32_t(p[3]) << 24);
      hs = 4;
      regen = (h >> 4) & 0x3FFF;
      comp = h >> 18;
    } else {
      need(p, 5, end, "literals section header");
      uint64_t h = p[0] | (uint64_t(p[1]) << 8) | (uint64_t(p[2]) << 16) |
                   (uint64_t(p[3]) << 24) | (uint64_t(p[4]) << 32);
      hs = 5;
      regen = size_t((h >> 4) & 0x3FFFF);
      comp = size_t((h >> 22) & 0x3FFFF);
    }
    if (regen > block_max)
      fail(off(p), "literals of %zu bytes exceed the block maximum %zu", regen, block_max);
    need(p + hs, comp, end, "compressed literals");
    const uint8_t* q = p + hs;
    const uint8_t* qend = q + comp;
    if (type == 2) {
      q += read_huffman_table(q, qend);
    } else if (huf.max_bits == 0) {
      fail(off(p), "treeless literals with no previous Huffman table in the frame");
    }
    lit_size = regen;
    if (streams == 1) {
      decode_huffman_stream(q, size_t(qend - q), lit, regen);
    } else {
      need(q, 6, qend, "Huffman jump table");
      size_t s1 = q[0] | (size_t(q[1]) << 8), s2 = q[2] | (size_t(q[3]) << 8),
             s3 = q[4] | (size_t(q[5]) << 8);
      size_t total = size_t(qend - q) - 6;
      if (s1 + s2 + s3 > total) fail(off(q), "Huffman jump table exceeds the literals");
      size_t s4 = total - s1 - s2 - s3;
      size_t seg = (regen + 3) / 4;
      if (3 * seg > regen) fail(off(q), "four Huffman streams for %zu literals", regen);
      const uint8_t* d = q + 6;
      const uint8_t* starts[4] = {d, d + s1, d + s1 + s2, d + s1 + s2 + s3};
      const size_t lens[4] = {s1, s2, s3, s4};
      decode_huffman_4(starts, lens, lit, seg, regen - 3 * seg);
    }
    return hs + comp;
  }

  // ---- sequences -------------------------------------------------------------

  size_t read_table(const uint8_t* p, const uint8_t* end, int mode, FseTable* t,
                    const FseTable& def, int max_log, int max_symbol, const char* name) {
    switch (mode) {
      case 0:
        *t = def;
        return 0;
      case 1:
        need(p, 1, end, "RLE sequence symbol");
        if (p[0] > max_symbol) fail(off(p), "%s RLE symbol %d above %d", name, p[0], max_symbol);
        build_rle(p[0], t);
        return 1;
      case 2: {
        int16_t norm[256];
        int log, nsym;
        size_t used = read_ncount(p, size_t(end - p), off(p), max_log, max_symbol, norm, &log, &nsym);
        build_fse(norm, nsym, log, t, off(p));
        return used;
      }
      default:
        if (t->log < 0) fail(off(p), "%s table in Repeat mode with no previous table", name);
        return 0;
    }
  }

  void decode_sequences(const uint8_t* p, const uint8_t* end) {
    need(p, 1, end, "sequences section header");
    size_t nseq;
    uint8_t b0 = p[0];
    if (b0 == 0) {
      if (p + 1 != end) fail(off(p + 1), "bytes after a sequences section of no sequences");
      put(lit, lit_size);
      return;
    } else if (b0 < 128) {
      nseq = b0;
      p += 1;
    } else if (b0 < 255) {
      need(p, 2, end, "sequences section header");
      nseq = (size_t(b0 - 128) << 8) + p[1];
      p += 2;
    } else {
      need(p, 3, end, "sequences section header");
      nseq = p[1] + (size_t(p[2]) << 8) + 0x7F00;
      p += 3;
    }
    need(p, 1, end, "symbol compression modes");
    uint8_t modes = p[0];
    if (modes & 3) fail(off(p), "reserved bits set in the symbol compression modes");
    p += 1;
    const Predefined& def = predefined();
    p += read_table(p, end, modes >> 6, &ll, def.ll, 9, 35, "literal length");
    p += read_table(p, end, (modes >> 4) & 3, &of, def.of, 8, 31, "offset");
    p += read_table(p, end, (modes >> 2) & 3, &ml, def.ml, 9, 52, "match length");

    BackwardBits br;
    br.init(p, size_t(end - p), off(p));
    uint32_t sll = uint32_t(br.read(ll.log));
    uint32_t sof = uint32_t(br.read(of.log));
    uint32_t sml = uint32_t(br.read(ml.log));
    size_t lp = 0;  // literals used
    for (size_t i = 0; i < nseq; ++i) {
      uint8_t llc = ll.e[sll].symbol, mlc = ml.e[sml].symbol, ofc = of.e[sof].symbol;
      uint64_t ofv = (uint64_t(1) << ofc) + br.read(ofc);
      size_t mlen = kMLBase[mlc] + size_t(br.read(kMLBits[mlc]));
      size_t llen = kLLBase[llc] + size_t(br.read(kLLBits[llc]));
      uint64_t offset;
      if (ofv > 3) {
        offset = ofv - 3;
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = offset;
      } else {
        int idx = int(ofv) - 1 + (llen == 0 ? 1 : 0);
        if (idx == 0) {
          offset = rep[0];
        } else {
          offset = idx == 3 ? rep[0] - 1 : rep[idx];
          if (idx != 1) rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = offset;
        }
      }
      if (llen > lit_size - lp)
        fail(off(p), "sequence %zu takes %zu literals, %zu left", i, llen, lit_size - lp);
      put(lit + lp, llen);
      lp += llen;
      match(offset, mlen, p);
      if (i + 1 < nseq) {
        sll = ll.e[sll].base + uint32_t(br.read(ll.e[sll].nb));
        sml = ml.e[sml].base + uint32_t(br.read(ml.e[sml].nb));
        sof = of.e[sof].base + uint32_t(br.read(of.e[sof].nb));
      }
      if (br.left() < 0) fail(off(p), "sequence bitstream read past its start");
    }
    if (br.left() != 0)
      fail(off(p), "sequence bitstream not consumed exactly (%lld bits left)", (long long)br.left());
    put(lit + lp, lit_size - lp);
  }

  void decode_block(const uint8_t* p, size_t size) {
    const uint8_t* end = p + size;
    size_t before = pos;
    p += read_literals(p, end);
    decode_sequences(p, end);
    if (pos - before > block_max)
      fail(off(end), "block decodes to %zu bytes, above the block maximum %zu", pos - before,
           block_max);
  }

  // ---- frames ---------------------------------------------------------------

  struct Header {
    bool single, checksum, has_fcs;
    uint64_t fcs, window;
    size_t size;
  };

  Header read_header(const uint8_t* p, const uint8_t* end) {
    Header h{};
    need(p, 5, end, "frame header");
    uint8_t fhd = p[4];
    int fcs_flag = fhd >> 6;
    h.single = (fhd >> 5) & 1;
    if ((fhd >> 3) & 1) fail(off(p + 4), "reserved bit set in the frame header descriptor");
    h.checksum = (fhd >> 2) & 1;
    int did_flag = fhd & 3;
    const uint8_t* q = p + 5;
    if (!h.single) {
      need(q, 1, end, "window descriptor");
      int exponent = q[0] >> 3, mantissa = q[0] & 7;
      int wlog = 10 + exponent;
      if (wlog > 31) fail(off(q), "window log %d above 31", wlog);
      uint64_t base = uint64_t(1) << wlog;
      h.window = base + (base >> 3) * uint64_t(mantissa);
      q += 1;
    }
    static const int kDidSize[4] = {0, 1, 2, 4};
    int ds = kDidSize[did_flag];
    need(q, size_t(ds), end, "dictionary id");
    uint64_t did = 0;
    for (int i = 0; i < ds; ++i) did |= uint64_t(q[i]) << (8 * i);
    if (did != 0)
      fail(off(q), "frame needs dictionary %llu; dictionaries are not supported",
           (unsigned long long)did);
    q += ds;
    static const int kFcsSize[4] = {0, 2, 4, 8};
    int fs = fcs_flag == 0 ? (h.single ? 1 : 0) : kFcsSize[fcs_flag];
    need(q, size_t(fs), end, "frame content size");
    h.has_fcs = fs > 0;
    for (int i = 0; i < fs; ++i) h.fcs |= uint64_t(q[i]) << (8 * i);
    if (fs == 2) h.fcs += 256;
    q += fs;
    if (h.single) h.window = h.fcs;
    h.size = size_t(q - p);
    return h;
  }

  const uint8_t* decode_frame(const uint8_t* p, const uint8_t* end) {
    Header h = read_header(p, end);
    p += h.size;
    frame_start = pos;
    block_max = h.window < kBlockSizeMax ? size_t(h.window) : kBlockSizeMax;
    rep[0] = 1;
    rep[1] = 4;
    rep[2] = 8;
    huf.max_bits = 0;
    ll.log = of.log = ml.log = -1;
    for (;;) {
      need(p, 3, end, "block header");
      uint32_t bh = p[0] | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16);
      bool last = bh & 1;
      int type = (bh >> 1) & 3;
      size_t size = bh >> 3;
      const uint8_t* body = p + 3;
      if (type == 3) fail(off(p), "reserved block type");
      if (size > block_max)
        fail(off(p), "block of %zu bytes above the block maximum %zu", size, block_max);
      if (type == 0) {
        need(body, size, end, "raw block");
        put(body, size);
        p = body + size;
      } else if (type == 1) {
        need(body, 1, end, "RLE block");
        fill(body[0], size);
        p = body + 1;
      } else {
        need(body, size, end, "compressed block");
        decode_block(body, size);
        p = body + size;
      }
      if (last) break;
    }
    size_t produced = pos - frame_start;
    if (h.has_fcs && produced != h.fcs)
      fail(off(p), "frame decodes to %zu bytes, its header says %llu", produced,
           (unsigned long long)h.fcs);
    if (h.checksum) {
      need(p, 4, end, "content checksum");
      if (!overflow) {
        uint32_t want = rd32(p);
        uint32_t got = uint32_t(xxh64(dst + frame_start, produced));
        if (want != got)
          fail(off(p), "content checksum mismatch (frame says %08x, content gives %08x)", want, got);
      }
      p += 4;
    }
    return p;
  }

  void run() {
    const uint8_t* p = src;
    const uint8_t* end = src + n;
    if (n == 0) fail(0, "no zstd frame in empty input");
    while (p < end) {
      need(p, 4, end, "frame magic");
      uint32_t magic = rd32(p);
      if (magic == kFrameMagic) {
        p = decode_frame(p, end);
      } else if ((magic & kSkippableMask) == kSkippableMagic) {
        need(p, 8, end, "skippable frame header");
        size_t size = rd32(p + 4);
        need(p + 8, size, end, "skippable frame");
        p += 8 + size;
      } else {
        fail(off(p), "not a zstd frame (magic %08x)", magic);
      }
    }
  }
};

thread_local std::vector<uint8_t> g_state;  // one Decoder's storage per thread

}  // namespace

extern "C" {

int tos_zstd_decompress(const uint8_t* src, uint64_t n, uint8_t* dst, uint64_t cap,
                        uint64_t* out_len, uint64_t* err_off, char* msg, uint64_t msg_cap) {
  if (g_state.size() < sizeof(Decoder)) g_state.resize(sizeof(Decoder));
  Decoder* d = new (g_state.data()) Decoder(src, size_t(n), dst, size_t(cap));
  try {
    d->run();
  } catch (const Failure& f) {
    *err_off = f.offset;
    if (msg_cap) snprintf(msg, size_t(msg_cap), "%s", f.msg);
    return 1;
  }
  *out_len = d->pos;
  return d->overflow ? 2 : 0;
}

int64_t tos_zstd_content_size(const uint8_t* src, uint64_t n) {
  if (g_state.size() < sizeof(Decoder)) g_state.resize(sizeof(Decoder));
  Decoder* d = new (g_state.data()) Decoder(src, size_t(n), nullptr, 0);
  const uint8_t* p = src;
  const uint8_t* end = src + n;
  uint64_t total = 0;
  try {
    while (p < end) {
      d->need(p, 4, end, "frame magic");
      uint32_t magic = rd32(p);
      if ((magic & kSkippableMask) == kSkippableMagic) {
        d->need(p, 8, end, "skippable frame header");
        size_t size = rd32(p + 4);
        d->need(p + 8, size, end, "skippable frame");
        p += 8 + size;
        continue;
      }
      if (magic != kFrameMagic) return -1;
      Decoder::Header h = d->read_header(p, end);
      if (!h.has_fcs) return -1;
      total += h.fcs;
      p += h.size;
      for (;;) {  // walk the block headers to the next frame
        d->need(p, 3, end, "block header");
        uint32_t bh = p[0] | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16);
        int type = (bh >> 1) & 3;
        size_t size = type == 1 ? 1 : bh >> 3;
        d->need(p + 3, size, end, "block");
        p += 3 + size;
        if (bh & 1) break;
      }
      if (h.checksum) {
        d->need(p, 4, end, "content checksum");
        p += 4;
      }
    }
  } catch (const Failure&) {
    return -1;
  }
  return int64_t(total);
}

}  // extern "C"

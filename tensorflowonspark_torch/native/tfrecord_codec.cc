// Native data-path codec for tensorflowonspark_torch.
//
// The reference delegated TFRecord I/O to the tensorflow-hadoop Java
// InputFormat and the TF C++ runtime (SURVEY.md §2.2); this is the TPU
// build's native equivalent for the host-side input pipeline: CRC-32C
// (Castagnoli) via slice-by-8, plus bulk record framing/unframing so Python
// touches each byte once.  Exposed through a minimal C ABI consumed with
// ctypes (no pybind11 in this environment).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 tfrecord_codec.cc -o libtfrecord_codec.so

#include <cstdint>
#include <cstring>
#include <cstddef>

namespace {

uint32_t kTable[8][256];
bool kInit = false;

void init_tables() {
  if (kInit) return;
  const uint32_t poly = 0x82F63B78u;
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t crc = i;
    for (int k = 0; k < 8; ++k) crc = (crc & 1) ? (crc >> 1) ^ poly : crc >> 1;
    kTable[0][i] = crc;
  }
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t crc = kTable[0][i];
    for (int s = 1; s < 8; ++s) {
      crc = kTable[0][crc & 0xFF] ^ (crc >> 8);
      kTable[s][i] = crc;
    }
  }
  kInit = true;
}

inline uint32_t le32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;  // little-endian hosts only (x86/ARM/TPU-VM)
}

}  // namespace

extern "C" {

// Raw CRC-32C of buf[0..n); crc is the running value (0 to start).
uint32_t tos_crc32c(const uint8_t* buf, size_t n, uint32_t crc) {
  init_tables();
  crc ^= 0xFFFFFFFFu;
  // slice-by-8 over aligned middle
  while (n >= 8) {
    crc ^= le32(buf);
    uint32_t hi = le32(buf + 4);
    crc = kTable[7][crc & 0xFF] ^ kTable[6][(crc >> 8) & 0xFF] ^
          kTable[5][(crc >> 16) & 0xFF] ^ kTable[4][crc >> 24] ^
          kTable[3][hi & 0xFF] ^ kTable[2][(hi >> 8) & 0xFF] ^
          kTable[1][(hi >> 16) & 0xFF] ^ kTable[0][hi >> 24];
    buf += 8;
    n -= 8;
  }
  while (n--) crc = kTable[0][(crc ^ *buf++) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

static inline uint32_t masked(uint32_t crc) {
  return (((crc >> 15) | (crc << 17)) + 0xA282EAD8u);
}

// Scan a buffer of framed TFRecords, verifying CRCs.
// Writes up to max_records (offset, length) pairs into out_off/out_len.
// Returns the number of records found; *consumed is the byte count of
// complete, valid records.  Returns -1 on corruption (crc mismatch),
// with *consumed = offset of the bad record.
int64_t tos_scan_records(const uint8_t* buf, size_t n, int verify,
                         uint64_t* out_off, uint64_t* out_len,
                         int64_t max_records, uint64_t* consumed) {
  init_tables();
  size_t pos = 0;
  int64_t count = 0;
  while (count < max_records) {
    if (n - pos < 12) break;
    uint64_t len;
    std::memcpy(&len, buf + pos, 8);
    uint32_t len_crc = le32(buf + pos + 8);
    if (verify && masked(tos_crc32c(buf + pos, 8, 0)) != len_crc) {
      *consumed = pos;
      return -1;
    }
    // Overflow-safe incomplete-record check: `len + 4` could wrap for a
    // corrupt length field when verify=0, turning an OOB read into a crash.
    const uint64_t avail = n - pos - 12;
    if (len > avail || avail - len < 4) break;  // incomplete record
    const uint8_t* data = buf + pos + 12;
    uint32_t data_crc = le32(data + len);
    if (verify && masked(tos_crc32c(data, len, 0)) != data_crc) {
      *consumed = pos;
      return -1;
    }
    out_off[count] = pos + 12;
    out_len[count] = len;
    ++count;
    pos += 12 + len + 4;
  }
  *consumed = pos;
  return count;
}

// Frame one record into out (which must hold 16 + n bytes).
// Returns the framed size.
uint64_t tos_frame_record(const uint8_t* data, uint64_t n, uint8_t* out) {
  init_tables();
  std::memcpy(out, &n, 8);
  uint32_t lc = masked(tos_crc32c(out, 8, 0));
  std::memcpy(out + 8, &lc, 4);
  std::memcpy(out + 12, data, n);
  uint32_t dc = masked(tos_crc32c(data, n, 0));
  std::memcpy(out + 12 + n, &dc, 4);
  return 16 + n;
}

}  // extern "C"

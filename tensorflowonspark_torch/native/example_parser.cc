// Native batch parser for tf.train.Example records — the data-loader hot
// path (reference equivalent: record/Example decoding inside the
// tensorflow-hadoop jar / TF runtime, both native; here the per-record
// proto walk happens in C++ and Python sees whole columns).
//
// Wire subset handled (matches example.py, the pure-Python codec):
//   Example    { Features features = 1; }
//   Features   { map<string, Feature> feature = 1; }
//   Feature    { oneof kind { BytesList bytes_list = 1;
//                             FloatList float_list = 2;
//                             Int64List int64_list = 3; } }
//   BytesList  { repeated bytes value = 1; }
//   FloatList  { repeated float value = 1 }   // packed or repeated
//   Int64List  { repeated int64 value = 1 }   // packed or repeated
//
// API shape: two passes per (shard, feature) — tos_count_feature sizes the
// output, tos_fill_feature writes it — so Python allocates exact numpy
// buffers and each pass is ONE ctypes call over the whole shard.
//
// Build: g++ -O3 -shared -fPIC (see native/build.py).

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

struct Reader {
  const uint8_t* p;
  const uint8_t* end;
  bool ok;

  Reader(const uint8_t* ptr, size_t n) : p(ptr), end(ptr + n), ok(true) {}

  uint64_t varint() {
    uint64_t result = 0;
    int shift = 0;
    while (p < end) {
      uint8_t b = *p++;
      result |= static_cast<uint64_t>(b & 0x7F) << shift;
      if (!(b & 0x80)) return result;
      shift += 7;
      // reject overlong (>10 byte) varints BEFORE a >=64-bit shift (UB);
      // the canonical 10th byte shifts by 63, which is defined
      if (shift >= 64) break;
    }
    ok = false;
    return 0;
  }

  // Returns subspan for length-delimited fields.
  bool subspan(const uint8_t** sub, size_t* n) {
    uint64_t len = varint();
    // compare against remaining bytes, NOT p + len (which can overflow)
    if (!ok || len > static_cast<uint64_t>(end - p)) { ok = false; return false; }
    *sub = p;
    *n = static_cast<size_t>(len);
    p += len;
    return true;
  }

  bool skip(int wire) {
    switch (wire) {
      case 0: varint(); return ok;
      case 1: if (p + 8 > end) { ok = false; return false; } p += 8; return true;
      case 2: { const uint8_t* s; size_t n; return subspan(&s, &n); }
      case 5: if (p + 4 > end) { ok = false; return false; } p += 4; return true;
      default: ok = false; return false;
    }
  }

  bool done() const { return p >= end; }
};

// Find the named feature's kind payload inside one Example record.
// Returns: 1/2/3 = kind found, 0 = feature absent, -1 = parse error.
// Proto map semantics: when a key appears multiple times on the wire the
// LAST entry wins (matching the pure-Python decode_example fallback), so
// the walk continues to the end of the record instead of early-returning.
int find_feature(const uint8_t* rec, size_t rec_len,
                 const uint8_t* name, size_t name_len,
                 const uint8_t** kind_payload, size_t* kind_len) {
  int result_kind = 0;
  Reader ex(rec, rec_len);
  while (!ex.done()) {
    uint64_t key = ex.varint();
    if (!ex.ok) return -1;
    int field = static_cast<int>(key >> 3), wire = static_cast<int>(key & 7);
    if (field == 1 && wire == 2) {  // Features
      const uint8_t* fs; size_t fs_len;
      if (!ex.subspan(&fs, &fs_len)) return -1;
      Reader feats(fs, fs_len);
      while (!feats.done()) {
        uint64_t fkey = feats.varint();
        if (!feats.ok) return -1;
        int ff = static_cast<int>(fkey >> 3), fw = static_cast<int>(fkey & 7);
        if (ff == 1 && fw == 2) {  // one map entry
          const uint8_t* entry; size_t entry_len;
          if (!feats.subspan(&entry, &entry_len)) return -1;
          Reader e(entry, entry_len);
          const uint8_t* ename = nullptr; size_t ename_len = 0;
          const uint8_t* feat = nullptr; size_t feat_len = 0;
          while (!e.done()) {
            uint64_t ekey = e.varint();
            if (!e.ok) return -1;
            int ef = static_cast<int>(ekey >> 3), ew = static_cast<int>(ekey & 7);
            if (ef == 1 && ew == 2) {
              if (!e.subspan(&ename, &ename_len)) return -1;
            } else if (ef == 2 && ew == 2) {
              if (!e.subspan(&feat, &feat_len)) return -1;
            } else if (!e.skip(ew)) {
              return -1;
            }
          }
          if (ename && ename_len == name_len &&
              memcmp(ename, name, name_len) == 0 && feat) {
            // record this entry's kind; keep walking (last map entry wins)
            Reader f(feat, feat_len);
            bool matched = false;
            while (!f.done()) {
              uint64_t kkey = f.varint();
              if (!f.ok) return -1;
              int kf = static_cast<int>(kkey >> 3), kw = static_cast<int>(kkey & 7);
              if ((kf == 1 || kf == 2 || kf == 3) && kw == 2 && !matched) {
                if (!f.subspan(kind_payload, kind_len)) return -1;
                result_kind = kf;
                matched = true;
              } else if (!f.skip(kw)) {
                return -1;
              }
            }
            // Empty kind payloads (zero values) report as ABSENT: the
            // pure-Python fallback cannot recover the kind of an empty
            // feature either, so this keeps both paths identical (incl.
            // not raising a kind mismatch for a valueless feature).
            if (!matched || *kind_len == 0) result_kind = 0;
          }
        } else if (!feats.skip(fw)) {
          return -1;
        }
      }
    } else {
      if (!ex.skip(wire)) return -1;
    }
  }
  return result_kind;
}

// Walk a kind payload (BytesList/FloatList/Int64List body), invoking the
// sink for every value.  Handles packed and repeated primitive encodings.
template <typename BytesSink, typename FloatSink, typename IntSink>
bool walk_values(int kind, const uint8_t* body, size_t body_len,
                 const uint8_t* base, BytesSink on_bytes, FloatSink on_float,
                 IntSink on_int) {
  Reader r(body, body_len);
  while (!r.done()) {
    uint64_t key = r.varint();
    if (!r.ok) return false;
    int field = static_cast<int>(key >> 3), wire = static_cast<int>(key & 7);
    if (field != 1) { if (!r.skip(wire)) return false; continue; }
    if (kind == 1) {  // bytes values are length-delimited
      const uint8_t* v; size_t n;
      if (wire != 2 || !r.subspan(&v, &n)) return false;
      on_bytes(static_cast<uint64_t>(v - base), static_cast<uint64_t>(n));
    } else if (kind == 2) {  // floats: packed (wire 2) or repeated (wire 5)
      if (wire == 2) {
        const uint8_t* v; size_t n;
        if (!r.subspan(&v, &n) || n % 4) return false;
        for (size_t i = 0; i < n; i += 4) {
          float f;
          memcpy(&f, v + i, 4);
          on_float(f);
        }
      } else if (wire == 5) {
        if (r.p + 4 > r.end) return false;
        float f;
        memcpy(&f, r.p, 4);
        r.p += 4;
        on_float(f);
      } else {
        return false;
      }
    } else {  // int64: packed (wire 2) or repeated varints (wire 0)
      if (wire == 2) {
        const uint8_t* v; size_t n;
        if (!r.subspan(&v, &n)) return false;
        Reader pr(v, n);
        while (!pr.done()) {
          uint64_t raw = pr.varint();
          if (!pr.ok) return false;
          on_int(static_cast<int64_t>(raw));
        }
      } else if (wire == 0) {
        uint64_t raw = r.varint();
        if (!r.ok) return false;
        on_int(static_cast<int64_t>(raw));
      } else {
        return false;
      }
    }
  }
  return true;
}

}  // namespace

extern "C" {

// Pass 1: per-record value counts for one feature across n records.
// counts[i] receives record i's value count (0 if absent).  Returns the
// total value count, or -1 on parse error, or -2 on kind mismatch with
// `expect_kind` (1 bytes / 2 float / 3 int64; 0 = accept any, and then
// *found_kind receives the first kind seen).
int64_t tos_count_feature(const uint8_t* buf, const uint64_t* offs,
                          const uint64_t* lens, int64_t n,
                          const uint8_t* name, uint64_t name_len,
                          int expect_kind, int* found_kind,
                          uint64_t* counts) {
  int64_t total = 0;
  int seen_kind = 0;
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* kp; size_t kl;
    int kind = find_feature(buf + offs[i], static_cast<size_t>(lens[i]), name,
                            static_cast<size_t>(name_len), &kp, &kl);
    if (kind < 0) return -1;
    if (kind == 0) { counts[i] = 0; continue; }
    if (expect_kind && kind != expect_kind) return -2;
    if (!seen_kind) seen_kind = kind;
    if (kind != seen_kind) return -2;  // heterogeneous column
    uint64_t c = 0;
    bool ok = walk_values(
        kind, kp, kl, buf,
        [&](uint64_t, uint64_t) { ++c; },
        [&](float) { ++c; },
        [&](int64_t) { ++c; });
    if (!ok) return -1;
    counts[i] = c;
    total += static_cast<int64_t>(c);
  }
  if (found_kind) *found_kind = seen_kind;
  return total;
}

// Pass 2: fill exactly-sized outputs.  For kind 1 (bytes), byte_offs/
// byte_lens receive spans relative to `buf`; for kind 2, f32_out; for
// kind 3, i64_out.  Caller sizes the arrays from pass 1.  Returns the
// number of values written or -1 on parse error.
int64_t tos_fill_feature(const uint8_t* buf, const uint64_t* offs,
                         const uint64_t* lens, int64_t n,
                         const uint8_t* name, uint64_t name_len, int kind,
                         float* f32_out, int64_t* i64_out,
                         uint64_t* byte_offs, uint64_t* byte_lens) {
  int64_t w = 0;
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* kp; size_t kl;
    int got = find_feature(buf + offs[i], static_cast<size_t>(lens[i]), name,
                           static_cast<size_t>(name_len), &kp, &kl);
    if (got < 0) return -1;
    if (got == 0) continue;
    if (got != kind) return -1;
    bool ok = walk_values(
        kind, kp, kl, buf,
        [&](uint64_t o, uint64_t l) { byte_offs[w] = o; byte_lens[w] = l; ++w; },
        [&](float f) { f32_out[w++] = f; },
        [&](int64_t v) { i64_out[w++] = v; });
    if (!ok) return -1;
  }
  return w;
}

}  // extern "C"

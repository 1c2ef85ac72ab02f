// Shared-memory SPSC ring buffer — the native same-host data-plane transport.
//
// The reference's in-host data plane was a multiprocessing.managers proxy
// queue between the pyspark worker and the TF process (TFManager.py,
// SURVEY.md §3.2): every sample paid a pickle + TCP-loopback + proxy hop.
// This is the TPU build's native equivalent: a single-producer /
// single-consumer byte ring in POSIX shared memory, lock-free (C++11
// acquire/release atomics), with records framed [u32 len][payload].  The
// Python side (shm_ring.py) moves pickled items through it when feeder and
// node share a host; cross-host feeding stays on the TCP DataServer.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 shm_ring.cc -o libshm_ring.so
//
// SPSC contract: exactly one pusher thread and one popper thread per ring.
// The DataClient/DataServer pairing guarantees this (one driver feed stream
// per node; replies on a second ring in the other direction).

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <ctime>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Header {
  uint64_t capacity;              // data region size in bytes
  std::atomic<uint64_t> head;     // total bytes written (mod capacity = offset)
  std::atomic<uint64_t> tail;     // total bytes read
  std::atomic<uint32_t> closed;   // producer hung up
  uint32_t magic;
};

constexpr uint32_t kMagic = 0x544F5352;  // "TOSR"

struct Ring {
  Header* hdr;
  uint8_t* data;
  size_t map_len;
  int fd;
};

inline uint64_t now_ms() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return uint64_t(ts.tv_sec) * 1000 + ts.tv_nsec / 1000000;
}

// Adaptive wait: spin briefly, then sleep 50us — latency where it matters,
// no busy-burn while blocked on an empty/full ring.
inline void backoff(int iter) {
  if (iter < 64) return;
  timespec ts{0, 50 * 1000};
  nanosleep(&ts, nullptr);
}

void copy_in(Ring* r, uint64_t pos, const uint8_t* src, uint64_t len) {
  uint64_t off = pos % r->hdr->capacity;
  uint64_t first = r->hdr->capacity - off;
  if (first >= len) {
    memcpy(r->data + off, src, len);
  } else {
    memcpy(r->data + off, src, first);
    memcpy(r->data, src + first, len - first);
  }
}

void copy_out(Ring* r, uint64_t pos, uint8_t* dst, uint64_t len) {
  uint64_t off = pos % r->hdr->capacity;
  uint64_t first = r->hdr->capacity - off;
  if (first >= len) {
    memcpy(dst, r->data + off, len);
  } else {
    memcpy(dst, r->data + off, first);
    memcpy(dst + first, r->data, len - first);
  }
}

}  // namespace

extern "C" {

// Create (creat=1) or attach (creat=0) a ring named `name` (shm_open name,
// must start with '/').  Returns an opaque handle or null.
void* tos_ring_open(const char* name, uint64_t capacity, int creat) {
  int fd = creat ? shm_open(name, O_CREAT | O_RDWR | O_EXCL, 0600)
                 : shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  size_t map_len = sizeof(Header) + capacity;
  if (creat && ftruncate(fd, (off_t)map_len) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  if (!creat) {
    struct stat st;
    if (fstat(fd, &st) != 0 || (size_t)st.st_size < sizeof(Header)) {
      close(fd);
      return nullptr;
    }
    map_len = st.st_size;
  }
  void* mem = mmap(nullptr, map_len, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (mem == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  Ring* r = new Ring;
  r->hdr = static_cast<Header*>(mem);
  r->data = reinterpret_cast<uint8_t*>(mem) + sizeof(Header);
  r->map_len = map_len;
  r->fd = fd;
  if (creat) {
    r->hdr->capacity = capacity;
    r->hdr->head.store(0, std::memory_order_relaxed);
    r->hdr->tail.store(0, std::memory_order_relaxed);
    r->hdr->closed.store(0, std::memory_order_relaxed);
    r->hdr->magic = kMagic;
  } else if (r->hdr->magic != kMagic) {
    munmap(mem, map_len);
    close(fd);
    delete r;
    return nullptr;
  }
  return r;
}

// Push one record assembled from TWO buffers (frame flag + payload) without
// requiring the caller to join them first — the zero-copy batched push path:
// Python hands the flag byte and the payload view separately and the only
// copy is the memcpy into the ring itself.  This is THE ring-commit
// implementation; the single-buffer push delegates here so the
// wait/backoff/closed/timeout protocol exists exactly once.
// 1 = ok, 0 = timeout, -1 = ring closed, -2 = too large.
int tos_ring_push2(void* h, const uint8_t* a, uint64_t alen,
                   const uint8_t* b, uint64_t blen, int timeout_ms) {
  Ring* r = static_cast<Ring*>(h);
  uint64_t len = alen + blen;
  uint64_t need = len + 4;
  if (need > r->hdr->capacity) return -2;
  uint64_t deadline = now_ms() + (uint64_t)timeout_ms;
  uint64_t head = r->hdr->head.load(std::memory_order_relaxed);
  int iter = 0;
  for (;;) {
    if (r->hdr->closed.load(std::memory_order_acquire)) return -1;
    uint64_t tail = r->hdr->tail.load(std::memory_order_acquire);
    if (r->hdr->capacity - (head - tail) >= need) break;
    if (timeout_ms >= 0 && now_ms() >= deadline) return 0;
    backoff(iter++);
  }
  uint8_t lenbuf[4] = {uint8_t(len), uint8_t(len >> 8), uint8_t(len >> 16),
                       uint8_t(len >> 24)};
  copy_in(r, head, lenbuf, 4);
  if (alen) copy_in(r, head + 4, a, alen);
  if (blen) copy_in(r, head + 4 + alen, b, blen);
  r->hdr->head.store(head + need, std::memory_order_release);
  return 1;
}

// Push one single-buffer record.  Same return codes as push2.
int tos_ring_push(void* h, const uint8_t* data, uint64_t len, int timeout_ms) {
  return tos_ring_push2(h, data, len, nullptr, 0, timeout_ms);
}

// Size of the next record without consuming it.
// >=0 = size, -1 = empty+closed (EOF), 0..: note 0-length records are legal,
// so empty-and-open is signalled by -3 (timeout) instead.
int64_t tos_ring_next_size(void* h, int timeout_ms) {
  Ring* r = static_cast<Ring*>(h);
  uint64_t deadline = now_ms() + (uint64_t)timeout_ms;
  uint64_t tail = r->hdr->tail.load(std::memory_order_relaxed);
  int iter = 0;
  for (;;) {
    uint64_t head = r->hdr->head.load(std::memory_order_acquire);
    if (head - tail >= 4) {
      uint8_t lenbuf[4];
      copy_out(r, tail, lenbuf, 4);
      return (int64_t)(uint32_t(lenbuf[0]) | uint32_t(lenbuf[1]) << 8 |
                       uint32_t(lenbuf[2]) << 16 | uint32_t(lenbuf[3]) << 24);
    }
    if (r->hdr->closed.load(std::memory_order_acquire)) return -1;
    if (timeout_ms >= 0 && now_ms() >= deadline) return -3;
    backoff(iter++);
  }
}

// Pop one record into out (cap bytes).  >=0 = record size, -1 = EOF,
// -2 = out buffer too small (record left in place), -3 = timeout.
int64_t tos_ring_pop(void* h, uint8_t* out, uint64_t cap, int timeout_ms) {
  Ring* r = static_cast<Ring*>(h);
  int64_t size = tos_ring_next_size(h, timeout_ms);
  if (size < 0) return size;
  if ((uint64_t)size > cap) return -2;
  uint64_t tail = r->hdr->tail.load(std::memory_order_relaxed);
  copy_out(r, tail + 4, out, (uint64_t)size);
  r->hdr->tail.store(tail + 4 + (uint64_t)size, std::memory_order_release);
  return size;
}

uint64_t tos_ring_capacity(void* h) {
  return static_cast<Ring*>(h)->hdr->capacity;
}

void tos_ring_close_write(void* h) {
  static_cast<Ring*>(h)->hdr->closed.store(1, std::memory_order_release);
}

int tos_ring_is_closed(void* h) {
  return (int)static_cast<Ring*>(h)->hdr->closed.load(std::memory_order_acquire);
}

uint64_t tos_ring_size(void* h) {
  Ring* r = static_cast<Ring*>(h);
  return r->hdr->head.load(std::memory_order_acquire) -
         r->hdr->tail.load(std::memory_order_acquire);
}

void tos_ring_detach(void* h) {
  Ring* r = static_cast<Ring*>(h);
  munmap(r->hdr, r->map_len);
  close(r->fd);
  delete r;
}

int tos_ring_unlink(const char* name) { return shm_unlink(name); }

}  // extern "C"

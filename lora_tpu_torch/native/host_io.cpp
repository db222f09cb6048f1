// Host-side IO of the PyTorch/CUDA port: the sample ring the streamers
// ingest through, and the UDP and file frame sinks.
//
// C-ABI shared library, built with g++ at first use and loaded with ctypes
// (lora_tpu_torch/native/__init__.py). It keeps the semantics of
// lora_tpu/native/host_io.cpp, which carries the reference's C++ runtime
// blocks:
//
//  - UDP frame sink        <- lib/message_socket_sink_impl.cc  (sendto per frame)
//  - UDP frame source      <- lib/message_socket_source_impl.cc (background
//                             receive thread + bounded drop-oldest queue)
//  - append-only file sink <- lib/message_file_sink_impl.cc (write + flush per msg)
//  - SPSC byte ring buffer <- the GNU Radio scheduler's bounded stream buffers
//                             (backpressure between the IQ producer and the
//                             block dispatcher), with peek/advance for
//                             overlap-save blocking
//
// The ring moves bytes in at most two memcpy spans (one on each side of
// the wrap) where the JAX package's ring copies byte by byte through a
// modulo; the bytes moved, and every return value, are the same. peek
// writes into any caller buffer, so a streamer peeks a block straight into
// its page-locked staging buffer.

#include <arpa/inet.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <sys/types.h>
#include <unistd.h>

#include <atomic>
#include <cerrno>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- UDP sink
struct lt_udp_sink {
  int fd;
  sockaddr_in addr;
};

void* lt_udp_sink_open(const char* ip, int port) {
  auto* s = new lt_udp_sink();
  s->fd = ::socket(AF_INET, SOCK_DGRAM, 0);
  if (s->fd < 0) {
    delete s;
    return nullptr;
  }
  std::memset(&s->addr, 0, sizeof(s->addr));
  s->addr.sin_family = AF_INET;
  s->addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::inet_pton(AF_INET, ip, &s->addr.sin_addr) != 1) {
    ::close(s->fd);
    delete s;
    return nullptr;
  }
  return s;
}

long lt_udp_sink_send(void* h, const uint8_t* buf, long len) {
  auto* s = static_cast<lt_udp_sink*>(h);
  return ::sendto(s->fd, buf, static_cast<size_t>(len), 0,
                  reinterpret_cast<sockaddr*>(&s->addr), sizeof(s->addr));
}

void lt_udp_sink_close(void* h) {
  auto* s = static_cast<lt_udp_sink*>(h);
  ::close(s->fd);
  delete s;
}

// -------------------------------------------------------------- UDP source
struct lt_udp_source {
  int fd = -1;
  std::thread rx;
  std::mutex mu;
  std::condition_variable cv;
  std::deque<std::vector<uint8_t>> q;
  std::atomic<bool> stop{false};
  size_t max_queue = 4096;
};

static void lt_udp_source_loop(lt_udp_source* s) {
  std::vector<uint8_t> buf(65536);
  while (!s->stop.load(std::memory_order_relaxed)) {
    ssize_t n = ::recv(s->fd, buf.data(), buf.size(), 0);
    if (n < 0) {
      if (errno == EAGAIN || errno == EWOULDBLOCK || errno == EINTR) continue;
      break;
    }
    std::lock_guard<std::mutex> lk(s->mu);
    if (s->q.size() >= s->max_queue) s->q.pop_front();  // drop-oldest
    s->q.emplace_back(buf.begin(), buf.begin() + n);
    s->cv.notify_one();
  }
}

void* lt_udp_source_open(const char* addr, int port) {
  auto* s = new lt_udp_source();
  s->fd = ::socket(AF_INET, SOCK_DGRAM, 0);
  if (s->fd < 0) {
    delete s;
    return nullptr;
  }
  int one = 1;
  ::setsockopt(s->fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  timeval tv{0, 200000};  // 200 ms poll so stop() is honored
  ::setsockopt(s->fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  sockaddr_in sa;
  std::memset(&sa, 0, sizeof(sa));
  sa.sin_family = AF_INET;
  sa.sin_port = htons(static_cast<uint16_t>(port));
  if (::inet_pton(AF_INET, addr, &sa.sin_addr) != 1)
    sa.sin_addr.s_addr = INADDR_ANY;
  if (::bind(s->fd, reinterpret_cast<sockaddr*>(&sa), sizeof(sa)) < 0) {
    ::close(s->fd);
    delete s;
    return nullptr;
  }
  s->rx = std::thread(lt_udp_source_loop, s);
  return s;
}

// The port the source is bound to (the kernel's choice when opened on 0).
int lt_udp_source_port(void* h) {
  auto* s = static_cast<lt_udp_source*>(h);
  sockaddr_in sa;
  socklen_t n = sizeof(sa);
  if (::getsockname(s->fd, reinterpret_cast<sockaddr*>(&sa), &n) < 0) return -1;
  return ntohs(sa.sin_port);
}

// Returns datagram length (copied into buf, truncated to cap), 0 on
// timeout (millis elapsed with nothing queued), -2 for an empty datagram.
long lt_udp_source_poll(void* h, uint8_t* buf, long cap, int timeout_ms) {
  auto* s = static_cast<lt_udp_source*>(h);
  std::unique_lock<std::mutex> lk(s->mu);
  if (!s->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                      [s] { return !s->q.empty(); }))
    return 0;
  std::vector<uint8_t> d = std::move(s->q.front());
  s->q.pop_front();
  lk.unlock();
  long n = static_cast<long>(d.size() < static_cast<size_t>(cap) ? d.size()
                                                                 : cap);
  std::memcpy(buf, d.data(), static_cast<size_t>(n));
  return n == 0 ? -2 : n;
}

void lt_udp_source_close(void* h) {
  auto* s = static_cast<lt_udp_source*>(h);
  s->stop.store(true);
  if (s->rx.joinable()) s->rx.join();
  ::close(s->fd);
  delete s;
}

// -------------------------------------------------------------- file sink
void* lt_file_sink_open(const char* path) { return std::fopen(path, "ab"); }

long lt_file_sink_write(void* h, const uint8_t* buf, long len) {
  FILE* f = static_cast<FILE*>(h);
  size_t n = std::fwrite(buf, 1, static_cast<size_t>(len), f);
  std::fflush(f);  // the reference flushes per message
  return static_cast<long>(n);
}

void lt_file_sink_close(void* h) { std::fclose(static_cast<FILE*>(h)); }

// -------------------------------------------------- SPSC byte ring buffer
// Lock-free single-producer single-consumer ring: the bounded buffer between
// the IQ producer (file or SDR reader) and the block dispatcher. head and
// tail count bytes since creation; a position in the buffer is the count
// modulo the capacity.
struct lt_ring {
  std::vector<uint8_t> buf;
  std::atomic<uint64_t> head{0};  // written by producer
  std::atomic<uint64_t> tail{0};  // written by consumer
};

// Copy n bytes out of the ring from position pos, in at most two spans.
static void ring_copy_out(const lt_ring* r, uint64_t pos, uint8_t* dst,
                          uint64_t n) {
  const uint64_t cap = r->buf.size();
  const uint64_t at = pos % cap;
  const uint64_t first = n < cap - at ? n : cap - at;
  std::memcpy(dst, r->buf.data() + at, first);
  std::memcpy(dst + first, r->buf.data(), n - first);
}

void* lt_ring_create(long capacity) {
  auto* r = new lt_ring();
  r->buf.resize(static_cast<size_t>(capacity));
  return r;
}

long lt_ring_capacity(void* h) {
  return static_cast<long>(static_cast<lt_ring*>(h)->buf.size());
}

long lt_ring_readable(void* h) {
  auto* r = static_cast<lt_ring*>(h);
  return static_cast<long>(r->head.load(std::memory_order_acquire) -
                           r->tail.load(std::memory_order_acquire));
}

// Copy up to len bytes in; returns bytes accepted (backpressure: may be
// short when the consumer lags).
long lt_ring_write(void* h, const uint8_t* src, long len) {
  auto* r = static_cast<lt_ring*>(h);
  const uint64_t cap = r->buf.size();
  const uint64_t head = r->head.load(std::memory_order_relaxed);
  const uint64_t tail = r->tail.load(std::memory_order_acquire);
  const uint64_t free_b = cap - (head - tail);
  const uint64_t n = static_cast<uint64_t>(len) < free_b
                         ? static_cast<uint64_t>(len)
                         : free_b;
  if (n) {
    const uint64_t at = head % cap;
    const uint64_t first = n < cap - at ? n : cap - at;
    std::memcpy(r->buf.data() + at, src, first);
    std::memcpy(r->buf.data(), src + first, n - first);
  }
  r->head.store(head + n, std::memory_order_release);
  return static_cast<long>(n);
}

// Copy up to cap_out bytes out; returns bytes read.
long lt_ring_read(void* h, uint8_t* dst, long cap_out) {
  auto* r = static_cast<lt_ring*>(h);
  const uint64_t tail = r->tail.load(std::memory_order_relaxed);
  const uint64_t head = r->head.load(std::memory_order_acquire);
  const uint64_t avail = head - tail;
  const uint64_t n = static_cast<uint64_t>(cap_out) < avail
                         ? static_cast<uint64_t>(cap_out)
                         : avail;
  if (n) ring_copy_out(r, tail, dst, n);
  r->tail.store(tail + n, std::memory_order_release);
  return static_cast<long>(n);
}

// Peek without consuming, then advance explicitly — overlap-save support:
// the dispatcher reads block+halo but only consumes block.
long lt_ring_peek(void* h, uint8_t* dst, long cap_out) {
  auto* r = static_cast<lt_ring*>(h);
  const uint64_t tail = r->tail.load(std::memory_order_relaxed);
  const uint64_t head = r->head.load(std::memory_order_acquire);
  const uint64_t avail = head - tail;
  const uint64_t n = static_cast<uint64_t>(cap_out) < avail
                         ? static_cast<uint64_t>(cap_out)
                         : avail;
  if (n) ring_copy_out(r, tail, dst, n);
  return static_cast<long>(n);
}

long lt_ring_advance(void* h, long n) {
  auto* r = static_cast<lt_ring*>(h);
  const uint64_t tail = r->tail.load(std::memory_order_relaxed);
  const uint64_t head = r->head.load(std::memory_order_acquire);
  const uint64_t avail = head - tail;
  const uint64_t adv =
      static_cast<uint64_t>(n) < avail ? static_cast<uint64_t>(n) : avail;
  r->tail.store(tail + adv, std::memory_order_release);
  return static_cast<long>(adv);
}

void lt_ring_destroy(void* h) { delete static_cast<lt_ring*>(h); }

}  // extern "C"

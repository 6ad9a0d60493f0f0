// atrt: native host-side streaming runtime for the audio-triangulation
// framework (the PyTorch port's copy of the JAX package's runtime; the two
// sources are the same program).
//
// This is the TPU-host re-expression of the reference firmware's acquisition
// and scheduling layers (capability parity, new design):
//
//   - reference L1 (src/components/dma_sampler.c): chained-DMA ADC ingest
//     with zero CPU -> here: a lock-free SPSC ring buffer a producer thread
//     (audio driver / socket / file reader) fills while the consumer drains,
//     plus per-channel rolling rings
//   - reference L3 detector (src/components/rolling_buffer.c): O(1) running
//     sum / sum-of-squares halves, trigger when the summed outgoing variance
//     exceeds threshold + incoming variance (src/sample_compute.h:78-90) ->
//     identical int64 math here, run at ingest rate on the host so only
//     event frames are shipped to the accelerator
//   - reference L2 (protothreads): cooperative producer/consumer handoff ->
//     here: an SPSC event queue between the ingest thread and the Python
//     feeder that batches frames for device transfer
//
// Exposed as a C ABI for ctypes (no pybind11 dependency).

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <new>
#include <string>
#include <thread>
#include <vector>

#include <arpa/inet.h>
#include <dlfcn.h>
#include <fcntl.h>
#include <netdb.h>
#include <netinet/in.h>
#include <poll.h>
#include <sys/socket.h>
#include <unistd.h>

namespace {

struct ChannelRing {
  std::vector<int16_t> buf;
  int head = 0;
  bool full = false;
  int64_t inc_total = 0, inc_power = 0;
  int64_t out_total = 0, out_power = 0;

  void init(int n) {
    buf.assign(n, 0);
    head = 0;
    full = false;
    inc_total = inc_power = out_total = out_power = 0;
  }

  inline void push(int16_t s) {
    const int n = (int)buf.size();
    const int half = n >> 1;
    int mid = head - half;
    if (mid < 0) mid += n;
    const int64_t m = buf[mid];
    const int64_t o = buf[head];
    out_total += m - o;
    out_power += m * m - o * o;
    inc_total += (int64_t)s - m;
    inc_power += (int64_t)s * s - m * m;
    buf[head] = s;
    if (++head >= n) {
      head = 0;
      full = true;
    }
  }

  inline int64_t incoming_power(int half_bits) const {
    return (inc_power << half_bits) - inc_total * inc_total;
  }
  inline int64_t outgoing_power(int half_bits) const {
    return (out_power << half_bits) - out_total * out_total;
  }

  // unroll oldest->newest into dst
  void write_out(int16_t* dst) const {
    const int n = (int)buf.size();
    std::memcpy(dst, buf.data() + head, (n - head) * sizeof(int16_t));
    std::memcpy(dst + (n - head), buf.data(), head * sizeof(int16_t));
  }
};

struct EventQueue {
  // SPSC queue of frames [channels * frame_size]
  std::vector<int16_t> storage;
  std::vector<int64_t> stamps;
  int capacity = 0;
  int slot_len = 0;
  std::atomic<uint64_t> head{0};  // consumer
  std::atomic<uint64_t> tail{0};  // producer

  void init(int cap, int slot) {
    capacity = cap;
    slot_len = slot;
    storage.assign((size_t)cap * slot, 0);
    stamps.assign(cap, 0);
    head.store(0);
    tail.store(0);
  }
  bool push(const int16_t* frame, int64_t stamp) {
    const uint64_t t = tail.load(std::memory_order_relaxed);
    if (t - head.load(std::memory_order_acquire) >= (uint64_t)capacity)
      return false;  // full: drop (caller counts)
    std::memcpy(&storage[(t % capacity) * slot_len], frame,
                slot_len * sizeof(int16_t));
    stamps[t % capacity] = stamp;
    tail.store(t + 1, std::memory_order_release);
    return true;
  }
  bool pop(int16_t* out, int64_t* stamp) {
    const uint64_t h = head.load(std::memory_order_relaxed);
    if (tail.load(std::memory_order_acquire) == h) return false;
    std::memcpy(out, &storage[(h % capacity) * slot_len],
                slot_len * sizeof(int16_t));
    *stamp = stamps[h % capacity];
    head.store(h + 1, std::memory_order_release);
    return true;
  }
};

struct Runtime {
  int channels = 0;
  int frame_size = 0;
  int frame_bits = 0;
  int64_t threshold = 0;
  // relative (CFAR-style) trigger ratio in 1/1000ths: trigger when
  // out > threshold + ratio_milli * inc / 1000.  1000 (= 1.0) reproduces
  // the reference rule out > threshold + inc exactly.
  int64_t ratio_milli = 1000;
  int64_t sample_count = 0;
  int64_t suppress_until = 0;  // post-event ring-refill holdoff
  int64_t events_detected = 0;
  int64_t events_dropped = 0;
  std::vector<ChannelRing> rings;
  std::vector<int16_t> scratch;
  EventQueue queue;
};

inline int ilog2(int v) {
  int b = 0;
  while ((1 << b) < v) ++b;
  return b;
}

}  // namespace

extern "C" {

void* atrt_create(int channels, int frame_size, long long threshold,
                  int queue_capacity, long long ratio_milli) {
  auto* rt = new (std::nothrow) Runtime();
  if (!rt) return nullptr;
  rt->channels = channels;
  rt->frame_size = frame_size;
  rt->frame_bits = ilog2(frame_size);
  rt->threshold = threshold;
  rt->ratio_milli = ratio_milli > 0 ? ratio_milli : 1000;
  rt->rings.resize(channels);
  for (auto& r : rt->rings) r.init(frame_size);
  rt->scratch.assign((size_t)channels * frame_size, 0);
  rt->queue.init(queue_capacity, channels * frame_size);
  rt->suppress_until = frame_size - 1;
  return rt;
}

void atrt_destroy(void* h) { delete static_cast<Runtime*>(h); }

// Push n interleaved sample tuples (n * channels int16 values).  Runs the
// detector per tuple; triggered frames are copied into the event queue.
// Returns the number of events detected in this call.
int atrt_push(void* h, const int16_t* interleaved, int n) {
  auto* rt = static_cast<Runtime*>(h);
  const int c = rt->channels;
  const int half_bits = rt->frame_bits - 1;
  int events = 0;
  for (int i = 0; i < n; ++i) {
    const int16_t* tuple = interleaved + (size_t)i * c;
    bool all_full = true;
    for (int m = 0; m < c; ++m) {
      rt->rings[m].push(tuple[m]);
      all_full &= rt->rings[m].full;
    }
    const int64_t t = rt->sample_count++;
    if (!all_full || t < rt->suppress_until) continue;
    int64_t inc = 0, out = 0;
    for (int m = 0; m < c; ++m) {
      inc += rt->rings[m].incoming_power(half_bits);
      out += rt->rings[m].outgoing_power(half_bits);
    }
    // 128-bit product: inc can reach ~2^48 and ratio_milli ~2^14
    const int64_t floor_term = rt->ratio_milli == 1000
        ? inc
        : (int64_t)(((__int128)rt->ratio_milli * inc) / 1000);
    if (out > rt->threshold + floor_term) {
      for (int m = 0; m < c; ++m)
        rt->rings[m].write_out(&rt->scratch[(size_t)m * rt->frame_size]);
      ++rt->events_detected;
      if (!rt->queue.push(rt->scratch.data(), t))
        ++rt->events_dropped;
      else
        ++events;
      // reference semantics: rings are re-initialized after a capture
      // (sample_compute.h:55-57) -> a full fresh frame before re-arming
      for (auto& r : rt->rings) r.init(rt->frame_size);
      rt->suppress_until = rt->sample_count + rt->frame_size - 1;
    }
  }
  return events;
}

// Pop one event frame ([channels * frame_size] int16, channel-major) and its
// trigger sample index.  Returns 1 on success, 0 if the queue is empty.
int atrt_poll(void* h, int16_t* frame_out, long long* stamp_out) {
  auto* rt = static_cast<Runtime*>(h);
  int64_t stamp = 0;
  if (!rt->queue.pop(frame_out, &stamp)) return 0;
  *stamp_out = stamp;
  return 1;
}

long long atrt_sample_count(void* h) {
  return static_cast<Runtime*>(h)->sample_count;
}
long long atrt_events_detected(void* h) {
  return static_cast<Runtime*>(h)->events_detected;
}
long long atrt_events_dropped(void* h) {
  return static_cast<Runtime*>(h)->events_dropped;
}

// Expose the detector powers for observability (vga_text.h parity).
void atrt_powers(void* h, long long* incoming_out, long long* outgoing_out) {
  auto* rt = static_cast<Runtime*>(h);
  const int half_bits = rt->frame_bits - 1;
  for (int m = 0; m < rt->channels; ++m) {
    incoming_out[m] = rt->rings[m].incoming_power(half_bits);
    outgoing_out[m] = rt->rings[m].outgoing_power(half_bits);
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Live transport sources: a native reader thread feeding atrt_push from a
// real byte stream (interleaved little-endian int16 tuples).  The TPU-host
// analogue of the reference's autonomous chained-DMA acquisition
// (src/components/dma_sampler.c:8-56): once started, samples flow into the
// detector with no Python in the loop; only event frames surface (atrt_poll).
// Kinds: 0 = FIFO/file path, 1 = TCP connect "host:port",
//        2 = TCP listen ":port" (accept one peer; port 0 picks a free one),
//        3 = ALSA capture device (dlopen'd libasound; no link-time dep).
// ---------------------------------------------------------------------------

namespace {

// error codes surfaced via atrt_source_error (0 = ok)
enum SourceError {
  kErrNone = 0,
  kErrDlopen = 1,     // libasound (or override) not loadable / symbols miss
  kErrDeviceOpen = 2, // snd_pcm_open failed
  kErrParams = 3,     // snd_pcm_set_params rejected the configuration
  kErrIo = 4,         // unrecoverable read error ended the source
};

struct Source {
  Runtime* rt = nullptr;
  int kind = 0;
  int reconnect = 0;  // survive producer EOF / disconnect and re-attach
  std::string address;
  std::thread thread;
  std::atomic<bool> stop{false};
  std::atomic<bool> running{false};
  std::atomic<long long> bytes{0};
  std::atomic<long long> tuples{0};
  std::atomic<long long> reconnects{0};  // producer re-attachments observed
  std::atomic<int> bound_port{0};  // for listen sources (port 0 -> chosen)
  std::atomic<int> listen_fd{-1};
  std::atomic<int> error{kErrNone};
  // ALSA-specific configuration (kind 3)
  int rate = 50000;
  int latency_us = 50000;
  std::string libpath;  // override for tests; default libasound.so.2

  void run();
  void read_loop(int fd);
  void alsa_loop();
};

int open_fifo(const std::string& path) {
  // O_NONBLOCK so open() doesn't hang waiting for a writer; the read loop
  // polls with a timeout instead.
  return open(path.c_str(), O_RDONLY | O_NONBLOCK);
}

int open_tcp_connect(const std::string& addr) {
  const size_t colon = addr.rfind(':');
  if (colon == std::string::npos) return -1;
  const std::string host = addr.substr(0, colon);
  const std::string port = addr.substr(colon + 1);
  addrinfo hints{};
  hints.ai_family = AF_UNSPEC;
  hints.ai_socktype = SOCK_STREAM;
  addrinfo* res = nullptr;
  if (getaddrinfo(host.empty() ? "127.0.0.1" : host.c_str(), port.c_str(),
                  &hints, &res) != 0)
    return -1;
  int fd = -1;
  for (addrinfo* ai = res; ai; ai = ai->ai_next) {
    fd = socket(ai->ai_family, ai->ai_socktype, ai->ai_protocol);
    if (fd < 0) continue;
    if (connect(fd, ai->ai_addr, ai->ai_addrlen) == 0) break;
    close(fd);
    fd = -1;
  }
  freeaddrinfo(res);
  return fd;
}

int bind_listen(Source* src, const std::string& addr) {
  const size_t colon = addr.rfind(':');
  const int port = colon == std::string::npos
                       ? atoi(addr.c_str())
                       : atoi(addr.substr(colon + 1).c_str());
  int lfd = socket(AF_INET, SOCK_STREAM, 0);
  if (lfd < 0) return -1;
  int one = 1;
  setsockopt(lfd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in sa{};
  sa.sin_family = AF_INET;
  sa.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  sa.sin_port = htons((uint16_t)port);
  if (bind(lfd, (sockaddr*)&sa, sizeof(sa)) != 0 || listen(lfd, 1) != 0) {
    close(lfd);
    return -1;
  }
  socklen_t len = sizeof(sa);
  getsockname(lfd, (sockaddr*)&sa, &len);
  src->bound_port.store(ntohs(sa.sin_port));
  src->listen_fd.store(lfd);
  return lfd;
}

int accept_peer(Source* src) {
  // poll-accept loop so stop() works while waiting for a peer; the listen
  // socket stays open across peers (reconnect re-accepts on the SAME port)
  const int lfd = src->listen_fd.load();
  if (lfd < 0) return -1;
  while (!src->stop.load()) {
    pollfd p{lfd, POLLIN, 0};
    const int r = poll(&p, 1, 100);
    if (r > 0 && (p.revents & POLLIN))
      return accept(lfd, nullptr, nullptr);
  }
  return -1;
}

void Source::read_loop(int fd) {
  // One producer session: read until stop / EOF / error.  With reconnect
  // on a FIFO the fd survives writer churn (POLLHUP just means "no writer
  // right now"), so this also spans successive writers in that mode.
  const int c = rt->channels;
  const size_t tuple_bytes = (size_t)c * sizeof(int16_t);
  std::vector<uint8_t> buf(tuple_bytes * 4096);
  size_t carry = 0;  // bytes of an incomplete tuple carried between reads
  bool writer_gone = false;
  while (!stop.load()) {
    pollfd p{fd, POLLIN, 0};
    const int r = poll(&p, 1, 100);
    if (r <= 0) continue;
    if (p.revents & (POLLERR | POLLNVAL)) break;
    const ssize_t n = read(fd, buf.data() + carry, buf.size() - carry);
    if (n == 0) {
      if (kind != 0) break;     // socket EOF
      if (p.revents & POLLHUP) {  // FIFO: all writers gone
        if (!reconnect) break;
        writer_gone = true;
        poll(nullptr, 0, 20);   // POLLHUP returns instantly; avoid a spin
      }
      continue;
    }
    if (n < 0) {
      if (errno == EAGAIN || errno == EINTR) continue;
      break;
    }
    if (writer_gone) {  // a new FIFO writer attached
      reconnects.fetch_add(1);
      writer_gone = false;
    }
    bytes.fetch_add(n);
    const size_t avail = carry + (size_t)n;
    const size_t n_tuples = avail / tuple_bytes;
    if (n_tuples) {
      atrt_push(rt, reinterpret_cast<const int16_t*>(buf.data()),
                (int)n_tuples);
      tuples.fetch_add((long long)n_tuples);
      const size_t used = n_tuples * tuple_bytes;
      carry = avail - used;
      if (carry) std::memmove(buf.data(), buf.data() + used, carry);
    } else {
      carry = avail;
    }
  }
}

// ----------------------------------------------------------------------
// ALSA capture via dlopen (the native live-mic path; reference analogue:
// the autonomous ADC+DMA chain, src/components/dma_sampler.c:8-56).  No
// link-time libasound dependency: the five entry points are resolved at
// runtime, so the binary builds and runs in audio-less containers and the
// test suite can substitute a synthetic shim library.
// ----------------------------------------------------------------------

struct AlsaApi {
  void* dl = nullptr;
  int (*open_)(void**, const char*, int, int) = nullptr;
  int (*close_)(void*) = nullptr;
  int (*set_params)(void*, int, int, unsigned, unsigned, int,
                    unsigned) = nullptr;
  long (*readi)(void*, void*, unsigned long) = nullptr;
  int (*recover)(void*, int, int) = nullptr;
  // optional (absent from the test shim): explicit start for nonblocking
  // capture — a prepared capture stream only fills once started
  int (*start_)(void*) = nullptr;

  bool load(const std::string& override_path) {
    const char* candidates[] = {override_path.empty() ? nullptr
                                                      : override_path.c_str(),
                                "libasound.so.2", "libasound.so"};
    for (const char* c : candidates) {
      if (!c) continue;
      dl = dlopen(c, RTLD_NOW | RTLD_LOCAL);
      if (dl) break;
      if (!override_path.empty()) return false;  // explicit path must load
    }
    if (!dl) return false;
    open_ = reinterpret_cast<int (*)(void**, const char*, int, int)>(
        dlsym(dl, "snd_pcm_open"));
    close_ = reinterpret_cast<int (*)(void*)>(dlsym(dl, "snd_pcm_close"));
    set_params = reinterpret_cast<int (*)(void*, int, int, unsigned,
                                          unsigned, int, unsigned)>(
        dlsym(dl, "snd_pcm_set_params"));
    readi = reinterpret_cast<long (*)(void*, void*, unsigned long)>(
        dlsym(dl, "snd_pcm_readi"));
    recover = reinterpret_cast<int (*)(void*, int, int)>(
        dlsym(dl, "snd_pcm_recover"));
    start_ = reinterpret_cast<int (*)(void*)>(dlsym(dl, "snd_pcm_start"));
    if (!(open_ && close_ && set_params && readi && recover)) {
      unload();  // library loaded but lacks a symbol: release the handle
      return false;
    }
    return true;
  }
  void unload() {
    if (dl) dlclose(dl);
    dl = nullptr;
  }
};

// ALSA ABI constants (sound/asound.h / alsa-lib pcm.h; stable ABI values)
constexpr int kSndPcmStreamCapture = 1;
constexpr int kSndPcmNonblock = 1;  // SND_PCM_NONBLOCK open mode
constexpr int kSndPcmFormatS16Le = 2;
constexpr int kSndPcmAccessRwInterleaved = 3;

void Source::alsa_loop() {
  AlsaApi api;
  if (!api.load(libpath)) {
    error.store(kErrDlopen);
    return;
  }
  const int c = rt->channels;
  const unsigned long period = 1024;  // tuples per readi
  std::vector<int16_t> buf(period * c);
  bool connected_before = false;
  while (!stop.load()) {
    void* pcm = nullptr;
    // NONBLOCK: a blocking readi on a stalled/suspended device would pin
    // this thread inside libasound and make stop() (thread.join) hang;
    // nonblocking readi returns -EAGAIN and the loop polls, so stop stays
    // responsive like every other source kind
    if (api.open_(&pcm, address.c_str(), kSndPcmStreamCapture,
                  kSndPcmNonblock) < 0) {
      error.store(kErrDeviceOpen);
      if (!reconnect) break;
      poll(nullptr, 0, 200);
      continue;
    }
    if (api.set_params(pcm, kSndPcmFormatS16Le, kSndPcmAccessRwInterleaved,
                       (unsigned)c, (unsigned)rate, /*soft_resample=*/1,
                       (unsigned)latency_us) < 0) {
      error.store(kErrParams);
      api.close_(pcm);
      break;  // a config rejection won't fix itself; don't spin
    }
    // nonblocking capture does not auto-start on readi: kick it explicitly
    // (optional symbol; harmless if the stream is already running)
    if (api.start_) api.start_(pcm);
    error.store(kErrNone);
    if (connected_before) reconnects.fetch_add(1);
    connected_before = true;
    while (!stop.load()) {
      const long n = api.readi(pcm, buf.data(), period);
      if (n > 0) {
        atrt_push(rt, buf.data(), (int)n);
        tuples.fetch_add(n);
        bytes.fetch_add((long long)n * c * (long long)sizeof(int16_t));
        continue;
      }
      if (n == -EAGAIN) {
        poll(nullptr, 0, 1);
        continue;
      }
      // overrun (-EPIPE) / suspend (-ESTRPIPE): recover in place
      if (api.recover(pcm, (int)n, /*silent=*/1) == 0) continue;
      error.store(kErrIo);
      break;  // session over; reconnect re-opens the device
    }
    api.close_(pcm);
    if (!reconnect) break;
  }
  api.unload();
}

void Source::run() {
  if (kind == 3) {
    alsa_loop();
    running.store(false);
    return;
  }
  if (kind == 2 && bind_listen(this, address) < 0) {
    running.store(false);
    return;
  }
  bool connected_before = false;
  while (!stop.load()) {
    int fd = -1;
    if (kind == 0)
      fd = open_fifo(address);
    else if (kind == 1)
      fd = open_tcp_connect(address);
    else
      fd = accept_peer(this);  // -1 only when stopping
    if (fd < 0) {
      if (kind == 2 || !reconnect) break;
      poll(nullptr, 0, 200);  // retry open/connect with a small backoff
      continue;
    }
    if (connected_before) reconnects.fetch_add(1);
    connected_before = true;
    read_loop(fd);
    close(fd);
    if (!reconnect) break;
  }
  const int lfd = listen_fd.exchange(-1);
  if (lfd >= 0) close(lfd);
  running.store(false);
}

}  // namespace

extern "C" {

void* atrt_source_start2(void* h, int kind, const char* address,
                         int reconnect) {
  auto* src = new (std::nothrow) Source();
  if (!src) return nullptr;
  src->rt = static_cast<Runtime*>(h);
  src->kind = kind;
  src->reconnect = reconnect;
  src->address = address ? address : "";
  src->running.store(true);
  src->thread = std::thread([src] { src->run(); });
  return src;
}

void* atrt_source_start(void* h, int kind, const char* address) {
  return atrt_source_start2(h, kind, address, 0);
}

// Probe whether an ALSA implementation is loadable (libpath NULL/empty ->
// the system libasound).  Lets callers choose the native path before
// starting a source, without waiting on a thread to fail.
int atrt_alsa_available(const char* libpath) {
  AlsaApi api;
  const bool ok = api.load(libpath ? libpath : "");
  api.unload();
  return ok ? 1 : 0;
}

// Start a native ALSA capture source: S16_LE interleaved at `rate` on
// `device`, feeding the runtime's detector with no Python in the loop.
// `libpath` overrides the dlopen'd library (tests use a synthetic shim).
void* atrt_source_start_alsa(void* h, const char* device, int rate,
                             int latency_us, int reconnect,
                             const char* libpath) {
  auto* src = new (std::nothrow) Source();
  if (!src) return nullptr;
  src->rt = static_cast<Runtime*>(h);
  src->kind = 3;
  src->reconnect = reconnect;
  src->address = device ? device : "default";
  src->rate = rate > 0 ? rate : 50000;
  src->latency_us = latency_us > 0 ? latency_us : 50000;
  src->libpath = libpath ? libpath : "";
  src->running.store(true);
  src->thread = std::thread([src] { src->run(); });
  return src;
}

// Last error observed by a source thread (SourceError; 0 = ok).
int atrt_source_error(void* s) {
  return static_cast<Source*>(s)->error.load();
}

// For listen sources: the bound port (valid once > 0).
int atrt_source_port(void* s) {
  return static_cast<Source*>(s)->bound_port.load();
}
int atrt_source_running(void* s) {
  return static_cast<Source*>(s)->running.load() ? 1 : 0;
}
long long atrt_source_bytes(void* s) {
  return static_cast<Source*>(s)->bytes.load();
}
long long atrt_source_tuples(void* s) {
  return static_cast<Source*>(s)->tuples.load();
}
// Producer re-attachments survived (reconnect mode): FIFO writer churn,
// TCP re-connects, listen re-accepts.
long long atrt_source_reconnects(void* s) {
  return static_cast<Source*>(s)->reconnects.load();
}

void atrt_source_stop(void* s) {
  auto* src = static_cast<Source*>(s);
  src->stop.store(true);
  if (src->thread.joinable()) src->thread.join();
  delete src;
}

}  // extern "C"

// Native streaming data loader for online filtering (a copy of the JAX
// package's vjf_tpu/native/src/stream_loader.cpp for the PyTorch port).
//
// A production online filter consumes an unbounded stream. This loader
// decouples disk/FIFO ingest from the device step loop with a
// single-producer single-consumer ring buffer and a reader thread, so host
// IO overlaps device compute (the Python side adds a pinned-memory
// prefetch to the card on top).
//
// C ABI (ctypes-friendly), no dependencies beyond pthread:
//   vjf_stream_open(path, step_bytes, capacity_steps) -> handle (or -1)
//   vjf_stream_read(handle, dst, n_steps) -> steps copied (0 on EOF+drained)
//   vjf_stream_close(handle)
//
// Built at first use by vjf_tpu_torch/native/loader.py
// (g++ -O3 -std=c++17 -shared -fPIC -pthread).

#include <errno.h>
#include <sys/stat.h>
#include <fcntl.h>
#include <poll.h>
#include <unistd.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct RingStream {
  std::vector<uint8_t> buf;
  size_t step_bytes = 0;
  size_t capacity = 0;          // in steps
  size_t head = 0;              // producer position (steps, monotonically inc)
  size_t tail = 0;              // consumer position
  std::mutex mu;
  std::condition_variable cv_nonfull;
  std::condition_variable cv_nonempty;
  std::atomic<bool> eof{false};
  std::atomic<bool> closed{false};
  std::thread reader;
  // Nonblocking fd + poll() + self-pipe wakeup: a blocking fread() on an
  // idle FIFO would make stop() (and Python __del__ / interpreter exit)
  // join a thread that never returns (r1 advisor finding). stop() writes
  // one byte to wake[1]; poll() wakes; the reader exits.
  int fd = -1;
  int wake[2] = {-1, -1};

  ~RingStream() { stop(); }

  void stop() {
    closed.store(true);
    if (wake[1] >= 0) {
      char c = 1;
      ssize_t r = write(wake[1], &c, 1);
      (void)r;
    }
    cv_nonfull.notify_all();
    cv_nonempty.notify_all();
    if (reader.joinable()) reader.join();
    if (fd >= 0) {
      close(fd);
      fd = -1;
    }
    for (int i = 0; i < 2; ++i) {
      if (wake[i] >= 0) {
        close(wake[i]);
        wake[i] = -1;
      }
    }
  }

  void reader_loop() {
    std::vector<uint8_t> step(step_bytes);
    size_t filled = 0;
    struct stat st;
    const bool is_fifo = fstat(fd, &st) == 0 && S_ISFIFO(st.st_mode);
    bool saw_data = false;
    // Whether a writer has EVER been observed attached. Needed because a
    // FIFO read()==0 means "no writer connected NOW" both before the first
    // writer arrives (not EOF) and after the last one leaves (EOF): without
    // this, a writer that opened and closed without delivering data would
    // be mistaken for "no writer yet" forever and the consumer would hang.
    bool writer_seen = false;
    while (!closed.load()) {
      struct pollfd pfds[2] = {{fd, POLLIN, 0}, {wake[0], POLLIN, 0}};
      // a FIFO with no writer attached reports POLLHUP/read()==0 — and
      // poll() on that fd returns POLLHUP *immediately*, so including it
      // would turn the timeout into a busy spin. While no writer has ever
      // attached: poll only the wake pipe for 20 ms, then SAMPLE writer
      // presence with a zero-timeout poll on the fifo (POLLIN = data;
      // no events = writer attached, nothing written yet; POLLHUP = still
      // no writer). A writer that attaches and detaches with zero bytes
      // entirely inside one 20 ms window remains undetectable — that is a
      // fifo semantics limit; any byte written, or >20 ms attached, is
      // caught.
      const bool waiting_for_writer = is_fifo && !saw_data && !writer_seen;
      int pr = waiting_for_writer ? poll(pfds + 1, 1, 20) : poll(pfds, 2, -1);
      if (pr < 0) {
        if (errno == EINTR) continue;
        break;
      }
      if (pfds[1].revents != 0) return;  // stop() woke us
      if (waiting_for_writer) {
        struct pollfd pf = {fd, POLLIN, 0};
        int wr = poll(&pf, 1, 0);
        if (wr < 0) {
          if (errno == EINTR) continue;
          break;
        }
        if (wr == 0) {
          writer_seen = true;  // attached, no data yet: block normally next
          continue;
        }
        if ((pf.revents & (POLLIN | POLLERR)) == 0) continue;  // POLLHUP only
        writer_seen = true;  // data (or error) ready: fall through to read
      } else if ((pfds[0].revents & (POLLIN | POLLHUP | POLLERR)) == 0) {
        continue;
      }
      ssize_t got = ::read(fd, step.data() + filled, step_bytes - filled);
      if (got < 0) {
        if (errno == EAGAIN || errno == EWOULDBLOCK || errno == EINTR) continue;
        got = 0;  // treat hard errors as EOF
      }
      if (got == 0) {
        eof.store(true);  // EOF / FIFO writer closed (a writer was seen)
        cv_nonempty.notify_all();
        return;
      }
      saw_data = true;
      filled += static_cast<size_t>(got);
      if (filled < step_bytes) continue;  // partial step: keep accumulating
      filled = 0;
      std::unique_lock<std::mutex> lk(mu);
      cv_nonfull.wait(lk, [&] { return closed.load() || head - tail < capacity; });
      if (closed.load()) return;
      size_t slot = head % capacity;
      memcpy(buf.data() + slot * step_bytes, step.data(), step_bytes);
      ++head;
      lk.unlock();
      cv_nonempty.notify_one();
    }
  }

  // Copy up to n steps into dst; blocks until at least 1 step or EOF.
  size_t read(uint8_t* dst, size_t n) {
    size_t copied = 0;
    while (copied < n) {
      std::unique_lock<std::mutex> lk(mu);
      cv_nonempty.wait(lk, [&] {
        return closed.load() || eof.load() || head > tail;
      });
      if (closed.load()) break;
      if (head == tail) {  // drained
        if (eof.load()) break;
        continue;
      }
      while (copied < n && head > tail) {
        size_t slot = tail % capacity;
        memcpy(dst + copied * step_bytes, buf.data() + slot * step_bytes,
               step_bytes);
        ++tail;
        ++copied;
      }
      lk.unlock();
      cv_nonfull.notify_one();
    }
    return copied;
  }
};

std::mutex g_mu;
// shared_ptr, deliberately: a consumer thread can be BLOCKED inside
// RingStream::read() (cv wait) while another thread calls
// vjf_stream_close() — with raw pointers the close would delete the
// mutex/condvar out from under the waiter (use-after-free). Each
// vjf_stream_read holds its own reference for the duration of the copy;
// close() erases the map entry (no new readers can find it) and stop()s
// the stream (closed=true wakes every waiter); the object is destroyed
// when the last in-flight read returns.
std::map<int64_t, std::shared_ptr<RingStream>> g_streams;
int64_t g_next = 1;

}  // namespace

extern "C" {

int64_t vjf_stream_open(const char* path, int64_t step_bytes,
                        int64_t capacity_steps) {
  // O_NONBLOCK is a no-op for regular files and lets a FIFO open without a
  // writer; the reader poll()s, so a writer attaching later is picked up.
  int fd = open(path, O_RDONLY | O_NONBLOCK | O_CLOEXEC);
  if (fd < 0) return -1;
  auto s = std::make_shared<RingStream>();
  s->fd = fd;
  if (pipe(s->wake) != 0) {
    close(fd);
    s->fd = -1;
    return -1;
  }
  s->step_bytes = static_cast<size_t>(step_bytes);
  s->capacity = static_cast<size_t>(capacity_steps);
  s->buf.resize(s->step_bytes * s->capacity);
  RingStream* raw = s.get();  // reader is joined in stop() before destruction
  s->reader = std::thread([raw] { raw->reader_loop(); });
  std::lock_guard<std::mutex> lk(g_mu);
  int64_t h = g_next++;
  g_streams[h] = s;
  return h;
}

int64_t vjf_stream_read(int64_t handle, uint8_t* dst, int64_t n_steps) {
  std::shared_ptr<RingStream> s;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_streams.find(handle);
    if (it == g_streams.end()) return -1;
    s = it->second;  // keeps the stream alive for the whole read
  }
  return static_cast<int64_t>(s->read(dst, static_cast<size_t>(n_steps)));
}

void vjf_stream_close(int64_t handle) {
  std::shared_ptr<RingStream> s;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_streams.find(handle);
    if (it == g_streams.end()) return;
    s = it->second;
    g_streams.erase(it);
  }
  // closed=true wakes a consumer blocked in read(); the reader thread is
  // joined here. Destruction happens when the last in-flight read drops
  // its reference (possibly right now, if none is in flight).
  s->stop();
}

}  // extern "C"

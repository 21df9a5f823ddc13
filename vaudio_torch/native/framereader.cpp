// Vaudio native runtime: double-buffered raw-frame reader.
//
// The ingest half of the live-capture path (the reference's capture
// delegate queue, VisionEngine.swift:55-75, where AVFoundation's own
// capture thread delivers pixel buffers while the app computes): a
// background thread reads fixed-size raw frames from a file, FIFO, or
// V4L2-style device node into a small pool of reusable buffers, so the
// (Python) consumer's device dispatch overlaps the next frame's I/O
// instead of blocking on read(2).
//
// Semantics:
//   * bounded pool of `n_buffers` frame slots; the reader blocks when all
//     are in flight (back-pressure, no unbounded memory);
//   * short reads are accumulated until the frame completes (FIFOs and
//     device nodes deliver pipe-sized pieces);
//   * EOF or read error marks the stream done; va_fr_next then returns -1
//     after draining;
//   * acquire/release protocol: va_fr_next hands out a filled slot index,
//     va_fr_release returns it to the pool.  The Python binding exposes
//     both a copying API (frames_bytes: slot released immediately) and a
//     true zero-copy API (frames_view: NumPy wraps the slot's memory
//     directly; release deferred by a lag so in-flight consumers finish
//     before the slot is recycled) — vaudio_torch/io/sources.py.
//
// Plain C ABI for ctypes binding (no pybind11 in the image).

#include <atomic>
#include <cerrno>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <fcntl.h>
#include <mutex>
#include <poll.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct FrameReader {
  int fd = -1;
  size_t frame_bytes = 0;
  int n_buffers = 0;
  std::vector<std::vector<uint8_t>> pool;
  std::deque<int> free_slots;    // available for the reader to fill
  std::deque<int> ready_slots;   // filled, waiting for the consumer
  bool done = false;             // EOF/error reached
  bool stop = false;             // close requested
  bool seen_data = false;        // any byte ever read (FIFO EOF latch)
  bool wait_for_writer = false;  // NAMED fifo: r==0 pre-data = no writer yet
  int64_t frames_read = 0;
  std::mutex mu;
  std::condition_variable cv_free;   // reader waits for a free slot
  std::condition_variable cv_ready;  // consumer waits for a ready slot
  std::thread reader;
};

// Read exactly n bytes into dst. The fd is nonblocking; poll() with a
// short timeout keeps the loop responsive to a stop/close request even
// when no writer exists yet (FIFO) or the device stalls. Returns false
// on EOF, error, or stop.
//
// FIFO EOF subtlety: a read-end opened before any writer ALSO reports
// r==0 / POLLHUP — that's "no writer yet", not EOF. `seen_data` latches
// once the stream has ever produced bytes; only then does a hangup with
// nothing buffered count as final (and a mid-frame hangup is always
// final: the frame can never complete).
bool read_exact(FrameReader* fr, uint8_t* dst, size_t n) {
  size_t got = 0;
  while (got < n) {
    {
      std::lock_guard<std::mutex> lk(fr->mu);
      if (fr->stop) return false;
    }
    ssize_t r = read(fr->fd, dst + got, n - got);
    if (r > 0) {
      got += static_cast<size_t>(r);
      fr->seen_data = true;
      continue;
    }
    if (r < 0 && errno == EINTR) continue;
    if (r < 0 && errno != EAGAIN && errno != EWOULDBLOCK)
      return false;  // hard error
    if (r == 0) {
      // r==0 is real EOF everywhere EXCEPT a NAMED fifo read-end that
      // no writer has connected to yet: regular files, char devices
      // (/dev/null), sockets and ANONYMOUS shell pipes (whose writers
      // all existed at fork — none can attach later) must end the
      // stream here, or an empty input hangs the reader forever.
      if (!fr->wait_for_writer) return false;
      // Named FIFO: final once the stream ever produced data or a
      // frame is mid-read; otherwise the writer just hasn't connected.
      if (fr->seen_data || got > 0) return false;
    }
    // EAGAIN (live writer, empty pipe) or no-writer-yet FIFO: wait a
    // short poll interval, then re-check stop/read.
    struct pollfd p{fr->fd, POLLIN, 0};
    (void)poll(&p, 1, 200);
  }
  return true;
}

void reader_loop(FrameReader* fr) {
  for (;;) {
    int slot;
    {
      std::unique_lock<std::mutex> lk(fr->mu);
      fr->cv_free.wait(lk, [fr] { return fr->stop || !fr->free_slots.empty(); });
      if (fr->stop) return;
      slot = fr->free_slots.front();
      fr->free_slots.pop_front();
    }
    bool ok = read_exact(fr, fr->pool[slot].data(), fr->frame_bytes);
    {
      std::lock_guard<std::mutex> lk(fr->mu);
      if (ok) {
        fr->ready_slots.push_back(slot);
        fr->frames_read++;
      } else {
        fr->free_slots.push_back(slot);
        fr->done = true;
      }
    }
    fr->cv_ready.notify_all();
    if (!ok) return;
  }
}

}  // namespace

extern "C" {

// Open `path` for reading `frame_bytes`-sized frames with an n_buffers
// pool. Returns a handle, or null if the path cannot be opened.
void* va_fr_open(const char* path, int64_t frame_bytes, int n_buffers) {
  // Nonblocking so (a) opening a FIFO needs no writer yet and (b) the
  // reader thread stays responsive to close() while idle.
  int fd = open(path, O_RDONLY | O_NONBLOCK);
  if (fd < 0) return nullptr;
  struct stat st;
  bool wait_writer = false;
  if (fstat(fd, &st) == 0 && S_ISFIFO(st.st_mode)) {
    // A NAMED fifo's writer may connect after us (r==0 until then); an
    // anonymous pipe's writers all existed at fork, so its r==0 is
    // always final.  /proc/self/fd distinguishes them: anonymous pipes
    // resolve to "pipe:[inode]", named fifos to their filesystem path.
    // If readlink fails (non-Linux / no procfs — not a supported
    // deployment target) we keep the conservative named-fifo wait;
    // note that revives the empty-anonymous-pipe hang there, the price
    // of not breaking reader-before-writer named fifos.
    char link[64], tgt[16];
    snprintf(link, sizeof link, "/proc/self/fd/%d", fd);
    ssize_t n = readlink(link, tgt, sizeof tgt - 1);
    wait_writer = !(n >= 5 && strncmp(tgt, "pipe:", 5) == 0);
  }
  auto* fr = new FrameReader();
  fr->fd = fd;
  fr->wait_for_writer = wait_writer;
  fr->frame_bytes = static_cast<size_t>(frame_bytes);
  fr->n_buffers = n_buffers;
  fr->pool.resize(n_buffers);
  for (int i = 0; i < n_buffers; i++) {
    fr->pool[i].resize(fr->frame_bytes);
    fr->free_slots.push_back(i);
  }
  fr->reader = std::thread(reader_loop, fr);
  return fr;
}

// Pointer to a slot's frame memory (stable for the handle's lifetime).
uint8_t* va_fr_buffer(void* h, int slot) {
  auto* fr = static_cast<FrameReader*>(h);
  if (slot < 0 || slot >= fr->n_buffers) return nullptr;
  return fr->pool[slot].data();
}

// Wait up to timeout_ms for a filled frame; returns its slot index,
// -1 when the stream is done and drained, -2 on timeout.
int va_fr_next(void* h, int timeout_ms) {
  auto* fr = static_cast<FrameReader*>(h);
  std::unique_lock<std::mutex> lk(fr->mu);
  bool got = fr->cv_ready.wait_for(
      lk, std::chrono::milliseconds(timeout_ms),
      [fr] { return !fr->ready_slots.empty() || fr->done || fr->stop; });
  if (!fr->ready_slots.empty()) {
    int slot = fr->ready_slots.front();
    fr->ready_slots.pop_front();
    return slot;
  }
  if (fr->done || fr->stop) return -1;
  (void)got;
  return -2;
}

// Return a slot to the pool after the consumer is finished with it.
void va_fr_release(void* h, int slot) {
  auto* fr = static_cast<FrameReader*>(h);
  {
    std::lock_guard<std::mutex> lk(fr->mu);
    fr->free_slots.push_back(slot);
  }
  fr->cv_free.notify_all();
}

int64_t va_fr_frames_read(void* h) {
  auto* fr = static_cast<FrameReader*>(h);
  std::lock_guard<std::mutex> lk(fr->mu);
  return fr->frames_read;
}

int va_fr_done(void* h) {
  auto* fr = static_cast<FrameReader*>(h);
  std::lock_guard<std::mutex> lk(fr->mu);
  return fr->done && fr->ready_slots.empty();
}

void va_fr_close(void* h) {
  auto* fr = static_cast<FrameReader*>(h);
  {
    std::lock_guard<std::mutex> lk(fr->mu);
    fr->stop = true;
  }
  fr->cv_free.notify_all();
  fr->cv_ready.notify_all();
  if (fr->reader.joinable()) fr->reader.join();
  close(fr->fd);
  delete fr;
}

}  // extern "C"

// Vaudio native runtime: real-time audio ring buffer.
//
// C++ re-implementation of the reference's audio transport
// (video-auralizer/SoundEngine.swift:88-217,442-474): a fixed ring of
// hop-sized PCM frames guarded by a lock, with
//   * warm-up gate: the consumer outputs silence until `warmup` frames have
//     been buffered at least once (SoundEngine.swift:171-175);
//   * overrun policy: writes are DROPPED when the ring is full — never
//     overwrite unread audio (SoundEngine.swift:448);
//   * underrun policy: reads zero-fill when the ring drains
//     (SoundEngine.swift:184-189);
//   * partial-frame reads: the consumer can pull any sample count; a read
//     cursor walks within frames (SoundEngine.swift:192-211).
//
// Exposed with a plain C ABI for ctypes binding
// (vaudio_torch/runtime/ringbuffer.py builds and loads it).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

namespace {

struct RingBuffer {
  int num_frames;
  int frame_size;
  int warmup;
  std::vector<float> data;      // num_frames * frame_size
  int write_index = 0;          // next frame slot to write
  int read_index = 0;           // frame slot being read
  int frame_cursor = 0;         // sample offset within read frame
  int available = 0;            // whole frames buffered
  bool warmed_up = false;
  int64_t dropped_frames = 0;
  int64_t underrun_samples = 0;
  int64_t total_written = 0;
  int64_t total_read = 0;
  std::mutex mu;
};

}  // namespace

extern "C" {

void* va_rb_create(int num_frames, int frame_size, int warmup) {
  auto* rb = new RingBuffer();
  rb->num_frames = num_frames;
  rb->frame_size = frame_size;
  rb->warmup = warmup;
  rb->data.assign(static_cast<size_t>(num_frames) * frame_size, 0.0f);
  return rb;
}

void va_rb_destroy(void* p) { delete static_cast<RingBuffer*>(p); }

// Producer: try to enqueue one frame of `frame_size` samples.
// Returns 1 on success, 0 if the ring was full and the frame was dropped.
int va_rb_write(void* p, const float* frame) {
  auto* rb = static_cast<RingBuffer*>(p);
  std::lock_guard<std::mutex> lock(rb->mu);
  if (rb->available >= rb->num_frames) {
    rb->dropped_frames++;
    return 0;
  }
  std::memcpy(&rb->data[static_cast<size_t>(rb->write_index) *
                        rb->frame_size],
              frame, sizeof(float) * rb->frame_size);
  rb->write_index = (rb->write_index + 1) % rb->num_frames;
  rb->available++;
  rb->total_written += rb->frame_size;
  return 1;
}

// Consumer: fill `out` with `n` samples.  Pre-warm-up: all zeros.  After
// warm-up: frame data, zero-filling any underrun.  Always writes n samples.
// Returns the number of *real* (non-zero-fill) samples delivered.
int va_rb_pull(void* p, float* out, int n) {
  auto* rb = static_cast<RingBuffer*>(p);
  std::lock_guard<std::mutex> lock(rb->mu);
  if (rb->available < rb->warmup && !rb->warmed_up) {
    std::memset(out, 0, sizeof(float) * n);
    return 0;
  }
  rb->warmed_up = true;

  int written = 0;
  int real = 0;
  while (written < n) {
    if (rb->available == 0) {
      out[written++] = 0.0f;
      rb->underrun_samples++;
      continue;
    }
    int remaining_in_frame = rb->frame_size - rb->frame_cursor;
    int to_copy = remaining_in_frame < (n - written) ? remaining_in_frame
                                                     : (n - written);
    const float* src = &rb->data[static_cast<size_t>(rb->read_index) *
                                 rb->frame_size + rb->frame_cursor];
    std::memcpy(out + written, src, sizeof(float) * to_copy);
    written += to_copy;
    real += to_copy;
    rb->frame_cursor += to_copy;
    if (rb->frame_cursor >= rb->frame_size) {
      rb->frame_cursor = 0;
      rb->read_index = (rb->read_index + 1) % rb->num_frames;
      rb->available--;
    }
  }
  rb->total_read += real;
  return real;
}

int va_rb_available(void* p) {
  auto* rb = static_cast<RingBuffer*>(p);
  std::lock_guard<std::mutex> lock(rb->mu);
  return rb->available;
}

// Mirrors SoundEngine.stop() (SoundEngine.swift:459-474): clears indices and
// buffered audio but — faithfully — does NOT clear the warm-up latch (the
// reference never resets isBufferWarmedUp).
void va_rb_reset(void* p) {
  auto* rb = static_cast<RingBuffer*>(p);
  std::lock_guard<std::mutex> lock(rb->mu);
  rb->available = 0;
  rb->read_index = 0;
  rb->write_index = 0;
  rb->frame_cursor = 0;
  std::fill(rb->data.begin(), rb->data.end(), 0.0f);
}

// Full reset for slot re-leasing (MultiStreamAuralizer.acquire_slot):
// also re-arms the warm-up gate and zeroes the drop/underrun counters,
// so a new client starts with a fresh real-time contract instead of
// inheriting the previous lessee's state.
void va_rb_reset_stats(void* p) {
  auto* rb = static_cast<RingBuffer*>(p);
  std::lock_guard<std::mutex> lock(rb->mu);
  rb->warmed_up = false;
  rb->dropped_frames = 0;
  rb->underrun_samples = 0;
  rb->total_written = 0;
  rb->total_read = 0;
}

int64_t va_rb_dropped(void* p) {
  auto* rb = static_cast<RingBuffer*>(p);
  std::lock_guard<std::mutex> lock(rb->mu);
  return rb->dropped_frames;
}

int64_t va_rb_underruns(void* p) {
  auto* rb = static_cast<RingBuffer*>(p);
  std::lock_guard<std::mutex> lock(rb->mu);
  return rb->underrun_samples;
}

int va_rb_warmed(void* p) {
  auto* rb = static_cast<RingBuffer*>(p);
  std::lock_guard<std::mutex> lock(rb->mu);
  return rb->warmed_up ? 1 : 0;
}

}  // extern "C"

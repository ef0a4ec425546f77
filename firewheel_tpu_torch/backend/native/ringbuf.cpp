// Lock-free single-producer/single-consumer ring buffer for f32 audio frames.
//
// Native analog of the `rtrb` crate the reference uses for every
// cross-thread channel (SURVEY component #14; e.g. firewheel-cpal/src/lib.rs
// streams audio through the OS callback, and context.rs:61-64 ships
// schedules over rtrb).  In this engine the buffer decouples the device
// render thread (bursty, high-latency dispatches) from the paced stream
// thread (hard real-time consumption): the producer writes rendered
// interleaved frames, the consumer drains them at the stream rate, and an
// empty read is an underflow.
//
// Design: classic Lamport SPSC queue with C++11 acquire/release atomics and
// cache-line-separated indices.  Capacity is rounded up to a power of two so
// wrap-around is a mask.  No locks, no allocation after creation — the same
// realtime discipline as the reference's audio thread
// (DESIGN_DOC.md:37 "no mutexes!").
//
// Built as a shared library; accessed from Python via ctypes
// (firewheel_tpu_torch/backend/ring_buffer.py).

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>

namespace {

constexpr size_t kCacheLine = 64;

struct RingBuf {
  float* data;
  size_t mask;  // capacity - 1 (capacity is a power of two)
  alignas(kCacheLine) std::atomic<uint64_t> head;  // consumer position
  alignas(kCacheLine) std::atomic<uint64_t> tail;  // producer position
};

size_t round_up_pow2(size_t v) {
  size_t p = 1;
  while (p < v) p <<= 1;
  return p;
}

}  // namespace

extern "C" {

// Create a ring buffer holding at least `capacity` floats.
RingBuf* rb_create(size_t capacity) {
  size_t cap = round_up_pow2(capacity < 2 ? 2 : capacity);
  RingBuf* rb = new (std::nothrow) RingBuf();
  if (!rb) return nullptr;
  rb->data = static_cast<float*>(std::malloc(cap * sizeof(float)));
  if (!rb->data) {
    delete rb;
    return nullptr;
  }
  rb->mask = cap - 1;
  rb->head.store(0, std::memory_order_relaxed);
  rb->tail.store(0, std::memory_order_relaxed);
  return rb;
}

void rb_destroy(RingBuf* rb) {
  if (!rb) return;
  std::free(rb->data);
  delete rb;
}

size_t rb_capacity(const RingBuf* rb) { return rb->mask + 1; }

// Number of floats available to read.
size_t rb_readable(const RingBuf* rb) {
  return rb->tail.load(std::memory_order_acquire) -
         rb->head.load(std::memory_order_acquire);
}

// Number of floats that can be written without overwriting.
size_t rb_writable(const RingBuf* rb) {
  return rb_capacity(rb) - rb_readable(rb);
}

// Producer: write up to n floats; returns the number actually written.
size_t rb_write(RingBuf* rb, const float* src, size_t n) {
  const uint64_t head = rb->head.load(std::memory_order_acquire);
  const uint64_t tail = rb->tail.load(std::memory_order_relaxed);
  const size_t cap = rb->mask + 1;
  size_t free_slots = cap - static_cast<size_t>(tail - head);
  if (n > free_slots) n = free_slots;
  if (n == 0) return 0;

  const size_t start = static_cast<size_t>(tail) & rb->mask;
  const size_t first = (start + n <= cap) ? n : cap - start;
  std::memcpy(rb->data + start, src, first * sizeof(float));
  if (first < n)
    std::memcpy(rb->data, src + first, (n - first) * sizeof(float));

  rb->tail.store(tail + n, std::memory_order_release);
  return n;
}

// Consumer: read up to n floats; returns the number actually read.
size_t rb_read(RingBuf* rb, float* dst, size_t n) {
  const uint64_t tail = rb->tail.load(std::memory_order_acquire);
  const uint64_t head = rb->head.load(std::memory_order_relaxed);
  size_t avail = static_cast<size_t>(tail - head);
  if (n > avail) n = avail;
  if (n == 0) return 0;

  const size_t cap = rb->mask + 1;
  const size_t start = static_cast<size_t>(head) & rb->mask;
  const size_t first = (start + n <= cap) ? n : cap - start;
  std::memcpy(dst, rb->data + start, first * sizeof(float));
  if (first < n)
    std::memcpy(dst + first, rb->data, (n - first) * sizeof(float));

  rb->head.store(head + n, std::memory_order_release);
  return n;
}

// Consumer: discard up to n floats (e.g. on shutdown); returns count.
size_t rb_skip(RingBuf* rb, size_t n) {
  const uint64_t tail = rb->tail.load(std::memory_order_acquire);
  const uint64_t head = rb->head.load(std::memory_order_relaxed);
  size_t avail = static_cast<size_t>(tail - head);
  if (n > avail) n = avail;
  rb->head.store(head + n, std::memory_order_release);
  return n;
}

}  // extern "C"

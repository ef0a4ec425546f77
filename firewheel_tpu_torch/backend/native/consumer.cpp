// Native paced stream consumer: the hard-realtime half of the output stream.
//
// The reference's audio thread is the OS (cpal) callback — the OS paces it
// and firewheel only reacts (firewheel-cpal/src/lib.rs:378-449: stream
// clock, underflow detection with a x1.2 wiggle, buffer hand-off).  This
// engine has no OS audio device, so the pacing loop itself is ours; doing
// it in Python adds GIL jitter on the one thread that must not jitter.
//
// This consumer runs the period loop natively:
//   * absolute-deadline sleeping (clock_nanosleep TIMER_ABSTIME on
//     CLOCK_MONOTONIC) — no drift accumulation from relative sleeps;
//   * the reference's underflow heuristic: if the wakeup is late by more
//     than 1.2 periods, flag OUTPUT_UNDERFLOW and re-anchor the deadline
//     (a stall must not become a catch-up burst);
//   * per-period: read one buffer from the input ring (the device render
//     side's SPSC queue, ringbuf.cpp); a short read zero-fills and counts
//     an underflow; frames are forwarded to an optional output ring that
//     the host drains to its sink OFF the realtime path.
//
// Stats (periods, underflows, last wakeup lateness) are published via
// atomics; the host polls them and folds the sticky underflow flag into
// the next block's StreamStatus, exactly like the cpal callback fed
// firewheel's ProcInfo.
//
// Compiled together with ringbuf.cpp into libfwnative.so (see
// firewheel_tpu_torch/backend/ring_buffer.py).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <new>
#include <thread>
#include <vector>

// Opaque SPSC ring from ringbuf.cpp (same shared library).
struct RingBuf;
extern "C" {
size_t rb_write(RingBuf* rb, const float* src, size_t n);
size_t rb_read(RingBuf* rb, float* dst, size_t n);
}

namespace {

constexpr int64_t kNsPerSec = 1000000000ll;

int64_t now_ns() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<int64_t>(ts.tv_sec) * kNsPerSec + ts.tv_nsec;
}

void sleep_until_ns(int64_t deadline) {
  timespec ts;
  ts.tv_sec = deadline / kNsPerSec;
  ts.tv_nsec = deadline % kNsPerSec;
  while (clock_nanosleep(CLOCK_MONOTONIC, TIMER_ABSTIME, &ts, nullptr) ==
         EINTR) {
  }
}

struct Consumer {
  RingBuf* in;
  RingBuf* out;  // nullable: frames are discarded after pacing
  int64_t period_ns;
  size_t floats_per_period;

  std::atomic<bool> stop{false};
  std::atomic<uint64_t> periods{0};
  std::atomic<uint64_t> underflows{0};
  // sticky flag, cleared by consumer_take_underflow (-> StreamStatus)
  std::atomic<uint32_t> underflow_flag{0};
  // wakeup lateness of the most recent period, ns (scheduling health)
  std::atomic<int64_t> last_late_ns{0};

  std::vector<float> scratch;
  std::thread th;

  void run() {
    int64_t deadline = now_ns() + period_ns;
    const int64_t wiggle = period_ns + period_ns / 5;  // x1.2 (lib.rs:404)
    while (!stop.load(std::memory_order_relaxed)) {
      sleep_until_ns(deadline);
      const int64_t t = now_ns();
      const int64_t late = t - deadline;
      last_late_ns.store(late, std::memory_order_relaxed);
      if (late > wiggle) {
        // A stall (host paused, scheduler preemption).  Count ONE break
        // and re-anchor: advancing the stale deadline period-by-period
        // would burst-read the backlog and inflate the underflow count.
        underflow_flag.store(1, std::memory_order_relaxed);
        underflows.fetch_add(1, std::memory_order_relaxed);
        deadline = t;
      }
      deadline += period_ns;

      const size_t got = rb_read(in, scratch.data(), floats_per_period);
      if (got < floats_per_period) {
        std::memset(scratch.data() + got, 0,
                    (floats_per_period - got) * sizeof(float));
        underflow_flag.store(1, std::memory_order_relaxed);
        underflows.fetch_add(1, std::memory_order_relaxed);
      }
      if (out != nullptr) {
        // Forward to the host-drained sink ring.  If the host is slow the
        // ring fills; dropping here keeps the pacing loop wait-free (the
        // host side sizes the ring to make this unreachable in practice).
        rb_write(out, scratch.data(), floats_per_period);
      }
      periods.fetch_add(1, std::memory_order_relaxed);
    }
  }
};

}  // namespace

extern "C" {

Consumer* consumer_start(RingBuf* in, RingBuf* out, double period_secs,
                         size_t floats_per_period) {
  Consumer* c = new (std::nothrow) Consumer();
  if (!c) return nullptr;
  c->in = in;
  c->out = out;
  c->period_ns = static_cast<int64_t>(period_secs * kNsPerSec);
  if (c->period_ns < 1000) c->period_ns = 1000;
  c->floats_per_period = floats_per_period;
  c->scratch.resize(floats_per_period);
  c->th = std::thread([c] { c->run(); });
  return c;
}

void consumer_stop(Consumer* c) {
  if (!c) return;
  c->stop.store(true, std::memory_order_relaxed);
  if (c->th.joinable()) c->th.join();
  delete c;
}

uint64_t consumer_periods(const Consumer* c) {
  return c ? c->periods.load(std::memory_order_relaxed) : 0;
}

uint64_t consumer_underflows(const Consumer* c) {
  return c ? c->underflows.load(std::memory_order_relaxed) : 0;
}

// Sticky underflow flag; reading clears it (feeds StreamStatus of the
// next rendered block, mirroring the cpal callback's flag hand-off).
uint32_t consumer_take_underflow(Consumer* c) {
  return c ? c->underflow_flag.exchange(0, std::memory_order_relaxed) : 0;
}

int64_t consumer_last_late_ns(const Consumer* c) {
  return c ? c->last_late_ns.load(std::memory_order_relaxed) : 0;
}

}  // extern "C"

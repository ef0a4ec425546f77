// The megakernel: a whole compiled audio schedule, K blocks, one launch;
// and the island kernel: one run of a schedule's rows between torch stages.
//
// mega_kernel (K2) replaces the TPU kernel firewheel_tpu/executor_pallas.py:
// MegaRenderer._build.kernel; island_kernel (K3) replaces
// HybridMegaRenderer._mega_segment.kernel.  The rows come in as tables that
// executor_mega.py:lower_schedule builds once per graph or island:
//
//   ops     int32 [n_ops, kRowWidth]  one row per interior node, in schedule
//                                     order (fields: enum Field)
//   io      int32  per row: its input buffers, their should_clear flags,
//                  its output buffers
//   slots   int32  per row: indices into the leaf list; leaf s has its input
//                  pointer at ptrs[2s] and its output pointer at ptrs[2s+1]
//   consts  f32    per row: the processor's float constants
//   out_row int32 [No, 2]  output buffer and should_clear (0 in an island)
//   in_bufs int32 [n_in]   an island's live-in buffers
//
// K3 takes the live-in rows env f32[B, K, n_in, F] and their silence flags
// bool[B, K, n_in] as operands: each block starts by copying block k's rows
// into their arena buffers (one thread per frame, so the loads coalesce),
// walks the island's rows, and writes the live-out buffers as they are,
// not zeroed by their flags (the torch stage after the island reads them),
// with their flags as bool[B, K, n_out].  K2 writes the graph outputs with
// flagged channels zeroed.
//
// Every leaf is a contiguous [B, ...] tensor.  Params are read; each state
// leaf is read from its input at block 0, from its output after that, and
// every device function writes all of its state every block.
//
// Threads: one CTA per `tile` instances and 128 threads per instance, one
// per frame of a 128-frame block (frames >= 128 loop).  Every thread of a
// CTA walks the same row at the same time, so the switch never diverges.
// Shared memory holds each instance's arena (num_buffers x F floats), the
// buffers' silence flags, four words of reduction scratch per kind and one
// carry per echo channel.  The K-block loop runs inside the kernel.
//
// What bounds it on an H100: not bytes.  Per block and instance the arena
// stays on chip; device memory sees the params and small state (a few
// hundred bytes), the echo's delayed tap and its write (2 x F floats per
// channel) and the output block; the echo line (D floats per channel) is
// read and written once per chunk.  Measured on the 64-node mixer
// (PERF.md), ~60% of the time is the row walk itself: every thread reads
// its row's fields and buffer indices from the tables, and every row ends
// in __syncthreads.  The smoothers' expf ramp and the pan law's cosf/sinf
// per frame take ~27%; the echo and the filter, whose recurrence runs on
// one thread per channel, ~5% each.
//
// Device functions, each the counterpart of one of the port's node kernels
// (and through it of the JAX package's):
//   dummy   nodes/dummy.py      beep    nodes/beep_test.py:71
//   volume  nodes/volume.py:89 with core/smoother.py
//   pan     nodes/pan.py:49     sum     nodes/sum.py:34
//   filter  nodes/filter.py:101 (the sequential recurrence of K1)
//   echo    nodes/delay.py:116  clip    nodes/hard_clip.py:55
//   meter   nodes/meter.py:55
// Built with --fmad=false and precise sinf/cosf/expf: each f32 operation
// rounds as the eager torch op does.

#include <cuda_runtime.h>
#include <stdint.h>

#include "biquad_step.cuh"

namespace {

constexpr int kThreads = 128;  // threads per instance
constexpr int kWarps = kThreads / 32;
constexpr int kRowWidth = 9;
enum Field { kOp, kNIn, kNOut, kIo, kSlot, kNSlot, kConst, kAux0, kAux1 };
enum OpCode { kDummy, kBeep, kVolume, kPan, kSum, kFilter, kEcho, kClip, kMeter };
enum SmootherStatus { kInactive = 0, kActive = 1, kDeactivating = 2 };

constexpr float kQuiet = 1e-10f;
constexpr float kTau = 6.28318530717958647692f;
constexpr float kQuarterPi = 0.78539816339744830962f;

struct Args {
  const int* ops;
  const int* io;
  const int* slots;
  const float* consts;
  const int* out_row;
  int n_out, n_ops;
  const int* in_bufs;     // K3: live-in buffers
  int n_in;
  const float* env;       // K3: [B, K, n_in, F] live-in rows
  const bool* env_flags;  // K3: [B, K, n_in] their flags
  const int64_t* ptrs;
  float* out;     // [B, K, No, F]
  bool* masks;    // [B, K, No]
  float* scratch; // [B, echo_channels, stride]: echoes the final line drops
  int64_t stride;
  int tile, K, F, num_buffers, echo_channels;
};

// 32-bit words of shared memory per instance: the arena, the flags, the
// reduction scratch and the echo carries (executor_mega.shared_bytes).
__host__ __device__ inline int words_per_instance(const Args& a) {
  return a.num_buffers * a.F + a.num_buffers + 2 * kWarps + a.echo_channels;
}

// One instance's view of the CTA's shared memory.
struct Inst {
  float* buf;   // [num_buffers][F]
  int* flag;    // [num_buffers], 1 = silent
  float* redf;  // [kWarps]
  int* redi;    // [kWarps]
  int* carry;   // [echo_channels]: count of loud samples in each echo window
  int64_t i;    // instance
  int t;        // thread within the instance
};

// The leaves of one row.
struct Leaves {
  const int64_t* ptrs;
  const int* slot;
  int64_t i;
  bool first;  // block 0: state comes from the chunk's input
  template <class T>
  __device__ const T* in(int pos, int64_t n = 1) const {
    return reinterpret_cast<const T*>(ptrs[2 * slot[pos]]) + i * n;
  }
  template <class T>
  __device__ T* out(int pos, int64_t n = 1) const {
    return reinterpret_cast<T*>(ptrs[2 * slot[pos] + 1]) + i * n;
  }
  template <class T>
  __device__ const T* state(int pos, int64_t n = 1) const {
    return first ? in<T>(pos, n) : out<T>(pos, n);
  }
};

// torch.maximum / torch.minimum: a NaN in either operand propagates.
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ float nanmin(float a, float b) {
  return (a != a || a < b) ? a : b;
}
__device__ __forceinline__ int loud(float x) { return !(fabsf(x) < kQuiet); }

// Reductions over one instance's 128 threads.  Every thread of the CTA
// calls them (they hold __syncthreads) and every thread gets the result.
__device__ float sum_f(float v, const Inst& I) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((I.t & 31) == 0) I.redf[I.t >> 5] = v;
  __syncthreads();
  return (I.redf[0] + I.redf[1]) + (I.redf[2] + I.redf[3]);
}

__device__ float max_f(float v, const Inst& I) {
  for (int o = 16; o > 0; o >>= 1)
    v = nanmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if ((I.t & 31) == 0) I.redf[I.t >> 5] = v;
  __syncthreads();
  return nanmax(nanmax(I.redf[0], I.redf[1]), nanmax(I.redf[2], I.redf[3]));
}

__device__ int sum_i(int v, const Inst& I) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((I.t & 31) == 0) I.redi[I.t >> 5] = v;
  __syncthreads();
  return (I.redi[0] + I.redi[1]) + (I.redi[2] + I.redi[3]);
}

// core/smoother.py:smoother_set_and_process, for one value per instance.
struct Smooth {
  float target, last, x_eff, log_b;
  int status;
  bool active, settled;

  __device__ float ramp(int f) const {
    return x_eff + (last - x_eff) * expf(static_cast<float>(f + 1) * log_b);
  }
  __device__ float value(int f) const {
    return settled ? target : (active ? ramp(f) : last);
  }
  __device__ float new_last(int frames) const {
    return settled ? target : (active ? ramp(frames - 1) : last);
  }
  __device__ int new_status() const {
    if (settled) return kDeactivating;
    if (active) return kActive;
    return status == kDeactivating ? kInactive : status;
  }
};

__device__ Smooth smoother(float val, float target, float last, int status,
                           float a, float log_b, float eps) {
  Smooth s;
  s.status = val != target ? kActive : status;
  s.target = val;
  s.last = last;
  s.active = s.status == kActive;
  s.x_eff = (val * a) / a;
  s.log_b = log_b;
  s.settled = s.active && fabsf(val - s.ramp(0)) < eps;
  return s;
}

// The new state; `reset` holds the target flat (smoother_init).
__device__ void write_smoother(const Leaves& L, int pos, const Smooth& s,
                               bool reset, int frames) {
  *L.out<float>(pos) = s.target;
  *L.out<float>(pos + 1) = reset ? s.target : s.new_last(frames);
  *L.out<int>(pos + 2) = reset ? kInactive : s.new_status();
}

struct Row {
  int n_in, n_out;
  const int* in;     // input buffers
  const int* clear;  // their should_clear flags
  const int* out;    // output buffers
  const float* c;    // constants
  int aux0, aux1;
};

__device__ bool all_silent(const Row& r, const Inst& I) {
  bool s = true;
  for (int j = 0; j < r.n_in; ++j) s = s && I.flag[r.in[j]] != 0;
  return s;
}

__device__ void op_dummy(const Args& a, const Row& r, const Inst& I) {
  for (int f = I.t; f < a.F; f += kThreads)
    for (int j = 0; j < r.n_out; ++j) I.buf[r.out[j] * a.F + f] = 0.f;
  if (I.t == 0)
    for (int j = 0; j < r.n_out; ++j) I.flag[r.out[j]] = 0;
}

// leaves: enabled (bool), inc (uint32 in int64), gain, phase (uint32 in int64)
__device__ void op_beep(const Args& a, const Row& r, const Inst& I,
                        const Leaves& L) {
  const bool en = *L.in<bool>(0);
  const uint32_t inc = static_cast<uint32_t>(*L.in<int64_t>(1));
  const float gain = *L.in<float>(2);
  const uint32_t ph = static_cast<uint32_t>(*L.state<int64_t>(3));
  for (int f = I.t; f < a.F; f += kThreads) {
    const uint32_t q = ph + static_cast<uint32_t>(f) * inc;
    // the signed phase in cycles, [-0.5, 0.5): _signed_phase
    const float x = static_cast<float>(static_cast<int32_t>(q)) * 0x1p-32f;
    const float v = en ? sinf(x * kTau) * gain : 0.f;
    for (int j = 0; j < r.n_out; ++j) I.buf[r.out[j] * a.F + f] = v;
  }
  if (I.t == 0)
    for (int j = 0; j < r.n_out; ++j) I.flag[r.out[j]] = !en;
  __syncthreads();  // every thread has read the phase
  if (I.t == 0) {
    const uint32_t next = en ? ph + static_cast<uint32_t>(a.F) * inc : ph;
    *L.out<int64_t>(3) = static_cast<int64_t>(next);
  }
}

// leaves: raw_gain, gain.{target, last, status}; consts: a, log_b, eps, mute
__device__ void op_volume(const Args& a, const Row& r, const Inst& I,
                          const Leaves& L) {
  const float raw = *L.in<float>(0);
  const Smooth s = smoother(raw, *L.state<float>(1), *L.state<float>(2),
                            *L.state<int>(3), r.c[0], r.c[1], r.c[2]);
  const bool silent_in = all_silent(r, I);
  const bool muted = s.new_status() == kInactive && s.value(0) < r.c[3];
  const bool silence = silent_in || muted;
  for (int f = I.t; f < a.F; f += kThreads) {
    const float g = s.value(f);
    for (int j = 0; j < r.n_in; ++j) {
      const float x = I.buf[r.in[j] * a.F + f];
      I.buf[r.out[j] * a.F + f] = silence ? 0.f : x * g;
    }
  }
  if (I.t == 0)
    for (int j = 0; j < r.n_in; ++j)
      I.flag[r.out[j]] = silence || I.flag[r.in[j]] != 0;
  __syncthreads();  // every thread has read the smoother
  // all-silent resets the smoother (volume.rs:95-97); muted does not
  if (I.t == 0) write_smoother(L, 1, s, silent_in, a.F);
}

// leaves: pan, pan.{target, last, status}; consts: a, log_b, eps
__device__ void op_pan(const Args& a, const Row& r, const Inst& I,
                       const Leaves& L) {
  const float pan = *L.in<float>(0);
  const Smooth s = smoother(pan, *L.state<float>(1), *L.state<float>(2),
                            *L.state<int>(3), r.c[0], r.c[1], r.c[2]);
  const bool silent_in = all_silent(r, I);
  for (int f = I.t; f < a.F; f += kThreads) {
    // ops/pan.py:equal_power_gains
    const float theta = (s.value(f) + 1.0f) * kQuarterPi;
    const float gl = cosf(theta);
    const float gr = sinf(theta);
    const float x0 = I.buf[r.in[0] * a.F + f];
    const float mid =
        r.n_in == 1 ? x0 : (x0 + I.buf[r.in[1] * a.F + f]) * 0.5f;
    I.buf[r.out[0] * a.F + f] = silent_in ? 0.f : mid * gl;
    I.buf[r.out[1] * a.F + f] = silent_in ? 0.f : mid * gr;
  }
  if (I.t == 0) I.flag[r.out[0]] = I.flag[r.out[1]] = silent_in;
  __syncthreads();  // every thread has read the smoother
  if (I.t == 0) write_smoother(L, 1, s, silent_in, a.F);
}

// out[ch] = in[ch] + in[m + ch] + ..., left to right
__device__ void op_sum(const Args& a, const Row& r, const Inst& I) {
  const int m = r.n_out;
  const int ports = r.n_in / m;
  const bool silent_in = all_silent(r, I);
  for (int f = I.t; f < a.F; f += kThreads) {
    for (int ch = 0; ch < m; ++ch) {
      float v = I.buf[r.in[ch] * a.F + f];
      for (int p = 1; p < ports; ++p) v = v + I.buf[r.in[p * m + ch] * a.F + f];
      I.buf[r.out[ch] * a.F + f] = silent_in ? 0.f : v;
    }
  }
  if (I.t == 0)
    for (int ch = 0; ch < m; ++ch)
      I.flag[r.out[ch]] =
          ports == 1 ? silent_in || I.flag[r.in[ch]] != 0 : silent_in;
}

// leaves: freq, q, gain_db (unread), z1 [C], z2 [C], coef [5] (derived)
__device__ void op_filter(const Args& a, const Row& r, const Inst& I,
                          const Leaves& L) {
  const int ch = r.n_in;
  if (I.t >= ch) return;
  const int c = I.t;  // one thread per channel runs the recurrence
  const float* k = L.in<float>(5, 5);
  const BiquadCoef bq = {k[0], k[1], k[2], k[3], k[4]};
  float z1 = L.state<float>(3, ch)[c];
  float z2 = L.state<float>(4, ch)[c];
  // silent input with settled state stays silent; a ringing tail is audio
  const bool mask =
      I.flag[r.in[c]] != 0 && fabsf(z1) < kQuiet && fabsf(z2) < kQuiet;
  const float* x = I.buf + r.in[c] * a.F;
  float* y = I.buf + r.out[c] * a.F;
  for (int f = 0; f < a.F; ++f) {
    const float v = biquad_step(bq, x[f], z1, z2);
    y[f] = mask ? 0.f : v;
  }
  I.flag[r.out[c]] = mask;
  L.out<float>(3, ch)[c] = z1;
  L.out<float>(4, ch)[c] = z2;
}

// The echo's line, oldest first, is line_in [C, D] at the chunk's start.
// Inside the chunk the logical line is line_in followed by the chunk's
// echoes, index j in [0, D + K*F).  Block k taps j = k*F + f, checks the
// window [k*F, k*F + D) and appends at j = D + k*F + f.  The final line is
// the window at k = K: j >= K*F lives in line_out at j - K*F, and an echo
// with j < K*F (only when K*F > D) lives in the scratch.
struct EchoLine {
  const float* in;
  float* out;
  float* scratch;
  int64_t d, kf;
  __device__ float read(int64_t j) const {
    if (j < d) return in[j];
    return j >= kf ? out[j - kf] : scratch[j - d];
  }
  __device__ void append(int64_t j, float v) const {
    if (j >= kf) out[j - kf] = v;
    else scratch[j - d] = v;
  }
};

__device__ EchoLine echo_line(const Args& a, const Row& r, const Inst& I,
                              const Leaves& L, int c) {
  const int64_t d = r.aux0;
  const int ch = r.n_in;
  EchoLine e;
  e.in = L.in<float>(3, ch * d) + c * d;
  e.out = L.out<float>(3, ch * d) + c * d;
  e.scratch = a.scratch + (I.i * a.echo_channels + r.aux1 + c) * a.stride;
  e.d = d;
  e.kf = static_cast<int64_t>(a.K) * a.F;
  return e;
}

// Once per chunk: count the loud samples of each channel's line and copy
// the part of line_in that the final line keeps.
__device__ void echo_begin(const Args& a, const Row& r, const Inst& I,
                           const Leaves& L) {
  for (int c = 0; c < r.n_in; ++c) {
    const EchoLine e = echo_line(a, r, I, L, c);
    int n = 0;
    for (int64_t j = I.t; j < e.d; j += kThreads) {
      const float x = e.in[j];
      n += loud(x);
      if (j >= e.kf) e.out[j - e.kf] = x;
    }
    n = sum_i(n, I);
    if (I.t == 0) I.carry[r.aux1 + c] = n;
  }
}

// leaves: feedback, wet, dry, line [C, D]; aux0 = D, aux1 = first carry
__device__ void op_echo(const Args& a, const Row& r, const Inst& I,
                        const Leaves& L, int k) {
  const float fb = *L.in<float>(0);
  const float wet = *L.in<float>(1);
  const float dry = *L.in<float>(2);
  for (int c = 0; c < r.n_in; ++c) {
    const EchoLine e = echo_line(a, r, I, L, c);
    const bool quiet = I.carry[r.aux1 + c] == 0;  // the window before this block
    const bool mask = I.flag[r.in[c]] != 0 && quiet;
    int delta = 0;
    for (int f = I.t; f < a.F; f += kThreads) {
      const int64_t j = static_cast<int64_t>(k) * a.F + f;
      const float x = I.buf[r.in[c] * a.F + f];
      const float delayed = e.read(j);
      const float echo = x + fb * delayed;
      e.append(e.d + j, echo);
      const float y = dry * x + wet * delayed;
      I.buf[r.out[c] * a.F + f] = mask ? 0.f : y;
      delta += loud(echo) - loud(delayed);
    }
    delta = sum_i(delta, I);
    if (I.t == 0) {
      I.carry[r.aux1 + c] += delta;
      I.flag[r.out[c]] = mask;
    }
  }
}

// leaves: threshold, clip_count (int32)
__device__ void op_clip(const Args& a, const Row& r, const Inst& I,
                        const Leaves& L) {
  const float th = *L.in<float>(0);
  const int count = *L.state<int>(1);
  int over = 0;
  for (int f = I.t; f < a.F; f += kThreads) {
    for (int j = 0; j < r.n_in; ++j) {
      const float x = I.buf[r.in[j] * a.F + f];
      I.buf[r.out[j] * a.F + f] = nanmax(nanmin(x, th), -th);
      // strictly over the threshold, on audible channels only
      over += (fabsf(x) > th) && I.flag[r.in[j]] == 0;
    }
  }
  over = sum_i(over, I);
  if (I.t == 0) {
    for (int j = 0; j < r.n_in; ++j) I.flag[r.out[j]] = I.flag[r.in[j]];
    *L.out<int>(1) = static_cast<int>(static_cast<uint32_t>(count) +
                                      static_cast<uint32_t>(over));
  }
}

// leaves: peak [C], rms_sq [C]; consts: peak decay, rms alpha
__device__ void op_meter(const Args& a, const Row& r, const Inst& I,
                         const Leaves& L) {
  const int ch = r.n_in;
  for (int c = 0; c < ch; ++c) {
    float peak = 0.f;
    float sq = 0.f;
    for (int f = I.t; f < a.F; f += kThreads) {
      const float x = I.buf[r.in[c] * a.F + f];
      I.buf[r.out[c] * a.F + f] = x;
      peak = nanmax(peak, fabsf(x));
      sq += x * x;
    }
    peak = max_f(peak, I);
    sq = sum_f(sq, I);
    if (I.t == 0) {
      const float p0 = L.state<float>(0, ch)[c];
      const float r0 = L.state<float>(1, ch)[c];
      L.out<float>(0, ch)[c] = nanmax(peak, p0 * r.c[0]);
      const float ms = sq / static_cast<float>(a.F);
      L.out<float>(1, ch)[c] = r0 + r.c[1] * (ms - r0);
      I.flag[r.out[c]] = I.flag[r.in[c]];
    }
  }
}

__device__ Row read_row(const Args& a, int n) {
  const int* w = a.ops + n * kRowWidth;
  Row r;
  r.n_in = w[kNIn];
  r.n_out = w[kNOut];
  r.in = a.io + w[kIo];
  r.clear = r.in + r.n_in;
  r.out = r.clear + r.n_in;
  r.c = a.consts + w[kConst];
  r.aux0 = w[kAux0];
  r.aux1 = w[kAux1];
  return r;
}

__device__ Leaves row_leaves(const Args& a, const Inst& I, int n, int k) {
  Leaves L;
  L.ptrs = a.ptrs;
  L.slot = a.slots + a.ops[n * kRowWidth + kSlot];
  L.i = I.i;
  L.first = k == 0;
  return L;
}

__device__ void run_row(const Args& a, const Inst& I, int n, int k) {
  const Row r = read_row(a, n);
  const Leaves L = row_leaves(a, I, n, k);
  // unconnected inputs read as cleared, silent buffers (schedule.rs:310-313)
  for (int j = 0; j < r.n_in; ++j) {
    if (!r.clear[j]) continue;
    for (int f = I.t; f < a.F; f += kThreads) I.buf[r.in[j] * a.F + f] = 0.f;
    if (I.t == 0) I.flag[r.in[j]] = 1;
  }
  __syncthreads();
  switch (a.ops[n * kRowWidth + kOp]) {
    case kDummy: op_dummy(a, r, I); break;
    case kBeep: op_beep(a, r, I, L); break;
    case kVolume: op_volume(a, r, I, L); break;
    case kPan: op_pan(a, r, I, L); break;
    case kSum: op_sum(a, r, I); break;
    case kFilter: op_filter(a, r, I, L); break;
    case kEcho: op_echo(a, r, I, L, k); break;
    case kClip: op_clip(a, r, I, L); break;
    case kMeter: op_meter(a, r, I, L); break;
  }
  __syncthreads();
}

// The graph outputs of block k: flagged channels read as zero
// (schedule.rs:255-287).
__device__ void write_outputs(const Args& a, const Inst& I, int k) {
  const int64_t at = (I.i * a.K + k) * a.n_out;
  for (int o = 0; o < a.n_out; ++o) {
    const int b = a.out_row[2 * o];
    const bool silent = a.out_row[2 * o + 1] != 0 || I.flag[b] != 0;
    for (int f = I.t; f < a.F; f += kThreads)
      a.out[(at + o) * a.F + f] = silent ? 0.f : I.buf[b * a.F + f];
    if (I.t == 0) a.masks[at + o] = silent;
  }
  __syncthreads();  // the next block's rows overwrite these buffers
}

// K3: block k's live-in rows and flags, from the operands.
__device__ void read_live_ins(const Args& a, const Inst& I, int k) {
  const int64_t at = (I.i * a.K + k) * a.n_in;
  for (int j = 0; j < a.n_in; ++j) {
    const int b = a.in_bufs[j];
    for (int f = I.t; f < a.F; f += kThreads)
      I.buf[b * a.F + f] = a.env[(at + j) * a.F + f];
    if (I.t == 0) I.flag[b] = a.env_flags[at + j] ? 1 : 0;
  }
  __syncthreads();
}

// K3: block k's live-out buffers as they are, and their flags.
__device__ void write_live_outs(const Args& a, const Inst& I, int k) {
  const int64_t at = (I.i * a.K + k) * a.n_out;
  for (int o = 0; o < a.n_out; ++o) {
    const int b = a.out_row[2 * o];
    for (int f = I.t; f < a.F; f += kThreads)
      a.out[(at + o) * a.F + f] = I.buf[b * a.F + f];
    if (I.t == 0) a.masks[at + o] = I.flag[b] != 0;
  }
  __syncthreads();  // the next block's rows overwrite these buffers
}

// The K-block loop of one instance; kIsland selects K3's operands.
template <bool kIsland>
__device__ void render(const Args& a, float* smem) {
  const int li = threadIdx.x / kThreads;
  float* base = smem + li * words_per_instance(a);
  Inst I;
  I.buf = base;
  I.flag = reinterpret_cast<int*>(base + a.num_buffers * a.F);
  I.redf = reinterpret_cast<float*>(I.flag + a.num_buffers);
  I.redi = reinterpret_cast<int*>(I.redf + kWarps);
  I.carry = I.redi + kWarps;
  I.i = static_cast<int64_t>(blockIdx.x) * a.tile + li;
  I.t = threadIdx.x % kThreads;

  for (int n = 0; n < a.n_ops; ++n) {
    if (a.ops[n * kRowWidth + kOp] == kEcho)
      echo_begin(a, read_row(a, n), I, row_leaves(a, I, n, 0));
  }
  __syncthreads();
  for (int k = 0; k < a.K; ++k) {
    if (kIsland) read_live_ins(a, I, k);
    for (int n = 0; n < a.n_ops; ++n) run_row(a, I, n, k);
    if (kIsland) {
      write_live_outs(a, I, k);
    } else {
      write_outputs(a, I, k);
    }
  }
}

__global__ void __launch_bounds__(1024) mega_kernel(const Args a) {
  extern __shared__ float smem[];
  render<false>(a, smem);
}

__global__ void __launch_bounds__(1024) island_kernel(const Args a) {
  extern __shared__ float smem[];
  render<true>(a, smem);
}

// Checks the sizes, raises the kernel's shared-memory limit when needed and
// launches; returns cudaGetLastError() (0 on success).
template <class Kernel>
int launch(Kernel kernel, const Args& a, int batch, void* stream) {
  if (batch <= 0) return 0;
  if (a.tile <= 0 || batch % a.tile != 0 || a.tile * kThreads > 1024 ||
      a.K <= 0 || a.F <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * a.tile *
                      static_cast<size_t>(words_per_instance(a));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<batch / a.tile, a.tile * kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

Args make_args(const int* ops, const int* io, const int* slots,
               const float* consts, const int* out_row, int n_out, int n_ops,
               const int64_t* ptrs, float* out, bool* masks, float* scratch,
               int64_t stride, int tile, int num_blocks, int frames,
               int num_buffers, int echo_channels) {
  Args a = {};
  a.ops = ops;
  a.io = io;
  a.slots = slots;
  a.consts = consts;
  a.out_row = out_row;
  a.n_out = n_out;
  a.n_ops = n_ops;
  a.ptrs = ptrs;
  a.out = out;
  a.masks = masks;
  a.scratch = scratch;
  a.stride = stride;
  a.tile = tile;
  a.K = num_blocks;
  a.F = frames;
  a.num_buffers = num_buffers;
  a.echo_channels = echo_channels;
  return a;
}

}  // namespace

// Renders K blocks of `batch` instances (see the top of this file for the
// tables).  All pointers are device pointers on the current device.
// Launches on `stream` and returns cudaGetLastError() (0 on success); it
// does not synchronise and allocates nothing.
extern "C" int fw_mega_render(const int* ops, const int* io, const int* slots,
                              const float* consts, const int* out_row,
                              int n_out, int n_ops, const int64_t* ptrs,
                              float* out, bool* masks, float* scratch,
                              int64_t stride, int batch, int tile,
                              int num_blocks, int frames, int num_buffers,
                              int echo_channels, void* stream) {
  const Args a = make_args(ops, io, slots, consts, out_row, n_out, n_ops, ptrs,
                           out, masks, scratch, stride, tile, num_blocks,
                           frames, num_buffers, echo_channels);
  return launch(mega_kernel, a, batch, stream);
}

// Renders K blocks of one island for `batch` instances: live-in rows `env`
// [B, K, n_in, F] and flags `env_flags` [B, K, n_in] in, live-out rows `out`
// [B, K, n_out, F] (unmasked) and flags `flags` [B, K, n_out] out.  The same
// contract as fw_mega_render otherwise.
extern "C" int fw_island_render(const int* ops, const int* io,
                                const int* slots, const float* consts,
                                const int* out_row, int n_out, int n_ops,
                                const int* in_bufs, int n_in,
                                const int64_t* ptrs, const float* env,
                                const bool* env_flags, float* out,
                                bool* flags, float* scratch, int64_t stride,
                                int batch, int tile, int num_blocks,
                                int frames, int num_buffers,
                                int echo_channels, void* stream) {
  Args a = make_args(ops, io, slots, consts, out_row, n_out, n_ops, ptrs, out,
                     flags, scratch, stride, tile, num_blocks, frames,
                     num_buffers, echo_channels);
  a.in_bufs = in_bufs;
  a.n_in = n_in;
  a.env = env;
  a.env_flags = env_flags;
  return launch(island_kernel, a, batch, stream);
}

// The megakernel: a whole compiled audio schedule, K blocks, one launch;
// and the island kernel: one run of a schedule's rows between torch stages.
//
// mega_kernel (K2) replaces the TPU kernel firewheel_tpu/executor_pallas.py:
// MegaRenderer._build.kernel; island_kernel (K3) replaces
// HybridMegaRenderer._mega_segment.kernel.  Both are render<> below.  The
// rows come in as tables that executor_mega.py:lower_schedule builds once
// per graph or island:
//
//   ops     int32 [n_ops, kRowWidth]  one row per interior node, in schedule
//                                     order (fields: enum Field)
//   io      int32  per row: its input buffers, their should_clear flags,
//                  its output buffers
//   consts  f32    per row: the processor's float constants
//   out_row int32 [n_out, 2]  output buffer and should_clear (0 in an island)
//   in_bufs int32 [n_in]      an island's live-in buffers
//   leaves  int32 [n_leaves, kLeafWidth]  per leaf of the flat param/state
//                  list: its first word in an instance's block of leaf
//                  words, its word count (0: the leaf stays in device
//                  memory), its type (enum LeafType) and whether it is
//                  state.  Leaf s has its input pointer at ptrs[2s] and its
//                  output pointer at ptrs[2s+1]; a row's leaves are
//                  consecutive from its kSlot, its words from its kWord.
//
// K3 takes the live-in rows env f32[B, K, n_in, F] and their silence flags
// bool[B, K, n_in] as operands, copies block k's rows into their arena
// buffers before the rows, and writes the live-out buffers as they are,
// not zeroed by their flags (the torch stage after the island reads them),
// with their flags as bool[B, K, n_out].  K2 writes the graph outputs with
// flagged channels zeroed.
//
// What bounds it on an H100.  The bytes a chunk must move are the outputs
// and, for an echo, its line read and written once: 1.86 GB for the 64-node
// mixer at B=8192, K=32, 0.55 ms at 3.35 TB/s; its f32 operations take a
// fifth of that.  The first design (128 threads an instance) took 31 ms: the
// row walk (table reads, a chase of three dependent global loads per param
// and state value, two or three CTA-wide barriers a row) and transcendentals
// that the pan recomputed every frame.  What bounds this design is latency:
// the mixer's arena (40 buffers x 128 frames, 20 KB) holds an SM to 8
// instances, two warps a scheduler, and each row is a chain of dependent
// shared-memory loads, branches and arithmetic.  Against that:
//
//  a. Tables on chip: every CTA copies ops, io, consts, out_row and in_bufs
//     into shared memory once; rows decode from there (a row's fields are
//     three int4 loads).  They cost the mixer two of ten resident instances
//     an SM, yet read through L1 instead K2 took 10.5 ms, not 9.0.
//  b. Leaves on chip: each instance gathers its params, state and derived
//     filter coefficients into 32-bit words in shared memory once a chunk
//     (bool as 0/1, the uint32 carried in int64 as its low 32 bits, f32 and
//     int32 as they are; lanes over leaves, so the loads overlap).  Rows
//     read and update the words for all K blocks; the state words go to the
//     output leaves once, at the end of the chunk.  Each echo channel keeps
//     its line's pointers and loud-sample count in shared memory too.
//  c. One warp per instance and no CTA-wide barrier after the table copy.
//     Lane l owns the float4s l, l + 32, ... of each buffer: frames
//     4l..4l+3 at F = 128.  F may be any size: an arena row is padded to a
//     whole float4, and the padding is kept out of every reduction (the
//     meter, the clip count, the echo's loud count), the filter's
//     recurrence, the echo line's tap and append, the outputs and K3's
//     live-in copies (in_block); rows of F % 4 != 0 frames in device memory
//     are not 16-byte aligned, so those copies go a float at a time.
//     F = 128, every graph in the repo, has kernels of its own in which F
//     is a compile-time constant (Args128) and no frame is padding.  Every
//     lane computes a row's flags and smoother scalars from the words; after a
//     __syncwarp the row's lanes publish what later rows read (flags in
//     parallel, state words, echo counts), and every row ends in a
//     __syncwarp.  Reductions are shuffles.  The filter's recurrence runs
//     on one lane per channel over all frames (biquad_step.cuh, K1's
//     rounding) while the SM's other warps run.  `tile` is the number of instances, so of warps, per CTA; it
//     changes nothing measurable (tiles 1-4).  Every access to shared memory
//     indexes the extern array by a 32-bit word offset: pointers into it
//     kept in structs compiled to generic 64-bit loads.
//  d. Per-block values out of the frame loop: while a smoother is not
//     ramping its value is one constant, so the pan's cosf/sinf and the
//     volume's gain are computed once a block (the same f32 inputs give the
//     same bits as per frame).  The ramping paths are out of line, which
//     keeps the hot code small; the beep's per-frame sinf is the work.
//  e. Registers on purpose: shared memory, not registers, bounds the
//     mixer's residency at 8 warps an SM, so __launch_bounds__ names the
//     most threads a CTA launches (kMaxTile warps) and asks for one CTA,
//     leaving ptxas free.  It reports 80 registers for mega_kernel and 92
//     for island_kernel (108 with F read at run time), no spills, and a
//     128-byte stack frame: the precise sinf/cosf slow path's local array
//     and the out-of-line ramping paths.
//     Capping island_kernel at 64 registers spilled and was faster at
//     B=8192 but slower at B=1024.  The rows beyond the mixer's (i., j.)
//     need more: compiled into every kernel the FX rows took island_kernel
//     to 132 registers, and at tile 1 registers, not shared memory, bound
//     K3's residency (the effects chain's island 40% slower), so they are
//     compiled only into the kernels that a table with such rows launches
//     (kFx), and into the spilled kernels (h.).  chip_smoke.py phase 2
//     prints the report for all ten entries.
//  f. The echo line at bandwidth: the chunk-start count and copy of the
//     kept line, and each block's tap and append, use 16-byte accesses when
//     the line length and F are multiples of 4 and the pointers are aligned
//     (the mixer's and the effects chain's are); 4-byte accesses otherwise.
//     K3's live-in and live-out copies and K2's outputs are 16-byte too
//     when F is a multiple of 4.
//  g. Rows side by side: lower_schedule marks runs of 2 or 4 consecutive
//     independent rows of dummy, beep, volume or pan (the mixer's voices)
//     as a group, which one step of the walk runs on 32/G lanes a row, G
//     float4s a lane: the mixer's 62 rows take 23 steps.  A later row of a
//     group may write a buffer that an earlier one reads (the allocator
//     reuses it), so a grouped row reads all of its inputs before the
//     __syncwarp that precedes its writes.
//  h. Large arenas: the spatial scene (BASELINE config 5, 266 nodes) keeps
//     258 buffers live, 159 376 B a CTA at F = 128, so it runs at tile 1,
//     one warp an SM, with every row's latency exposed.  At F = 256 its
//     arena (264 KB) fits no CTA: when an instance's arena does not fit at
//     tile 1 (executor_mega.spills), every instance's buffers live in a
//     device-memory workspace [B, num_buffers, round4(F)] that the wrapper
//     allocates, and the flags, leaf words, echo records, scratch and
//     tables stay in shared memory.  Rows reach buffers only through
//     frames4/frame, which index the workspace when the argument type is
//     ArgsSpill, a compile-time property: the kernels with the arena on
//     chip carry no branch for it.  The spilled kernels read F at run time
//     and compile every row in (two entries; they are not the hot path).
//     The JAX kernel keeps its whole arena in VMEM; a lowering that keeps
//     fewer buffers live is later work.  The spatializer rows run their
//     one-pole on one lane (op_spatial).
//  i. The FX palette's rows (examples/interactive_graph.py, every node but
//     the flanger, whose feedback program opts out as in the JAX package):
//     lanes over frames, each f32 operation as the eager op rounds it on
//     the card.  The EQ's bands and the waveshaper's DC blocker are K7's
//     associative scan (assoc_scan.cuh) on the whole warp, its levels in
//     the instance's scratch (scan_words: a row of frames, then the
//     levels); the gate's latch runs on lane 0 into the scratch row, as K5
//     runs it.  The mod delay's line and the pitch ring stay in device
//     memory as the echo's line does (an EchoLine each channel, the same
//     echo channel records); the pitch shifter's all-silent reset zeroes
//     its ring by moving the channel's zero_below past it and zeroing the
//     final line's part in line_out.
//  j. The mastering bus's rows (examples/mastering_bus.py; with the LFO,
//     the latency pass's delay compensator and the meter as a sink): the
//     compressor's and the ducker's envelopes and the limiter's release
//     run on lane 0 as K5 runs them, into the row's scratch; the dB gain
//     (log10f, powf) and the gains on the lanes.  The limiter's window
//     maximum reads the level sequence (the tail, then the block) from the
//     scratch; its dry line and the delay compensator's line stay in device
//     memory through the echo channel records (line_loud: the limiter's
//     quiet check is `== 0`).  The loudness meter runs its K-weighting as
//     two K7 sections a channel (k7_section), sums each hop's powers with a
//     warp reduction (another order than torch's: the ring is held to a
//     tolerance) and keeps the ring, counts and indices in its words.
//
// Device functions, each the counterpart of one of the port's node kernels
// (and through it of the JAX package's):
//   dummy   nodes/dummy.py      beep    nodes/beep_test.py:71
//   volume  nodes/volume.py:89 with core/smoother.py
//   pan     nodes/pan.py:49     sum     nodes/sum.py:34
//   filter  nodes/filter.py:101 (the sequential recurrence of K1)
//   echo    nodes/delay.py:116  clip    nodes/hard_clip.py:55
//   meter   nodes/meter.py:55       spatial nodes/spatial.py (no doppler)
//   mono_to_stereo, stereo_to_mono  nodes/channel.py
//   width   nodes/stereo_width.py   tremolo nodes/mod_effects.py:TremoloProcessor
//   waveshaper nodes/waveshaper.py  gate    nodes/dynamics.py:GateProcessor
//   eq      nodes/eq.py             mod_delay nodes/mod_effects.py (no feedback)
//   pitch   nodes/pitch_shift.py
//   compressor, ducker, limiter  nodes/dynamics.py
//   loudness nodes/loudness.py      lfo     nodes/generators.py:LFOProcessor
//   delay_comp nodes/delay.py:DelayCompProcessor
//   sink meter nodes/meter.py:_SinkMeterProcessor (op_meter, no outputs)
// Built with --fmad=false and precise sinf/cosf/expf/log10f/powf: each f32
// operation rounds as the eager torch op does.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "assoc_scan.cuh"
#include "biquad_step.cuh"

// The CTA's dynamic shared memory.  Every access indexes this array itself
// by a 32-bit word offset, so that ptxas emits LDS/STS: pointers into it
// kept in structs compiled to generic 64-bit loads (LD.E), which slowed the
// row walk.
extern __shared__ float4 smem4[];

namespace {

constexpr int kLanes = 32;    // threads per instance: one warp
constexpr int kMaxTile = 8;   // instances (warps) per CTA at most
constexpr int kMaxThreads = kLanes * kMaxTile;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowWidth = 12;  // 48 bytes: a row's fields load as three int4
enum Field {
  kOp, kNIn, kNOut, kIo, kSlot, kNSlot, kConst, kAux0, kAux1, kWord, kNClear,
  kGroup
};
enum OpCode {
  kDummy, kBeep, kVolume, kPan, kSum, kFilter, kEcho, kClip, kMeter, kSpatial,
  kMonoToStereo, kStereoToMono, kWidth, kTremolo, kWaveshaper, kGate, kEq,
  kModDelay, kPitch, kCompressor, kDucker, kLimiter, kLoudness, kLfo,
  kDelayComp, kSinkMeter
};
enum SmootherStatus { kInactive = 0, kActive = 1, kDeactivating = 2 };
constexpr int kLeafWidth = 4;
enum LeafField { kLeafWord, kLeafCount, kLeafType, kLeafState };
enum LeafType { kWord32, kBool, kInt64 };

constexpr float kQuiet = 1e-10f;
constexpr float kRingQuiet = 0x1.197998p-40f;  // float32(1e-12): the pitch ring
constexpr float kTwoOverPi = 0x1.45f306p-1f;   // float32(2/pi)
constexpr float kTau = 6.28318530717958647692f;
constexpr float kQuarterPi = 0.78539816339744830962f;
constexpr float kKneeFloor = 0x1.12e0bep-30f;  // float32(1e-9): the knee's and the
                                               // limiter's peak floor
constexpr float kTenth = 0.1f;  // 1/10 rounded: torch's x / 10.0 on the card

struct Args {
  const int* ops;
  const int* io;
  const float* consts;
  const int* out_row;
  const int* in_bufs;     // K3: live-in buffers
  const int* leaves;
  int n_ops, n_io, n_consts, n_out, n_in, n_leaves, num_words;
  const int64_t* ptrs;
  const float* env;       // K3: [B, K, n_in, F] live-in rows
  const bool* env_flags;  // K3: [B, K, n_in] their flags
  float* out;     // [B, K, n_out, F]
  bool* masks;    // [B, K, n_out]
  float* scratch; // [B, echo_channels, stride]: echoes the final line drops
  int64_t stride;
  int tile, K, F, num_buffers, echo_channels;
  int scan_words;  // per instance: the scratch of the rows that need one
  int fx;          // the table has rows beyond the mixer's: launch the
                   // kernels built with them
  int spill;       // the arena lives in device memory (`arena`), not shared
  float* arena;    // spilled: [B, num_buffers, round4(F)]
  // F % 4 == 0 known at compile time (Args128); else F is any size > 0
  static constexpr bool kWhole = false;
  // the arena in device memory, known at compile time (ArgsSpill)
  static constexpr bool kSpill = false;
};

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// One channel of a row's line in device memory (the echo's, the mod
// delay's, the pitch shifter's ring), in shared memory for the chunk: its
// loud-sample count, what a reset zeroed and its line's pointers (10 words).
struct EchoChannel {
  int count;  // loud samples in the window before the current block
  int vec;    // 16-byte accesses (see EchoLine)
  int64_t zero_below;  // logical samples below this read as 0 (a reset)
  const float* in;
  float* out;
  float* scratch;
};
constexpr int kEchoWords = sizeof(EchoChannel) / 4;

// 32-bit words of shared memory (executor_mega.shared_bytes): the tables,
// once per CTA, then per instance its arena (num_buffers rows of F floats,
// each padded to round4(F) so that the lanes move whole float4s; none when
// the arena is spilled to device memory), its echo channels, the buffers'
// silence flags, its leaf words and the scan rows' scratch.  Both parts
// round up to 16 bytes, so every arena row is 16-byte aligned and every
// echo channel 8-byte aligned.
__host__ __device__ inline int table_words(const Args& a) {
  return round4(a.n_ops * kRowWidth + a.n_io + a.n_consts + 2 * a.n_out + a.n_in);
}
__host__ __device__ inline int arena_words(const Args& a) {
  return a.spill ? 0 : a.num_buffers * round4(a.F);
}
__host__ __device__ inline int words_per_instance(const Args& a) {
  return round4(arena_words(a) + kEchoWords * a.echo_channels + a.num_buffers +
                a.num_words + a.scan_words);
}
__host__ __device__ inline size_t shared_bytes(const Args& a) {
  return 4 * (static_cast<size_t>(table_words(a)) +
              static_cast<size_t>(a.tile) * words_per_instance(a));
}

// The CTA's dynamic shared memory (smem4) by 32-bit word offset.
__device__ __forceinline__ int& s_int(int w) {
  return reinterpret_cast<int*>(smem4)[w];
}
__device__ __forceinline__ float& s_float(int w) {
  return reinterpret_cast<float*>(smem4)[w];
}
__device__ __forceinline__ uint32_t& s_word(int w) {
  return reinterpret_cast<uint32_t*>(smem4)[w];
}
__device__ __forceinline__ float4& s_float4(int w) {  // w % 4 == 0
  return smem4[w >> 2];
}

// Where the tables start in shared memory (word offsets).
struct Tables {
  int ops, io, consts, out_row, in_bufs;
};

// One instance's part of the CTA's shared memory (word offsets), and the
// lanes that run the current row: a group of G rows runs on 32/G lanes each
// (`span`), lane `sub` of them owning float4 sub, sub + span, ... of each
// buffer.  A row alone has span 32 and sub = lane; the rows with warp-wide
// reductions (sum, filter, echo, clip, meter) always run alone.
struct Inst {
  int buf;    // [num_buffers][F] (in shared memory unless spilled)
  int echo;   // [echo_channels] EchoChannel
  int flag;   // [num_buffers], 1 = silent
  int word;   // [num_words]: the leaves on chip
  int scan;   // [scan_words]: a row's frame row and scan levels
  int64_t i;  // instance
  int lane, sub, span;
  unsigned mask;  // the lanes of the row
};

struct Row {
  int op, n_in, n_out, n_clear;
  int in;     // input buffers (word offset of the list)
  int clear;  // their should_clear flags
  int out;    // output buffers
  int c;      // constants
  int aux0, aux1, slot;
  int w;      // the row's leaf words
};

__device__ __forceinline__ int in_buf(const Row& r, int j) { return s_int(r.in + j); }
__device__ __forceinline__ int out_buf(const Row& r, int j) { return s_int(r.out + j); }
__device__ __forceinline__ float cst(const Row& r, int k) { return s_float(r.c + k); }
__device__ __forceinline__ uint32_t& word(const Row& r, int k) {
  return s_word(r.w + k);
}
__device__ __forceinline__ float wf(const Row& r, int k) {
  return __uint_as_float(word(r, k));
}
__device__ __forceinline__ void set_wf(const Row& r, int k, float v) {
  word(r, k) = __float_as_uint(v);
}
__device__ __forceinline__ int& flag(const Inst& I, int b) {
  return s_int(I.flag + b);
}
__device__ __forceinline__ EchoChannel& echo_ch(const Inst& I, int c) {
  return reinterpret_cast<EchoChannel*>(reinterpret_cast<int*>(smem4) + I.echo)[c];
}

// An arena row's floats: F rounded up to a float4.
template <class A>
__device__ __forceinline__ int pitch(const A& a) { return round4(a.F); }
// Buffer b of the instance's arena in device memory (ArgsSpill).
template <class A>
__device__ __forceinline__ float* spilled(const A& a, const Inst& I, int b) {
  return a.arena + (I.i * a.num_buffers + b) * pitch(a);
}
// The float4 of buffer b that holds frames 4q..4q+3: in shared memory, or
// in the spilled arena (a compile-time property of the argument type, so
// the kernels with the arena on chip carry no branch for it).
template <class A>
__device__ __forceinline__ float4& frames4(const A& a, const Inst& I, int b,
                                          int q) {
  if constexpr (A::kSpill)
    return reinterpret_cast<float4*>(spilled(a, I, b))[q];
  else
    return s_float4(I.buf + b * pitch(a) + 4 * q);
}
// Frame f of buffer b.
template <class A>
__device__ __forceinline__ float& frame(const A& a, const Inst& I, int b, int f) {
  if constexpr (A::kSpill)
    return spilled(a, I, b)[f];
  else
    return s_float(I.buf + b * pitch(a) + f);
}
// Float4s in a block, the last one padded past F when F % 4 != 0; lane sub
// of a row owns q = sub, sub + span, ...
template <class A>
__device__ __forceinline__ int quads(const A& a) { return (a.F + 3) >> 2; }
// Whether frame f of a float4 is in the block, not padding: the padding
// never reaches a reduction, the filter's recurrence, the echo line or an
// output.
template <class A>
__device__ __forceinline__ bool in_block(const A& a, int f) {
  return A::kWhole || f < a.F;
}
__device__ __forceinline__ float& at(float4& v, int e) {
  return reinterpret_cast<float*>(&v)[e];
}
__device__ __forceinline__ float4 splat(float x) { return make_float4(x, x, x, x); }

// torch.maximum / torch.minimum: a NaN in either operand propagates.
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ float nanmin(float a, float b) {
  return (a != a || a < b) ? a : b;
}
__device__ __forceinline__ int loud(float x) { return !(fabsf(x) < kQuiet); }

// core/smoother.py:smoother_set_and_process, for one value per instance.
struct Smooth {
  float target, last, x_eff, log_b;
  int status;
  bool active, settled;

  __device__ float ramp(int f) const {
    return x_eff + (last - x_eff) * expf(static_cast<float>(f + 1) * log_b);
  }
  // one value for every frame of the block
  __device__ bool flat() const { return settled || !active; }
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

// words: value (at v), target, last, status (at w, w + 1, w + 2); consts:
// a, log_b, eps
__device__ Smooth smoother(const Row& r, int v = 0, int w = 1) {
  const float val = wf(r, v);
  Smooth s;
  s.status = val != wf(r, w) ? kActive : static_cast<int>(word(r, w + 2));
  s.target = val;
  s.last = wf(r, w + 1);
  s.active = s.status == kActive;
  // x_eff = (val * a) / a as torch computes it on the card: its CUDA
  // division by a Python scalar multiplies by the scalar's f32 reciprocal
  s.x_eff = (val * cst(r, 0)) * __frcp_rn(cst(r, 0));
  s.log_b = cst(r, 1);
  s.settled = s.active && fabsf(val - s.ramp(0)) < cst(r, 2);
  return s;
}

// The new state at words w, w + 1, w + 2; `reset` holds the target flat
// (smoother_init).
__device__ void write_smoother(const Row& r, const Smooth& s, bool reset,
                               int frames, int w = 1) {
  set_wf(r, w, s.target);
  set_wf(r, w + 1, reset ? s.target : s.new_last(frames));
  word(r, w + 2) = reset ? kInactive : s.new_status();
}

// The smoother's values for frames 4q..4q+3 while it ramps: out of line,
// so that the flat path's code stays compact.
__device__ __noinline__ float4 value4(const Smooth& s, int q) {
  float4 v;
#pragma unroll
  for (int e = 0; e < 4; ++e) at(v, e) = s.value(4 * q + e);
  return v;
}

// True when every input buffer of the row is flagged silent; the row's
// lane j looks at input j (and j + span, ...), so the loads overlap.
__device__ bool all_silent(const Row& r, const Inst& I) {
  bool s = true;
  for (int base = 0; base < r.n_in; base += I.span) {
    const int j = base + I.sub;
    const unsigned b =
        __ballot_sync(kFull, j >= r.n_in || flag(I, in_buf(r, j)) != 0);
    s = s && (b & I.mask) == I.mask;
  }
  return s;
}

template <class A>
__device__ void op_dummy(const A& a, const Row& r, const Inst& I) {
  for (int q = I.sub; q < quads(a); q += I.span)
    for (int j = 0; j < r.n_out; ++j) frames4(a, I, out_buf(r, j), q) = splat(0.f);
  for (int j = I.sub; j < r.n_out; j += I.span) flag(I, out_buf(r, j)) = 0;
}

// words: enabled, inc, gain, phase (state)
template <class A>
__device__ void op_beep(const A& a, const Row& r, const Inst& I) {
  const bool en = word(r, 0) != 0;
  const uint32_t inc = word(r, 1);
  const float gain = wf(r, 2);
  const uint32_t ph = word(r, 3);
  for (int q = I.sub; q < quads(a); q += I.span) {
    float4 v = splat(0.f);
    if (en) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t p = ph + static_cast<uint32_t>(4 * q + e) * inc;
        // the signed phase in cycles, [-0.5, 0.5): _signed_phase
        const float x = static_cast<float>(static_cast<int32_t>(p)) * 0x1p-32f;
        at(v, e) = sinf(x * kTau) * gain;
      }
    }
    for (int j = 0; j < r.n_out; ++j) frames4(a, I, out_buf(r, j), q) = v;
  }
  __syncwarp();  // every lane has read the phase
  for (int j = I.sub; j < r.n_out; j += I.span) flag(I, out_buf(r, j)) = !en;
  if (I.sub == 0) word(r, 3) = en ? ph + static_cast<uint32_t>(a.F) * inc : ph;
}

// words: raw_gain, gain.{target, last, status}; consts: a, log_b, eps, mute
// In a group of rows, a row may write a buffer that another row of the
// group reads: every lane reads its inputs and their flags before the
// __syncwarp that precedes the writes.
template <class A>
__device__ void op_volume(const A& a, const Row& r, const Inst& I) {
  const Smooth s = smoother(r);
  const bool silent_in = all_silent(r, I);
  const bool muted = s.new_status() == kInactive && s.value(0) < cst(r, 3);
  const bool silence = silent_in || muted;
  const bool flag_mine =
      I.sub < r.n_in && (silence || flag(I, in_buf(r, I.sub)) != 0);
  const float4 flat = splat(s.value(0));
  // every lane takes as many steps as the row's first (the __syncwarp)
  for (int q0 = 0; q0 < quads(a); q0 += I.span) {
    const int q = q0 + I.sub;
    const bool mine = q < quads(a);
    float4 g = s.flat() || !mine ? flat : value4(s, q);
    for (int j = 0; j < r.n_in; j += 2) {  // two channels at a time
      const bool two = j + 1 < r.n_in;
      float4 x0 = flat, x1 = flat;
      if (mine) {
        x0 = frames4(a, I, in_buf(r, j), q);
        if (two) x1 = frames4(a, I, in_buf(r, j + 1), q);
      }
      __syncwarp();
      if (!mine) continue;
      float4 y0, y1;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        at(y0, e) = silence ? 0.f : at(x0, e) * at(g, e);
        at(y1, e) = silence ? 0.f : at(x1, e) * at(g, e);
      }
      frames4(a, I, out_buf(r, j), q) = y0;
      if (two) frames4(a, I, out_buf(r, j + 1), q) = y1;
    }
  }
  __syncwarp();  // every lane has read the smoother
  for (int j = I.sub; j < r.n_in; j += I.span)
    flag(I, out_buf(r, j)) =
        j == I.sub ? flag_mine : silence || flag(I, in_buf(r, j)) != 0;
  // all-silent resets the smoother (volume.rs:95-97); muted does not
  if (I.sub == 0) write_smoother(r, s, silent_in, a.F);
}

// ops/pan.py:equal_power_gains for one smoothed value.
__device__ __forceinline__ void pan_gains(float v, float& gl, float& gr) {
  const float theta = (v + 1.0f) * kQuarterPi;
  gl = cosf(theta);
  gr = sinf(theta);
}

// The pan law for frames 4q..4q+3 while the smoother ramps (out of line).
__device__ __noinline__ void pan_gains4(const Smooth& s, int q, float4& gl,
                                        float4& gr) {
#pragma unroll 1
  for (int e = 0; e < 4; ++e) pan_gains(s.value(4 * q + e), at(gl, e), at(gr, e));
}

// words: pan, pan.{target, last, status}; consts: a, log_b, eps
template <class A>
__device__ void op_pan(const A& a, const Row& r, const Inst& I) {
  const Smooth s = smoother(r);
  const bool silent_in = all_silent(r, I);
  float gl0, gr0;
  pan_gains(s.value(0), gl0, gr0);
  // every lane takes as many steps as the row's first (the __syncwarp)
  for (int q0 = 0; q0 < quads(a); q0 += I.span) {
    const int q = q0 + I.sub;
    const bool mine = q < quads(a);
    float4 x = splat(0.f);
    if (mine) {
      x = frames4(a, I, in_buf(r, 0), q);
      if (r.n_in != 1) {
        float4 x1 = frames4(a, I, in_buf(r, 1), q);
#pragma unroll
        for (int e = 0; e < 4; ++e) at(x, e) = (at(x, e) + at(x1, e)) * 0.5f;
      }
    }
    __syncwarp();  // a group's inputs are read before its outputs are written
    if (!mine) continue;
    float4 gl = splat(gl0), gr = splat(gr0), yl, yr;
    if (!s.flat()) pan_gains4(s, q, gl, gr);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      at(yl, e) = silent_in ? 0.f : at(x, e) * at(gl, e);
      at(yr, e) = silent_in ? 0.f : at(x, e) * at(gr, e);
    }
    frames4(a, I, out_buf(r, 0), q) = yl;
    frames4(a, I, out_buf(r, 1), q) = yr;
  }
  __syncwarp();  // every lane has read the smoother
  if (I.sub < 2) flag(I, out_buf(r, I.sub)) = silent_in;
  if (I.sub == 0) write_smoother(r, s, silent_in, a.F);
}

// out[ch] = in[ch] + in[m + ch] + ..., left to right
template <class A>
__device__ void op_sum(const A& a, const Row& r, const Inst& I) {
  const int m = r.n_out;
  const int ports = r.n_in / m;
  const bool silent_in = all_silent(r, I);
  for (int q = I.lane; q < quads(a); q += kLanes) {
    for (int ch = 0; ch < m; ++ch) {
      float4 v = frames4(a, I, in_buf(r, ch), q);
#pragma unroll 4
      for (int p = 1; p < ports; ++p) {
        const float4 x = frames4(a, I, in_buf(r, p * m + ch), q);
        v.x = v.x + x.x;
        v.y = v.y + x.y;
        v.z = v.z + x.z;
        v.w = v.w + x.w;
      }
      frames4(a, I, out_buf(r, ch), q) = silent_in ? splat(0.f) : v;
    }
  }
  __syncwarp();
  for (int ch = I.lane; ch < m; ch += kLanes)
    flag(I, out_buf(r, ch)) =
        ports == 1 ? silent_in || flag(I, in_buf(r, ch)) != 0 : silent_in;
}

// words: freq, q, gain_db (unread), z1 [C], z2 [C], coef [5] (derived)
template <class A>
__device__ void op_filter(const A& a, const Row& r, const Inst& I) {
  const int ch = r.n_in;
  // one lane per channel runs the recurrence over every frame
  for (int c = I.lane; c < ch; c += kLanes) {
    const int k = 3 + 2 * ch;
    const BiquadCoef bq = {wf(r, k), wf(r, k + 1), wf(r, k + 2), wf(r, k + 3),
                           wf(r, k + 4)};
    float z1 = wf(r, 3 + c);
    float z2 = wf(r, 3 + ch + c);
    // silent input with settled state stays silent; a ringing tail is audio
    const int x = in_buf(r, c), y = out_buf(r, c);
    const bool mask = flag(I, x) != 0 && fabsf(z1) < kQuiet && fabsf(z2) < kQuiet;
    for (int q = 0; q < quads(a); ++q) {
      float4 xv = frames4(a, I, x, q);
      float4 yv;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = 0.f;
        if (in_block(a, 4 * q + e)) v = biquad_step(bq, at(xv, e), z1, z2);
        at(yv, e) = mask ? 0.f : v;
      }
      frames4(a, I, y, q) = yv;
    }
    flag(I, y) = mask;
    set_wf(r, 3 + c, z1);
    set_wf(r, 3 + ch + c, z2);
  }
}

// The echo's line, oldest first, is line_in [C, D] at the chunk's start.
// Inside the chunk the logical line is line_in followed by the chunk's
// echoes, index j in [0, D + K*F).  Block k taps j = k*F + f, checks the
// window [k*F, k*F + D) and appends at j = D + k*F + f.  The final line is
// the window at k = K: j >= K*F lives in line_out at j - K*F, and an echo
// with j < K*F (only when K*F > D) lives in the scratch.  With D a multiple
// of 4 and every base 16-byte aligned (`vec`), the float4 at j = 4n never
// straddles two of the three parts.
struct EchoLine {
  const float* in;
  float* out;
  float* scratch;
  int64_t d, kf, zero_below;
  bool vec;
  __device__ float read(int64_t j) const {
    if (j < zero_below) return 0.f;
    if (j < d) return in[j];
    return j >= kf ? out[j - kf] : scratch[j - d];
  }
  __device__ void append(int64_t j, float v) const {
    if (j >= kf) out[j - kf] = v;
    else scratch[j - d] = v;
  }
  __device__ float4 read4(int64_t j) const {
    if (!vec || j < zero_below)
      return make_float4(read(j), read(j + 1), read(j + 2), read(j + 3));
    if (j < d) return *reinterpret_cast<const float4*>(in + j);
    return *reinterpret_cast<const float4*>(j >= kf ? out + (j - kf)
                                                    : scratch + (j - d));
  }
  __device__ void append4(int64_t j, float4 v) const {
    if (!vec) {
      append(j, v.x);
      append(j + 1, v.y);
      append(j + 2, v.z);
      append(j + 3, v.w);
      return;
    }
    *reinterpret_cast<float4*>(j >= kf ? out + (j - kf) : scratch + (j - d)) = v;
  }
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Channel c of an echo row's line, from its echo channel record.
template <class A>
__device__ EchoLine echo_line(const A& a, const Row& r, const Inst& I,
                              int c) {
  const EchoChannel& ec = echo_ch(I, r.aux1 + c);
  EchoLine e;
  e.in = ec.in;
  e.out = ec.out;
  e.scratch = ec.scratch;
  e.d = r.aux0;
  e.kf = static_cast<int64_t>(a.K) * a.F;
  e.zero_below = ec.zero_below;
  e.vec = ec.vec != 0;
  return e;
}

__device__ __forceinline__ int loud_q(float x, float q) { return !(fabsf(x) < q); }

// The rows with a line in device memory: the line's leaf (after the row's
// first) and which of its samples are loud: at or over 1e-10 (1e-12 for the
// pitch ring), or, for the limiter's dry line, not exactly 0
// (nodes/dynamics.py: `(delay == 0.0).all()`).  A NaN is loud.
__device__ __forceinline__ int line_leaf(int op) {
  switch (op) {
    case kEcho: return 3;
    case kModDelay: return 6;
    case kDelayComp: return 0;
    default: return 2;  // kPitch, kLimiter
  }
}
__device__ __forceinline__ int line_loud(int op, float x) {
  if (op == kLimiter) return x != 0.f;
  return loud_q(x, op == kPitch ? kRingQuiet : kQuiet);
}
__device__ __forceinline__ bool has_line(int op) {
  return op == kEcho || op == kModDelay || op == kPitch || op == kLimiter ||
         op == kDelayComp;
}

// Once per chunk, for each channel of a row with a line (has_line): its
// line's pointers into the instance's echo channel record; the count of
// loud samples of the line; the copy of the part of line_in that the final
// line keeps.  The line [C, D] stays in device memory (leaf slot +
// line_leaf); aux0 = D, aux1 = the row's first echo channel.
template <class A>
__device__ void echo_begin(const A& a, const Row& r, const Inst& I) {
  const int64_t d = r.aux0;
  const int64_t n_line = static_cast<int64_t>(r.n_in) * d;
  const int line = r.slot + line_leaf(r.op);
  for (int c = 0; c < r.n_in; ++c) {
    EchoLine e;
    e.in = reinterpret_cast<const float*>(a.ptrs[2 * line]) + I.i * n_line + c * d;
    e.out = reinterpret_cast<float*>(a.ptrs[2 * line + 1]) + I.i * n_line + c * d;
    e.scratch = a.scratch + (I.i * a.echo_channels + r.aux1 + c) * a.stride;
    e.d = d;
    e.kf = static_cast<int64_t>(a.K) * a.F;
    e.zero_below = 0;
    // the float4 at j = k*F + 4q is aligned only when F % 4 == 0
    e.vec = (A::kWhole || a.F % 4 == 0) && d % 4 == 0 && aligned16(e.in) &&
            aligned16(e.out) && aligned16(e.scratch);
    int n = 0;
    if (e.vec) {
      const float4* in = reinterpret_cast<const float4*>(e.in);
      float4* out = reinterpret_cast<float4*>(e.out);
      const int64_t d4 = e.d / 4, kf4 = e.kf / 4;
#pragma unroll 4
      for (int64_t q = I.lane; q < d4; q += kLanes) {
        const float4 x = in[q];
        n += line_loud(r.op, x.x) + line_loud(r.op, x.y) + line_loud(r.op, x.z) +
             line_loud(r.op, x.w);
        if (q >= kf4) out[q - kf4] = x;
      }
    } else {
      for (int64_t j = I.lane; j < e.d; j += kLanes) {
        const float x = e.in[j];
        n += line_loud(r.op, x);
        if (j >= e.kf) e.out[j - e.kf] = x;
      }
    }
    n = __reduce_add_sync(kFull, n);
    if (I.lane == 0) {
      EchoChannel& ec = echo_ch(I, r.aux1 + c);
      ec.count = n;
      ec.zero_below = 0;
      ec.vec = e.vec;
      ec.in = e.in;
      ec.out = e.out;
      ec.scratch = e.scratch;
    }
  }
}

// Two channels at a time: both taps are in flight together.
template <class A>
__device__ void op_echo(const A& a, const Row& r, const Inst& I, int k) {
  const float fb = wf(r, 0);
  const float wet = wf(r, 1);
  const float dry = wf(r, 2);
  for (int c0 = 0; c0 < r.n_in; c0 += 2) {
    int delta[2] = {0, 0};
    bool mask[2] = {false, false};
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int c = c0 + cc;
      if (c >= r.n_in) break;
      const EchoLine e = echo_line(a, r, I, c);
      const int x_buf = in_buf(r, c), y_buf = out_buf(r, c);
      // the window before this block
      mask[cc] = flag(I, x_buf) != 0 && echo_ch(I, r.aux1 + c).count == 0;
      for (int q = I.lane; q < quads(a); q += kLanes) {
        const int64_t j = static_cast<int64_t>(k) * a.F + 4 * q;
        // the last float4 of a block of F % 4 != 0 frames taps and appends
        // only its frames in the block
        const bool whole = in_block(a, 4 * q + 3);
        float4 x = frames4(a, I, x_buf, q);
        float4 delayed = splat(0.f);
        if (whole) {
          delayed = e.read4(j);
        } else {
          for (int s = 0; in_block(a, 4 * q + s); ++s) at(delayed, s) = e.read(j + s);
        }
        float4 echo, y;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          at(echo, s) = at(x, s) + fb * at(delayed, s);
          at(y, s) = mask[cc] ? 0.f : dry * at(x, s) + wet * at(delayed, s);
          if (in_block(a, 4 * q + s))
            delta[cc] += loud(at(echo, s)) - loud(at(delayed, s));
        }
        if (whole) {
          e.append4(e.d + j, echo);
        } else {
          for (int s = 0; in_block(a, 4 * q + s); ++s) e.append(e.d + j + s, at(echo, s));
        }
        frames4(a, I, y_buf, q) = y;
      }
    }
    delta[0] = __reduce_add_sync(kFull, delta[0]);
    delta[1] = __reduce_add_sync(kFull, delta[1]);
    __syncwarp();  // every lane has read the counts and the flags
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      if (I.lane == cc && c0 + cc < r.n_in) {
        echo_ch(I, r.aux1 + c0 + cc).count += delta[cc];
        flag(I, out_buf(r, c0 + cc)) = mask[cc];
      }
    }
  }
}

// words: threshold, clip_count (int32 state)
template <class A>
__device__ void op_clip(const A& a, const Row& r, const Inst& I) {
  const float th = wf(r, 0);
  int over = 0;
  for (int q = I.lane; q < quads(a); q += kLanes) {
#pragma unroll 2
    for (int j = 0; j < r.n_in; ++j) {
      const int b = in_buf(r, j);
      float4 x = frames4(a, I, b, q);
      const bool audible = flag(I, b) == 0;
      float4 y;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        at(y, e) = nanmax(nanmin(at(x, e), th), -th);
        // strictly over the threshold, on audible channels only
        over += (fabsf(at(x, e)) > th) && audible && in_block(a, 4 * q + e);
      }
      frames4(a, I, out_buf(r, j), q) = y;
    }
  }
  over = __reduce_add_sync(kFull, over);
  __syncwarp();
  for (int j = I.lane; j < r.n_in; j += kLanes)
    flag(I, out_buf(r, j)) = flag(I, in_buf(r, j));
  if (I.lane == 0) word(r, 1) += static_cast<uint32_t>(over);
}

// words: peak [C], rms_sq [C] (state); consts: peak decay, rms alpha.
// kSink: the meter as a graph sink (nodes/meter.py:_SinkMeterProcessor, no
// outputs).
template <class A, bool kSink = false>
__device__ void op_meter(const A& a, const Row& r, const Inst& I) {
  const int ch = r.n_in;
  for (int c = 0; c < ch; ++c) {
    float peak = 0.f;
    float sq = 0.f;
    const int x_buf = in_buf(r, c);
    for (int q = I.lane; q < quads(a); q += kLanes) {
      float4 x = frames4(a, I, x_buf, q);
      if constexpr (!kSink) frames4(a, I, out_buf(r, c), q) = x;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!in_block(a, 4 * q + e)) continue;
        peak = nanmax(peak, fabsf(at(x, e)));
        sq += at(x, e) * at(x, e);
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      peak = nanmax(peak, __shfl_xor_sync(kFull, peak, o));
      sq += __shfl_xor_sync(kFull, sq, o);
    }
    if (I.lane == 0) {
      const float p0 = wf(r, c);
      const float r0 = wf(r, ch + c);
      set_wf(r, c, nanmax(peak, p0 * cst(r, 0)));
      const float ms = sq / static_cast<float>(a.F);
      set_wf(r, ch + c, r0 + cst(r, 1) * (ms - r0));
    }
  }
  __syncwarp();
  if constexpr (!kSink)
    for (int c = I.lane; c < ch; c += kLanes)
      flag(I, out_buf(r, c)) = flag(I, in_buf(r, c));
}

// words: gain, pan, lp_b (params); gain.{target, last, status},
// pan.{target, last, status}, lp (state); consts: a, log_b, eps (both
// smoothers').  mono in → x·gain → the one-pole y = (1-b)·x + b·y_prev →
// equal-power pan → L/R.  The one-pole runs on one lane over the block
// with biquad_step's rounding, (b0, b1, b2, a1, a2) = (1-b, 0, 0, -b, 0)
// and z1 = b·lp: each step is y = fma(1-b, x, b·y_prev), what the plain
// versions compute through the sequential biquad
// (nodes/spatial.py:one_pole_seq).  The other lanes wait at the
// __syncwarp.  Silent only when the input is silent and the lowpass tail
// is quiet (nodes/spatial.py:_kernel).
template <class A>
__device__ void op_spatial(const A& a, const Row& r, const Inst& I) {
  const Smooth g = smoother(r, 0, 3);
  const Smooth p = smoother(r, 1, 6);
  const float b = wf(r, 2);
  const float lp = wf(r, 9);
  const bool silent = all_silent(r, I) && !(fabsf(lp) >= kQuiet);
  const int x_buf = in_buf(r, 0), l_buf = out_buf(r, 0), r_buf = out_buf(r, 1);
  // x·gain into the left output (the input may share its buffer)
  const float4 flat = splat(g.value(0));
  for (int q = I.lane; q < quads(a); q += kLanes) {
    float4 gv = g.flat() ? flat : value4(g, q);
    float4 x = frames4(a, I, x_buf, q);
    float4 y;
#pragma unroll
    for (int e = 0; e < 4; ++e) at(y, e) = at(x, e) * at(gv, e);
    frames4(a, I, l_buf, q) = y;
  }
  __syncwarp();
  if (I.lane == 0) {
    const BiquadCoef c = {1.0f - b, 0.f, 0.f, -b, 0.f};
    float z1 = b * lp, z2 = 0.f, y = lp;
    for (int f = 0; f < a.F; ++f) {
      y = biquad_step(c, frame(a, I, l_buf, f), z1, z2);
      frame(a, I, l_buf, f) = y;
    }
    set_wf(r, 9, silent ? 0.f : y);
  }
  __syncwarp();
  float gl0, gr0;
  pan_gains(p.value(0), gl0, gr0);
  for (int q = I.lane; q < quads(a); q += kLanes) {
    float4 y = frames4(a, I, l_buf, q);
    float4 gl = splat(gl0), gr = splat(gr0), yl, yr;
    if (!p.flat()) pan_gains4(p, q, gl, gr);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      at(yl, e) = silent ? 0.f : at(y, e) * at(gl, e);
      at(yr, e) = silent ? 0.f : at(y, e) * at(gr, e);
    }
    frames4(a, I, l_buf, q) = yl;
    frames4(a, I, r_buf, q) = yr;
  }
  __syncwarp();  // every lane has read the smoothers
  if (I.lane < 2) flag(I, out_buf(r, I.lane)) = silent;
  if (I.lane == 0) {
    write_smoother(r, g, silent, a.F, 3);
    write_smoother(r, p, silent, a.F, 6);
  }
}

// -- the FX palette's rows -----------------------------------------------------
// Each computes what its node's eager kernel computes on the card, op for
// op: every f32 operation rounds as the torch op does (the nodes divide by
// tensors, so a division is IEEE's here too), torch.remainder is fmodf with
// the divisor's sign, and the scans are K7's (assoc_scan.cuh).  Lanes run over frames; a recurrence that is
// sequential in its node (the gate's latch) runs on lane 0.

// torch.remainder(x, m) for m > 0 on the card: fmod, moved up by m when
// negative
__device__ __forceinline__ float remainder_pos(float x, float m) {
  float r = fmodf(x, m);
  if (r != 0.f && r < 0.f) r += m;
  return r;
}

// nodes/mod_effects.py:_lfo_phases: frame f's phase of the channel whose
// offset (spread·c / C) is `offs`
__device__ __forceinline__ float lfo_phase(float phase, float rate, float offs,
                                           int f) {
  return remainder_pos(phase + static_cast<float>(f + 1) * rate + offs, 1.0f);
}

// The row's scratch in shared memory: one row of frames, then the scan's
// levels (executor_mega.scan_words).
template <class A>
__device__ __forceinline__ float* scan_row(const A& a, const Inst& I) {
  return &s_float(I.scan);
}
template <class A, class E>
__device__ __forceinline__ E* scan_levels(const A& a, const Inst& I) {
  return reinterpret_cast<E*>(&s_float(I.scan + pitch(a)));
}

// nodes/channel.py: MonoToStereoNode, channel 0 to both outputs
template <class A>
__device__ void op_mono_to_stereo(const A& a, const Row& r, const Inst& I) {
  const bool silent = flag(I, in_buf(r, 0)) != 0;
  for (int f = I.lane; f < a.F; f += kLanes) {
    const float y = silent ? 0.f : frame(a, I, in_buf(r, 0), f);
    frame(a, I, out_buf(r, 0), f) = y;
    frame(a, I, out_buf(r, 1), f) = y;
  }
  __syncwarp();
  if (I.lane < 2) flag(I, out_buf(r, I.lane)) = silent;
}

// nodes/channel.py: StereoToMonoNode, (L + R)·0.5
template <class A>
__device__ void op_stereo_to_mono(const A& a, const Row& r, const Inst& I) {
  const bool silent = all_silent(r, I);
  for (int f = I.lane; f < a.F; f += kLanes) {
    const float m = (frame(a, I, in_buf(r, 0), f) + frame(a, I, in_buf(r, 1), f)) * 0.5f;
    frame(a, I, out_buf(r, 0), f) = silent ? 0.f : m;
  }
  __syncwarp();
  if (I.lane == 0) flag(I, out_buf(r, 0)) = silent;
}

// nodes/stereo_width.py.  words: width, width.{target, last, status};
// consts: a, log_b, eps.  Mid/side with the smoothed width on the side; an
// all-silent block resets the smoother to its target.
template <class A>
__device__ void op_width(const A& a, const Row& r, const Inst& I) {
  const Smooth s = smoother(r);
  const bool silent = all_silent(r, I);
  for (int f = I.lane; f < a.F; f += kLanes) {
    const float l = frame(a, I, in_buf(r, 0), f), rr = frame(a, I, in_buf(r, 1), f);
    const float mid = (l + rr) * 0.5f;
    const float side = ((l - rr) * 0.5f) * s.value(f);
    frame(a, I, out_buf(r, 0), f) = silent ? 0.f : mid + side;
    frame(a, I, out_buf(r, 1), f) = silent ? 0.f : mid - side;
  }
  __syncwarp();  // every lane has read the smoother
  if (I.lane < 2) flag(I, out_buf(r, I.lane)) = silent;
  if (I.lane == 0) write_smoother(r, s, silent, a.F);
}

// nodes/mod_effects.py:TremoloProcessor.  words: rate, depth, spread,
// phase (state); aux0: bipolar (ring modulation).
template <class A>
__device__ void op_tremolo(const A& a, const Row& r, const Inst& I) {
  const float rate = wf(r, 0), depth = wf(r, 1), spread = wf(r, 2);
  const float phase = wf(r, 3);
  for (int c = 0; c < r.n_in; ++c) {
    const float offs = (spread * static_cast<float>(c)) / static_cast<float>(r.n_in);
    const int x = in_buf(r, c), y = out_buf(r, c);
    const bool silent = flag(I, x) != 0;
    for (int f = I.lane; f < a.F; f += kLanes) {
      const float carrier = cosf(kTau * lfo_phase(phase, rate, offs, f));
      const float g = r.aux0 ? (1.0f - depth) + depth * carrier
                             : 1.0f - depth * (0.5f - 0.5f * carrier);
      const float v = frame(a, I, x, f) * g;
      frame(a, I, y, f) = silent ? 0.f : v;
    }
  }
  __syncwarp();  // every lane has read the phase
  for (int c = I.lane; c < r.n_in; c += kLanes)
    flag(I, out_buf(r, c)) = flag(I, in_buf(r, c));
  if (I.lane == 0)
    set_wf(r, 3, remainder_pos(phase + static_cast<float>(a.F) * rate, 1.0f));
}

// nodes/waveshaper.py:_shape, the curves in SHAPES' order
__device__ __forceinline__ float shape(int curve, float v) {
  switch (curve) {
    case 0: return tanhf(v);
    case 1: return kTwoOverPi * atanf(v);
    case 2: {
      const float t = nanmin(nanmax(v, -1.0f), 1.0f);
      return 1.5f * t - 0.5f * t * t * t;
    }
    case 3: return nanmin(nanmax(v, -1.0f), 1.0f);
    default: return fabsf(remainder_pos(v - 1.0f, 4.0f) - 2.0f) - 1.0f;
  }
}

// The DC blocker's leaves: the one-pole map (R, 1·Δx) of x = the shaped
// block after its last sample x1 (ops/iir.py:one_pole_scan(Δx, y1, 1, R)).
struct DcLeaves {
  const float* x;
  float x1, r;
  __device__ __forceinline__ scan::Affine1 operator()(int p) const {
    return scan::Affine1{r, 1.0f * (x[p] - (p ? x[p - 1] : x1))};
  }
};

// nodes/waveshaper.py.  words: drive, out, mix; with the DC blocker x1 [C],
// y1 [C] (state); aux0: the curve, aux1: the DC blocker; consts: its pole
// R.  The blocker is the one-pole scan of K7 on the shaped block in the
// scratch row; a silent input still drains its tail.
template <class A>
__device__ void op_waveshaper(const A& a, const Row& r, const Inst& I) {
  const float drive = wf(r, 0), gain = wf(r, 1), mix = wf(r, 2);
  const int ch = r.n_in;
  float* shaped = scan_row(a, I);
  scan::Affine1* lv = scan_levels<A, scan::Affine1>(a, I);
  for (int c = 0; c < ch; ++c) {
    const int xb = in_buf(r, c), yb = out_buf(r, c);
    if (!r.aux1) {
      const bool silent = flag(I, xb) != 0;
      for (int f = I.lane; f < a.F; f += kLanes) {
        const float x = frame(a, I, xb, f);
        const float v = (x + mix * (shape(r.aux0, x * drive) - x)) * gain;
        frame(a, I, yb, f) = silent ? 0.f : v;
      }
      __syncwarp();
      if (I.lane == 0) flag(I, yb) = silent;
      continue;
    }
    const float x1 = wf(r, 3 + c), y1 = wf(r, 3 + ch + c);
    const bool silent = flag(I, xb) != 0 && fabsf(x1) < kQuiet && fabsf(y1) < kQuiet;
    for (int f = I.lane; f < a.F; f += kLanes)
      shaped[f] = shape(r.aux0, frame(a, I, xb, f) * drive);
    __syncwarp();
    const DcLeaves leaf{shaped, x1, cst(r, 0)};
    scan::sweep(lv, a.F, leaf, I.lane);
    float y_last = 0.f;
    for (int p = I.lane; p < a.F; p += kLanes) {
      const scan::Affine1 m = scan::level0(lv, p, leaf);
      const float dc = scan::fma64(m.m, y1, m.v);
      const float x = frame(a, I, xb, p);
      const float v = (x + mix * (dc - x)) * gain;
      frame(a, I, yb, p) = silent ? 0.f : v;
      if (p == a.F - 1) y_last = dc;
    }
    const float x_last = shaped[a.F - 1];
    __syncwarp();  // every lane has read the state, the levels and the row
    if ((a.F - 1) % kLanes == I.lane) {
      set_wf(r, 3 + c, x_last);
      set_wf(r, 3 + ch + c, y_last);
      flag(I, yb) = silent;
    }
    __syncwarp();
  }
}

// The loudest of inputs [c0, c1)'s |x| at frame f: torch's amax over the
// channels (a NaN propagates).
template <class A>
__device__ __forceinline__ float channel_level(const A& a, const Row& r, const Inst& I,
                                               int c0, int c1, int f) {
  float lvl = fabsf(frame(a, I, in_buf(r, c0), f));
  for (int c = c0 + 1; c < c1; ++c) lvl = nanmax(lvl, fabsf(frame(a, I, in_buf(r, c), f)));
  return lvl;
}

// nodes/dynamics.py:GateProcessor.  words: open_lin, close_lin, floor,
// att_b, rel_b, hold_n; open, hold, gain (state).  Lane 0 runs the latch
// over the loudest channel's |x| as K5 does (csrc/sample_scan.cu, kGate)
// into the scratch row; the lanes then apply the gains.
template <class A>
__device__ void op_gate(const A& a, const Row& r, const Inst& I) {
  float* gains = scan_row(a, I);
  if (I.lane == 0) {
    const float open_lin = wf(r, 0), close_lin = wf(r, 1), floor_gain = wf(r, 2);
    const float att = wf(r, 3), rel = wf(r, 4), hold_n = wf(r, 5);
    float opn = wf(r, 6), hold = wf(r, 7), g = wf(r, 8);
    for (int f = 0; f < a.F; ++f) {
      const float lvl = channel_level(a, r, I, 0, r.n_in, f);
      const bool above = lvl >= open_lin;
      const bool below = lvl < close_lin;
      const bool expired = hold <= 0.0f;
      opn = above ? 1.0f : ((below && expired) ? 0.0f : opn);
      hold = above ? hold_n : nanmax(hold - 1.0f, 0.0f);
      const float target = opn + (1.0f - opn) * floor_gain;
      const float b = target > g ? att : rel;
      g = fmaf(b, g, (1.0f - b) * target);
      gains[f] = g;
    }
    set_wf(r, 6, opn);
    set_wf(r, 7, hold);
    set_wf(r, 8, g);
  }
  __syncwarp();
  for (int c = 0; c < r.n_in; ++c) {
    const bool silent = flag(I, in_buf(r, c)) != 0;
    for (int f = I.lane; f < a.F; f += kLanes) {
      const float v = frame(a, I, in_buf(r, c), f) * gains[f];
      frame(a, I, out_buf(r, c), f) = silent ? 0.f : v;
    }
  }
  __syncwarp();
  for (int c = I.lane; c < r.n_in; c += kLanes)
    flag(I, out_buf(r, c)) = flag(I, in_buf(r, c));
}

// One K7 biquad section (assoc_scan.cuh) over the F frames at x, as K7
// runs a row: emit(f, y) for every frame f, and the final state into
// (z1, z2) on the lane that holds frame F - 1, which returns true.  The
// EQ's bands and the loudness meter's K-weighting.
template <class A, class Emit>
__device__ bool k7_section(const A& a, const Inst& I, const float* x,
                           const BiquadCoef& c, float& z1, float& z2,
                           scan::Affine2* lv, Emit emit) {
  const scan::BiquadLeaves leaf{x, -c.a1, -c.a2, c.b1 - c.a1 * c.b0,
                                c.b2 - c.a2 * c.b0};
  scan::sweep(lv, a.F, leaf, I.lane);
  const float zp1 = z1, zp2 = z2;
  bool last = false;
  if (I.lane == 0) emit(0, c.b0 * x[0] + zp1);
  for (int p = I.lane; p < a.F; p += kLanes) {
    const scan::Affine2 m = scan::level0(lv, p, leaf);
    const float n1 = m.p11 * zp1 + m.p12 * zp2 + m.q1;
    const float n2 = m.p21 * zp1 + m.p22 * zp2 + m.q2;
    if (p + 1 < a.F) {
      emit(p + 1, c.b0 * x[p + 1] + n1);
    } else {
      z1 = n1;
      z2 = n2;
      last = true;
    }
  }
  __syncwarp();  // every lane has read the levels and x
  return last;
}

// nodes/eq.py.  words: each band's b0, b1, b2, a1, a2 (params), then each
// band's z1 [C], z2 [C] (state); aux0: bands.  Each band of each channel is
// one K7 section (k7_section): band 0 reads the input buffer, a later band a
// copy of the output buffer in the scratch row.  A channel is silent when
// its input is and every band's state was quiet.
template <class A>
__device__ void op_eq(const A& a, const Row& r, const Inst& I) {
  const int ch = r.n_in, bands = r.aux0;
  float* copy = scan_row(a, I);
  scan::Affine2* lv = scan_levels<A, scan::Affine2>(a, I);
  for (int c = 0; c < ch; ++c) {
    const int xb = in_buf(r, c), yb = out_buf(r, c);
    float* y = &frame(a, I, yb, 0);
    bool quiet = true;
    for (int i = 0; i < bands; ++i) {
      const int zw = 5 * bands + 2 * ch * i;
      float z1 = wf(r, zw + c), z2 = wf(r, zw + ch + c);
      quiet = quiet && fabsf(z1) < kQuiet && fabsf(z2) < kQuiet;
      const float* x = &frame(a, I, xb, 0);
      if (i > 0) {
        for (int f = I.lane; f < a.F; f += kLanes) copy[f] = y[f];
        __syncwarp();
        x = copy;
      }
      const BiquadCoef bq = {wf(r, 5 * i), wf(r, 5 * i + 1), wf(r, 5 * i + 2),
                             wf(r, 5 * i + 3), wf(r, 5 * i + 4)};
      if (k7_section(a, I, x, bq, z1, z2, lv, [&](int f, float v) { y[f] = v; })) {
        set_wf(r, zw + c, z1);
        set_wf(r, zw + ch + c, z2);
      }
      __syncwarp();
    }
    const bool silent = flag(I, xb) != 0 && quiet;
    if (silent)
      for (int f = I.lane; f < a.F; f += kLanes) y[f] = 0.f;
    __syncwarp();
    if (I.lane == 0) flag(I, yb) = silent;
  }
}

// The lines of the mod delay and the pitch shifter, as the echo's
// (EchoLine): block k's line before it is logical [k·F, k·F + W), its
// samples are appended at W + k·F.  Index i of cat(line, x) (the mod
// delay's seq; the pitch ring after this block's write is i + F) reads
// the block's own input from the arena.
template <class A>
__device__ __forceinline__ float seq_at(const A& a, const Inst& I, const EchoLine& e,
                                        int xb, int k, int w, int i) {
  return i >= w ? frame(a, I, xb, i - w)
                : e.read(static_cast<int64_t>(k) * a.F + i);
}

// nodes/mod_effects.py:ModDelayProcessor without feedback.  words: rate,
// base, depth, mix, spread, feedback (unread), phase (state); the line
// [C, W] (leaf slot + 6) stays in device memory; aux0 = W, aux1 = the
// row's first echo channel.  The tap interpolates cat(line,
// x) at W + f − delay; a channel is silent when its input is and its line
// was quiet.
template <class A>
__device__ void op_mod_delay(const A& a, const Row& r, const Inst& I, int k) {
  const float rate = wf(r, 0), base = wf(r, 1), depth = wf(r, 2), mix = wf(r, 3);
  const float spread = wf(r, 4), phase = wf(r, 6);
  const int w = r.aux0;
  for (int c = 0; c < r.n_in; ++c) {
    const EchoLine e = echo_line(a, r, I, c);
    const int xb = in_buf(r, c), yb = out_buf(r, c);
    const bool silent = flag(I, xb) != 0 && echo_ch(I, r.aux1 + c).count == 0;
    const float offs = (spread * static_cast<float>(c)) / static_cast<float>(r.n_in);
    int delta = 0;
    for (int f = I.lane; f < a.F; f += kLanes) {
      const float ph = lfo_phase(phase, rate, offs, f);
      const float d = base + depth * (0.5f - 0.5f * cosf(kTau * ph));
      const float pos = (static_cast<float>(w) + static_cast<float>(f)) - d;
      const float i0 = floorf(pos);
      const float frac = pos - i0;
      const int i = static_cast<int>(i0);
      const float s0 = seq_at(a, I, e, xb, k, w, i);
      const float s1 = seq_at(a, I, e, xb, k, w, i + 1);
      const float tap = s0 + (s1 - s0) * frac;
      const float x = frame(a, I, xb, f);
      frame(a, I, yb, f) = silent ? 0.f : x + mix * (tap - x);
      // the line drops seq index f and appends x at W + f
      delta += loud(x) - loud(seq_at(a, I, e, xb, k, w, f));
      e.append(w + static_cast<int64_t>(k) * a.F + f, x);
    }
    delta = __reduce_add_sync(kFull, delta);
    __syncwarp();  // every lane has read the count and the flag
    if (I.lane == 0) {
      echo_ch(I, r.aux1 + c).count += delta;
      flag(I, yb) = silent;
    }
  }
  __syncwarp();
  if (I.lane == 0)
    set_wf(r, 6, remainder_pos(phase + static_cast<float>(a.F) * rate, 1.0f));
}

// nodes/pitch_shift.py.  words: ratio, mix, phase (state); the ring [C, W]
// (leaf slot + 2) stays in device memory; aux0 = W, aux1 = the row's first
// echo channel.  Two taps half a wrap cycle apart read the
// ring after this block's write; an all-silent block with a quiet ring
// zeroes the ring (zero_below, and the final line's part in line_out) and
// the phase.
template <class A>
__device__ void op_pitch(const A& a, const Row& r, const Inst& I, int k) {
  const float ratio = wf(r, 0), mix = wf(r, 1), phase = wf(r, 2);
  const int w = r.aux0;
  const float span = static_cast<float>(w - w / 8);
  const float dphase = (1.0f - ratio) / span;
  bool silent = all_silent(r, I);
  for (int c = 0; c < r.n_in; ++c) silent = silent && echo_ch(I, r.aux1 + c).count == 0;
  float phase_last = 0.f;
  for (int c = 0; c < r.n_in; ++c) {
    const EchoLine e = echo_line(a, r, I, c);
    const int xb = in_buf(r, c), yb = out_buf(r, c);
    int delta = 0;
    for (int f = I.lane; f < a.F; f += kLanes) {
      const float t = static_cast<float>(f + 1);
      const float pa = remainder_pos(phase + t * dphase, 1.0f);
      const float pb = remainder_pos(pa + 0.5f, 1.0f);
      const float now = (static_cast<float>(w - a.F) + t) - 1.0f;
      float shifted = 0.f;
#pragma unroll
      for (int tap = 0; tap < 2; ++tap) {
        const float ph = tap ? pb : pa;
        const float pos = now - ph * span;
        const float i0 = floorf(pos);
        const float frac = pos - i0;
        const int i = static_cast<int>(i0);
        const int i1 = min(i + 1, w - 1);
        // the ring after the write: ring index i is seq index i + F
        const float s0 = seq_at(a, I, e, xb, k, w, i + a.F);
        const float s1 = seq_at(a, I, e, xb, k, w, i1 + a.F);
        const float v = (s0 + (s1 - s0) * frac) * (1.0f - fabsf(2.0f * ph - 1.0f));
        shifted = tap ? shifted + v : v;
      }
      const float x = frame(a, I, xb, f);
      frame(a, I, yb, f) = silent ? 0.f : x + mix * (shifted - x);
      if (f == a.F - 1) phase_last = pa;
      if (!silent) {
        delta += loud_q(x, kRingQuiet) - loud_q(seq_at(a, I, e, xb, k, w, f), kRingQuiet);
        e.append(w + static_cast<int64_t>(k) * a.F + f, x);
      }
    }
    delta = __reduce_add_sync(kFull, delta);
    const int64_t top = static_cast<int64_t>(k + 1) * a.F + w;
    if (silent) {  // the ring after this block is zeros: logical [top - W, top)
      const int64_t from = top - w > e.kf ? top - w : e.kf;
      for (int64_t j = from + I.lane; j < top; j += kLanes)
        e.out[j - e.kf] = 0.f;
    }
    __syncwarp();  // every lane has read the counts and the flags
    if (I.lane == 0) {
      EchoChannel& ec = echo_ch(I, r.aux1 + c);
      ec.count = silent ? 0 : ec.count + delta;
      if (silent) ec.zero_below = top;
      flag(I, yb) = silent;
    }
  }
  __syncwarp();
  if ((a.F - 1) % kLanes == I.lane) set_wf(r, 2, silent ? 0.f : phase_last);
}

// -- the mastering bus's rows ---------------------------------------------------
// The compressor, ducker, limiter, loudness meter, LFO, delay compensator
// and the sink meter (examples/mastering_bus.py and the latency pass), each
// its eager kernel's ops as torch rounds them on the card: log10f and powf
// are the precise ones torch calls, a division by a Python number is a
// product with its float32 reciprocal, a clamp propagates a NaN.  The
// sample recurrences (envelope, release) run on lane 0 as K5 runs them
// (csrc/sample_scan.cu) into the row's scratch; the lanes then apply the
// gains.

// ops/dynamics.py:envelope_follow on lane 0 (K5's kEnvelope) over the level
// of inputs [c0, c1): env[f] into `env_row`; returns the last.
template <class A>
__device__ float envelope_row(const A& a, const Row& r, const Inst& I, int c0, int c1,
                              float env, float att, float rel, float* env_row) {
  for (int f = 0; f < a.F; ++f) {
    const float v = channel_level(a, r, I, c0, c1, f);
    const float b = v > env ? att : rel;
    env = fmaf(b, env, (1.0f - b) * v);
    env_row[f] = env;
  }
  return env;
}

// nodes/dynamics.py:_gain_to_db and _db_to_gain
__device__ __forceinline__ float gain_to_db(float amp) { return 20.0f * log10f(amp); }
__device__ __forceinline__ float db_to_gain(float db) { return powf(10.0f, 0.05f * db); }

// ops/dynamics.py:compressor_gain_db, op for op (1.0 / ratio is torch's
// reciprocal times 1.0)
__device__ __forceinline__ float compressor_gain_db(float level_db, float threshold,
                                                    float ratio, float knee) {
  const float over = level_db - threshold;
  const float slope = (1.0f / ratio) * 1.0f - 1.0f;
  const float half_knee = knee * 0.5f;
  const float in_knee = nanmin(nanmax(over + half_knee, 0.0f), knee);
  const float knee_gain = slope * in_knee * in_knee / (2.0f * nanmax(knee, kKneeFloor));
  const float hard = slope * over;
  return over <= -half_knee ? 0.0f : (over >= half_knee ? hard : knee_gain);
}

// Each input c's frames times gains[f] into output c, zeroed where input c
// is silent; the outputs' flags are the inputs'.
template <class A>
__device__ void apply_gains(const A& a, const Row& r, const Inst& I, int channels,
                            const float* gains) {
  for (int c = 0; c < channels; ++c) {
    const bool silent = flag(I, in_buf(r, c)) != 0;
    for (int f = I.lane; f < a.F; f += kLanes) {
      const float v = frame(a, I, in_buf(r, c), f) * gains[f];
      frame(a, I, out_buf(r, c), f) = silent ? 0.f : v;
    }
  }
  __syncwarp();
  for (int c = I.lane; c < channels; c += kLanes)
    flag(I, out_buf(r, c)) = flag(I, in_buf(r, c));
}

// nodes/dynamics.py:CompressorProcessor.  words: threshold_db, ratio,
// knee_db, makeup, att_b, rel_b; env (state).  The envelope of the loudest
// channel, the soft-knee gain in dB, then 10^(gain/20)·makeup.
template <class A>
__device__ void op_compressor(const A& a, const Row& r, const Inst& I) {
  float* g = scan_row(a, I);
  if (I.lane == 0)
    set_wf(r, 6, envelope_row(a, r, I, 0, r.n_in, wf(r, 6), wf(r, 4), wf(r, 5), g));
  __syncwarp();
  const float threshold = wf(r, 0), ratio = wf(r, 1), knee = wf(r, 2), makeup = wf(r, 3);
  for (int f = I.lane; f < a.F; f += kLanes)
    g[f] = db_to_gain(compressor_gain_db(gain_to_db(g[f]), threshold, ratio, knee)) *
           makeup;
  __syncwarp();
  apply_gains(a, r, I, r.n_in, g);
}

// nodes/dynamics.py:DuckerProcessor.  words: threshold_db, duck_db, att_b,
// rel_b; env (state).  The sidechain (inputs n_out..) drives the envelope;
// the duck depth applies through a 10 dB soft region below the threshold
// to the main inputs (0..n_out), whose flags are the outputs'.
template <class A>
__device__ void op_ducker(const A& a, const Row& r, const Inst& I) {
  const int m = r.n_out;
  float* g = scan_row(a, I);
  if (I.lane == 0)
    set_wf(r, 4, envelope_row(a, r, I, m, r.n_in, wf(r, 4), wf(r, 2), wf(r, 3), g));
  __syncwarp();
  const float threshold = wf(r, 0), duck = wf(r, 1);
  for (int f = I.lane; f < a.F; f += kLanes) {
    const float over = nanmin(nanmax(((gain_to_db(g[f]) - threshold) + 10.0f) * kTenth,
                                     0.0f), 1.0f);
    g[f] = db_to_gain(duck * over);
  }
  __syncwarp();
  apply_gains(a, r, I, m, g);
}

// Channel c of a row with a fixed line of D = aux0 frames in device memory
// through its echo channel record (the limiter's dry line, the delay
// compensator's): y[f] = cat(line, x)[f], times gains[f] when there are
// gains; x is appended to the line.  The channel is silent when its input
// is and its line held no loud sample (line_loud); `zero_silent` then
// zeroes its output (the limiter's gate; the delay compensator passes the
// delayed samples as they are).
template <class A>
__device__ void delay_channel(const A& a, const Row& r, const Inst& I, int k, int c,
                              const float* gains, bool zero_silent) {
  const int d = r.aux0;
  const EchoLine e = echo_line(a, r, I, c);
  const int xb = in_buf(r, c), yb = out_buf(r, c);
  const bool silent = flag(I, xb) != 0 && echo_ch(I, r.aux1 + c).count == 0;
  int delta = 0;
  for (int f = I.lane; f < a.F; f += kLanes) {
    const float x = frame(a, I, xb, f);
    const float v = seq_at(a, I, e, xb, k, d, f);
    const float y = gains ? v * gains[f] : v;
    frame(a, I, yb, f) = zero_silent && silent ? 0.f : y;
    if (d > 0) {  // the line drops seq index f and appends x at D + f
      delta += line_loud(r.op, x) - line_loud(r.op, v);
      e.append(d + static_cast<int64_t>(k) * a.F + f, x);
    }
  }
  delta = __reduce_add_sync(kFull, delta);
  __syncwarp();  // every lane has read the count and the flag
  if (I.lane == 0) {
    echo_ch(I, r.aux1 + c).count += delta;
    flag(I, yb) = silent;
  }
}

// nodes/dynamics.py:LimiterProcessor.  words: ceiling, rel_b; level_tail
// [L], env (state); the dry line [C, L] (leaf slot + 2) stays in device
// memory; aux0 = L, the lookahead, aux1 = the row's first echo channel.
// The scratch holds the level sequence cat(level_tail, level) [L + F],
// then the gains [F].  The peak over each window of L + 1 is max_pool1d's
// (a NaN propagates), the release K5's kLimiter on lane 0.
template <class A>
__device__ void op_limiter(const A& a, const Row& r, const Inst& I, int k) {
  const int la = r.aux0;
  float* seq = scan_row(a, I);
  float* g = seq + round4(la + a.F);
  for (int j = I.lane; j < la; j += kLanes) seq[j] = wf(r, 2 + j);
  for (int f = I.lane; f < a.F; f += kLanes)
    seq[la + f] = channel_level(a, r, I, 0, r.n_in, f);
  __syncwarp();
  const float ceiling = wf(r, 0);
  for (int t = I.lane; t < a.F; t += kLanes) {
    float peak = seq[t];
    for (int j = 1; j <= la; ++j) peak = nanmax(peak, seq[t + j]);
    g[t] = nanmin(ceiling / nanmax(peak, kKneeFloor), 1.0f);
  }
  for (int j = I.lane; j < la; j += kLanes) set_wf(r, 2 + j, seq[a.F + j]);
  __syncwarp();
  if (I.lane == 0) {
    const float rel = wf(r, 1);
    const float omb = 1.0f - rel;
    float env = wf(r, 2 + la);
    for (int f = 0; f < a.F; ++f) {
      env = nanmin(g[f], fmaf(rel, env, omb * g[f]));
      g[f] = env;
    }
    set_wf(r, 2 + la, env);
  }
  __syncwarp();
  for (int c = 0; c < r.n_in; ++c) delay_channel(a, r, I, k, c, g, true);
}

// nodes/delay.py:DelayCompProcessor.  The line [C, D] (leaf slot + 0) stays
// in device memory; aux0 = D (0: a copy), aux1 = the row's first echo
// channel.
template <class A>
__device__ void op_delay_comp(const A& a, const Row& r, const Inst& I, int k) {
  for (int c = 0; c < r.n_in; ++c) delay_channel(a, r, I, k, c, nullptr, false);
}

// nodes/loudness.py:LoudnessMeterProcessor.  words: shelf_z [C, 2], hp_z
// [C, 2], ring [R], counts [R] (uint32), pos, idx (state); consts: the
// shelf's and the high-pass's b0, b1, b2, a1, a2, then the C channel
// weights; aux0: the hop in frames, aux1: R.  Each channel's K-weighting
// is two K7 sections (the shelf's output in the scratch's first row, the
// weighted power summed over the channels in channel order in its second,
// then the levels); the hops' energies are warp sums (another order than
// torch's reduction: the ring is held to a tolerance), added to the ring
// hop by hop in order on lane 0 after the fresh slots are cleared.  The
// inputs pass through to the outputs (none for a sink).
template <class A>
__device__ void op_loudness(const A& a, const Row& r, const Inst& I) {
  const int ch = r.n_in, hop = r.aux0, ring_len = r.aux1;
  float* kw = scan_row(a, I);
  float* power = kw + pitch(a);
  scan::Affine2* lv = reinterpret_cast<scan::Affine2*>(power + pitch(a));
  const BiquadCoef shelf = {cst(r, 0), cst(r, 1), cst(r, 2), cst(r, 3), cst(r, 4)};
  const BiquadCoef hp = {cst(r, 5), cst(r, 6), cst(r, 7), cst(r, 8), cst(r, 9)};
  for (int c = 0; c < ch; ++c) {
    const float w = cst(r, 10 + c);
    float s1 = wf(r, 2 * c), s2 = wf(r, 2 * c + 1);
    const bool last1 = k7_section(a, I, &frame(a, I, in_buf(r, c), 0), shelf, s1, s2,
                                  lv, [&](int f, float y) { kw[f] = y; });
    float h1 = wf(r, 2 * ch + 2 * c), h2 = wf(r, 2 * ch + 2 * c + 1);
    const bool last2 = k7_section(a, I, kw, hp, h1, h2, lv, [&](int f, float y) {
      const float p = w * y * y;
      power[f] = c == 0 ? p : power[f] + p;
    });
    if (last1) {
      set_wf(r, 2 * c, s1);
      set_wf(r, 2 * c + 1, s2);
    }
    if (last2) {
      set_wf(r, 2 * ch + 2 * c, h1);
      set_wf(r, 2 * ch + 2 * c + 1, h2);
    }
  }
  // the passthrough
  for (int c = 0; c < r.n_out; ++c)
    for (int f = I.lane; f < a.F; f += kLanes)
      frame(a, I, out_buf(r, c), f) = frame(a, I, in_buf(r, c), f);
  const int ring = 4 * ch, counts = ring + ring_len, pos_w = counts + ring_len;
  const int pos = static_cast<int>(word(r, pos_w)), idx = static_cast<int>(word(r, pos_w + 1));
  const int total = pos + a.F;
  const int hops = total / hop;
  const int n_hops = (hop - 1 + a.F - 1) / hop + 1;
  // the slots entered for the first time this block start from zero
  for (int s = I.lane; s < ring_len; s += kLanes) {
    int m = (s - idx - 1) % ring_len;
    if (m < 0) m += ring_len;
    if (m < hops) {
      set_wf(r, ring + s, 0.f);
      word(r, counts + s) = 0;
    }
  }
  for (int h = 0; h < n_hops; ++h) {
    // frames [lo, hi) fall in hop h
    const int lo = max(0, h * hop - pos), hi = min(a.F, (h + 1) * hop - pos);
    float e = 0.f;
    for (int f = lo + I.lane; f < hi; f += kLanes) e += power[f];
    for (int o = 16; o > 0; o >>= 1) e += __shfl_xor_sync(kFull, e, o);
    __syncwarp();  // every lane has cleared its slots
    if (I.lane == 0) {
      const int slot = (idx + h) % ring_len;
      set_wf(r, ring + slot, wf(r, ring + slot) + e);
      word(r, counts + slot) += static_cast<uint32_t>(max(hi - lo, 0));
    }
  }
  __syncwarp();  // every lane has read pos and idx
  if (I.lane == 0) {
    word(r, pos_w) = static_cast<uint32_t>(total % hop);
    word(r, pos_w + 1) = static_cast<uint32_t>((idx + hops) % ring_len);
  }
  for (int c = I.lane; c < r.n_out; c += kLanes)
    flag(I, out_buf(r, c)) = flag(I, in_buf(r, c));
}

// nodes/generators.py:LFOProcessor.  words: inc, depth, offset, shape,
// phase (state; inc, shape and phase uint32).  No inputs; every output is
// offset + depth·wave, never silent.
template <class A>
__device__ void op_lfo(const A& a, const Row& r, const Inst& I) {
  const uint32_t inc = word(r, 0), shape = word(r, 3), ph = word(r, 4);
  const float depth = wf(r, 1), offset = wf(r, 2);
  for (int f = I.lane; f < a.F; f += kLanes) {
    const uint32_t p = ph + static_cast<uint32_t>(f) * inc;
    // the signed phase in cycles, [-0.5, 0.5): _signed_phase
    const float x = static_cast<float>(static_cast<int32_t>(p)) * 0x1p-32f;
    float wave;
    switch (shape) {
      case 0: wave = sinf(x * kTau); break;
      case 1: wave = 1.0f - 4.0f * fabsf(x); break;
      case 2: wave = 2.0f * x; break;
      default: wave = fabsf(x) < 0.25f ? 1.0f : -1.0f;
    }
    const float v = offset + depth * wave;
    for (int j = 0; j < r.n_out; ++j) frame(a, I, out_buf(r, j), f) = v;
  }
  __syncwarp();  // every lane has read the phase
  for (int j = I.lane; j < r.n_out; j += kLanes) flag(I, out_buf(r, j)) = 0;
  if (I.lane == 0) word(r, 4) = ph + static_cast<uint32_t>(a.F) * inc;
}

// Row n's fields, three int4 loads from the table in shared memory.
__device__ Row read_row(const Tables& t, const Inst& I, int n) {
  const int at0 = t.ops + n * kRowWidth;
  const int4 f0 = reinterpret_cast<const int4&>(s_float4(at0));
  const int4 f1 = reinterpret_cast<const int4&>(s_float4(at0 + 4));
  const int4 f2 = reinterpret_cast<const int4&>(s_float4(at0 + 8));
  const int w[kRowWidth] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y,
                            f1.z, f1.w, f2.x, f2.y, f2.z, f2.w};
  Row r;
  r.op = w[kOp];
  r.n_in = w[kNIn];
  r.n_out = w[kNOut];
  r.n_clear = w[kNClear];
  r.in = t.io + w[kIo];
  r.clear = r.in + r.n_in;
  r.out = r.clear + r.n_in;
  r.c = t.consts + w[kConst];
  r.aux0 = w[kAux0];
  r.aux1 = w[kAux1];
  r.slot = w[kSlot];
  r.w = I.word + w[kWord];
  return r;
}

// The device functions of the rows beyond the mixer's (the FX palette's and
// the mastering bus's), compiled only into the kernels for graphs that have
// such rows (kFx): their registers (132 an island thread, not 94) would
// cost every other graph residency, K3 on the effects chain 40%.
template <class A>
__device__ void run_fx_row(const A& a, const Row& r, const Inst& I, int k) {
  switch (r.op) {
    case kMonoToStereo: op_mono_to_stereo(a, r, I); break;
    case kStereoToMono: op_stereo_to_mono(a, r, I); break;
    case kWidth: op_width(a, r, I); break;
    case kTremolo: op_tremolo(a, r, I); break;
    case kWaveshaper: op_waveshaper(a, r, I); break;
    case kGate: op_gate(a, r, I); break;
    case kEq: op_eq(a, r, I); break;
    case kModDelay: op_mod_delay(a, r, I, k); break;
    case kPitch: op_pitch(a, r, I, k); break;
    case kCompressor: op_compressor(a, r, I); break;
    case kDucker: op_ducker(a, r, I); break;
    case kLimiter: op_limiter(a, r, I, k); break;
    case kLoudness: op_loudness(a, r, I); break;
    case kLfo: op_lfo(a, r, I); break;
    case kDelayComp: op_delay_comp(a, r, I, k); break;
    case kSinkMeter: op_meter<A, true>(a, r, I); break;
  }
}

template <bool kFx, class A>
__device__ void run_row(const A& a, const Row& r, const Inst& I, int k) {
  // unconnected inputs read as cleared, silent buffers (schedule.rs:310-313)
  if (r.n_clear) {
    for (int j = 0; j < r.n_in; ++j) {
      if (!s_int(r.clear + j)) continue;
      for (int q = I.lane; q < quads(a); q += kLanes)
        frames4(a, I, in_buf(r, j), q) = splat(0.f);
      if (I.lane == 0) flag(I, in_buf(r, j)) = 1;
    }
    __syncwarp();
  }
  switch (r.op) {
    case kDummy: op_dummy(a, r, I); break;
    case kBeep: op_beep(a, r, I); break;
    case kVolume: op_volume(a, r, I); break;
    case kPan: op_pan(a, r, I); break;
    case kSum: op_sum(a, r, I); break;
    case kFilter: op_filter(a, r, I); break;
    case kEcho: op_echo(a, r, I, k); break;
    case kClip: op_clip(a, r, I); break;
    case kMeter: op_meter(a, r, I); break;
    case kSpatial: op_spatial(a, r, I); break;
    default:
      if constexpr (kFx) run_fx_row(a, r, I, k);
  }
  __syncwarp();  // the next row reads what this one wrote
}

// K2: the graph outputs of block k, flagged channels read as zero
// (schedule.rs:255-287).  K3: the live-out buffers as they are.
template <bool kIsland, class A>
__device__ void write_outputs(const A& a, const Tables& t, const Inst& I,
                              int k) {
  const int64_t at0 = (I.i * a.K + k) * a.n_out;
  for (int o = 0; o < a.n_out; ++o) {
    const int b = s_int(t.out_row + 2 * o);
    const bool flagged = flag(I, b) != 0;
    const bool zero = !kIsland && (s_int(t.out_row + 2 * o + 1) != 0 || flagged);
    if (A::kWhole || a.F % 4 == 0) {
      float4* dst = reinterpret_cast<float4*>(a.out + (at0 + o) * a.F);
      for (int q = I.lane; q < quads(a); q += kLanes)
        __stcs(dst + q, zero ? splat(0.f) : frames4(a, I, b, q));
    } else {  // rows of F % 4 != 0 frames are not 16-byte aligned
      float* dst = a.out + (at0 + o) * a.F;
      for (int f = I.lane; f < a.F; f += kLanes)
        __stcs(dst + f, zero ? 0.f : frame(a, I, b, f));
    }
    if (I.lane == 0) a.masks[at0 + o] = kIsland ? flagged : zero;
  }
  __syncwarp();  // the next block's rows overwrite these flags
}

// K3: block k's live-in rows and flags, from the operands.
template <class A>
__device__ void read_live_ins(const A& a, const Tables& t, const Inst& I,
                              int k) {
  const int64_t at0 = (I.i * a.K + k) * a.n_in;
  for (int j = 0; j < a.n_in; ++j) {
    const int b = s_int(t.in_bufs + j);
    if (A::kWhole || a.F % 4 == 0) {
      const float4* src = reinterpret_cast<const float4*>(a.env + (at0 + j) * a.F);
      for (int q = I.lane; q < quads(a); q += kLanes)
        frames4(a, I, b, q) = __ldcs(src + q);
    } else {  // the padding past F stays as it was; nothing reads it
      const float* src = a.env + (at0 + j) * a.F;
      for (int f = I.lane; f < a.F; f += kLanes) frame(a, I, b, f) = __ldcs(src + f);
    }
  }
  for (int j = I.lane; j < a.n_in; j += kLanes)
    flag(I, s_int(t.in_bufs + j)) = a.env_flags[at0 + j] ? 1 : 0;
  __syncwarp();
}

// The instance's leaves into its words, lanes over leaves.
__device__ void gather_leaves(const Args& a, const Inst& I) {
  for (int s = I.lane; s < a.n_leaves; s += kLanes) {
    const int* L = a.leaves + s * kLeafWidth;
    const int n = L[kLeafCount];
    const char* p = reinterpret_cast<const char*>(a.ptrs[2 * s]);
    const int w = I.word + L[kLeafWord];
    for (int e = 0; e < n; ++e) {
      const int64_t at0 = I.i * n + e;
      switch (L[kLeafType]) {
        case kBool:
          s_word(w + e) = reinterpret_cast<const uint8_t*>(p)[at0] != 0;
          break;
        case kInt64:
          s_word(w + e) =
              static_cast<uint32_t>(reinterpret_cast<const int64_t*>(p)[at0]);
          break;
        default:
          s_word(w + e) = reinterpret_cast<const uint32_t*>(p)[at0];
      }
    }
  }
  __syncwarp();
}

// The instance's state words into the output leaves, once a chunk.
__device__ void scatter_state(const Args& a, const Inst& I) {
  for (int s = I.lane; s < a.n_leaves; s += kLanes) {
    const int* L = a.leaves + s * kLeafWidth;
    if (!L[kLeafState]) continue;
    const int n = L[kLeafCount];
    char* p = reinterpret_cast<char*>(a.ptrs[2 * s + 1]);
    const int w = I.word + L[kLeafWord];
    for (int e = 0; e < n; ++e) {
      const int64_t at0 = I.i * n + e;
      const uint32_t v = s_word(w + e);
      switch (L[kLeafType]) {
        case kBool:
          reinterpret_cast<uint8_t*>(p)[at0] = v != 0;
          break;
        case kInt64:  // the uint32 value, zero-extended
          reinterpret_cast<int64_t*>(p)[at0] = static_cast<int64_t>(v);
          break;
        default:
          reinterpret_cast<uint32_t*>(p)[at0] = v;
      }
    }
  }
}

// Copies the tables into shared memory (every thread of the CTA).
__device__ Tables load_tables(const Args& a) {
  int used = 0;
  auto copy = [&](const int* src, int n) {
    for (int j = threadIdx.x; j < n; j += blockDim.x) s_int(used + j) = src[j];
    used += n;
    return used - n;
  };
  Tables t;
  t.ops = copy(a.ops, a.n_ops * kRowWidth);
  t.io = copy(a.io, a.n_io);
  t.consts = copy(reinterpret_cast<const int*>(a.consts), a.n_consts);
  t.out_row = copy(a.out_row, 2 * a.n_out);
  t.in_bufs = copy(a.in_bufs, a.n_in);
  return t;
}

// The K-block loop of one instance per warp; kIsland selects K3's operands,
// kFx the FX rows.
template <bool kIsland, bool kFx, class A>
__device__ void render(const A& a) {
  const Tables t = load_tables(a);
  __syncthreads();  // the CTA's only barrier
  const int li = threadIdx.x / kLanes;
  Inst I;
  I.buf = table_words(a) + li * words_per_instance(a);
  I.echo = I.buf + arena_words(a);
  I.flag = I.echo + kEchoWords * a.echo_channels;
  I.word = I.flag + a.num_buffers;
  I.scan = I.word + a.num_words;
  I.i = static_cast<int64_t>(blockIdx.x) * a.tile + li;
  I.lane = I.sub = threadIdx.x % kLanes;
  I.span = kLanes;
  I.mask = kFull;

  gather_leaves(a, I);
  for (int n = 0; n < a.n_ops; ++n) {
    const Row r = read_row(t, I, n);
    if (has_line(r.op)) echo_begin(a, r, I);
  }
  __syncwarp();
  for (int k = 0; k < a.K; ++k) {
    if (kIsland) read_live_ins(a, t, I, k);
    for (int n = 0; n < a.n_ops;) {
      const int g = s_int(t.ops + n * kRowWidth + kGroup);
      if (g > 1) {  // a group of 2 or 4: row n + lane / span on each span lanes
        const int log_span = g == 2 ? 4 : 3;
        Inst J = I;
        J.span = 1 << log_span;
        J.sub = I.lane & (J.span - 1);
        J.mask = ((1u << J.span) - 1) << (I.lane - J.sub);
        run_row<kFx>(a, read_row(t, J, n + (I.lane >> log_span)), J, k);
        n += g;
      } else {
        run_row<kFx>(a, read_row(t, I, n), I, k);
        ++n;
      }
    }
    write_outputs<kIsland>(a, t, I, k);
  }
  scatter_state(a, I);
}

// Blocks of 128 frames, the size of every graph in the repo, as a
// constant: `a.F` is then 128 at compile time in every function templated
// on the Args type, and the loops over a block's float4s have fixed trip
// counts.  Read at run time, F cost K2 6% and K3 20% (more registers).
struct Args128 : Args {
  static constexpr int F = 128;
  static constexpr bool kWhole = true;
};

// The arena in device memory (`spill`): an instance's buffers do not fit a
// CTA's shared memory at tile 1.  F is read at run time and every row is
// compiled in: the kernels of a large graph are not the hot path.
struct ArgsSpill : Args {
  static constexpr bool kSpill = true;
};

template <class A, bool kFx>
__global__ void __launch_bounds__(kMaxThreads, 1) mega_kernel(const A a) {
  render<false, kFx>(a);
}

template <class A, bool kFx>
__global__ void __launch_bounds__(kMaxThreads, 1) island_kernel(const A a) {
  render<true, kFx>(a);
}

// The most dynamic shared memory each of the ten kernels (K2, K3; F fixed
// or not, with the rows beyond the mixer's or not; and with the arena
// spilled) may take on each device so far: its attributes are set when a
// launch needs more, not on every launch.
constexpr int kKernels = 10;
constexpr int kMaxDevices = 64;
std::atomic<size_t> g_allowed[kKernels][kMaxDevices];

// Lets `kernel` (number `which` of the ten) take `smem` bytes of dynamic
// shared memory on the current device, and asks for all of the SM's
// unified memory as shared memory: the arena bounds how many instances an
// SM holds.
template <class A>
cudaError_t allow_shared(void (*kernel)(A), int which, size_t smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::atomic<size_t>* allowed =
      dev < kMaxDevices ? &g_allowed[which][dev] : nullptr;
  if (allowed && allowed->load() >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             static_cast<int>(cudaSharedmemCarveoutMaxShared));
  if (err == cudaSuccess && allowed) allowed->store(smem);
  return err;
}

template <class A, bool kFx>
int launch_kernel(bool island, const A& a, int batch, void* stream) {
  const size_t smem = shared_bytes(a);
  const auto kernel = island ? island_kernel<A, kFx> : mega_kernel<A, kFx>;
  const int which = A::kSpill ? 8 + island
                              : 4 * kFx + 2 * island + !std::is_same<A, Args>::value;
  const cudaError_t err = allow_shared(kernel, which, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<batch / a.tile, a.tile * kLanes, smem,
           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <class A>
int launch_as(bool island, const A& a, int batch, void* stream) {
  return a.fx ? launch_kernel<A, true>(island, a, batch, stream)
              : launch_kernel<A, false>(island, a, batch, stream);
}

// Checks the sizes, lets the kernel take its shared memory and launches
// it: with the arena spilled when `spill` is set, else with F fixed when
// it is 128 and the rows beyond the mixer's compiled in when the table has
// them; returns cudaGetLastError() (0 on success).
int launch(bool island, const Args& a, int batch, void* stream) {
  if (batch <= 0) return 0;
  if (a.tile <= 0 || a.tile > kMaxTile || batch % a.tile != 0 || a.K <= 0 ||
      a.F <= 0 || (a.spill && a.arena == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.spill) {
    ArgsSpill spilled_args;
    static_cast<Args&>(spilled_args) = a;
    return launch_kernel<ArgsSpill, true>(island, spilled_args, batch, stream);
  }
  if (a.F != Args128::F) return launch_as(island, a, batch, stream);
  Args128 fixed;
  static_cast<Args&>(fixed) = a;
  return launch_as(island, fixed, batch, stream);
}

Args make_args(const int* ops, const int* io, const float* consts,
               const int* out_row, const int* leaves, const int64_t* ptrs,
               float* out, bool* masks, float* scratch, float* arena, int n_ops,
               int n_io, int n_consts, int n_out, int n_leaves, int num_words,
               int64_t stride, int tile, int num_blocks, int frames,
               int num_buffers, int echo_channels, int scan_words, int fx,
               int spill) {
  Args a = {};
  a.ops = ops;
  a.io = io;
  a.consts = consts;
  a.out_row = out_row;
  a.leaves = leaves;
  a.ptrs = ptrs;
  a.out = out;
  a.masks = masks;
  a.scratch = scratch;
  a.arena = arena;
  a.n_ops = n_ops;
  a.n_io = n_io;
  a.n_consts = n_consts;
  a.n_out = n_out;
  a.n_leaves = n_leaves;
  a.num_words = num_words;
  a.stride = stride;
  a.tile = tile;
  a.K = num_blocks;
  a.F = frames;
  a.num_buffers = num_buffers;
  a.echo_channels = echo_channels;
  a.scan_words = scan_words;
  a.fx = fx;
  a.spill = spill;
  return a;
}

}  // namespace

// Dynamic shared memory of one CTA for these sizes, in bytes: what the
// launch asks for (executor_mega.shared_bytes computes the same).
extern "C" int64_t fw_mega_shared_bytes(int n_ops, int n_io, int n_consts,
                                        int n_out, int n_in, int num_words,
                                        int tile, int frames, int num_buffers,
                                        int echo_channels, int scan_words,
                                        int spill) {
  Args a = {};
  a.n_ops = n_ops;
  a.n_io = n_io;
  a.n_consts = n_consts;
  a.n_out = n_out;
  a.n_in = n_in;
  a.num_words = num_words;
  a.tile = tile;
  a.F = frames;
  a.num_buffers = num_buffers;
  a.echo_channels = echo_channels;
  a.scan_words = scan_words;
  a.spill = spill;
  return static_cast<int64_t>(shared_bytes(a));
}

// Renders K blocks of `batch` instances (see the top of this file for the
// tables).  All pointers are device pointers on the current device; `arena`
// is the spilled arena [batch, num_buffers, round4(frames)] when `spill`
// is set (null otherwise).  Launches on `stream` and returns
// cudaGetLastError() (0 on success); it does not synchronise and allocates
// nothing.
extern "C" int fw_mega_render(const int* ops, const int* io,
                              const float* consts, const int* out_row,
                              const int* leaves, const int64_t* ptrs,
                              float* out, bool* masks, float* scratch,
                              float* arena, int n_ops, int n_io, int n_consts,
                              int n_out, int n_leaves, int num_words,
                              int64_t stride, int batch, int tile,
                              int num_blocks, int frames, int num_buffers,
                              int echo_channels, int scan_words, int fx,
                              int spill, void* stream) {
  const Args a = make_args(ops, io, consts, out_row, leaves, ptrs, out, masks,
                           scratch, arena, n_ops, n_io, n_consts, n_out,
                           n_leaves, num_words, stride, tile, num_blocks,
                           frames, num_buffers, echo_channels, scan_words, fx,
                           spill);
  return launch(false, a, batch, stream);
}

// Renders K blocks of one island for `batch` instances: live-in rows `env`
// [B, K, n_in, F] and flags `env_flags` [B, K, n_in] in, live-out rows `out`
// [B, K, n_out, F] (unmasked) and flags `flags` [B, K, n_out] out.  The same
// contract as fw_mega_render otherwise.
extern "C" int fw_island_render(const int* ops, const int* io,
                                const float* consts, const int* out_row,
                                const int* leaves, const int64_t* ptrs,
                                float* out, bool* flags, float* scratch,
                                float* arena, int n_ops, int n_io,
                                int n_consts, int n_out, int n_leaves,
                                int num_words, int64_t stride, int batch,
                                int tile, int num_blocks, int frames,
                                int num_buffers, int echo_channels,
                                int scan_words, int fx, int spill,
                                void* stream, const int* in_bufs, int n_in,
                                const float* env, const bool* env_flags) {
  Args a = make_args(ops, io, consts, out_row, leaves, ptrs, out, flags,
                     scratch, arena, n_ops, n_io, n_consts, n_out, n_leaves,
                     num_words, stride, tile, num_blocks, frames, num_buffers,
                     echo_channels, scan_words, fx, spill);
  a.in_bufs = in_bufs;
  a.n_in = n_in;
  a.env = env;
  a.env_flags = env_flags;
  return launch(true, a, batch, stream);
}

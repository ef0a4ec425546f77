// Sequential transposed-direct-form-II biquad, one thread per lane.
//
// Replaces the TPU kernel firewheel_tpu/ops/pallas_iir.py:_biquad_kernel.
// Per lane (instance x channel), over F frames:
//
//     y   = fma(b0, x, z1)
//     z1' = fma(b1, x, -(a1*y)) + z2
//     z2' = fma(b2, x, -(a2*y))
//
// with the state (z1, z2) read at the start and written at the end.  Unlike
// the TPU kernel, which takes one filter per call as scalar prefetch, every
// lane carries its own five coefficients: a batch of instances carries a
// batch of cutoffs.  Each of the seven per-lane operands (z1, z2, b0, b1,
// b2, a1, a2) comes with a lane divisor: lane l reads element l / rep of it,
// so the filter node's per-instance coefficients [B, 1] serve both channels
// of [B, 2] lanes without a copy (ops/seq_iir.py:lane_repeat).
//
// What bounds it on an H100: memory.  A lane moves 1 060 bytes at F = 128
// (x and y, 512 each, its coefficients and state) for ~9 f32 operations a
// frame: 17.4 MB, 5.2 us at 3.35 TB/s, for the eager mixer's 16 384 lanes.
// The recurrence cannot be shortened: a chain of fma, mul, fma, add per
// frame, ~16 cycles, ~1.1 us over 128 frames, which fits inside the byte
// bound only if the loads stay in flight while it runs.  The first design
// (64 lanes a CTA, 32-frame tiles staged by a load loop, three CTA barriers
// a tile) left the card nearly empty (2 warps a CTA, ~4 warps an SM) and
// never overlapped loads, recurrence and stores.  This design:
//
//  a. One warp a CTA, one lane a thread: 32 lanes, whose rows of x are one
//     contiguous slab.  16 384 lanes are 512 CTAs, ~4 an SM, each with its
//     whole slab (16 KB at F = 128) in flight at once.  No CTA barrier.
//  b. Stages of 32 frames copied with cp.async into a ring of kRing stages
//     in shared memory, each stage its own commit group.  The warp waits
//     for stage s alone (cp.async.wait_group) and runs its 32 frames while
//     the later stages land.  At F <= 32 * kRing every copy is issued
//     before the first frame runs; a longer F refills a stage's slot as
//     soon as its outputs are stored (the loop takes the place of the TPU's
//     sequential grid).
//  c. A lane's row of a stage has a pitch of 32 + 4 floats: 16-byte aligned,
//     and the 8 threads of a quarter-warp reading one float4 each from 8
//     rows hit 32 distinct banks.  A thread reads 4 frames a float4, runs
//     them and writes y back in place.
//  d. Stores as soon as a stage is done: after a __syncwarp the warp writes
//     the stage's y with 16-byte coalesced stores, which drain while the
//     next stage's recurrence runs.
//  e. The ragged edges: 16-byte copies when F % 4 == 0 and x and y are
//     16-byte aligned, 4-byte copies otherwise (an instantiation each);
//     lanes past the end and frames past F are neither copied nor run.
//  f. __launch_bounds__ names the 32 threads a CTA launches; chip_smoke.py
//     phase 2 prints ptxas's registers, spills and stack frame.
//
// Rounding: the three fused multiply-adds above are written out with fmaf
// in biquad_step.cuh (shared with the megakernel), and the file is built
// with --fmad=false so that nvcc contracts nothing else.  That is the
// rounding XLA gives the Pallas kernel's body on the CPU (its interpret
// mode, the port's reference in the tests), and the one the plain PyTorch
// version reproduces, so the kernel matches both to the bit save for the
// plain version's rare double rounding (see seq_iir.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "biquad_step.cuh"

namespace {

constexpr int kLanes = 32;          // lanes per CTA: one warp, a thread each
constexpr int kStage = 32;          // frames per stage
constexpr int kPitch = kStage + 4;  // floats per lane row of a stage
constexpr int kRing = 4;            // stages in shared memory
constexpr int kOperands = 7;        // z1, z2, b0, b1, b2, a1, a2

struct Args {
  const float* x;  // [lanes, frames]
  float* y;        // [lanes, frames]
  float* z_out;    // [2, lanes]
  const float* src[kOperands];  // lane l reads src[i][l / rep[i]]
  int64_t rep[kOperands];
  int64_t lanes;
  int frames;
};

using Stage = float[kLanes][kPitch];

__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void copy16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(shared_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(shared_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most n of this thread's commit groups are pending.
template <int n>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(n) : "memory");
}

// Frames of stage s.
__device__ __forceinline__ int stage_frames(const Args& a, int s) {
  const int left = a.frames - s * kStage;
  return left < kStage ? left : kStage;
}

// Copies stage s of the warp's `rows` lanes into `st`.  16-byte copies: a
// row's stage is 8 float4s, and thread t takes float4 t % 8 of rows t / 8,
// t / 8 + 4, ...: each instruction reads 4 rows of 128 contiguous bytes.
// 4-byte copies: thread t takes frame t of every row.
template <bool kVec>
__device__ void load_stage(const Args& a, Stage& st, int64_t lane0, int rows,
                           int s, int t) {
  const int nf = stage_frames(a, s);
  const float* x = a.x + lane0 * a.frames + s * kStage;
  if (kVec) {
    const int c = 4 * (t & 7);
    if (c >= nf) return;
#pragma unroll
    for (int j = 0; j < kLanes / 4; ++j) {
      const int r = (t >> 3) + 4 * j;
      if (r < rows) copy16(&st[r][c], x + static_cast<int64_t>(r) * a.frames + c);
    }
  } else {
    if (t >= nf) return;
#pragma unroll 8
    for (int r = 0; r < rows; ++r)
      copy4(&st[r][t], x + static_cast<int64_t>(r) * a.frames + t);
  }
}

// Writes stage s of y from `st`, as load_stage reads x.
template <bool kVec>
__device__ void store_stage(const Args& a, const Stage& st, int64_t lane0,
                            int rows, int s, int t) {
  const int nf = stage_frames(a, s);
  float* y = a.y + lane0 * a.frames + s * kStage;
  if (kVec) {
    const int c = 4 * (t & 7);
    if (c >= nf) return;
#pragma unroll
    for (int j = 0; j < kLanes / 4; ++j) {
      const int r = (t >> 3) + 4 * j;
      if (r < rows)
        *reinterpret_cast<float4*>(y + static_cast<int64_t>(r) * a.frames + c) =
            *reinterpret_cast<const float4*>(&st[r][c]);
    }
  } else {
    if (t >= nf) return;
#pragma unroll 8
    for (int r = 0; r < rows; ++r) y[static_cast<int64_t>(r) * a.frames + t] = st[r][t];
  }
}

// The recurrence over the `nf` frames of one lane's row of a stage, y
// written over x.
__device__ __forceinline__ void run_stage(float* row, int nf,
                                          const BiquadCoef& bq, float& z1,
                                          float& z2) {
  float4* v = reinterpret_cast<float4*>(row);
  if (nf == kStage) {
#pragma unroll
    for (int q = 0; q < kStage / 4; ++q) {
      float4 f = v[q];
      f.x = biquad_step(bq, f.x, z1, z2);
      f.y = biquad_step(bq, f.y, z1, z2);
      f.z = biquad_step(bq, f.z, z1, z2);
      f.w = biquad_step(bq, f.w, z1, z2);
      v[q] = f;
    }
    return;
  }
  for (int q = 0; 4 * q < nf; ++q) {
    float4 f = v[q];
    f.x = biquad_step(bq, f.x, z1, z2);
    if (4 * q + 1 < nf) f.y = biquad_step(bq, f.y, z1, z2);
    if (4 * q + 2 < nf) f.z = biquad_step(bq, f.z, z1, z2);
    if (4 * q + 3 < nf) f.w = biquad_step(bq, f.w, z1, z2);
    v[q] = f;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kLanes) biquad_seq_kernel(const Args a) {
  __shared__ __align__(16) Stage ring[kRing];

  const int t = threadIdx.x;
  const int64_t lane0 = static_cast<int64_t>(blockIdx.x) * kLanes;
  const int rows = static_cast<int>(a.lanes - lane0 < kLanes ? a.lanes - lane0
                                                             : kLanes);
  const bool live = t < rows;
  const int stages = (a.frames + kStage - 1) / kStage;

  // the first kRing stages in flight, a commit group each (empty past F)
#pragma unroll
  for (int s = 0; s < kRing; ++s) {
    if (s < stages) load_stage<kVec>(a, ring[s], lane0, rows, s, t);
    commit();
  }

  // the lane's state and coefficients, loaded while the copies land
  float v[kOperands];
  const int64_t lane = lane0 + t;
#pragma unroll
  for (int i = 0; i < kOperands; ++i)
    v[i] = live ? a.src[i][a.rep[i] == 1 ? lane : lane / a.rep[i]] : 0.f;
  float z1 = v[0], z2 = v[1];
  const BiquadCoef bq = {v[2], v[3], v[4], v[5], v[6]};

  for (int s = 0; s < stages; ++s) {
    Stage& st = ring[s % kRing];
    wait_pending<kRing - 1>();  // this thread's copies of stage s landed
    __syncwarp();               // and every lane's
    if (live) run_stage(st[t], stage_frames(a, s), bq, z1, z2);
    __syncwarp();
    store_stage<kVec>(a, st, lane0, rows, s, t);
    __syncwarp();  // every lane has read the slot before it is refilled
    if (s + kRing < stages) load_stage<kVec>(a, st, lane0, rows, s + kRing, t);
    commit();
  }

  if (live) {
    a.z_out[lane] = z1;
    a.z_out[a.lanes + lane] = z2;
  }
}

__host__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// x, y: f32[lanes, frames], contiguous; z_out: f32[2, lanes]; for each of
// z1, z2, b0, b1, b2, a1, a2 (in that order) a pointer and its lane divisor
// rep >= 1: lane l reads element l / rep.  All on the current device.
// Launches on `stream` and returns cudaGetLastError() (0 on success); it
// does not synchronise.
extern "C" int fw_biquad_seq(const float* x, float* y, float* z_out,
                             const float* z1, int64_t rep_z1,
                             const float* z2, int64_t rep_z2,
                             const float* b0, int64_t rep_b0,
                             const float* b1, int64_t rep_b1,
                             const float* b2, int64_t rep_b2,
                             const float* a1, int64_t rep_a1,
                             const float* a2, int64_t rep_a2,
                             int64_t lanes, int frames, void* stream) {
  if (lanes <= 0) return 0;
  if (frames < 0 || rep_z1 < 1 || rep_z2 < 1 || rep_b0 < 1 || rep_b1 < 1 ||
      rep_b2 < 1 || rep_a1 < 1 || rep_a2 < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = {x, y, z_out, {z1, z2, b0, b1, b2, a1, a2},
                  {rep_z1, rep_z2, rep_b0, rep_b1, rep_b2, rep_a1, rep_a2},
                  lanes, frames};
  const int64_t blocks = (lanes + kLanes - 1) / kLanes;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (frames % 4 == 0 && aligned16(x) && aligned16(y))
    biquad_seq_kernel<true><<<static_cast<unsigned>(blocks), kLanes, 0, s>>>(a);
  else
    biquad_seq_kernel<false><<<static_cast<unsigned>(blocks), kLanes, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

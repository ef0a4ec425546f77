// K5: the per-lane, per-sample recurrences of the dynamics nodes and the
// pink-noise filter.
//
// Replaces firewheel_tpu/ops/dynamics.py:30 sample_scan (a lax.scan over
// the block's samples) at its five callers: envelope_follow (:69; the
// compressor and the ducker), the limiter's release (nodes/dynamics.py:
// 193-197), the gate's latch (:294-310) and the Kellet pink filter
// (nodes/generators.py:98-106).  Its plain version is ops/dynamics.py:
// scan_reference; with the same fused multiply-adds (explicit fmaf here,
// built with --fmad=false; ops/iir.py:_fma there) the two agree to the bit.
// The fmaf placement is the one XLA gives each scan body on the CPU.
//
// What bounds it on an H100: bytes.  x is read and y written once, 1 KB a
// lane at F = 128 (8.5 MB, 2.5 us at 3.35 TB/s, for the dynamics' 8192
// lanes; 17.2 MB, 5.1 us, for the pink filter's 16 384), against a
// recurrence of a few dependent operations a frame.  Each lane's frames
// are serial, so the card holds only one thread a lane: at 8192 lanes two
// warps an SM, and nothing but loads kept in flight ahead of the
// recurrence hides device memory's latency.  A first design (one
// thread a lane reading x[lane, f] straight from device memory, a warp's
// load touching 32 rows F floats apart) waited on a miss every eighth
// frame and ran at 11-13% of the bound.  This design is K1's
// (csrc/biquad.cu):
//
//  a. One warp a CTA, one lane a thread: 32 lanes, whose rows of x are one
//     contiguous slab.  8192 lanes are 256 CTAs, about two an SM, each
//     with its whole slab (16 KB at F = 128) in flight at once.
//  b. Stages of 32 frames copied with cp.async (16-byte copies when
//     F % 4 == 0 and x and y are 16-byte aligned, 4-byte copies otherwise)
//     into a ring of kRing stages in shared memory, a commit group each.
//     The warp waits for stage s alone and runs its 32 frames while the
//     later stages land; a longer F refills a stage's slot once its
//     outputs are stored.
//  c. A lane's row of a stage has a pitch of 32 + 4 floats: the 8 threads
//     of a quarter-warp reading one float4 each from 8 rows hit 32
//     distinct banks.  A thread runs 4 frames a float4 and writes y back
//     over x in the slot.
//  d. y leaves a stage at a time with 16-byte coalesced stores, which
//     drain while the next stage's recurrence runs.
//  e. The steps are the plain version's arithmetic in its order.  Forming
//     both candidate products (1 - b)·v before the envelope's and the
//     gate's comparison (a chain of compare, select and fmaf, the same
//     bits) measured 0-7% slower on the card than this (PERF.md):
//     nvcc predicates the second product after the comparison, and at the
//     main paths' widths the loads' and stores' latency, not the chain,
//     sets the time.
//  f. Operands in place or by value (k5::Operand, as K7's): a carry leaf or
//     coefficient is a number, or a float tensor read at an outer and an
//     inner stride of the lanes; the carry goes out at a leaf and a lane
//     stride, so the pink filter's poles [..., 3] are read and written
//     where the node keeps them.
//
// Rounding: the products and fmaf below are the plain version's, written
// out; --fmad=false keeps nvcc from contracting anything else.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The launch's arguments, in a named namespace: the C entry point takes a
// pointer to them, and a type of an unnamed namespace would keep it out of
// the library's exported symbols.
namespace k5 {

constexpr int kMaxCarry = 3;
constexpr int kMaxCoef = 6;

// A per-lane operand.  Lanes are [outer, inner] (inner: the last axis of
// the caller's lane shape); lane l reads p[(l / inner) * so + (l % inner) *
// si], or v for every lane when p is null (a number, passed by value).
struct Operand {
    const float* p;
    int64_t so, si;
    float v;
};

struct Args {
    const float* x;  // [lanes, frames]
    float* y;        // [lanes, frames]
    Operand carry[kMaxCarry];
    Operand coef[kMaxCoef];
    float* carry_out;  // leaf k of lane l at carry_out[k * out_leaf + l * out_lane]
    int64_t out_leaf, out_lane;
    int64_t inner;
    int64_t lanes;
    int frames;
};

}  // namespace k5

namespace {

using k5::Args;
using k5::Operand;

constexpr int kLanes = 32;          // lanes per CTA: one warp, a thread each
constexpr int kStage = 32;          // frames per stage
constexpr int kPitch = kStage + 4;  // floats per lane row of a stage
constexpr int kRing = 4;            // stages in shared memory

enum Kind { kEnvelope = 0, kLimiter = 1, kGate = 2, kPink = 3 };

using Stage = float[kLanes][kPitch];

// jnp.minimum / jnp.maximum: NaN in either operand gives NaN
__device__ __forceinline__ float nan_min(float a, float b) {
    return (a != a) ? a : (a < b ? a : b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
    return (a != a) ? a : (a > b ? a : b);
}

__device__ __forceinline__ float at(const Operand& o, int64_t lane, int64_t inner) {
    return o.p ? o.p[(lane / inner) * o.so + (lane % inner) * o.si] : o.v;
}

// The steps, by kind: the carry in registers, the lane's coefficients
// loaded once.  step(v) runs one frame and returns its output.

// b = x > env ? attack : release;  env = b·env + (1−b)·x
struct Envelope {
    float att, rel, env;
    __device__ Envelope(const Args& a, int64_t lane) {
        att = at(a.coef[0], lane, a.inner);
        rel = at(a.coef[1], lane, a.inner);
        env = at(a.carry[0], lane, a.inner);
    }
    __device__ __forceinline__ float step(float v) {
        const float b = v > env ? att : rel;
        env = fmaf(b, env, (1.0f - b) * v);
        return env;
    }
    __device__ void store(const Args& a, int64_t lane) const {
        a.carry_out[lane * a.out_lane] = env;
    }
};

// env = min(g, b·env + (1−b)·g): instantaneous attack, one-pole release
struct Limiter {
    float rel, omb, env;
    __device__ Limiter(const Args& a, int64_t lane) {
        rel = at(a.coef[0], lane, a.inner);
        omb = 1.0f - rel;
        env = at(a.carry[0], lane, a.inner);
    }
    __device__ __forceinline__ float step(float g) {
        env = nan_min(g, fmaf(rel, env, omb * g));
        return env;
    }
    __device__ void store(const Args& a, int64_t lane) const {
        a.carry_out[lane * a.out_lane] = env;
    }
};

// The latch (open, hold) follows the level alone; the gain chases the
// latch's target with attack or release.
struct Gate {
    float open_lin, close_lin, floor_gain, att, rel, hold_n;
    float opn, hold, g;
    __device__ Gate(const Args& a, int64_t lane) {
        open_lin = at(a.coef[0], lane, a.inner);
        close_lin = at(a.coef[1], lane, a.inner);
        floor_gain = at(a.coef[2], lane, a.inner);
        att = at(a.coef[3], lane, a.inner);
        rel = at(a.coef[4], lane, a.inner);
        hold_n = at(a.coef[5], lane, a.inner);
        opn = at(a.carry[0], lane, a.inner);
        hold = at(a.carry[1], lane, a.inner);
        g = at(a.carry[2], lane, a.inner);
    }
    __device__ __forceinline__ float step(float lvl) {
        const bool above = lvl >= open_lin;
        const bool below = lvl < close_lin;
        const bool expired = hold <= 0.0f;
        opn = above ? 1.0f : ((below && expired) ? 0.0f : opn);
        hold = above ? hold_n : nan_max(hold - 1.0f, 0.0f);
        const float target = opn + (1.0f - opn) * floor_gain;
        const float b = target > g ? att : rel;
        g = fmaf(b, g, (1.0f - b) * target);
        return g;
    }
    __device__ void store(const Args& a, int64_t lane) const {
        a.carry_out[lane * a.out_lane] = opn;
        a.carry_out[a.out_leaf + lane * a.out_lane] = hold;
        a.carry_out[2 * a.out_leaf + lane * a.out_lane] = g;
    }
};

// Paul Kellet's economy pink filter.  The carry and the output contract
// the poles' sums differently, as XLA does on the CPU.
struct Pink {
    float z0, z1, z2;
    __device__ Pink(const Args& a, int64_t lane) {
        z0 = at(a.carry[0], lane, a.inner);
        z1 = at(a.carry[1], lane, a.inner);
        z2 = at(a.carry[2], lane, a.inner);
    }
    __device__ __forceinline__ float step(float w) {
        const float b0 = fmaf(0.99765f, z0, w * 0.0990460f);
        const float o1 = fmaf(w, 0.2965164f, 0.96300f * z1);
        const float o2 = fmaf(w, 1.0526913f, 0.57000f * z2);
        const float y = fmaf(w, 0.1848f, (b0 + o1) + o2) * 0.25f;
        z1 = fmaf(0.96300f, z1, w * 0.2965164f);
        z2 = fmaf(0.57000f, z2, w * 1.0526913f);
        z0 = b0;
        return y;
    }
    __device__ void store(const Args& a, int64_t lane) const {
        a.carry_out[lane * a.out_lane] = z0;
        a.carry_out[a.out_leaf + lane * a.out_lane] = z1;
        a.carry_out[2 * a.out_leaf + lane * a.out_lane] = z2;
    }
};

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
__device__ void load_stage(const Args& a, Stage& st, int64_t lane0, int rows, int s,
                           int t) {
    const int nf = stage_frames(a, s);
    const float* x = a.x + lane0 * a.frames + s * kStage;
    if (kVec) {
        const int c = 4 * (t & 7);
        if (c >= nf) return;
#pragma unroll
        for (int j = 0; j < kLanes / 4; ++j) {
            const int r = (t >> 3) + 4 * j;
            if (r < rows)
                __pipeline_memcpy_async(&st[r][c], x + static_cast<int64_t>(r) * a.frames + c,
                                        16);
        }
    } else {
        if (t >= nf) return;
#pragma unroll 8
        for (int r = 0; r < rows; ++r)
            __pipeline_memcpy_async(&st[r][t], x + static_cast<int64_t>(r) * a.frames + t, 4);
    }
}

// Writes stage s of y from `st`, as load_stage reads x.
template <bool kVec>
__device__ void store_stage(const Args& a, const Stage& st, int64_t lane0, int rows,
                            int s, int t) {
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
template <class Step>
__device__ __forceinline__ void run_stage(float* row, int nf, Step& k) {
    float4* v = reinterpret_cast<float4*>(row);
    if (nf == kStage) {
#pragma unroll
        for (int q = 0; q < kStage / 4; ++q) {
            float4 f = v[q];
            f.x = k.step(f.x);
            f.y = k.step(f.y);
            f.z = k.step(f.z);
            f.w = k.step(f.w);
            v[q] = f;
        }
        return;
    }
    for (int q = 0; 4 * q < nf; ++q) {
        float4 f = v[q];
        f.x = k.step(f.x);
        if (4 * q + 1 < nf) f.y = k.step(f.y);
        if (4 * q + 2 < nf) f.z = k.step(f.z);
        if (4 * q + 3 < nf) f.w = k.step(f.w);
        v[q] = f;
    }
}

template <class Step, bool kVec>
__global__ void __launch_bounds__(kLanes) sample_scan_kernel(const Args a) {
    __shared__ __align__(16) Stage ring[kRing];

    const int t = threadIdx.x;
    const int64_t lane0 = static_cast<int64_t>(blockIdx.x) * kLanes;
    const int rows = static_cast<int>(a.lanes - lane0 < kLanes ? a.lanes - lane0 : kLanes);
    const bool live = t < rows;
    const int stages = (a.frames + kStage - 1) / kStage;

    // the first kRing stages in flight, a commit group each (empty past F)
#pragma unroll
    for (int s = 0; s < kRing; ++s) {
        if (s < stages) load_stage<kVec>(a, ring[s], lane0, rows, s, t);
        __pipeline_commit();
    }

    // the lane's carry and coefficients, read while the copies land
    const int64_t lane = live ? lane0 + t : lane0;
    Step k(a, lane);

    for (int s = 0; s < stages; ++s) {
        Stage& st = ring[s % kRing];
        __pipeline_wait_prior(kRing - 1);  // this thread's copies of stage s landed
        __syncwarp();                      // and every lane's
        if (live) run_stage(st[t], stage_frames(a, s), k);
        __syncwarp();
        store_stage<kVec>(a, st, lane0, rows, s, t);
        __syncwarp();  // every lane has read the slot before it is refilled
        if (s + kRing < stages) load_stage<kVec>(a, st, lane0, rows, s + kRing, t);
        __pipeline_commit();
    }

    if (live) k.store(a, lane);
}

__host__ inline bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <class Step>
int launch(const Args& a, cudaStream_t s) {
    const unsigned blocks = static_cast<unsigned>((a.lanes + kLanes - 1) / kLanes);
    if (a.frames % 4 == 0 && aligned16(a.x) && aligned16(a.y))
        sample_scan_kernel<Step, true><<<blocks, kLanes, 0, s>>>(a);
    else
        sample_scan_kernel<Step, false><<<blocks, kLanes, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kind: 0 envelope (coef att, rel; carry env), 1 limiter (coef rel; carry
// env), 2 gate (coef open, close, floor, att, rel, hold_n; carry open,
// hold, gain), 3 pink (no coef; carry the three poles).  x, y: f32[lanes,
// frames], contiguous; the operands as k5::Args says.  Launches on
// `stream` and returns cudaGetLastError() (cudaErrorInvalidValue for an
// unknown kind or a bad shape); it does not synchronise.
extern "C" int fw_sample_scan(int kind, const k5::Args* args, void* stream) {
    const Args& a = *args;
    if (a.lanes <= 0) return 0;
    if (a.frames < 0 || a.inner < 1) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (kind) {
        case kEnvelope: return launch<Envelope>(a, s);
        case kLimiter: return launch<Limiter>(a, s);
        case kGate: return launch<Gate>(a, s);
        case kPink: return launch<Pink>(a, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

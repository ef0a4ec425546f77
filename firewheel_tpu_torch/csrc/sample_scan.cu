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
// One thread per lane runs the F samples of its lane in order, the carry
// in registers.  Layouts: x and y [lanes, F]; carry in and out [n_carry,
// lanes]; coefficients [n_coef, lanes], so a warp reads each of them in one
// coalesced access.  Bound: bytes (x read once, y written once); a warp
// reads x[lane, f] with a stride of F floats, served from L1 over the
// lane's 32-byte sectors.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;

enum Kind { kEnvelope = 0, kLimiter = 1, kGate = 2, kPink = 3 };

// jnp.minimum / jnp.maximum: NaN in either operand gives NaN
__device__ __forceinline__ float nan_min(float a, float b) {
    return (a != a) ? a : (a < b ? a : b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
    return (a != a) ? a : (a > b ? a : b);
}

template <int KIND>
__global__ void __launch_bounds__(kThreads)
sample_scan_kernel(const float* __restrict__ x, float* __restrict__ y,
                   const float* __restrict__ carry_in, float* __restrict__ carry_out,
                   const float* __restrict__ coef, int64_t lanes, int frames) {
    const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= lanes) return;
    const float* xl = x + lane * frames;
    float* yl = y + lane * frames;

    if (KIND == kEnvelope) {
        // b = x > env ? attack : release;  env = b·env + (1−b)·x
        const float att = coef[lane], rel = coef[lanes + lane];
        float env = carry_in[lane];
        for (int f = 0; f < frames; ++f) {
            const float v = xl[f];
            const float b = v > env ? att : rel;
            env = fmaf(b, env, (1.0f - b) * v);
            yl[f] = env;
        }
        carry_out[lane] = env;
    } else if (KIND == kLimiter) {
        // env = min(g, b·env + (1−b)·g): instantaneous attack, one-pole release
        const float rel = coef[lane];
        const float omb = 1.0f - rel;
        float env = carry_in[lane];
        for (int f = 0; f < frames; ++f) {
            const float g = xl[f];
            env = nan_min(g, fmaf(rel, env, omb * g));
            yl[f] = env;
        }
        carry_out[lane] = env;
    } else if (KIND == kGate) {
        const float open_lin = coef[lane], close_lin = coef[lanes + lane];
        const float floor_gain = coef[2 * lanes + lane];
        const float att = coef[3 * lanes + lane], rel = coef[4 * lanes + lane];
        const float hold_n = coef[5 * lanes + lane];
        float opn = carry_in[lane], hold = carry_in[lanes + lane];
        float g = carry_in[2 * lanes + lane];
        for (int f = 0; f < frames; ++f) {
            const float lvl = xl[f];
            const bool above = lvl >= open_lin;
            const bool below = lvl < close_lin;
            const bool expired = hold <= 0.0f;
            opn = above ? 1.0f : ((below && expired) ? 0.0f : opn);
            hold = above ? hold_n : nan_max(hold - 1.0f, 0.0f);
            const float target = opn + (1.0f - opn) * floor_gain;
            const float b = target > g ? att : rel;
            g = fmaf(b, g, (1.0f - b) * target);
            yl[f] = g;
        }
        carry_out[lane] = opn;
        carry_out[lanes + lane] = hold;
        carry_out[2 * lanes + lane] = g;
    } else {
        // Paul Kellet's economy pink filter.  The carry and the output
        // contract the poles' sums differently, as XLA does on the CPU.
        float z0 = carry_in[lane], z1 = carry_in[lanes + lane];
        float z2 = carry_in[2 * lanes + lane];
        for (int f = 0; f < frames; ++f) {
            const float w = xl[f];
            const float b0 = fmaf(0.99765f, z0, w * 0.0990460f);
            const float o1 = fmaf(w, 0.2965164f, 0.96300f * z1);
            const float o2 = fmaf(w, 1.0526913f, 0.57000f * z2);
            yl[f] = fmaf(w, 0.1848f, (b0 + o1) + o2) * 0.25f;
            z1 = fmaf(0.96300f, z1, w * 0.2965164f);
            z2 = fmaf(0.57000f, z2, w * 1.0526913f);
            z0 = b0;
        }
        carry_out[lane] = z0;
        carry_out[lanes + lane] = z1;
        carry_out[2 * lanes + lane] = z2;
    }
}

}  // namespace

// kind: 0 envelope (coef att, rel; carry env), 1 limiter (coef rel; carry
// env), 2 gate (coef open, close, floor, att, rel, hold_n; carry open,
// hold, gain), 3 pink (no coef; carry the three poles).  Returns the
// launch's cudaError_t (cudaErrorInvalidValue for an unknown kind).
extern "C" int fw_sample_scan(int kind, const void* x, void* y, const void* carry_in,
                              void* carry_out, const void* coef, int64_t lanes,
                              int frames, void* stream) {
    const unsigned blocks = (unsigned)((lanes + kThreads - 1) / kThreads);
    cudaStream_t s = (cudaStream_t)stream;
    const float* xi = static_cast<const float*>(x);
    float* yo = static_cast<float*>(y);
    const float* ci = static_cast<const float*>(carry_in);
    float* co = static_cast<float*>(carry_out);
    const float* k = static_cast<const float*>(coef);
    switch (kind) {
        case kEnvelope:
            sample_scan_kernel<kEnvelope><<<blocks, kThreads, 0, s>>>(xi, yo, ci, co, k, lanes, frames);
            break;
        case kLimiter:
            sample_scan_kernel<kLimiter><<<blocks, kThreads, 0, s>>>(xi, yo, ci, co, k, lanes, frames);
            break;
        case kGate:
            sample_scan_kernel<kGate><<<blocks, kThreads, 0, s>>>(xi, yo, ci, co, k, lanes, frames);
            break;
        case kPink:
            sample_scan_kernel<kPink><<<blocks, kThreads, 0, s>>>(xi, yo, ci, co, k, lanes, frames);
            break;
        default:
            return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

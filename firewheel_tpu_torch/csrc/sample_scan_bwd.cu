// K9: the backward of K5 (csrc/sample_scan.cu), one launch a call.
//
// Replaces no TPU kernel: the JAX package differentiates its per-sample
// recurrences (firewheel_tpu/ops/dynamics.py:30 sample_scan, a lax.scan
// over the block, with each node's step) by XLA's autodiff.  The port
// replaced those scans with K5, which autograd cannot see through, so they
// get their vector-Jacobian product here, bound through
// torch.autograd.Function (ops/dynamics.py:_ScanFn).  Its plain version is
// ops/dynamics.py:scan_lanes_backward_reference, frame by frame in
// float32; this kernel does its operations in its order (built with
// --fmad=false), the gradient autograd takes through the plain steps:
//
//  * envelope: lam = g_y + lam; b = x > env_prev ? att : rel carries no
//    gradient; g_x = lam (1 - b); lam (env_prev - x) goes to att or rel;
//    lam <- lam b.
//  * limiter: env = min(g, u), u = fmaf(rel, env_prev, (1 - rel) g)
//    recomputed; the lesser side takes lam, a tie half each way (torch's
//    and JAX's minimum); u's share goes on to g, rel and env_prev.
//  * gate: the latch (open, hold) is recomputed forward from the level and
//    the carry into a device-memory workspace [2, lanes, frames] (each
//    frame's open value and the hold it started from), then run
//    backwards: the gain's adjoint through b = target > g_prev ? att : rel,
//    the target's into floor and into open where neither branch of its
//    latch fires, the hold's through max(hold - 1, 0) (a tie at 0 half) to
//    hold_n where the level opens the gate.  The level and the thresholds
//    get none: they enter comparisons only.
//  * pink: linear; q = g_y / 4, g_x = ((c0 lam0 + c1 lam1) + c2 lam2) +
//    (c0 + c1 + c2 + 0.1848) q, lam_k <- a_k (lam_k + q).
//
// Design: K5's, run backwards.  One warp a CTA, one lane a thread; x, y
// and g_y (and the gate's workspace) go through shared memory in stages of
// 32 frames by cp.async, last stage first (csrc/reverse_stage.cuh), y with
// the frame before the stage beside it (load_halo), so that a frame's
// y[n - 1] is read from the tile at every frame; the pink's adjoint, which
// is linear, stages g_y alone.  g_x leaves a stage at a time in coalesced
// 16-byte stores; the per-lane coefficient gradients are sums in
// registers, written once.
//
// What bounds it on an H100: bytes.  x, y and g_y read and g_x written, 16
// bytes a frame (17 MB for the bus's 8192 lanes of 128 frames, 5.0 us at
// 3.35 TB/s; the gate's workspace written and read besides, 16 more); the
// pink's g_y read and g_x written, 8 bytes a frame; against a recurrence of
// a few dependent operations a frame.

#include <cuda_runtime.h>
#include <stdint.h>

#include "reverse_stage.cuh"

namespace k9 {

constexpr int kMaxCarry = 3;
constexpr int kMaxCoef = 6;

using bwd::Operand;

// x, y, g_y, g_x [lanes, frames]; the forward's carry in and coefficients,
// and the carry-out gradients, per lane; g_carry [n_carry, lanes], g_coef
// [n_coef, lanes]; ws the gate's workspace [2, lanes, frames]
struct Args {
    const float* x;
    const float* y;
    const float* g_y;
    float* g_x;
    Operand carry[kMaxCarry];
    Operand coef[kMaxCoef];
    Operand g_carry_out[kMaxCarry];
    float* g_carry;
    float* g_coef;
    float* ws;
    int64_t inner, lanes;
    int frames;
};

}  // namespace k9

namespace {

using namespace bwd;
using k9::Args;

enum Kind { kEnvelope = 0, kLimiter = 1, kGate = 2, kPink = 3 };

// The adjoints, by kind.  step(xi, prev, g) runs frame n backwards from
// x[n], y[n - 1] (prev) and g_y[n], and returns g_x[n] (the pink's,
// step(g), from g_y[n] alone: kIn = 1); store writes the carry's and the
// coefficients' gradients.

struct EnvelopeBwd {
    static constexpr int kIn = 3;  // x, y, g_y
    float att, rel, env0, lam, g_att = 0.0f, g_rel = 0.0f;
    __device__ EnvelopeBwd(const Args& a, int64_t lane) {
        att = at(a.coef[0], lane, a.inner);
        rel = at(a.coef[1], lane, a.inner);
        env0 = at(a.carry[0], lane, a.inner);
        lam = at(a.g_carry_out[0], lane, a.inner);
    }
    __device__ float carry_in() const { return env0; }
    __device__ __forceinline__ float step(float xi, float prev, float g, const Tile*, int, int) {
        lam = lam + g;
        const bool up = xi > prev;
        const float b = up ? att : rel;
        const float gx = lam * (1.0f - b);
        const float gb = lam * (prev - xi);
        if (up)
            g_att = g_att + gb;
        else
            g_rel = g_rel + gb;
        lam = lam * b;
        return gx;
    }
    __device__ void store(const Args& a, int64_t lane) const {
        a.g_carry[lane] = lam;
        a.g_coef[lane] = g_att;
        a.g_coef[a.lanes + lane] = g_rel;
    }
};

struct LimiterBwd {
    static constexpr int kIn = 3;
    float rel, omb, env0, lam, g_rel = 0.0f;
    __device__ LimiterBwd(const Args& a, int64_t lane) {
        rel = at(a.coef[0], lane, a.inner);
        omb = 1.0f - rel;
        env0 = at(a.carry[0], lane, a.inner);
        lam = at(a.g_carry_out[0], lane, a.inner);
    }
    __device__ float carry_in() const { return env0; }
    __device__ __forceinline__ float step(float gi, float prev, float g, const Tile*, int, int) {
        lam = lam + g;
        const float u = fmaf(rel, prev, omb * gi);  // the step's release, as K5 computed it
        const float to_u = u < gi ? lam : (u == gi ? 0.5f * lam : 0.0f);
        const float gx = (lam - to_u) + to_u * omb;
        g_rel = g_rel + to_u * (prev - gi);
        lam = to_u * rel;
        return gx;
    }
    __device__ void store(const Args& a, int64_t lane) const {
        a.g_carry[lane] = lam;
        a.g_coef[lane] = g_rel;
    }
};

struct GateBwd {
    static constexpr int kIn = 5;  // x, y, g_y, and the workspace's open and hold
    float open_lin, close_lin, floor_gain, att, rel, g0;
    float lam_o, lam_h, lam_g;
    float g_floor = 0.0f, g_att = 0.0f, g_rel = 0.0f, g_hold_n = 0.0f;
    __device__ GateBwd(const Args& a, int64_t lane) {
        open_lin = at(a.coef[0], lane, a.inner);
        close_lin = at(a.coef[1], lane, a.inner);
        floor_gain = at(a.coef[2], lane, a.inner);
        att = at(a.coef[3], lane, a.inner);
        rel = at(a.coef[4], lane, a.inner);
        g0 = at(a.carry[2], lane, a.inner);
        lam_o = at(a.g_carry_out[0], lane, a.inner);
        lam_h = at(a.g_carry_out[1], lane, a.inner);
        lam_g = at(a.g_carry_out[2], lane, a.inner);
    }
    __device__ float carry_in() const { return g0; }
    __device__ __forceinline__ float step(float lvl, float prev, float g, const Tile* slot,
                                          int t, int f) {
        lam_g = lam_g + g;
        const float o = slot[3][t][f];  // the frame's open value
        const float h = slot[4][t][f];  // the hold it started from
        const bool above = lvl >= open_lin;
        const bool keep = !above && !(lvl < close_lin && h <= 0.0f);
        const float target = o + (1.0f - o) * floor_gain;
        const bool up = target > prev;
        const float b = up ? att : rel;
        const float gb = lam_g * (prev - target);
        if (up)
            g_att = g_att + gb;
        else
            g_rel = g_rel + gb;
        const float lam_t = lam_g * (1.0f - b);
        g_floor = g_floor + lam_t * (1.0f - o);
        lam_o = keep ? lam_o + lam_t * (1.0f - floor_gain) : 0.0f;
        if (above) g_hold_n = g_hold_n + lam_h;
        const float d = h - 1.0f;
        lam_h = (above || d < 0.0f) ? 0.0f : (d == 0.0f ? 0.5f * lam_h : lam_h);
        lam_g = lam_g * b;
        return 0.0f;  // the level enters comparisons only
    }
    __device__ void store(const Args& a, int64_t lane) const {
        a.g_carry[lane] = lam_o;
        a.g_carry[a.lanes + lane] = lam_h;
        a.g_carry[2 * a.lanes + lane] = lam_g;
        a.g_coef[lane] = 0.0f;
        a.g_coef[a.lanes + lane] = 0.0f;
        a.g_coef[2 * a.lanes + lane] = g_floor;
        a.g_coef[3 * a.lanes + lane] = g_att;
        a.g_coef[4 * a.lanes + lane] = g_rel;
        a.g_coef[5 * a.lanes + lane] = g_hold_n;
    }
};

// Paul Kellet's economy pink filter's poles and input weights (K5's)
constexpr float kA0 = 0.99765f, kA1 = 0.96300f, kA2 = 0.57000f;
constexpr float kC0 = 0.0990460f, kC1 = 0.2965164f, kC2 = 1.0526913f;
constexpr float kCSum = ((kC0 + kC1) + kC2) + 0.1848f;

struct PinkBwd {
    static constexpr int kIn = 1;  // g_y
    float lam0, lam1, lam2;
    __device__ PinkBwd(const Args& a, int64_t lane) {
        lam0 = at(a.g_carry_out[0], lane, a.inner);
        lam1 = at(a.g_carry_out[1], lane, a.inner);
        lam2 = at(a.g_carry_out[2], lane, a.inner);
    }
    __device__ __forceinline__ float step(float g) {
        const float q = g * 0.25f;
        const float gx = ((kC0 * lam0 + kC1 * lam1) + kC2 * lam2) + kCSum * q;
        lam0 = kA0 * (lam0 + q);
        lam1 = kA1 * (lam1 + q);
        lam2 = kA2 * (lam2 + q);
        return gx;
    }
    __device__ void store(const Args& a, int64_t lane) const {
        a.g_carry[lane] = lam0;
        a.g_carry[a.lanes + lane] = lam1;
        a.g_carry[2 * a.lanes + lane] = lam2;
    }
};

// The gate's latch, forward over the lane's frames from the level and the
// carry: tile 1 of each stage gets the hold each frame started from, tile 2
// the frame's open value, stored to the workspace.
template <bool kVec>
__device__ void gate_latch(const Args& a, Tile (*ring)[GateBwd::kIn], int64_t lane0,
                           int rows, bool live, int64_t lane, int t) {
    const float open_lin = at(a.coef[0], lane, a.inner);
    const float close_lin = at(a.coef[1], lane, a.inner);
    const float hold_n = at(a.coef[5], lane, a.inner);
    float opn = at(a.carry[0], lane, a.inner);
    float hold = at(a.carry[1], lane, a.inner);
    const int64_t plane = a.lanes * a.frames;
    const float* src[1] = {a.x};
    float* const dst[2] = {a.ws + plane, a.ws};
    const int out[2] = {1, 2};
    run_stages<1, 2, GateBwd::kIn, kVec, false>(
        src, dst, out, ring, lane0, rows, a.frames, t, [&](Tile* slot, int, int nf) {
            if (!live) return;
            for (int f = 0; f < nf; ++f) {
                const float lvl = slot[0][t][f];
                const bool above = lvl >= open_lin;
                slot[1][t][f] = hold;
                opn = above ? 1.0f : ((lvl < close_lin && hold <= 0.0f) ? 0.0f : opn);
                const float h = hold - 1.0f;
                hold = above ? hold_n : (h != h ? h : (h > 0.0f ? h : 0.0f));
                slot[2][t][f] = opn;
            }
        });
}

template <class K, bool kVec>
__global__ void __launch_bounds__(kLanes) sample_scan_bwd_kernel(const Args a) {
    __shared__ __align__(16) Tile ring[kRing][K::kIn];

    const int t = threadIdx.x;
    const int64_t lane0 = static_cast<int64_t>(blockIdx.x) * kLanes;
    const int rows = static_cast<int>(a.lanes - lane0 < kLanes ? a.lanes - lane0 : kLanes);
    const bool live = t < rows;
    const int64_t lane = live ? lane0 + t : lane0;

    if constexpr (K::kIn == GateBwd::kIn) gate_latch<kVec>(a, ring, lane0, rows, live, lane, t);

    K k(a, lane);
    float* const dst[1] = {a.g_x};
    if constexpr (K::kIn == 1) {  // the pink: g_y in tile 0, g_x out of it
        const float* src[1] = {a.g_y};
        const int out[1] = {0};
        run_stages<1, 1, 1, kVec, true>(
            src, dst, out, ring, lane0, rows, a.frames, t, [&](Tile* slot, int, int nf) {
                if (!live) return;
                float* gr = slot[0][t];
                for (int f = nf - 1; f >= 0; --f) gr[f] = k.step(gr[f]);
            });
    } else {
        const int64_t plane = a.lanes * a.frames;
        const float* src[K::kIn];
        src[0] = a.x;
        src[1] = a.y;
        src[2] = a.g_y;
        if constexpr (K::kIn == GateBwd::kIn) {
            src[3] = a.ws;
            src[4] = a.ws + plane;
        }
        const int out[1] = {2};
        // y's tile (1) carries the frame before its stage: y[n - 1] at every
        // frame from the tile, the carry in at the lane's first
        run_stages<K::kIn, 1, K::kIn, kVec, true, 1>(
            src, dst, out, ring, lane0, rows, a.frames, t, [&](Tile* slot, int s, int nf) {
                if (!live) return;
                const float* xr = slot[0][t];
                const float* yr = slot[1][t];
                float* gr = slot[2][t];
                const float y_before = s ? yr[kStage] : k.carry_in();
                for (int f = nf - 1; f >= 0; --f)
                    gr[f] = k.step(xr[f], f ? yr[f - 1] : y_before, gr[f], slot, t, f);
            });
    }
    if (live) k.store(a, lane);
}

template <class K>
int launch(const Args& a, cudaStream_t s) {
    const unsigned blocks = static_cast<unsigned>((a.lanes + kLanes - 1) / kLanes);
    const bool vec = a.frames % 4 == 0 && aligned16(a.x) && aligned16(a.y) &&
                     aligned16(a.g_y) && aligned16(a.g_x) && (a.ws == nullptr || aligned16(a.ws));
    if (vec)
        sample_scan_bwd_kernel<K, true><<<blocks, kLanes, 0, s>>>(a);
    else
        sample_scan_bwd_kernel<K, false><<<blocks, kLanes, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kind as fw_sample_scan's (0 envelope, 1 limiter, 2 gate, 3 pink); the
// operands as k9::Args says.  Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for an unknown kind, a bad
// shape or the gate's workspace missing); it does not synchronise.
extern "C" int fw_sample_scan_bwd(int kind, const k9::Args* args, void* stream) {
    const Args& a = *args;
    if (a.lanes <= 0) return 0;
    if (a.frames < 0 || a.inner < 1 || (kind == kGate && a.ws == nullptr && a.frames > 0))
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (kind) {
        case kEnvelope: return launch<EnvelopeBwd>(a, s);
        case kLimiter: return launch<LimiterBwd>(a, s);
        case kGate: return launch<GateBwd>(a, s);
        case kPink: return launch<PinkBwd>(a, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

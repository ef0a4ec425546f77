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
//    the carry (each frame's open value and the hold it started from),
//    then run backwards: the gain's adjoint through b = target > g_prev ?
//    att : rel, the target's into floor and into open where neither
//    branch of its latch fires, the hold's through max(hold - 1, 0) (a tie
//    at 0 half) to hold_n where the level opens the gate.  The level and
//    the thresholds get none: they enter comparisons only.
//  * pink: linear; q = g_y / 4, g_x = ((c0 lam0 + c1 lam1) + c2 lam2) +
//    (c0 + c1 + c2 + 0.1848) q, lam_k <- a_k (lam_k + q).
//
// Design: K5's, run backwards.  One warp a CTA, one lane a thread; x, y
// and g_y go through shared memory in stages of 32 frames by cp.async,
// last stage first (csrc/reverse_stage.cuh), y with the frame before the
// stage beside it (load_halo), so that a frame's y[n - 1] is read from the
// tile at every frame; the pink's adjoint, which is linear, stages g_y
// alone.  g_x leaves a stage at a time in coalesced 16-byte stores; the
// per-lane coefficient gradients are sums in registers, written once.
//
//  a. A full stage of the kinds that read x and y runs a loop over its 8
//     quads of 4 frames, a pair of quads a turn (the pink's, a few
//     operations a frame, runs unrolled), the pair's x, y and g_y (the
//     gate's latch too) read as float4s from the thread's rows of the tiles
//     before either is run and its g_x written back the same way: the
//     reads sit off the chain that
//     carries the adjoint, a quarter-warp's float4s hit distinct banks (a
//     float a thread from one column of 32 rows meets 4 threads a bank),
//     and the stage's code stays small.  A ragged last stage runs a frame
//     at a time.  The steps are branch-free, every operand of a choice
//     computed before it (bwd::pick where nvcc would not keep a select): a
//     choice one of whose operands was computed on its side alone (0.5 lam,
//     a sum added on one side) compiled to a branch a frame, which split
//     the stage into blocks scheduled one frame at a time.
//  b. The gate's latch never leaves the chip: a checkpoint sweep, forwards
//     over the staged x, writes the latch's (open, hold) at the start of
//     each stage to a small array [2, stages, lanes] (2/32 of one array's
//     bytes); the backward sweep, in the same ring (run_sweeps), recomputes
//     the stage's latch from its checkpoint and the x tile it has staged
//     into two tiles beside the ring, then runs the adjoint.
//  c. Each lane's operations run in the plain version's serial order: bit
//     for bit.
//
// What bounds it on an H100: bytes, and the warps' instructions.  x, y and
// g_y read and g_x written, 16 bytes a frame (17 MB for the bus's 8192
// lanes of 128 frames, 5.0 us at 3.35 TB/s); the gate reads x once more
// for its checkpoint sweep, 20 bytes a frame (21 MB, 6.3 us); the pink's
// g_y read and g_x written, 8 bytes a frame.  At 8192 lanes the card holds
// two warps an SM, each issuing one lane's serial chain and its copies'
// addresses: the gate's ~70 instructions a frame, its latch twice and its
// adjoint, set its time.

#include <cuda_runtime.h>
#include <stdint.h>

#include "reverse_stage.cuh"

namespace k9 {

constexpr int kMaxCarry = 3;
constexpr int kMaxCoef = 6;

using bwd::Operand;

// x, y, g_y, g_x [lanes, frames]; the forward's carry in and coefficients,
// and the carry-out gradients, per lane; g_carry [n_carry, lanes], g_coef
// [n_coef, lanes]; ckpt the gate's latch checkpoints [2, stages, lanes]
// (open, then hold; stages = ceil(frames / 32)), null for the other kinds
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
    float* ckpt;
    int64_t inner, lanes;
    int frames;
};

}  // namespace k9

namespace {

using namespace bwd;
using k9::Args;

enum Kind { kEnvelope = 0, kLimiter = 1, kGate = 2, kPink = 3 };

constexpr int kRing = 2;  // stages of the staged arrays in flight

// The adjoints, by kind.  step(xi, prev, g, o, h) runs frame n backwards
// from x[n], y[n - 1] (prev) and g_y[n] (the gate: and the latch's open
// value o and the hold h it started from at frame n), and returns g_x[n]
// (the pink's, step(g), from g_y[n] alone: kIn = 1); store writes the
// carry's and the coefficients' gradients.  kLatch: the gate's latch is
// recomputed (Latch).

struct EnvelopeBwd {
    static constexpr int kIn = 3;  // x, y, g_y
    static constexpr bool kLatch = false;
    float att, rel, env0, lam, g_att = 0.0f, g_rel = 0.0f;
    __device__ EnvelopeBwd(const Args& a, RowAt ra) {
        att = at(a.coef[0], ra);
        rel = at(a.coef[1], ra);
        env0 = at(a.carry[0], ra);
        lam = at(a.g_carry_out[0], ra);
    }
    __device__ float carry_in() const { return env0; }
    __device__ __forceinline__ float step(float xi, float prev, float g, float, float) {
        lam = lam + g;
        const bool up = xi > prev;
        const float b = up ? att : rel;
        const float gx = lam * (1.0f - b);
        const float gb = lam * (prev - xi);
        const float ga = g_att + gb, gr = g_rel + gb;
        g_att = up ? ga : g_att;
        g_rel = up ? g_rel : gr;
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
    static constexpr bool kLatch = false;
    float rel, omb, env0, lam, g_rel = 0.0f;
    __device__ LimiterBwd(const Args& a, RowAt ra) {
        rel = at(a.coef[0], ra);
        omb = 1.0f - rel;
        env0 = at(a.carry[0], ra);
        lam = at(a.g_carry_out[0], ra);
    }
    __device__ float carry_in() const { return env0; }
    __device__ __forceinline__ float step(float gi, float prev, float g, float, float) {
        lam = lam + g;
        const float u = fmaf(rel, prev, omb * gi);  // the step's release, as K5 computed it
        const float half = 0.5f * lam;
        const float to_u = u < gi ? lam : (u == gi ? half : 0.0f);
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

// The gate's latch, forwards from the level: each frame's open value (o)
// and the hold it started from (h).
struct Latch {
    float open_lin, close_lin, hold_n, opn, hold;
    __device__ Latch(const Args& a, RowAt ra) {
        open_lin = at(a.coef[0], ra);
        close_lin = at(a.coef[1], ra);
        hold_n = at(a.coef[5], ra);
        opn = at(a.carry[0], ra);
        hold = at(a.carry[1], ra);
    }
    __device__ __forceinline__ void step(float lvl, float& o, float& h) {
        const bool above = lvl >= open_lin;
        const bool shut = (lvl < close_lin) & (hold <= 0.0f);
        h = hold;
        opn = above ? 1.0f : (shut ? 0.0f : opn);
        const float d = hold - 1.0f;
        const float dm = d > 0.0f ? d : 0.0f;
        hold = above ? hold_n : (d != d ? d : dm);
        o = opn;
    }
};

struct GateBwd {
    static constexpr int kIn = 3;  // x, y, g_y; the latch in two tiles beside the ring
    static constexpr bool kLatch = true;
    float open_lin, close_lin, floor_gain, att, rel, g0;
    float lam_o, lam_h, lam_g;
    float g_floor = 0.0f, g_att = 0.0f, g_rel = 0.0f, g_hold_n = 0.0f;
    __device__ GateBwd(const Args& a, RowAt ra) {
        open_lin = at(a.coef[0], ra);
        close_lin = at(a.coef[1], ra);
        floor_gain = at(a.coef[2], ra);
        att = at(a.coef[3], ra);
        rel = at(a.coef[4], ra);
        g0 = at(a.carry[2], ra);
        lam_o = at(a.g_carry_out[0], ra);
        lam_h = at(a.g_carry_out[1], ra);
        lam_g = at(a.g_carry_out[2], ra);
    }
    __device__ float carry_in() const { return g0; }
    __device__ __forceinline__ float step(float lvl, float prev, float g, float o, float h) {
        lam_g = lam_g + g;
        const bool above = lvl >= open_lin;
        const bool keep = !above & !((lvl < close_lin) & (h <= 0.0f));
        const float target = o + (1.0f - o) * floor_gain;
        const bool up = target > prev;
        const float b = up ? att : rel;
        const float gb = lam_g * (prev - target);
        const float ga = g_att + gb, gr = g_rel + gb;
        g_att = up ? ga : g_att;
        g_rel = up ? g_rel : gr;
        const float lam_t = lam_g * (1.0f - b);
        g_floor = g_floor + lam_t * (1.0f - o);
        lam_o = pick(keep, lam_o + lam_t * (1.0f - floor_gain), 0.0f);
        g_hold_n = pick(above, g_hold_n + lam_h, g_hold_n);
        const float d = h - 1.0f;
        lam_h = pick(above | (d < 0.0f), 0.0f, pick(d == 0.0f, 0.5f * lam_h, lam_h));
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
    static constexpr bool kLatch = false;
    float lam0, lam1, lam2;
    __device__ PinkBwd(const Args& a, RowAt ra) {
        lam0 = at(a.g_carry_out[0], ra);
        lam1 = at(a.g_carry_out[1], ra);
        lam2 = at(a.g_carry_out[2], ra);
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

// Dynamic shared memory: kRing slots of K::kIn tiles, then the gate's two
// latch tiles (open, hold).
template <class K>
constexpr size_t shared_bytes() {
    return ring_bytes(kRing, K::kIn, K::kLatch ? 2 : 0);
}

template <class K, bool kVec>
__global__ void __launch_bounds__(kLanes) sample_scan_bwd_kernel(const Args a) {
    extern __shared__ __align__(16) unsigned char smem[];
    Tile(*ring)[K::kIn] = reinterpret_cast<Tile(*)[K::kIn]>(smem);
    Tile* latch = reinterpret_cast<Tile*>(smem) + kRing * K::kIn;  // the gate's: open, hold

    const int t = threadIdx.x;
    const int64_t lane0 = static_cast<int64_t>(blockIdx.x) * kLanes;
    const int rows = static_cast<int>(a.lanes - lane0 < kLanes ? a.lanes - lane0 : kLanes);
    const bool live = t < rows;
    const int64_t lane = live ? lane0 + t : lane0;
    const int stages = (a.frames + kStage - 1) / kStage;

    const RowAt ra = row_at(lane, a.inner);
    K k(a, ra);
    float* const dst[1] = {a.g_x};

    if constexpr (K::kIn == 1) {  // the pink: g_y in tile 0, g_x out of it
        const float* src[1] = {a.g_y};
        const int out[1] = {0};
        run_sweeps<0, 1, 1, 1, kRing, kVec>(
            src, dst, out, ring, lane0, rows, a.frames, t, NoSweep(), [&](Tile* slot, int, int nf) {
                if (!live) return;
                if (nf == kStage) {
                    float4* g4 = quads(slot[0], t);
#pragma unroll
                    for (int q = kQuads - 1; q >= 0; --q) {
                        float4 f = g4[q];
                        f.w = k.step(f.w);
                        f.z = k.step(f.z);
                        f.y = k.step(f.y);
                        f.x = k.step(f.x);
                        g4[q] = f;
                    }
                } else {
                    float* gr = slot[0][t];
                    for (int f = nf - 1; f >= 0; --f) gr[f] = k.step(gr[f]);
                }
            });
    } else {
        // the gate: the latch at the start of the stage run next
        Latch l(a, ra);
        auto ck = [&](int j, int s) {
            return a.ckpt + (static_cast<int64_t>(j) * stages + s) * a.lanes + lane;
        };
        float n_open = 0.0f, n_hold = 0.0f;
        // its checkpoint sweep
        auto checkpoint = [&](Tile* slot, int s, int nf) {
            if (!live) return;
            *ck(0, s) = n_open = l.opn;
            *ck(1, s) = n_hold = l.hold;
            float o, h;
            if (nf == kStage) {
                const float4* x4 = quads(slot[0], t);
#pragma unroll
                for (int q = 0; q < kQuads; ++q) {
                    const float4 f = x4[q];
                    l.step(f.x, o, h);
                    l.step(f.y, o, h);
                    l.step(f.z, o, h);
                    l.step(f.w, o, h);
                }
            } else {
                for (int f = 0; f < nf; ++f) l.step(slot[0][t][f], o, h);
            }
        };
        const float* src[3] = {a.x, a.y, a.g_y};
        const int out[1] = {2};
        // y's tile (1) carries the frame before its stage: y[n - 1] at every
        // frame from the tile, the carry in at the lane's first; the gate's
        // checkpoint sweep first, in the same ring (x staged alone)
        run_sweeps<K::kLatch ? 1 : 0, 3, 1, K::kIn, kRing, kVec, 1>(
            src, dst, out, ring, lane0, rows, a.frames, t, checkpoint,
            [&](Tile* slot, int s, int nf) {
                if (!live) return;
                const float y_before = s ? slot[1][t][kStage] : k.carry_in();
                if constexpr (K::kLatch) {  // the stage's latch, from its checkpoint
                    l.opn = n_open;
                    l.hold = n_hold;
                    if (s > 0) {  // the next stage's, read while this one runs
                        n_open = *ck(0, s - 1);
                        n_hold = *ck(1, s - 1);
                    }
                    if (nf == kStage) {
                        const float4* x4 = quads(slot[0], t);
                        float4* o4 = quads(latch[0], t);
                        float4* h4 = quads(latch[1], t);
#pragma unroll
                        for (int q = 0; q < kQuads; ++q) {
                            const float4 f = x4[q];
                            float4 o, h;
                            l.step(f.x, o.x, h.x);
                            l.step(f.y, o.y, h.y);
                            l.step(f.z, o.z, h.z);
                            l.step(f.w, o.w, h.w);
                            o4[q] = o;
                            h4[q] = h;
                        }
                    } else {
                        for (int f = 0; f < nf; ++f)
                            l.step(slot[0][t][f], latch[0][t][f], latch[1][t][f]);
                    }
                }
                if (nf == kStage) {
                    const float4* x4 = quads(slot[0], t);
                    const float4* y4 = quads(slot[1], t);
                    const float4* o4 = quads(latch[0], t);
                    const float4* h4 = quads(latch[1], t);
                    float4* g4 = quads(slot[2], t);
                    // quad q's operands, read a pair of quads before either
                    // is stored; a loop, so that the stage's code stays small
                    struct Quad {
                        float4 x, y, g, o, h;
                        float yb;
                    };
                    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
                    auto load = [&](int q) {
                        Quad d;
                        d.x = x4[q];
                        d.y = y4[q];
                        d.yb = q ? slot[1][t][4 * q - 1] : y_before;
                        d.g = g4[q];
                        d.o = K::kLatch ? o4[q] : zero;
                        d.h = K::kLatch ? h4[q] : zero;
                        return d;
                    };
                    auto run = [&](const Quad& d) {
                        float4 gq;
                        gq.w = k.step(d.x.w, d.y.z, d.g.w, d.o.w, d.h.w);
                        gq.z = k.step(d.x.z, d.y.y, d.g.z, d.o.z, d.h.z);
                        gq.y = k.step(d.x.y, d.y.x, d.g.y, d.o.y, d.h.y);
                        gq.x = k.step(d.x.x, d.yb, d.g.x, d.o.x, d.h.x);
                        return gq;
                    };
#pragma unroll 1
                    for (int q = kQuads - 1; q > 0; q -= 2) {
                        const Quad d1 = load(q), d0 = load(q - 1);
                        g4[q] = run(d1);
                        g4[q - 1] = run(d0);
                    }
                } else {
                    const float* xr = slot[0][t];
                    const float* yr = slot[1][t];
                    float* gr = slot[2][t];
                    for (int f = nf - 1; f >= 0; --f)
                        gr[f] = k.step(xr[f], f ? yr[f - 1] : y_before, gr[f],
                                       K::kLatch ? latch[0][t][f] : 0.0f,
                                       K::kLatch ? latch[1][t][f] : 0.0f);
                }
            });
    }
    if (live) k.store(a, lane);
}

template <class K>
int launch(const Args& a, cudaStream_t s) {
    const bool vec = a.frames % 4 == 0 && aligned16(a.x) && aligned16(a.y) &&
                     aligned16(a.g_y) && aligned16(a.g_x);
    return vec ? launch_kernel(sample_scan_bwd_kernel<K, true>, a.lanes, shared_bytes<K>(), s, a)
               : launch_kernel(sample_scan_bwd_kernel<K, false>, a.lanes, shared_bytes<K>(), s,
                               a);
}

}  // namespace

// kind as fw_sample_scan's (0 envelope, 1 limiter, 2 gate, 3 pink); the
// operands as k9::Args says.  Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for an unknown kind, a bad
// shape or the gate's checkpoints missing); it does not synchronise.
extern "C" int fw_sample_scan_bwd(int kind, const k9::Args* args, void* stream) {
    const Args& a = *args;
    if (a.lanes <= 0) return 0;
    if (a.frames < 0 || a.inner < 1 || (kind == kGate && a.ckpt == nullptr && a.frames > 0))
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

// K8: the backwards of K7's scans (csrc/assoc_scan.cu), one launch a call.
//
// Replaces no TPU kernel: the JAX package differentiates its associative
// scans (firewheel_tpu/ops/iir.py:biquad_scan, :one_pole_scan, through
// lax.associative_scan) by XLA's autodiff.  The port replaced those scans
// with K7, which autograd cannot see through, so each gets its
// vector-Jacobian product here, bound through torch.autograd.Function
// (ops/iir.py:_CascadeFn, _OnePoleFn).  Its plain versions are
// ops/iir.py:biquad_cascade_backward_reference and
// one_pole_scan_backward_reference, frame by frame in float32; this
// kernel does their operations in their order (built with --fmad=false).
//
// * fw_biquad_cascade_bwd: up to kMaxSections TDF-II sections in series.
//   Section s's adjoint runs backwards in time: with the state's adjoint
//   (mu1, mu2) (the state-out gradient at the last frame), e = (g_y - a1
//   mu1) - a2 mu2 is the output's, g_x = (b0 e + b1 mu1) + b2 mu2, the
//   coefficients' gradients sum e x, mu1 x, mu2 x, -mu1 y and -mu2 y over
//   the frames, and (mu1, mu2) <- (e, mu1); section s's g_x is section
//   s - 1's g_y.  Its input x and output y are the cascade's for the first
//   and the last section; the others' are recomputed forward, frame by
//   frame, from x and the states in (y = b0 x + z1, z1 = (b1 x - a1 y) +
//   z2, z2 = b2 x - a2 y).
// * fw_one_pole_scan_bwd: y = a x + b y_prev backwards, lam = g_y + b lam,
//   g_x = a lam, g_a = sum lam x, g_b = sum lam y_prev; lam[n + 1] y[n] is
//   added at frame n, so no frame reads the one before it.
//
// Design: one warp a CTA, one row a thread, the recurrences serial along
// the row; arrays go through shared memory in stages of 32 frames by
// cp.async (csrc/reverse_stage.cuh), so that device memory is read and
// written in coalesced 16-byte pieces; the per-row coefficient gradients
// are sums in registers, written once.  A cascade of S sections
// (biquad_bwd_kernel<S>) takes two sweeps over a row through one ring
// (run_sweeps), and its recomputed inputs never leave the chip:
//
//  a. A checkpoint sweep, forwards: x is staged, sections 0..S-2 run frame
//     by frame, and each one's (z1, z2) at the start of each stage goes to
//     a small array [S - 1, 2, stages, rows] in device memory (2 (S - 1) /
//     32 of one array's bytes, written and read by the same thread).
//  b. One backward sweep over the stages, last first, its first stages in
//     flight while (a) ends: x, y and g_y are staged; sections 0..S-2 are
//     recomputed over the stage from its checkpoint into S - 1 tiles
//     beside the ring; then the adjoints of sections S-1..0 run over the
//     stage, each backwards in time; g_x is stored once a stage.  Each
//     section's (mu1, mu2), five sums and coefficients stay in registers
//     across stages (the kernel is instantiated for each S, its loops over
//     sections unrolled); the next stage's checkpoints are read while this
//     one runs.
//  c. A full stage runs its sections as a wavefront: step tau runs each
//     section at one frame, section k one frame behind section k - 1
//     (forwards) or k + 1 (backwards), its input from that neighbour a
//     register made a step before, so that the S serial chains interleave
//     in the warp's instruction stream.  From three sections the steps
//     where every section runs are a loop over pairs of steps, each pair's
//     operands read before either stores: unrolled whole, three sections'
//     stage was ~3 000 instructions, read once a stage, and ran at about a
//     fifth of an instruction a cycle (PERF.md §6).  One or two
//     sections run unrolled whole, from registers read a float4 at a time.
//     A ragged last stage (frames % 32) runs a frame at a time.
//  d. Every section's values and sums come from the plain version's
//     operations, in its order, from the same states: bit for bit.
//
// Shared memory: a ring of two stages of the three staged arrays plus S - 1
// recomputed tiles, 4.5 KB a tile: 27 KB at S = 1, 36 KB at S = 3 (six CTAs
// an SM; 16 384 rows are 512 CTAs, under four an SM, all resident at
// once), 58.5 KB at S = 8 (dynamic shared memory past 48 KB; three CTAs an
// SM, so 16 384 rows take a second wave).
//
// What bounds it on an H100: bytes, and from three sections the warps'
// instructions.  The cascade reads x twice and y and g_y once and writes
// g_x, 20 bytes a frame (42 MB at the EQ's f32[16384, 128], 12.5 us at
// 3.35 TB/s, against the 36.9 MB of x, y, g_y and g_x once); one section
// skips the checkpoint sweep, 16 bytes a frame.  The work is 19 f32
// operations a frame a section and 9 more a recomputed one, twice for the
// checkpoint sweep.  Each row's frames are serial, so the card holds one
// thread a row: 16 384 rows are 512 warps, about four an SM, each issuing
// its own serial chains, and only the copies kept in flight ahead of the
// recurrences hide device memory's latency.

#include <cuda_runtime.h>
#include <stdint.h>

#include "reverse_stage.cuh"

namespace k8 {

constexpr int kMaxSections = 8;

using bwd::Operand;

// S sections: each one's coefficients (b0, b1, b2, a1, a2), state in (z1,
// z2) and state-out gradient; x, y, g_y, g_x [rows, frames]; g_coef [S, 5,
// rows], g_z_in [S, 2, rows]; ckpt [S - 1, 2, stages, rows] (null for S =
// 1), stages = ceil(frames / 32)
struct BiquadBwdArgs {
    Operand coef[kMaxSections][5];
    Operand z_in[kMaxSections][2];
    Operand g_z_out[kMaxSections][2];
    const float* x;
    const float* y;
    const float* g_y;
    float* g_x;
    float* g_coef;
    float* g_z_in;
    float* ckpt;
    int64_t inner, rows;
    int frames, sections;
};

// the one-pole's a, b, y_in and the carry-out gradient; g_coef [2, rows]
// (g_a, g_b), g_y_in [rows]
struct OnePoleBwdArgs {
    Operand a, b, y_in, g_y_out;
    const float* x;
    const float* y;
    const float* g_y;
    float* g_x;
    float* g_coef;
    float* g_y_in;
    int64_t inner, rows;
    int frames;
};

}  // namespace k8

namespace {

using namespace bwd;
using k8::BiquadBwdArgs;
using k8::OnePoleBwdArgs;

constexpr int kRing = 2;  // stages of the staged arrays in flight

// One section's coefficients, read once a row.
struct Section {
    float b0, b1, b2, a1, a2;

    // The TDF-II step: x's output, the state (z1, z2) advanced.
    __device__ __forceinline__ float step(float& z1, float& z2, float xi) const {
        const float yi = b0 * xi + z1;
        z1 = (b1 * xi - a1 * yi) + z2;
        z2 = b2 * xi - a2 * yi;
        return yi;
    }
};

// One section's adjoint: the state's (mu1, mu2) and the coefficients'
// gradient sums.
struct Adjoint {
    float mu1, mu2;
    float g0 = 0.0f, g1 = 0.0f, g2 = 0.0f, g3 = 0.0f, g4 = 0.0f;

    // Frame n backwards from its input xi, output yi and output gradient
    // g; returns the input's gradient.
    __device__ __forceinline__ float step(const Section& c, float xi, float yi, float g) {
        const float e = (g - c.a1 * mu1) - c.a2 * mu2;
        const float gx = (c.b0 * e + c.b1 * mu1) + c.b2 * mu2;
        g0 = g0 + e * xi;
        g1 = g1 + mu1 * xi;
        g2 = g2 + mu2 * xi;
        g3 = g3 - mu1 * yi;
        g4 = g4 - mu2 * yi;
        mu2 = mu1;
        mu1 = e;
        return gx;
    }

};

// A full stage of a small cascade (kS <= kUnrolled) runs unrolled whole,
// each frame's values in registers, its rows read a float4 at a time: ~1 300
// instructions at two sections, where the loops below ran 10–25% slower
// (PERF.md §6).
constexpr int kUnrolled = 2;

// Frame f (known at compile time) of a thread's row of a full stage, read
// as part of its float4, so that one quad's reads are one load.
__device__ __forceinline__ float elem(Tile& st, int t, int f) {
    const float4 q = quads(st, t)[f >> 2];
    return (f & 3) == 0 ? q.x : (f & 3) == 1 ? q.y : (f & 3) == 2 ? q.z : q.w;
}

__device__ __forceinline__ void load_row(Tile& st, int t, float (&v)[kStage]) {
#pragma unroll
    for (int f = 0; f < kStage; ++f) v[f] = elem(st, t, f);
}

// Sections 0..kR-1 forwards over v (section 0's input) in place, the
// wavefront below unrolled; section k's outputs into rec[k] when kStore.
template <int kR, bool kStore>
__device__ __forceinline__ void forward_regs(const Section* c, float* z1, float* z2,
                                             float (&v)[kStage], Tile* rec, int t) {
#pragma unroll
    for (int tau = 0; tau < kStage + kR - 1; ++tau) {
#pragma unroll
        for (int k = 0; k < kR; ++k) {
            const int f = tau - k;
            if (f >= 0 && f < kStage) {
                v[f] = c[k].step(z1[k], z2[k], v[f]);
                if (kStore) rec[k][t][f] = v[f];
            }
        }
    }
}

// The adjoints of sections kS-1..0 over the stage in `slot`, unrolled; v
// holds the last section's input.
template <int kS>
__device__ __forceinline__ void adjoint_regs(const Section* c, Adjoint* m,
                                             const float (&v)[kStage], Tile* slot, Tile* rec,
                                             int t) {
    float g[kStage];
    load_row(slot[2], t, g);
#pragma unroll
    for (int tau = 0; tau < kStage + kS - 1; ++tau) {
#pragma unroll
        for (int j = kS - 1; j >= 0; --j) {
            const int f = kStage - 1 - tau + (kS - 1 - j);
            if (f >= 0 && f < kStage) {
                const float xi = j == kS - 1 ? v[f] : j ? elem(rec[j - 1], t, f) : elem(slot[0], t, f);
                const float yi = j == kS - 1 ? elem(slot[1], t, f) : elem(rec[j], t, f);
                g[f] = m[j].step(c[j], xi, yi, g[f]);
            }
        }
    }
#pragma unroll
    for (int q = 0; q < kQuads; ++q)
        quads(slot[2], t)[q] = make_float4(g[4 * q], g[4 * q + 1], g[4 * q + 2], g[4 * q + 3]);
}

// The full stage's wavefronts.  Step tau runs each section at one frame,
// section k one frame behind section k - 1 (forwards) or k + 1 (backwards),
// so that the sections' serial chains interleave in the warp's instruction
// stream; a section's input from its neighbour passes in a register
// (carry), made a step before.  The steps where every section runs are a
// loop of pairs of steps, each pair's operands read before either step
// stores (the tiles' reads do not then wait behind its stores), so that the
// stage's code stays a few hundred instructions: unrolled whole, the 32
// frames of three sections were ~3 000, fetched once a stage, and ran at a
// fifth of an instruction a cycle (PERF.md §6).  The steps before and
// after, where only some sections run, are unrolled.

// Sections 0..kR-1 forwards over a full stage from x's row, section k's
// outputs into rec[k]'s row when kStore.
template <int kR, bool kStore>
__device__ __forceinline__ void forward_stage(const Section* c, float* z1, float* z2,
                                              const float* x, Tile* rec, int t) {
    if constexpr (kR == 0) return;
    float carry[kR > 1 ? kR - 1 : 1];  // carry[k]: section k's output a step before
    // step tau, sections hi..lo (descending: section k reads carry[k - 1]
    // before section k - 1 replaces it), x0 the frame tau of x
    auto step = [&](int tau, int lo, int hi, float x0) {
#pragma unroll
        for (int k = hi; k >= lo; --k) {
            const float y = c[k].step(z1[k], z2[k], k ? carry[k - 1] : x0);
            if (kStore) rec[k][t][tau - k] = y;
            if (k + 1 < kR) carry[k] = y;
        }
    };
#pragma unroll
    for (int tau = 0; tau < kR - 1; ++tau) step(tau, 0, tau, x[tau]);
    constexpr int kPairs = (kStage - kR + 1) / 2;
#pragma unroll 1
    for (int p = 0; p < kPairs; ++p) {
        const int tau = kR - 1 + 2 * p;
        const float x0 = x[tau], x1 = x[tau + 1];
        step(tau, 0, kR - 1, x0);
        step(tau + 1, 0, kR - 1, x1);
    }
    if constexpr ((kStage - kR + 1) % 2) step(kStage - 1, 0, kR - 1, x[kStage - 1]);
#pragma unroll
    for (int tau = kStage; tau < kStage + kR - 1; ++tau) step(tau, tau - kStage + 1, kR - 1, 0.0f);
}

// The adjoints of sections kS-1..0 over a full stage: section j's input
// is x's row (j = 0) or rec[j - 1]'s, its output rec[j]'s or y's (j = kS -
// 1); section kS - 1 reads g_y from g's row, section 0 writes g_x there, at
// a frame kS - 1 steps behind the reads.  Section j runs frame kStage - 1 -
// tau + (kS - 1 - j) at step tau.
template <int kS>
__device__ __forceinline__ void adjoint_stage(const Section* c, Adjoint* m, const float* x,
                                              const float* y, float* g, Tile* rec, int t) {
    float carry[kS > 1 ? kS - 1 : 1];  // carry[j]: section j + 1's g_x a step before
    struct Ops {
        float x[kS], y[kS], g;
    };
    auto frame = [](int j, int tau) { return kStage - 1 - tau + (kS - 1 - j); };
    auto load = [&](int tau, int lo, int hi) {
        Ops o;
#pragma unroll
        for (int j = lo; j <= hi; ++j) {
            const int f = frame(j, tau);
            o.x[j] = j ? rec[j - 1][t][f] : x[f];
            o.y[j] = j == kS - 1 ? y[f] : rec[j][t][f];
        }
        o.g = hi == kS - 1 ? g[frame(kS - 1, tau)] : 0.0f;
        return o;
    };
    // step tau, sections lo..hi (ascending: section j reads carry[j]
    // before section j + 1 replaces it)
    auto step = [&](int tau, int lo, int hi, const Ops& o) {
#pragma unroll
        for (int j = lo; j <= hi; ++j) {
            const float gx = m[j].step(c[j], o.x[j], o.y[j], j == kS - 1 ? o.g : carry[j]);
            if (j)
                carry[j - 1] = gx;
            else
                g[frame(0, tau)] = gx;
        }
    };
#pragma unroll
    for (int tau = 0; tau < kS - 1; ++tau) step(tau, kS - 1 - tau, kS - 1, load(tau, kS - 1 - tau, kS - 1));
    constexpr int kPairs = (kStage - kS + 1) / 2;
#pragma unroll 1
    for (int p = 0; p < kPairs; ++p) {
        const int tau = kS - 1 + 2 * p;
        const Ops o0 = load(tau, 0, kS - 1), o1 = load(tau + 1, 0, kS - 1);
        step(tau, 0, kS - 1, o0);
        step(tau + 1, 0, kS - 1, o1);
    }
    if constexpr ((kStage - kS + 1) % 2) step(kStage - 1, 0, kS - 1, load(kStage - 1, 0, kS - 1));
#pragma unroll
    for (int tau = kStage; tau < kStage + kS - 1; ++tau)
        step(tau, 0, kStage + kS - 2 - tau, load(tau, 0, kStage + kS - 2 - tau));
}

// kS sections (the file's head comment, a-d).  Dynamic shared memory: kRing
// slots of x, y and g_y, then kS - 1 tiles of the recomputed sections'
// outputs (ring_bytes(kRing, 3, kS - 1)).
template <int kS, bool kVec>
__global__ void __launch_bounds__(kLanes) biquad_bwd_kernel(const BiquadBwdArgs a) {
    extern __shared__ __align__(16) unsigned char smem[];
    constexpr int kR = kS - 1;            // sections recomputed
    constexpr int kRA = kR > 0 ? kR : 1;  // the length of their arrays
    Tile(*ring)[3] = reinterpret_cast<Tile(*)[3]>(smem);
    Tile* rec = reinterpret_cast<Tile*>(smem) + kRing * 3;

    const int t = threadIdx.x;
    const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kLanes;
    const int rows = static_cast<int>(a.rows - row0 < kLanes ? a.rows - row0 : kLanes);
    const bool live = t < rows;
    const int64_t row = live ? row0 + t : row0;
    const RowAt ra = row_at(row, a.inner);
    const int stages = (a.frames + kStage - 1) / kStage;

    Section c[kS];
    Adjoint m[kS];
#pragma unroll
    for (int s = 0; s < kS; ++s) {
        const Operand* o = a.coef[s];
        c[s] = {at(o[0], ra), at(o[1], ra), at(o[2], ra),
                at(o[3], ra), at(o[4], ra)};
        m[s].mu1 = at(a.g_z_out[s][0], ra);
        m[s].mu2 = at(a.g_z_out[s][1], ra);
    }
    // checkpoint j (0: z1, 1: z2) of recomputed section k at stage s
    auto ck = [&](int k, int j, int s) {
        return a.ckpt + ((static_cast<int64_t>(k) * 2 + j) * stages + s) * a.rows + row;
    };

    // the states at the start of the stage the backward sweep runs next
    float n1[kRA], n2[kRA];
    // a. the checkpoint sweep, from the states in
    float z1[kRA], z2[kRA];
#pragma unroll
    for (int k = 0; k < kR; ++k) {
        z1[k] = at(a.z_in[k][0], ra);
        z2[k] = at(a.z_in[k][1], ra);
    }
    auto checkpoint = [&](Tile* slot, int s, int nf) {
        if (!live) return;
#pragma unroll
        for (int k = 0; k < kR; ++k) {
            *ck(k, 0, s) = n1[k] = z1[k];
            *ck(k, 1, s) = n2[k] = z2[k];
        }
        if (nf == kStage) {
            if constexpr (kS <= kUnrolled) {
                float v[kStage];
                load_row(slot[0], t, v);
                forward_regs<kR, false>(c, z1, z2, v, rec, t);
            } else {
                forward_stage<kR, false>(c, z1, z2, slot[0][t], rec, t);
            }
        } else {
            const float* xr = slot[0][t];
            for (int f = 0; f < nf; ++f) {
                float v = xr[f];
#pragma unroll
                for (int k = 0; k < kR; ++k) v = c[k].step(z1[k], z2[k], v);
            }
        }
    };

    // b. the backward sweep, in the same ring (x staged alone for a)
    const float* src[3] = {a.x, a.y, a.g_y};
    float* const dst[1] = {a.g_x};
    const int out[1] = {2};
    run_sweeps<kR ? 1 : 0, 3, 1, 3, kRing, kVec>(
        src, dst, out, ring, row0, rows, a.frames, t, checkpoint, [&](Tile* slot, int s, int nf) {
            if (!live) return;
            float w1[kRA], w2[kRA];  // the recomputed sections' states
            if constexpr (kR > 0) {
#pragma unroll
                for (int k = 0; k < kR; ++k) {
                    w1[k] = n1[k];
                    w2[k] = n2[k];
                }
                if (s > 0) {  // the next stage's, read while this one runs
#pragma unroll
                    for (int k = 0; k < kR; ++k) {
                        n1[k] = *ck(k, 0, s - 1);
                        n2[k] = *ck(k, 1, s - 1);
                    }
                }
            }
            if (nf == kStage) {
                if constexpr (kS <= kUnrolled) {
                    // v: x, then the recomputed section's outputs: the last
                    // section's input
                    float v[kStage];
                    load_row(slot[0], t, v);
                    forward_regs<kR, true>(c, w1, w2, v, rec, t);
                    adjoint_regs<kS>(c, m, v, slot, rec, t);
                } else {
                    forward_stage<kR, true>(c, w1, w2, slot[0][t], rec, t);
                    adjoint_stage<kS>(c, m, slot[0][t], slot[1][t], slot[2][t], rec, t);
                }
            } else {
                const float* xr = slot[0][t];
#pragma unroll
                for (int k = 0; k < kR; ++k) {
                    const float* in = k ? rec[k - 1][t] : xr;
                    float* o = rec[k][t];
                    for (int f = 0; f < nf; ++f) o[f] = c[k].step(w1[k], w2[k], in[f]);
                }
                float* gr = slot[2][t];
#pragma unroll
                for (int k = kS - 1; k >= 0; --k) {
                    const float* in = k ? rec[k - 1][t] : xr;
                    const float* o = k == kS - 1 ? slot[1][t] : rec[k][t];
                    for (int f = nf - 1; f >= 0; --f) gr[f] = m[k].step(c[k], in[f], o[f], gr[f]);
                }
            }
        });

    if (live) {
#pragma unroll
        for (int s = 0; s < kS; ++s) {
            float* gc = a.g_coef + static_cast<int64_t>(s) * 5 * a.rows + row;
            gc[0] = m[s].g0;
            gc[a.rows] = m[s].g1;
            gc[2 * a.rows] = m[s].g2;
            gc[3 * a.rows] = m[s].g3;
            gc[4 * a.rows] = m[s].g4;
            float* gz = a.g_z_in + static_cast<int64_t>(s) * 2 * a.rows + row;
            gz[0] = m[s].mu1;
            gz[a.rows] = m[s].mu2;
        }
    }
}

template <bool kVec>
__global__ void __launch_bounds__(kLanes) one_pole_bwd_kernel(const OnePoleBwdArgs a) {
    __shared__ __align__(16) Tile ring[kRing][3];

    const int t = threadIdx.x;
    const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kLanes;
    const int rows = static_cast<int>(a.rows - row0 < kLanes ? a.rows - row0 : kLanes);
    const bool live = t < rows;
    const int64_t row = live ? row0 + t : row0;
    const RowAt ra = row_at(row, a.inner);

    const float ca = at(a.a, ra), cb = at(a.b, ra);
    const float y_in = at(a.y_in, ra);
    // lam: the adjoint of y[n] before g_y[n] joins; mu: lam[n + 1] after it
    // joined, whose term mu * y[n] of g_b is added at frame n (the plain
    // version adds it at frame n + 1 with y[n] as y_prev: the same terms in
    // the same order, without reading y[n - 1])
    float lam = at(a.g_y_out, ra);
    float mu = 0.0f;
    bool first = true;
    float g_a = 0.0f, g_b = 0.0f;
    const float* src[3] = {a.x, a.y, a.g_y};
    float* const dst[1] = {a.g_x};
    const int out[1] = {2};
    run_sweeps<0, 3, 1, 3, kRing, kVec>(
        src, dst, out, ring, row0, rows, a.frames, t, NoSweep(), [&](Tile* slot, int, int nf) {
            if (!live) return;
            const float* xr = slot[0][t];
            const float* yr = slot[1][t];
            float* gr = slot[2][t];
            for (int f = nf - 1; f >= 0; --f) {
                if (!first) g_b = g_b + mu * yr[f];
                first = false;
                lam = lam + gr[f];
                gr[f] = ca * lam;
                g_a = g_a + lam * xr[f];
                mu = lam;
                lam = cb * lam;
            }
        });
    if (live) {
        a.g_coef[row] = g_a;
        a.g_coef[a.rows + row] = g_b + mu * y_in;
        a.g_y_in[row] = lam;
    }
}

template <int kS>
int launch_cascade(const BiquadBwdArgs& a, bool vec, cudaStream_t st) {
    constexpr size_t bytes = ring_bytes(kRing, 3, kS - 1);
    return vec ? launch_kernel(biquad_bwd_kernel<kS, true>, a.rows, bytes, st, a)
               : launch_kernel(biquad_bwd_kernel<kS, false>, a.rows, bytes, st, a);
}

}  // namespace

// biquad: args->sections (1..8) sections over x [rows, frames] whose
// output was y; g_x, g_coef, g_z_in written; ckpt the checkpoints [S - 1,
// 2, stages, rows] (null for one section).  Launches on `stream` and
// returns cudaGetLastError() (cudaErrorInvalidValue for frames < 1, a
// section count out of range or the checkpoints missing); it does not
// synchronise.
extern "C" int fw_biquad_cascade_bwd(const k8::BiquadBwdArgs* args, void* stream) {
    const BiquadBwdArgs& a = *args;
    if (a.rows <= 0) return static_cast<int>(cudaSuccess);
    if (a.frames < 1 || a.sections < 1 || a.sections > k8::kMaxSections || a.inner < 1 ||
        (a.sections > 1 && a.ckpt == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool vec = a.frames % 4 == 0 && aligned16(a.x) && aligned16(a.y) &&
                     aligned16(a.g_y) && aligned16(a.g_x);
    switch (a.sections) {
        case 1: return launch_cascade<1>(a, vec, st);
        case 2: return launch_cascade<2>(a, vec, st);
        case 3: return launch_cascade<3>(a, vec, st);
        case 4: return launch_cascade<4>(a, vec, st);
        case 5: return launch_cascade<5>(a, vec, st);
        case 6: return launch_cascade<6>(a, vec, st);
        case 7: return launch_cascade<7>(a, vec, st);
        default: return launch_cascade<8>(a, vec, st);
    }
}

// one-pole: x [rows, frames] whose output was y; g_x, g_coef, g_y_in
// written.  As above.
extern "C" int fw_one_pole_scan_bwd(const k8::OnePoleBwdArgs* args, void* stream) {
    const OnePoleBwdArgs& a = *args;
    if (a.rows <= 0) return static_cast<int>(cudaSuccess);
    if (a.frames < 1 || a.inner < 1) return static_cast<int>(cudaErrorInvalidValue);
    const unsigned blocks = static_cast<unsigned>((a.rows + kLanes - 1) / kLanes);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool vec = a.frames % 4 == 0 && aligned16(a.x) && aligned16(a.y) &&
                     aligned16(a.g_y) && aligned16(a.g_x);
    if (vec)
        one_pole_bwd_kernel<true><<<blocks, kLanes, 0, st>>>(a);
    else
        one_pole_bwd_kernel<false><<<blocks, kLanes, 0, st>>>(a);
    return static_cast<int>(cudaGetLastError());
}

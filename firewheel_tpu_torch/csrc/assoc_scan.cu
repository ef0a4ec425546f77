// K7: the associative scans of ops/iir.py, one launch a call.
//
// Replaces the eager op-by-op evaluation of ops/iir.py:biquad_scan (the
// TDF-II biquad as a scan of 2x2 affine maps) and ops/iir.py:one_pole_scan
// (y = a*x + b*y_prev as a scan of scalar affine maps), which the JAX
// package leaves to XLA (firewheel_tpu/ops/iir.py:biquad_scan,
// :one_pole_scan, both through lax.associative_scan).  Eager PyTorch pays
// ~440 launches for one biquad of 128 frames; this is one, and one for a
// cascade of biquad sections in series over the same rows
// (ops/iir.py:biquad_cascade: the parametric EQ's bands, the loudness
// meter's K-weighting).  Other callers: the filter node's "auto" backend,
// the waveshaper's DC blocker, the spatializer's air absorption and the
// binaural node's head shadow.
//
// The contract is the plain versions' rounding, bit for bit: the same
// compositions of the same partial products in the same order, for any
// length n >= 1 (the recursion of lax.associative_scan, assoc_scan.cuh's
// comment).  The carry applies each position's composed map to the state
// in and reads y off it (biquad: y[p] = b0*x[p] + z1[p-1]).  The one-pole's
// v1*m2 + v2 and its carry are fma64, ops/iir.py:_fma.  A cascade's section
// s + 1 reads section s's output, so it sees the bits the next call of the
// plain chain would see.
//
// Two designs:
//
// * n a power of two from 32 to 256 (the 128-frame blocks of every batched
//   path and stream, the 256-frame blocks of the bus's stream): the tree in
//   registers, kL lanes a row (8, 16 or 32; 32 / kL rows a warp).  Lane l
//   of a row loads its kM = n / kL consecutive frames with vector loads (x
//   read once) and builds its kM leaves; the log2(kM) levels whose pairs
//   lie inside a lane run in registers, the other log2(kL) across the row's
//   lanes by __shfl_up_sync: level c's element i sits in lane (i + 1) 2^c -
//   1, so the up-sweep composes lane l - 2^(c-1) into lane l, and the
//   down-sweep's compose(res_{c+1}[j-1], e_c[2j]) reads lane l - 2^c.  Every
//   level inside a lane whose first pair partner lies in the lane before
//   composes that lane's inclusive result, one more shuffle.  The level
//   counts are template constants: no shared memory, no barrier, no local
//   arrays.  The carry is applied in registers and y written as aligned
//   vectors; a cascade keeps each section's output in registers as the next
//   one's input.
// * every other n, one warp a row: the levels in shared memory
//   (assoc_scan.cuh's sweep, the code the megakernel's rows run), n - 1 maps
//   a row, as many rows a CTA as fit in 48 KB (at most 8), a row longer than
//   that in a CTA of its own with the shared memory opted in up to the
//   card's 227 KB; a row whose levels do not fit there (past 9686 frames for
//   the biquad, 29 057 for the one-pole) keeps them in a device-memory
//   workspace of [rows, n - 1] maps that the wrapper allocates (kGlobal).  A
//   cascade on this path writes section s to y or to a [rows, n] workspace
//   in turn, so that the last lands in y, __syncwarp between sections.
//
// What bounds it on an H100: at the callers' shapes (16 384 rows of 128
// frames) memory, x read once and y written once, ~16.8 MB, ~5 us at
// 3.35 TB/s; a biquad section does ~28 f32 operations a frame (~59 M at
// that shape, under 1 us at 67 TFLOP/s, twice that without fused
// multiply-adds, which the contract forbids), the one-pole 4 float64
// operations a frame at the FP64 rate and four f32<->f64 conversions a
// composition at a quarter of it.  The register design moves each frame's
// bytes once; what is left is issue: the compositions (20 f32 instructions
// each), the shuffle rounds (6 floats each for the biquad, 2 for the
// one-pole) and the lanes that idle at the levels across lanes, which more
// frames a lane cut.  The shared design is bounded by its levels'
// __syncwarp chain, its idle lanes and its 24-byte elements' bank
// conflicts.

#include <cuda_runtime.h>
#include <stdint.h>

#include "assoc_scan.cuh"

// The launch's arguments, in a named namespace: the C entry points take
// pointers to them, and a type of an unnamed namespace would keep those
// entry points out of the library's exported symbols.
namespace k7 {

constexpr int kMaxSections = 8;  // a cascade's sections a launch

// A per-row operand.  Rows are [outer, inner] (inner: the last axis of the
// caller's row shape); row r reads p[(r / inner) * so + (r % inner) * si],
// or v for every row when p is null (a number, passed by value).
struct Operand {
    const float* p;
    int64_t so, si;
    float v;
};

__device__ __forceinline__ float at(const Operand& o, int64_t outer, int64_t inner) {
    return o.p ? o.p[outer * o.so + inner * o.si] : o.v;
}

// S biquad sections: each one's (b0, b1, b2, a1, a2) and state in (z1, z2);
// z_out [S, 2, rows]
struct BiquadArgs {
    Operand coef[kMaxSections][5];
    Operand z_in[kMaxSections][2];
    float* z_out;
    int64_t inner;
    int sections;
};

// the one-pole's a, b and y_in; y_out [rows]
struct OnePoleArgs {
    Operand a, b, y_in;
    float* y_out;
    int64_t inner;
};

}  // namespace k7

namespace {

using namespace scan;
using namespace k7;

constexpr int kMaxWarps = 8;                   // rows a CTA, shared design
constexpr int kDefaultShared = 48 * 1024;      // without the opt-in
constexpr int kMaxShared = 232448;             // 227 KB, the H100's per-CTA limit

// ---------------------------------------------------------------------------
// The shared-memory (or workspace) design, for every n that is not a power
// of two from 32 to 256
// ---------------------------------------------------------------------------

// The levels of row `row`, warp `w` of the CTA: in shared memory, or in the
// workspace `ws` [rows, row_elems] (kGlobal).
template <bool kGlobal, typename E>
__device__ __forceinline__ E* row_levels(E* ws, int64_t row, int w, int row_elems) {
    extern __shared__ unsigned char smem[];
    if (kGlobal) return ws + row * row_elems;
    return reinterpret_cast<E*>(smem) + (int64_t)w * row_elems;
}

// One biquad section over a row of n frames, xr -> yr, its state out to
// z_out[0] and z_out[rows] (the levels in lv).
__device__ __forceinline__ void biquad_section(const float* __restrict__ xr,
                                               float* __restrict__ yr, Affine2* lv,
                                               const Operand* c, const Operand* z,
                                               float* z_out, int64_t rows, int64_t outer,
                                               int64_t inner, int n, int lane) {
    const float b0 = at(c[0], outer, inner), b1 = at(c[1], outer, inner);
    const float b2 = at(c[2], outer, inner), a1 = at(c[3], outer, inner);
    const float a2 = at(c[4], outer, inner);
    const BiquadLeaves leaf{xr, -a1, -a2, b1 - a1 * b0, b2 - a2 * b0};
    sweep(lv, n, leaf, lane);

    const float zp1 = at(z[0], outer, inner), zp2 = at(z[1], outer, inner);
    if (lane == 0) yr[0] = b0 * xr[0] + zp1;
    for (int p = lane; p < n; p += kWarp) {
        const Affine2 r = level0(lv, p, leaf);
        const float z1 = r.p11 * zp1 + r.p12 * zp2 + r.q1;
        const float z2 = r.p21 * zp1 + r.p22 * zp2 + r.q2;
        if (p + 1 < n) {
            yr[p + 1] = b0 * xr[p + 1] + z1;
        } else {
            z_out[0] = z1;
            z_out[rows] = z2;
        }
    }
}

// x, y, tmp [rows, n] (tmp: sections > 1 only).  Each buffer is read and
// written only through pointers derived from its own argument.  The first
// section reads x itself: an input pointer that is x or y by the section
// would cost x its read-only loads against the workspace's stores (a tenth
// of the time past shared memory).
template <bool kGlobal>
__global__ void biquad_scan_kernel(const float* __restrict__ x, float* __restrict__ y,
                                   float* __restrict__ tmp, const BiquadArgs args,
                                   int64_t rows, int n, int row_elems, Affine2* ws) {
    const int lane = threadIdx.x & (kWarp - 1);
    const int w = threadIdx.x / kWarp;
    const int64_t row = (int64_t)blockIdx.x * (blockDim.x / kWarp) + w;
    if (row >= rows) return;  // the whole warp: no CTA barrier follows
    const int64_t outer = row / args.inner, inner = row % args.inner;
    Affine2* lv = row_levels<kGlobal>(ws, row, w, row_elems);
    // the last section writes y, the one before it tmp, and so on
    auto out = [&](int s) { return (((args.sections - 1 - s) & 1) ? tmp : y) + row * n; };
    float* yr = out(0);
    biquad_section(x + row * n, yr, lv, args.coef[0], args.z_in[0], args.z_out + row, rows,
                   outer, inner, n, lane);
    for (int s = 1; s < args.sections; ++s) {
        __syncwarp();  // the section before's output and levels, before this one reads them
        float* next = out(s);
        biquad_section(yr, next, lv, args.coef[s], args.z_in[s],
                       args.z_out + 2 * s * rows + row, rows, outer, inner, n, lane);
        yr = next;
    }
}

// x, y [rows, n]
template <bool kGlobal>
__global__ void one_pole_scan_kernel(const float* __restrict__ x, float* __restrict__ y,
                                     const OnePoleArgs args, int64_t rows, int n,
                                     int row_elems, Affine1* ws) {
    const int lane = threadIdx.x & (kWarp - 1);
    const int w = threadIdx.x / kWarp;
    const int64_t row = (int64_t)blockIdx.x * (blockDim.x / kWarp) + w;
    if (row >= rows) return;
    const int64_t outer = row / args.inner, inner = row % args.inner;
    Affine1* lv = row_levels<kGlobal>(ws, row, w, row_elems);
    const float* xr = x + row * n;
    float* yr = y + row * n;
    const OnePoleLeaves leaf{xr, at(args.a, outer, inner), at(args.b, outer, inner)};
    sweep(lv, n, leaf, lane);

    const float yp = at(args.y_in, outer, inner);
    for (int p = lane; p < n; p += kWarp) {
        const Affine1 r = level0(lv, p, leaf);
        const float v = fma64(r.m, yp, r.v);
        yr[p] = v;
        if (p == n - 1) args.y_out[row] = v;
    }
}

// The elements of a row's levels: n - 1 maps (one for n = 1, never read).
__host__ __device__ inline int row_elems_of(int n) { return n > 1 ? n - 1 : 1; }

// ---------------------------------------------------------------------------
// The register design, for n = kM kL: kL lanes a row (8, 16 or 32), kM
// consecutive frames a lane, 32 / kL rows a warp
// ---------------------------------------------------------------------------

namespace reg {

constexpr int kWarps = 4;  // warps a CTA
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int log2i(int n) { return n <= 1 ? 0 : 1 + log2i(n / 2); }

// lane - d within the lane's row of kL lanes (its own value for the first d)
template <int kL>
__device__ __forceinline__ float shfl_up(float v, int d) {
    return __shfl_up_sync(kFull, v, d, kL);
}
template <int kL>
__device__ __forceinline__ Affine2 shfl_up(const Affine2& e, int d) {
    return Affine2{shfl_up<kL>(e.p11, d), shfl_up<kL>(e.p12, d), shfl_up<kL>(e.p21, d),
                   shfl_up<kL>(e.p22, d), shfl_up<kL>(e.q1, d), shfl_up<kL>(e.q2, d)};
}
template <int kL>
__device__ __forceinline__ Affine1 shfl_up(const Affine1& e, int d) {
    return Affine1{shfl_up<kL>(e.m, d), shfl_up<kL>(e.v, d)};
}

// The up-sweep inside a lane: level l (kN elements at t) composes its pairs
// into level l + 1 at t + kN, until a level has one element.
template <int kN, typename E>
__device__ __forceinline__ void up(E* t) {
    if constexpr (kN >= 2) {
#pragma unroll
        for (int i = 0; i < kN / 2; ++i) t[kN + i] = compose(t[2 * i], t[2 * i + 1]);
        up<kN / 2>(t + kN);
    }
}

// The down-sweep inside a lane: r mirrors t, its top element (the lane's
// inclusive result) set.  A level's first element composes `prev`, the lane
// before's inclusive result (res_{l+1} of the position before the lane's
// first pair), except in the row's first lane.
template <int kN, typename E>
__device__ __forceinline__ void down(const E* t, E* r, const E& prev, bool first) {
    if constexpr (kN >= 2) {
        down<kN / 2>(t + kN, r + kN, prev, first);
        r[0] = first ? t[0] : compose(prev, t[0]);
        r[1] = r[kN];
#pragma unroll
        for (int j = 1; j < kN / 2; ++j) {
            r[2 * j] = compose(r[kN + j - 1], t[2 * j]);
            r[2 * j + 1] = r[kN + j];
        }
    }
}

// The inclusive scan of a row of kL kM maps, lane l of the row holding
// positions [l kM, l kM + kM) as t[0, kM): on return r[0, kM) holds each
// position's composed map.  t and r hold the lane's levels (2 kM - 1 maps).
template <int kM, int kL, typename E>
__device__ __forceinline__ void scan_row(E (&t)[2 * kM - 1], E (&r)[2 * kM - 1], int l) {
    up<kM>(t);
    // across lanes: level c's element i in lane (i + 1) 2^c - 1; a lane
    // keeps the element of the highest level it holds
    E v = t[2 * kM - 2];
#pragma unroll
    for (int c = 1; c <= log2i(kL); ++c) {
        const E o = shfl_up<kL>(v, 1 << (c - 1));
        if (((l + 1) & ((1 << c) - 1)) == 0) v = compose(o, v);
    }
    // level c's result at 2j + 1 is level c + 1's at j (the same lane), at
    // 2j (j >= 1) compose(level c + 1's at j - 1, e_c[2j]), at 0 e_c[0];
    // the row's last lane holds the top level, its own result
    E res = v;
#pragma unroll
    for (int c = log2i(kL) - 1; c >= 0; --c) {
        const E o = shfl_up<kL>(res, 1 << c);
        const int i = ((l + 1) >> c) - 1;
        if (((l + 1) & ((1 << c) - 1)) == 0 && (i & 1) == 0) res = i == 0 ? v : compose(o, v);
    }
    const E prev = shfl_up<kL>(res, 1);
    r[2 * kM - 2] = res;
    down<kM>(t, r, prev, l == 0);
}

// kM consecutive floats at p (aligned to min(16, 4 kM) bytes)
template <int kM>
__device__ __forceinline__ void load(const float* __restrict__ p, float (&v)[kM]) {
    if constexpr (kM >= 4) {
#pragma unroll
        for (int k = 0; k < kM; k += 4) {
            const float4 q = *reinterpret_cast<const float4*>(p + k);
            v[k] = q.x; v[k + 1] = q.y; v[k + 2] = q.z; v[k + 3] = q.w;
        }
    } else if constexpr (kM == 2) {
        const float2 q = *reinterpret_cast<const float2*>(p);
        v[0] = q.x; v[1] = q.y;
    } else {
        v[0] = p[0];
    }
}

template <int kM>
__device__ __forceinline__ void store(float* __restrict__ p, const float (&v)[kM]) {
    if constexpr (kM >= 4) {
#pragma unroll
        for (int k = 0; k < kM; k += 4)
            *reinterpret_cast<float4*>(p + k) = make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
    } else if constexpr (kM == 2) {
        *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
    } else {
        p[0] = v[0];
    }
}

// This lane's row of a kernel over rows of kL lanes: its index, the lane
// within the row, and whether the row exists (a warp's rows past the last
// still shuffle, and neither read nor write).
template <int kL>
struct Row {
    int64_t row;
    int l;
    bool live;
    unsigned outer, inner;  // the row's operand indices, (row / inner, row % inner)
    __device__ __forceinline__ Row(int64_t rows, int64_t inner_len) {
        const int lane = threadIdx.x & (kWarp - 1);
        l = lane & (kL - 1);
        row = ((int64_t)blockIdx.x * kWarps + threadIdx.x / kWarp) * (kWarp / kL) + lane / kL;
        live = row < rows;
        const unsigned r = (unsigned)(live ? row : rows - 1);
        outer = r / (unsigned)inner_len;
        inner = r % (unsigned)inner_len;
    }
};

// x, y [rows, kM kL]; the sections in series, each one's output kept in
// registers as the next one's input
template <int kM, int kL>
__global__ void __launch_bounds__(kWarps * kWarp)
biquad_scan_kernel(const float* __restrict__ x, float* __restrict__ y,
                   const BiquadArgs args, int64_t rows) {
    const Row<kL> w(rows, args.inner);
    float v[kM] = {};
    if (w.live) load<kM>(x + w.row * (kM * kL) + w.l * kM, v);
    for (int s = 0; s < args.sections; ++s) {
        const Operand* c = args.coef[s];
        const float b0 = at(c[0], w.outer, w.inner), b1 = at(c[1], w.outer, w.inner);
        const float b2 = at(c[2], w.outer, w.inner), a1 = at(c[3], w.outer, w.inner);
        const float a2 = at(c[4], w.outer, w.inner);
        const float na1 = -a1, na2 = -a2, c1 = b1 - a1 * b0, c2 = b2 - a2 * b0;
        Affine2 t[2 * kM - 1], r[2 * kM - 1];
#pragma unroll
        for (int k = 0; k < kM; ++k) t[k] = Affine2{na1, 1.0f, na2, 0.0f, c1 * v[k], c2 * v[k]};
        scan_row<kM, kL>(t, r, w.l);

        const float zp1 = at(args.z_in[s][0], w.outer, w.inner);
        const float zp2 = at(args.z_in[s][1], w.outer, w.inner);
        float z1[kM], z2[kM];
#pragma unroll
        for (int k = 0; k < kM; ++k) {
            z1[k] = r[k].p11 * zp1 + r[k].p12 * zp2 + r[k].q1;
            z2[k] = r[k].p21 * zp1 + r[k].p22 * zp2 + r[k].q2;
        }
        // y[p] = b0 x[p] + z1[p - 1]: the lane's first frame reads the lane
        // before's last z1 (the state in for the row's first lane)
        const float before = shfl_up<kL>(z1[kM - 1], 1);
        v[0] = b0 * v[0] + (w.l == 0 ? zp1 : before);
#pragma unroll
        for (int k = 1; k < kM; ++k) v[k] = b0 * v[k] + z1[k - 1];
        if (w.live && w.l == kL - 1) {
            args.z_out[2 * s * rows + w.row] = z1[kM - 1];
            args.z_out[(2 * s + 1) * rows + w.row] = z2[kM - 1];
        }
    }
    if (w.live) store<kM>(y + w.row * (kM * kL) + w.l * kM, v);
}

template <int kM, int kL>
__global__ void __launch_bounds__(kWarps * kWarp)
one_pole_scan_kernel(const float* __restrict__ x, float* __restrict__ y,
                     const OnePoleArgs args, int64_t rows) {
    const Row<kL> w(rows, args.inner);
    float v[kM] = {};
    if (w.live) load<kM>(x + w.row * (kM * kL) + w.l * kM, v);
    const float a = at(args.a, w.outer, w.inner), b = at(args.b, w.outer, w.inner);
    Affine1 t[2 * kM - 1], r[2 * kM - 1];
#pragma unroll
    for (int k = 0; k < kM; ++k) t[k] = Affine1{b, a * v[k]};
    scan_row<kM, kL>(t, r, w.l);
    const float yp = at(args.y_in, w.outer, w.inner);
#pragma unroll
    for (int k = 0; k < kM; ++k) v[k] = fma64(r[k].m, yp, r[k].v);
    if (!w.live) return;
    if (w.l == kL - 1) args.y_out[w.row] = v[kM - 1];
    store<kM>(y + w.row * (kM * kL) + w.l * kM, v);
}

}  // namespace reg

// True for the lengths the register kernels take: 32, 64, 128, 256.
__host__ inline bool in_registers(int n) {
    return n >= 32 && n <= 256 && (n & (n - 1)) == 0;
}

// A register kernel and its lanes a row.
template <typename Args>
struct RegKernel {
    void (*kernel)(const float*, float*, const Args, int64_t);
    int lanes;
};

// Launches `k` over `rows` rows (fewer than 2^31); x and y aligned to 16
// bytes (the wrapper's tensors are).
template <typename Args>
int launch_registers(const RegKernel<Args>& k, const void* x, void* y, const Args& args,
                     int64_t rows, cudaStream_t stream) {
    if (((uintptr_t)x | (uintptr_t)y) & 15) return (int)cudaErrorMisalignedAddress;
    if (rows >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
    const int64_t rows_a_cta = (int64_t)reg::kWarps * (kWarp / k.lanes);
    const unsigned blocks = (unsigned)((rows + rows_a_cta - 1) / rows_a_cta);
    k.kernel<<<blocks, reg::kWarps * kWarp, 0, stream>>>(
        static_cast<const float*>(x), static_cast<float*>(y), args, rows);
    return (int)cudaGetLastError();
}

// The lanes a row, as measured on an H100 (PERF.md): more frames a
// lane move levels from the shuffles, where most lanes idle, into
// registers, and fewer rows a CTA leave more of the card's waves idle.  32
// lanes up to 64 frames and at 256 (the streams' two rows: the shortest
// chain); at 128 frames 16, and 8 for a cascade, whose sections repay the
// longer chain in a lane.
template <int kM, int kL>
constexpr RegKernel<BiquadArgs> biquad_reg() { return {reg::biquad_scan_kernel<kM, kL>, kL}; }
template <int kM, int kL>
constexpr RegKernel<OnePoleArgs> one_pole_reg() {
    return {reg::one_pole_scan_kernel<kM, kL>, kL};
}

RegKernel<BiquadArgs> biquad_register_kernel(int n, int sections) {
    switch (n) {
        case 32: return biquad_reg<1, 32>();
        case 64: return biquad_reg<2, 32>();
        case 128: return sections > 1 ? biquad_reg<16, 8>() : biquad_reg<8, 16>();
        default: return biquad_reg<8, 32>();
    }
}

RegKernel<OnePoleArgs> one_pole_register_kernel(int n) {
    switch (n) {
        case 32: return one_pole_reg<1, 32>();
        case 64: return one_pole_reg<2, 32>();
        case 128: return one_pole_reg<8, 16>();
        default: return one_pole_reg<8, 32>();
    }
}

// How the shared design runs rows of n frames of maps E: rows a CTA and
// dynamic shared bytes (the workspace, `global`, when a row's levels pass
// a CTA's shared memory).
struct Plan {
    bool global;
    int warps;
    size_t bytes;
};

template <typename E>
Plan plan_levels(int n) {
    const size_t row_bytes = (size_t)row_elems_of(n) * sizeof(E);
    if (row_bytes > (size_t)kMaxShared) return Plan{true, kMaxWarps, 0};
    int warps = (int)(kDefaultShared / row_bytes);
    warps = warps < 1 ? 1 : (warps > kMaxWarps ? kMaxWarps : warps);
    return Plan{false, warps, row_bytes * warps};
}

template <typename K>
int opt_in(K kernel, size_t bytes) {
    if (bytes <= (size_t)kDefaultShared) return (int)cudaSuccess;
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)bytes);
}

// The shared design's workspace: the levels when they pass shared memory,
// then (the biquad, more than one section) a [rows, n] row of frames for
// every other section's output.
int64_t workspace_bytes(int biquad, int64_t rows, int n, int sections) {
    if (rows <= 0 || n < 1 || in_registers(n)) return 0;
    const Plan plan = biquad ? plan_levels<Affine2>(n) : plan_levels<Affine1>(n);
    const size_t elem = biquad ? sizeof(Affine2) : sizeof(Affine1);
    int64_t bytes = plan.global ? (int64_t)((size_t)row_elems_of(n) * elem * rows) : 0;
    if (biquad && sections > 1) bytes += (int64_t)sizeof(float) * rows * n;
    return bytes;
}

}  // namespace

// Bytes of the device-memory workspace a call over `rows` rows of `frames`
// frames needs (0 for the register kernels, and for the shared ones while a
// row's levels fit in a CTA and the call has one section).  `biquad`
// selects the biquad's maps (24 bytes), else the one-pole's (8).
extern "C" int64_t fw_scan_workspace_bytes(int biquad, int64_t rows, int frames,
                                           int sections) {
    return workspace_bytes(biquad, rows, frames, sections);
}

// biquad: args->sections (1..8) sections in series over x [rows, frames] →
// y, the states out in args->z_out [S, 2, rows]; ws the workspace of
// fw_scan_workspace_bytes (null when that is 0).  Returns the launch's
// cudaError_t (cudaErrorInvalidValue for frames < 1, a section count out of
// range, or a workspace missing).
extern "C" int fw_biquad_cascade(const void* x, void* y, const BiquadArgs* args,
                                 int64_t rows, int frames, void* ws, void* stream) {
    if (rows <= 0) return (int)cudaSuccess;
    if (frames < 1 || args->sections < 1 || args->sections > kMaxSections || args->inner < 1)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    if (in_registers(frames))
        return launch_registers(biquad_register_kernel(frames, args->sections), x, y, *args,
                                rows, st);
    if (workspace_bytes(1, rows, frames, args->sections) > 0 && ws == nullptr)
        return (int)cudaErrorInvalidValue;
    const Plan plan = plan_levels<Affine2>(frames);
    const size_t level_bytes =
        plan.global ? (size_t)row_elems_of(frames) * sizeof(Affine2) * rows : 0;
    float* tmp = args->sections > 1
                     ? reinterpret_cast<float*>(static_cast<unsigned char*>(ws) + level_bytes)
                     : nullptr;
    auto kernel = plan.global ? biquad_scan_kernel<true> : biquad_scan_kernel<false>;
    const int e = opt_in(kernel, plan.bytes);
    if (e != (int)cudaSuccess) return e;
    const unsigned blocks = (unsigned)((rows + plan.warps - 1) / plan.warps);
    kernel<<<blocks, plan.warps * kWarp, plan.bytes, st>>>(
        static_cast<const float*>(x), static_cast<float*>(y), tmp, *args, rows, frames,
        row_elems_of(frames), static_cast<Affine2*>(ws));
    return (int)cudaGetLastError();
}

// one-pole: x [rows, frames] → y, the carry out in args->y_out [rows]; ws as
// above.
extern "C" int fw_one_pole_scan(const void* x, void* y, const OnePoleArgs* args,
                                int64_t rows, int frames, void* ws, void* stream) {
    if (rows <= 0) return (int)cudaSuccess;
    if (frames < 1 || args->inner < 1) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    if (in_registers(frames))
        return launch_registers(one_pole_register_kernel(frames), x, y, *args, rows, st);
    const Plan plan = plan_levels<Affine1>(frames);
    if (plan.global && ws == nullptr) return (int)cudaErrorInvalidValue;
    auto kernel = plan.global ? one_pole_scan_kernel<true> : one_pole_scan_kernel<false>;
    const int e = opt_in(kernel, plan.bytes);
    if (e != (int)cudaSuccess) return e;
    const unsigned blocks = (unsigned)((rows + plan.warps - 1) / plan.warps);
    kernel<<<blocks, plan.warps * kWarp, plan.bytes, st>>>(
        static_cast<const float*>(x), static_cast<float*>(y), *args, rows, frames,
        row_elems_of(frames), static_cast<Affine1*>(ws));
    return (int)cudaGetLastError();
}

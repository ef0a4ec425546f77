// K7: the associative scans of ops/iir.py, one launch a section.
//
// Replaces the eager op-by-op evaluation of ops/iir.py:biquad_scan (the
// TDF-II biquad as a scan of 2x2 affine maps) and ops/iir.py:one_pole_scan
// (y = a*x + b*y_prev as a scan of scalar affine maps), which the JAX
// package leaves to XLA (firewheel_tpu/ops/iir.py:biquad_scan,
// :one_pole_scan, both through lax.associative_scan).  Eager PyTorch pays
// ~440 launches for one biquad of 128 frames; this is one.  Callers: the
// filter node's "auto" backend, the parametric EQ (a launch a band), the
// waveshaper's DC blocker, the loudness meter's K-weighting, the
// spatializer's air absorption and the binaural node's head shadow.
//
// The contract is the plain versions' rounding, bit for bit: the same
// compositions of the same partial products in the same order, for any
// length n >= 1.  The up-sweep and the down-sweep are assoc_scan.cuh's
// (shared with the megakernel's EQ and DC-blocker rows); the carry applies
// each position's composed map to the state in and reads y off it (biquad:
// y[p] = b0*x[p] + z1[p-1]).  The one-pole's carry is a fused multiply-add
// in the plain version (ops/iir.py:_fma), here fma64, as its compose is.
//
// Layout: one warp a row.  The leaves are computed from x as they are
// needed (a biquad leaf is (-a1, 1, -a2, 0, (b1 - a1*b0)*x, (b2 - a2*b0)*x),
// a one-pole leaf (b, a*x)); levels 1.. live in shared memory, n - 1
// elements a row at most, and the down-sweep writes each level's results
// over its elements.  Level 0's results are never stored: each lane turns
// its positions' maps into outputs at once.  A CTA holds as many rows as
// fit in 48 KB (at most 8); a row longer than that gets a CTA of its own
// with the shared memory opted in, up to the card's 227 KB a CTA.  A row
// whose levels do not fit there (past 9686 frames for the biquad, 29 057
// for the one-pole) keeps them in a device-memory workspace of [rows,
// n - 1] maps that the wrapper allocates (kGlobal): the same recursion, the
// same pairs in the same order, so the same bits, eight rows a CTA and no
// shared memory.  __syncwarp orders the lanes' global accesses as it does
// their shared ones.  Rows that fit take the shared-memory kernels, which
// this does not change.
//
// What bounds it on an H100: at the callers' shapes (16 384 rows of 128
// frames) memory, x read once and y written once, ~16.8 MB, ~5 us at
// 3.35 TB/s; the biquad does ~28 f32 operations a frame over both sweeps
// (~59 M at that shape, under 1 us at 67 TFLOP/s), the one-pole 4 float64
// operations a frame at the FP64 rate.  This first design does not reach
// the byte bound: each level is a __syncwarp apart, the levels' lanes fall
// idle as they shrink, and the 24-byte elements are read from shared memory
// with bank conflicts.  Fast is a later design's work; this one is right.

#include <cuda_runtime.h>
#include <stdint.h>

#include "assoc_scan.cuh"

namespace {

using namespace scan;

constexpr int kMaxWarps = 8;                   // rows a CTA
constexpr int kDefaultShared = 48 * 1024;      // without the opt-in
constexpr int kMaxShared = 232448;             // 227 KB, the H100's per-CTA limit

// The levels of row `row`, warp `w` of the CTA: in shared memory, or in the
// workspace `ws` [rows, row_elems] (kGlobal).
template <bool kGlobal, typename E>
__device__ __forceinline__ E* row_levels(E* ws, int64_t row, int w, int row_elems) {
    extern __shared__ unsigned char smem[];
    if (kGlobal) return ws + row * row_elems;
    return reinterpret_cast<E*>(smem) + (int64_t)w * row_elems;
}

// x, y [rows, n]; coef [5, rows] (b0, b1, b2, a1, a2); z_in, z_out [2, rows]
template <bool kGlobal>
__global__ void biquad_scan_kernel(const float* __restrict__ x, float* __restrict__ y,
                                   const float* __restrict__ coef,
                                   const float* __restrict__ z_in,
                                   float* __restrict__ z_out, int64_t rows, int n,
                                   int row_elems, Affine2* ws) {
    const int lane = threadIdx.x & (kWarp - 1);
    const int w = threadIdx.x / kWarp;
    const int64_t row = (int64_t)blockIdx.x * (blockDim.x / kWarp) + w;
    if (row >= rows) return;  // the whole warp: no CTA barrier follows
    Affine2* lv = row_levels<kGlobal>(ws, row, w, row_elems);
    const float* xr = x + row * n;
    float* yr = y + row * n;
    const float b0 = coef[row], b1 = coef[rows + row], b2 = coef[2 * rows + row];
    const float a1 = coef[3 * rows + row], a2 = coef[4 * rows + row];
    const BiquadLeaves leaf{xr, -a1, -a2, b1 - a1 * b0, b2 - a2 * b0};
    sweep(lv, n, leaf, lane);

    const float zp1 = z_in[row], zp2 = z_in[rows + row];
    if (lane == 0) yr[0] = b0 * xr[0] + zp1;
    for (int p = lane; p < n; p += kWarp) {
        const Affine2 r = level0(lv, p, leaf);
        const float z1 = r.p11 * zp1 + r.p12 * zp2 + r.q1;
        const float z2 = r.p21 * zp1 + r.p22 * zp2 + r.q2;
        if (p + 1 < n) {
            yr[p + 1] = b0 * xr[p + 1] + z1;
        } else {
            z_out[row] = z1;
            z_out[rows + row] = z2;
        }
    }
}

// x, y [rows, n]; coef [2, rows] (a, b); y_in, y_out [rows]
template <bool kGlobal>
__global__ void one_pole_scan_kernel(const float* __restrict__ x, float* __restrict__ y,
                                     const float* __restrict__ coef,
                                     const float* __restrict__ y_in,
                                     float* __restrict__ y_out, int64_t rows, int n,
                                     int row_elems, Affine1* ws) {
    const int lane = threadIdx.x & (kWarp - 1);
    const int w = threadIdx.x / kWarp;
    const int64_t row = (int64_t)blockIdx.x * (blockDim.x / kWarp) + w;
    if (row >= rows) return;
    Affine1* lv = row_levels<kGlobal>(ws, row, w, row_elems);
    const float* xr = x + row * n;
    float* yr = y + row * n;
    const OnePoleLeaves leaf{xr, coef[row], coef[rows + row]};
    sweep(lv, n, leaf, lane);

    const float yp = y_in[row];
    for (int p = lane; p < n; p += kWarp) {
        const Affine1 r = level0(lv, p, leaf);
        const float v = fma64(r.m, yp, r.v);
        yr[p] = v;
        if (p == n - 1) y_out[row] = v;
    }
}

// The elements of a row's levels: n - 1 maps (one for n = 1, never read).
__host__ __device__ inline int row_elems_of(int n) { return n > 1 ? n - 1 : 1; }

// Launches `shared` (levels in shared memory) when a row's levels fit in a
// CTA's, else `global` with the levels in `ws` (rows * row_elems maps).
template <typename E>
int launch(void (*shared)(const float*, float*, const float*, const float*, float*,
                          int64_t, int, int, E*),
           void (*global)(const float*, float*, const float*, const float*, float*,
                          int64_t, int, int, E*),
           const void* x, void* y, const void* coef, const void* s_in, void* s_out,
           int64_t rows, int n, void* ws, void* stream) {
    if (rows <= 0) return (int)cudaSuccess;
    if (n < 1) return (int)cudaErrorInvalidValue;
    const int row_elems = row_elems_of(n);
    const size_t row_bytes = (size_t)row_elems * sizeof(E);
    auto kernel = shared;
    int warps = kMaxWarps;
    size_t bytes = 0;
    if (row_bytes > (size_t)kMaxShared) {
        if (ws == nullptr) return (int)cudaErrorInvalidValue;
        kernel = global;
    } else {
        warps = (int)(kDefaultShared / row_bytes);
        warps = warps < 1 ? 1 : (warps > kMaxWarps ? kMaxWarps : warps);
        bytes = row_bytes * warps;
        if (bytes > (size_t)kDefaultShared) {
            const cudaError_t e = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
            if (e != cudaSuccess) return (int)e;
        }
    }
    const unsigned blocks = (unsigned)((rows + warps - 1) / warps);
    kernel<<<blocks, warps * kWarp, bytes, (cudaStream_t)stream>>>(
        static_cast<const float*>(x), static_cast<float*>(y),
        static_cast<const float*>(coef), static_cast<const float*>(s_in),
        static_cast<float*>(s_out), rows, n, row_elems, static_cast<E*>(ws));
    return (int)cudaGetLastError();
}

}  // namespace

// Bytes of the device-memory workspace a call over `rows` rows of `frames`
// frames needs: 0 when a row's levels fit in a CTA's shared memory.
// `biquad` selects the biquad's maps (24 bytes), else the one-pole's (8).
extern "C" int64_t fw_scan_workspace_bytes(int biquad, int64_t rows, int frames) {
    if (rows <= 0 || frames < 1) return 0;
    const size_t elem = biquad ? sizeof(Affine2) : sizeof(Affine1);
    const size_t row_bytes = (size_t)row_elems_of(frames) * elem;
    return row_bytes > (size_t)kMaxShared ? (int64_t)(row_bytes * rows) : 0;
}

// biquad: coef [5, rows] (b0, b1, b2, a1, a2), z_in and z_out [2, rows];
// ws the workspace of fw_scan_workspace_bytes (null when that is 0).
// Returns the launch's cudaError_t (cudaErrorInvalidValue for frames < 1,
// or for a row past shared memory without a workspace).
extern "C" int fw_biquad_scan(const void* x, void* y, const void* coef, const void* z_in,
                              void* z_out, int64_t rows, int frames, void* ws,
                              void* stream) {
    return launch<Affine2>(biquad_scan_kernel<false>, biquad_scan_kernel<true>, x, y,
                           coef, z_in, z_out, rows, frames, ws, stream);
}

// one-pole: coef [2, rows] (a, b), y_in and y_out [rows]; ws as above.
extern "C" int fw_one_pole_scan(const void* x, void* y, const void* coef, const void* y_in,
                                void* y_out, int64_t rows, int frames, void* ws,
                                void* stream) {
    return launch<Affine1>(one_pole_scan_kernel<false>, one_pole_scan_kernel<true>, x, y,
                           coef, y_in, y_out, rows, frames, ws, stream);
}

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
//   The sections before the last are recomputed forward, frame by frame,
//   from x and the states in (y = b0 x + z1, z1 = (b1 x - a1 y) + z2, z2 =
//   b2 x - a2 y), into a device-memory workspace [S - 1, rows, frames];
//   the last section's output is K7's y.  Then the sections run in reverse
//   order, each its adjoint backwards in time: with the state's adjoint
//   (mu1, mu2) (the state-out gradient at the last frame), e = (g_y - a1
//   mu1) - a2 mu2 is the output's, g_x = (b0 e + b1 mu1) + b2 mu2, the
//   coefficients' gradients sum e x, mu1 x, mu2 x, -mu1 y and -mu2 y over
//   the frames, and (mu1, mu2) <- (e, mu1).  Section s's g_x is section
//   s - 1's g_y, kept in g_x.
// * fw_one_pole_scan_bwd: y = a x + b y_prev backwards, lam = g_y + b lam,
//   g_x = a lam, g_a = sum lam x, g_b = sum lam y_prev; lam[n + 1] y[n] is
//   added at frame n, so no frame reads the one before it.
//
// Design (K1's and K5's): one warp a CTA, one row a thread, the recurrence
// serial along the row; each array's stages of 32 frames go through
// shared memory by cp.async, last stage first (csrc/reverse_stage.cuh), so
// that device memory is read and written in coalesced 16-byte pieces; the
// per-row coefficient gradients are sums in registers, written once.
//
// What bounds it on an H100: bytes.  A section reads x, y and g_y and
// writes g_x, 16 bytes a frame (8.4 MB at the EQ's f32[16384, 128], 2.5 us
// at 3.35 TB/s), and a cascade of S sections writes and reads S - 1
// recomputed inputs besides; the work is ~16 f32 operations a frame a
// section.  Each row's frames are serial, so the card holds one thread a
// row: 16 384 rows are 512 warps, about four an SM, and only the copies
// kept in flight ahead of the recurrence hide device memory's latency.

#include <cuda_runtime.h>
#include <stdint.h>

#include "reverse_stage.cuh"

namespace k8 {

constexpr int kMaxSections = 8;

using bwd::Operand;

// S sections: each one's coefficients (b0, b1, b2, a1, a2), state in (z1,
// z2) and state-out gradient; x, y, g_y, g_x [rows, frames]; g_coef [S, 5,
// rows], g_z_in [S, 2, rows]; ws [S - 1, rows, frames] (null for S = 1)
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
    float* ws;
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

template <bool kVec>
__global__ void __launch_bounds__(kLanes) biquad_bwd_kernel(const BiquadBwdArgs a) {
    __shared__ __align__(16) Tile ring[kRing][3];

    const int t = threadIdx.x;
    const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kLanes;
    const int rows = static_cast<int>(a.rows - row0 < kLanes ? a.rows - row0 : kLanes);
    const bool live = t < rows;
    const int64_t row = live ? row0 + t : row0;
    const int64_t stride = a.rows * a.frames;  // a workspace section
    const int last = a.sections - 1;

    // the inputs of sections 1..S-1, recomputed forward into ws
    for (int s = 0; s < last; ++s) {
        const Operand* c = a.coef[s];
        const float b0 = at(c[0], row, a.inner), b1 = at(c[1], row, a.inner);
        const float b2 = at(c[2], row, a.inner), a1 = at(c[3], row, a.inner);
        const float a2 = at(c[4], row, a.inner);
        float z1 = at(a.z_in[s][0], row, a.inner), z2 = at(a.z_in[s][1], row, a.inner);
        const float* src[1] = {s ? a.ws + (s - 1) * stride : a.x};
        float* const dst[1] = {a.ws + s * stride};
        const int out[1] = {0};
        run_stages<1, 1, 3, kVec, false>(
            src, dst, out, ring, row0, rows, a.frames, t, [&](Tile* slot, int, int nf) {
                if (!live) return;
                float* r = slot[0][t];
                for (int f = 0; f < nf; ++f) {
                    const float xi = r[f];
                    const float yi = b0 * xi + z1;
                    z1 = (b1 * xi - a1 * yi) + z2;
                    z2 = b2 * xi - a2 * yi;
                    r[f] = yi;
                }
            });
    }

    // the sections' adjoints, last section first
    for (int s = last; s >= 0; --s) {
        const Operand* c = a.coef[s];
        const float b0 = at(c[0], row, a.inner), b1 = at(c[1], row, a.inner);
        const float b2 = at(c[2], row, a.inner), a1 = at(c[3], row, a.inner);
        const float a2 = at(c[4], row, a.inner);
        float mu1 = at(a.g_z_out[s][0], row, a.inner);
        float mu2 = at(a.g_z_out[s][1], row, a.inner);
        float g0 = 0.0f, g1 = 0.0f, g2 = 0.0f, g3 = 0.0f, g4 = 0.0f;
        const float* src[3] = {s ? a.ws + (s - 1) * stride : a.x,
                               s == last ? a.y : a.ws + s * stride,
                               s == last ? a.g_y : a.g_x};
        float* const dst[1] = {a.g_x};
        const int out[1] = {2};
        run_stages<3, 1, 3, kVec, true>(
            src, dst, out, ring, row0, rows, a.frames, t, [&](Tile* slot, int, int nf) {
                if (!live) return;
                const float* xr = slot[0][t];
                const float* yr = slot[1][t];
                float* gr = slot[2][t];
                for (int f = nf - 1; f >= 0; --f) {
                    const float xi = xr[f], yi = yr[f];
                    const float e = (gr[f] - a1 * mu1) - a2 * mu2;
                    gr[f] = (b0 * e + b1 * mu1) + b2 * mu2;
                    g0 = g0 + e * xi;
                    g1 = g1 + mu1 * xi;
                    g2 = g2 + mu2 * xi;
                    g3 = g3 - mu1 * yi;
                    g4 = g4 - mu2 * yi;
                    mu2 = mu1;
                    mu1 = e;
                }
            });
        if (live) {
            float* gc = a.g_coef + static_cast<int64_t>(s) * 5 * a.rows + row;
            gc[0] = g0;
            gc[a.rows] = g1;
            gc[2 * a.rows] = g2;
            gc[3 * a.rows] = g3;
            gc[4 * a.rows] = g4;
            float* gz = a.g_z_in + static_cast<int64_t>(s) * 2 * a.rows + row;
            gz[0] = mu1;
            gz[a.rows] = mu2;
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

    const float ca = at(a.a, row, a.inner), cb = at(a.b, row, a.inner);
    const float y_in = at(a.y_in, row, a.inner);
    // lam: the adjoint of y[n] before g_y[n] joins; mu: lam[n + 1] after it
    // joined, whose term mu * y[n] of g_b is added at frame n (the plain
    // version adds it at frame n + 1 with y[n] as y_prev: the same terms in
    // the same order, without reading y[n - 1])
    float lam = at(a.g_y_out, row, a.inner);
    float mu = 0.0f;
    bool first = true;
    float g_a = 0.0f, g_b = 0.0f;
    const float* src[3] = {a.x, a.y, a.g_y};
    float* const dst[1] = {a.g_x};
    const int out[1] = {2};
    run_stages<3, 1, 3, kVec, true>(
        src, dst, out, ring, row0, rows, a.frames, t, [&](Tile* slot, int, int nf) {
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

}  // namespace

// biquad: args->sections (1..8) sections over x [rows, frames] whose
// output was y; g_x, g_coef, g_z_in written; ws the workspace [S - 1, rows,
// frames] (null for one section).  Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for frames < 1, a section count
// out of range or a workspace missing); it does not synchronise.
extern "C" int fw_biquad_cascade_bwd(const k8::BiquadBwdArgs* args, void* stream) {
    const BiquadBwdArgs& a = *args;
    if (a.rows <= 0) return static_cast<int>(cudaSuccess);
    if (a.frames < 1 || a.sections < 1 || a.sections > k8::kMaxSections || a.inner < 1 ||
        (a.sections > 1 && a.ws == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    const unsigned blocks = static_cast<unsigned>((a.rows + kLanes - 1) / kLanes);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool vec = a.frames % 4 == 0 && aligned16(a.x) && aligned16(a.y) &&
                     aligned16(a.g_y) && aligned16(a.g_x) && (a.ws == nullptr || aligned16(a.ws));
    if (vec)
        biquad_bwd_kernel<true><<<blocks, kLanes, 0, st>>>(a);
    else
        biquad_bwd_kernel<false><<<blocks, kLanes, 0, st>>>(a);
    return static_cast<int>(cudaGetLastError());
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

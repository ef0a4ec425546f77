// The associative scans of ops/iir.py as device code, shared by K7
// (assoc_scan.cu, one launch a section) and the megakernel (megakernel.cu,
// the EQ's bands and the waveshaper's DC blocker inside a row), so that both
// compose the same partial products in the same order: the recursion of
// lax.associative_scan (ops/iir.py:_associative_scan), pair for pair.
//
//   up-sweep    level 0 is the n leaves; level l+1 composes the pairs
//               (2i, 2i+1) of level l, floor(n_l / 2) of them, until a
//               level has one element;
//   down-sweep  from the top down, level l's result at 2j+1 is level l+1's
//               result at j, at 2j (j >= 1) compose(result_{l+1}[j-1],
//               e_l[2j]), at 0 e_l[0].
//
// One warp runs a row.  Levels 1.. live in `lv` (n - 1 elements at most);
// level 0's results are never stored: level0() composes a position's map
// from level 1's results when the caller turns it into an output.  Every
// file that includes this one is built with --fmad=false, so that nvcc
// contracts none of compose()'s products; the one-pole's v1*m2 + v2 is
// ops/iir.py:_fma's float64 product and sum rounded to float32, not fmaf.

#pragma once

namespace scan {

constexpr int kWarp = 32;
constexpr int kMaxLevels = 32;

// a 2x2 affine map of the biquad's state (z1, z2): z -> M z + v
struct Affine2 {
    float p11, p12, p21, p22, q1, q2;
};

// the one-pole's affine map y -> m y + v
struct Affine1 {
    float m, v;
};

// float32 a*b + c rounded as ops/iir.py:_fma rounds it
__device__ __forceinline__ float fma64(float a, float b, float c) {
    return (float)((double)a * (double)b + (double)c);
}

// e2 o e1, ops/iir.py:_compose
__device__ __forceinline__ Affine2 compose(const Affine2& e1, const Affine2& e2) {
    Affine2 r;
    r.p11 = e2.p11 * e1.p11 + e2.p12 * e1.p21;
    r.p12 = e2.p11 * e1.p12 + e2.p12 * e1.p22;
    r.p21 = e2.p21 * e1.p11 + e2.p22 * e1.p21;
    r.p22 = e2.p21 * e1.p12 + e2.p22 * e1.p22;
    r.q1 = e2.p11 * e1.q1 + e2.p12 * e1.q2 + e2.q1;
    r.q2 = e2.p21 * e1.q1 + e2.p22 * e1.q2 + e2.q2;
    return r;
}

// e2 o e1, ops/iir.py:_one_pole_compose
__device__ __forceinline__ Affine1 compose(const Affine1& e1, const Affine1& e2) {
    Affine1 r;
    r.m = e1.m * e2.m;
    r.v = fma64(e1.v, e2.m, e2.v);
    return r;
}

// The leaves of a row, computed from x on demand.
struct BiquadLeaves {
    const float* x;
    float na1, na2, c1, c2;
    __device__ __forceinline__ Affine2 operator()(int p) const {
        const float xp = x[p];
        return Affine2{na1, 1.0f, na2, 0.0f, c1 * xp, c2 * xp};
    }
};

struct OnePoleLeaves {
    const float* x;
    float a, b;
    __device__ __forceinline__ Affine1 operator()(int p) const {
        return Affine1{b, a * x[p]};
    }
};

// The up-sweep and the down-sweep of levels 1..: on return lv holds every
// level's results, level 1 (the pairs of leaves) at lv[0, n / 2).  One warp.
template <typename E, typename Leaves>
__device__ void sweep(E* lv, int n, const Leaves& leaf, int lane) {
    int off[kMaxLevels], size[kMaxLevels];
    int levels = 0, m = n, cur = -1, o = 0;
    while (m >= 2) {
        const int h = m >> 1;
        for (int i = lane; i < h; i += kWarp) {
            const E a = cur < 0 ? leaf(2 * i) : lv[cur + 2 * i];
            const E b = cur < 0 ? leaf(2 * i + 1) : lv[cur + 2 * i + 1];
            lv[o + i] = compose(a, b);
        }
        __syncwarp();
        off[levels] = o;
        size[levels] = h;
        ++levels;
        cur = o;
        o += h;
        m = h;
    }
    // the top level (one element) is its own result
    for (int k = levels - 2; k >= 0; --k) {
        const int base = off[k], up = off[k + 1], mk = size[k];
        for (int j = 1 + lane; j <= (mk - 1) / 2; j += kWarp)
            lv[base + 2 * j] = compose(lv[up + j - 1], lv[base + 2 * j]);
        for (int j = lane; j < mk / 2; j += kWarp)
            lv[base + 2 * j + 1] = lv[up + j];
        __syncwarp();
    }
}

// position p's composed map at level 0, from level 1's results
template <typename E, typename Leaves>
__device__ __forceinline__ E level0(const E* lv, int p, const Leaves& leaf) {
    if (p == 0) return leaf(0);
    if (p & 1) return lv[(p - 1) >> 1];
    return compose(lv[(p >> 1) - 1], leaf(p));
}

}  // namespace scan

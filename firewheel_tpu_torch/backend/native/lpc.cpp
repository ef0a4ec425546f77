// Exact integer FLAC LPC synthesis: x[i] = r[i] + ((sum_j c[j] * x[i-1-j]) >> shift).
//
// The recurrence is inherently sequential (each output feeds the next
// prediction), so it cannot vectorize in NumPy; the pure-Python loop in
// core/flac.py costs ~order x n Python operations per subframe, enough to
// stall a StreamingSamplerNode prefetch on ordinary 16-bit LPC files.
// int64 accumulation is exact for every spec-conformant stream: |coeff|
// <= 2^14 (15-bit precision), order <= 32, |sample| <= 2^32 (33-bit side
// channel) => |acc| <= 2^51.  >> on int64 is an arithmetic shift on every
// toolchain we build with, matching the spec's and Python's floor shift.

#include <cstddef>
#include <cstdint>
#include <vector>

extern "C" void flac_lpc(const int64_t* warm, size_t order,
                         const int32_t* coeffs, int shift,
                         const int64_t* resid, size_t n, int64_t* out) {
    std::vector<int64_t> x(order + n);
    for (size_t i = 0; i < order; ++i) x[i] = warm[i];
    for (size_t i = 0; i < n; ++i) {
        int64_t acc = 0;
        for (size_t j = 0; j < order; ++j)
            acc += (int64_t)coeffs[j] * x[order + i - 1 - j];
        x[order + i] = resid[i] + (acc >> shift);
    }
    for (size_t i = 0; i < n; ++i) out[i] = x[order + i];
}

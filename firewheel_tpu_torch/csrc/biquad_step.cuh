// One step of the transposed-direct-form-II biquad, shared by the
// sequential-biquad kernel (biquad.cu) and the megakernel (megakernel.cu),
// so that both round the recurrence the same way:
//
//     y   = fma(b0, x, z1)
//     z1' = fma(b1, x, -(a1*y)) + z2
//     z2' = fma(b2, x, -(a2*y))
//
// Every file that includes it is built with --fmad=false: the three fmaf
// calls are the only fused operations.  That is the rounding XLA gives the
// JAX package's Pallas body on the CPU, and the one the plain PyTorch
// version (ops/seq_iir.py) reproduces.

#pragma once

struct BiquadCoef {
  float b0, b1, b2, a1, a2;
};

__device__ __forceinline__ float biquad_step(const BiquadCoef& c, float x,
                                             float& z1, float& z2) {
  const float y = fmaf(c.b0, x, z1);
  const float z1n = fmaf(c.b1, x, -(c.a1 * y)) + z2;
  z2 = fmaf(c.b2, x, -(c.a2 * y));
  z1 = z1n;
  return y;
}

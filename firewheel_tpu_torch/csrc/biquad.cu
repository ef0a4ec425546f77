// Sequential transposed-direct-form-II biquad, one thread per lane.
//
// Replaces the TPU kernel firewheel_tpu/ops/pallas_iir.py:_biquad_kernel.
// Per lane (instance x channel), over F frames:
//
//     y   = fma(b0, x, z1)
//     z1' = fma(b1, x, -(a1*y)) + z2
//     z2' = fma(b2, x, -(a2*y))
//
// with the state (z1, z2) read at the start and written at the end.  Unlike
// the TPU kernel, which takes one filter per call as scalar prefetch, every
// lane carries its own five coefficients: a batch of instances carries a
// batch of cutoffs.
//
// What bounds it on an H100: memory.  Each lane-frame reads 4 bytes of x and
// writes 4 bytes of y for ~5 flops; the recurrence itself is a short
// dependent chain per frame held in registers.  x and y are [lanes, F]
// row-major, so a thread walking its own row directly would read with a
// stride of F floats and no two threads of a warp would share a 128-byte
// line.  The design therefore stages a tile of kTileF frames for the
// block's kLanes lanes through shared memory: the warp loads and stores
// 32 consecutive frames of one row at a time (fully coalesced), and each
// thread runs the recurrence over its own row of the tile.  The row pitch
// is kTileF + 1 floats, so the 32 threads of a warp reading column c of 32
// different rows hit 32 different banks.
//
// Rounding: the three fused multiply-adds above are written out with fmaf
// in biquad_step.cuh (shared with the megakernel), and the file is built
// with --fmad=false so that nvcc contracts nothing else.  That is the rounding XLA gives the Pallas kernel's body on the CPU
// (its interpret mode, the port's reference in the tests), and the one the
// plain PyTorch version reproduces, so the kernel matches both to the bit
// save for the plain version's rare double rounding (see seq_iir.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "biquad_step.cuh"

namespace {

constexpr int kLanes = 64;   // lanes per block, one thread each
constexpr int kTileF = 32;   // frames per shared-memory tile

__global__ void __launch_bounds__(kLanes)
biquad_seq_kernel(const float* __restrict__ x, float* __restrict__ y,
                  const float* __restrict__ z_in, float* __restrict__ z_out,
                  const float* __restrict__ coef, int64_t lanes, int frames) {
  __shared__ float tile[kLanes][kTileF + 1];

  const int t = threadIdx.x;
  const int64_t lane0 = static_cast<int64_t>(blockIdx.x) * kLanes;
  const int64_t lane = lane0 + t;
  const int rows = static_cast<int>(
      lanes - lane0 < kLanes ? lanes - lane0 : kLanes);
  const bool live = t < rows;

  // coef is [5, lanes]: b0, b1, b2, a1, a2; z_in/z_out are [2, lanes].
  BiquadCoef bq = {0.f, 0.f, 0.f, 0.f, 0.f};
  float z1 = 0.f, z2 = 0.f;
  if (live) {
    bq.b0 = coef[lane];
    bq.b1 = coef[lanes + lane];
    bq.b2 = coef[2 * lanes + lane];
    bq.a1 = coef[3 * lanes + lane];
    bq.a2 = coef[4 * lanes + lane];
    z1 = z_in[lane];
    z2 = z_in[lanes + lane];
  }

  for (int f0 = 0; f0 < frames; f0 += kTileF) {
    const int nf = frames - f0 < kTileF ? frames - f0 : kTileF;

    for (int i = t; i < rows * kTileF; i += kLanes) {
      const int r = i / kTileF;
      const int c = i % kTileF;
      if (c < nf) tile[r][c] = x[(lane0 + r) * frames + f0 + c];
    }
    __syncthreads();

    if (live) {
      for (int f = 0; f < nf; ++f) {
        tile[t][f] = biquad_step(bq, tile[t][f], z1, z2);
      }
    }
    __syncthreads();

    for (int i = t; i < rows * kTileF; i += kLanes) {
      const int r = i / kTileF;
      const int c = i % kTileF;
      if (c < nf) y[(lane0 + r) * frames + f0 + c] = tile[r][c];
    }
    __syncthreads();
  }

  if (live) {
    z_out[lane] = z1;
    z_out[lanes + lane] = z2;
  }
}

}  // namespace

// x, y: f32[lanes, frames]; z_in, z_out: f32[2, lanes]; coef: f32[5, lanes].
// All contiguous on the current device.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); it does not synchronise.
extern "C" int fw_biquad_seq(const float* x, float* y, const float* z_in,
                             float* z_out, const float* coef, int64_t lanes,
                             int frames, void* stream) {
  if (lanes <= 0) return 0;
  const int64_t blocks = (lanes + kLanes - 1) / kLanes;
  biquad_seq_kernel<<<static_cast<unsigned int>(blocks), kLanes, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      x, y, z_in, z_out, coef, lanes, frames);
  return static_cast<int>(cudaGetLastError());
}

// K6: the noise node's white draw, jax.random.uniform(fold_in(PRNGKey(seed),
// stream_sample), (ch, F), -1, 1), bit for bit.
//
// Replaces firewheel_tpu/nodes/generators.py:85-90 (jax.random's threefry
// under the noise kernel).  Its plain version is ops/noise.py:
// noise_uniform_reference (int64 masked to 32 bits); both are integer
// exact and agree to the bit.
//
// One thread an output element (instance, channel, frame): it folds the
// block's stream sample into the instance's key (one Threefry-2x32 hash),
// hashes its row-major index i in the (ch, F) draw as the counts (i >> 32,
// i) (the partitionable mode of JAX 0.9), XORs the two words, and keeps the
// top 23 bits as the mantissa of a float in [1, 2): 2·(u − 1) − 1, at least
// −1.  Bound: bytes (one f32 written a sample; two hashes of 20 rounds of
// 32-bit adds, rotates and XORs are ~250 integer operations a sample, far
// under the card's integer rate at these sizes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
    return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                                             uint32_t& x1) {
    const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
    const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
    x0 += ks[0];
    x1 += ks[1];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            x0 += x1;
            x1 = x0 ^ rotl(x1, rot[i % 2][j]);
        }
        x0 += ks[(i + 1) % 3];
        x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
    }
}

__global__ void __launch_bounds__(kThreads)
noise_uniform_kernel(const int64_t* __restrict__ seeds, const int64_t* __restrict__ sample,
                     float* __restrict__ out, int64_t lanes, int64_t per_lane) {
    const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= lanes * per_lane) return;
    const int64_t lane = e / per_lane;
    const uint64_t i = (uint64_t)(e - lane * per_lane);
    // PRNGKey(seed) = (0, seed); fold_in hashes (0, stream_sample)
    uint32_t k0 = 0u, k1 = (uint32_t)*sample;
    threefry2x32(0u, (uint32_t)seeds[lane], k0, k1);
    uint32_t x0 = (uint32_t)(i >> 32), x1 = (uint32_t)i;
    threefry2x32(k0, k1, x0, x1);
    const uint32_t bits = x0 ^ x1;
    const float u = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
    const float v = u * 2.0f + -1.0f;
    out[e] = v < -1.0f ? -1.0f : v;
}

}  // namespace

// seeds: int64 [lanes] holding uint32 seeds; sample: a device pointer to the
// block's int64 stream sample; out: f32 [lanes, per_lane].  Returns the
// launch's cudaError_t.
extern "C" int fw_noise_uniform(const void* seeds, const void* sample, void* out,
                                int64_t lanes, int64_t per_lane, void* stream) {
    const int64_t total = lanes * per_lane;
    const int64_t blocks = (total + kThreads - 1) / kThreads;
    noise_uniform_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const int64_t*>(seeds), static_cast<const int64_t*>(sample),
        static_cast<float*>(out), lanes, per_lane);
    return (int)cudaGetLastError();
}

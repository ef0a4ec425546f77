// K6: the noise node's white draw, jax.random.uniform(fold_in(PRNGKey(seed),
// stream_sample), (ch, F), -1, 1), bit for bit.
//
// Replaces firewheel_tpu/nodes/generators.py:85-90 (jax.random's threefry
// under the noise kernel).  Its plain version is ops/noise.py:
// noise_uniform_reference (int64 masked to 32 bits); both are integer
// exact and agree to the bit.  tests/test_torch_generators.py holds a
// plain version in this kernel's order against JAX.
//
// Lanes are the instances, each a row of per_lane = ch·F elements.  The
// launch is 2-D (ops/noise.py:launch_geometry): a CTA of kThreads threads
// holds blockDim.y lanes, blockDim.x threads along each, and each thread
// draws kElems consecutive elements of its lane; grid.y tiles a lane longer
// than blockDim.x·kElems.  So a thread finds its lane and its elements
// without any division, in 32-bit indices (the wrapper refuses a shape
// whose lanes·per_lane leaves them).  kElems is 8 in a draw that fills
// the card at 8 a thread (the bus's f32[8192, 2, 128]), 4 in a smaller
// one, and 1 in a draw that the launch's latency bounds (the stream's
// [1, 2, 256]): more elements a thread share its overhead (indices, the
// key's load and schedule) among more hashes, fewer spread a small draw
// over more SMs and shorten each thread's chain.
//
// Bound: bytes, closely followed by operations.  A sample writes its four
// bytes once and needs one Threefry-2x32 hash (20 rounds of a 32-bit add,
// a rotate and an XOR, and the key injections) and the float conversion
// (chip_smoke.py:k6_work counts both).  So each lane's key, the
// fold_in of the block's stream sample into PRNGKey(seed), is one more
// hash that is the same for every element of the lane: one thread a lane
// of the CTA hashes it into shared memory before one barrier, once for the
// CTA's run of the lane (the whole lane, but for a lane longer than a
// CTA's tile).  The element's counts are (i >> 32, i) = (0, i) for a
// lane shorter than 2^32 (the wrapper refuses a longer one), so the first
// injection leaves k0 in x0; the injections' key-plus-round constants are
// the same for a thread's kElems hashes and are formed once.  The rotate is
// one funnel shift (SHF.L.W).  The float is (bits >> 9 | 1.0f's exponent)
// = f in [1, 2), and 2·(f − 1) − 1 = 2f − 3 is exact in float32, so one
// fmaf gives the bits of JAX's (f − 1)·2 + (−1) and its max with −1.  The
// kElems floats go out as 16-byte stores where the row allows it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // ops/noise.py:THREADS
constexpr uint32_t kParity = 0x1BD11BDAu;

// Threefry-2x32's key schedule: the key's two words and their parity word
struct Key {
    uint32_t k[3];
};

__device__ __forceinline__ Key schedule(uint32_t k0, uint32_t k1) {
    return {{k0, k1, k0 ^ k1 ^ kParity}};
}

// The 20 rounds and the five key injections after the first: (x0, x1) are
// the counts with the first injection added.
__device__ __forceinline__ void threefry_rounds(const Key& ks, uint32_t& x0, uint32_t& x1) {
    constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
#pragma unroll
    for (int i = 0; i < 5; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            x0 += x1;
            x1 = x0 ^ __funnelshift_l(x1, x1, kRot[i % 2][j]);
        }
        x0 += ks.k[(i + 1) % 3];
        x1 += ks.k[(i + 2) % 3] + (uint32_t)(i + 1);
    }
}

// jax.random.uniform's float in [-1, 1) from 32 random bits (see above)
__device__ __forceinline__ float uniform(uint32_t bits) {
    return fmaf(__uint_as_float((bits >> 9) | 0x3F800000u), 2.0f, -3.0f);
}

template <int kElems>
__global__ void __launch_bounds__(kThreads)
noise_uniform_kernel(const int64_t* __restrict__ seeds, const int64_t* __restrict__ sample,
                     float* __restrict__ out, uint32_t lanes, uint32_t per_lane) {
    __shared__ uint32_t keys[2][kThreads];
    const uint32_t first = blockIdx.x * blockDim.y;
    const uint32_t t = threadIdx.y * blockDim.x + threadIdx.x;
    if (t < blockDim.y && first + t < lanes) {
        // fold_in(PRNGKey(seed), sample): the key (0, seed), the counts
        // (0, sample)
        const Key ks = schedule(0u, (uint32_t)seeds[first + t]);
        uint32_t x0 = 0u, x1 = (uint32_t)*sample + ks.k[1];
        threefry_rounds(ks, x0, x1);
        keys[0][t] = x0;
        keys[1][t] = x1;
    }
    __syncthreads();
    const uint32_t lane = first + threadIdx.y;
    const uint32_t i = (blockIdx.y * blockDim.x + threadIdx.x) * kElems;
    if (lane >= lanes || i >= per_lane) return;
    const Key ks = schedule(keys[0][threadIdx.y], keys[1][threadIdx.y]);
    float v[kElems];
#pragma unroll
    for (int j = 0; j < kElems; ++j) {
        uint32_t x0 = ks.k[0], x1 = i + j + ks.k[1];
        threefry_rounds(ks, x0, x1);
        v[j] = uniform(x0 ^ x1);
    }
    const uint32_t e = lane * per_lane + i;
    if constexpr (kElems % 4 == 0) {
        // out is the wrapper's fresh tensor: 16-byte aligned where e is
        if (i + kElems <= per_lane && e % 4 == 0) {
#pragma unroll
            for (int j = 0; j < kElems; j += 4) {
                *reinterpret_cast<float4*>(out + e + j) =
                    make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
            }
            return;
        }
    }
#pragma unroll
    for (int j = 0; j < kElems; ++j) {
        if (i + j < per_lane) out[e + j] = v[j];
    }
}

template <int kElems>
int launch(const void* seeds, const void* sample, void* out, int64_t lanes,
           int64_t per_lane, dim3 grid, dim3 block, cudaStream_t stream) {
    noise_uniform_kernel<kElems><<<grid, block, 0, stream>>>(
        static_cast<const int64_t*>(seeds), static_cast<const int64_t*>(sample),
        static_cast<float*>(out), (uint32_t)lanes, (uint32_t)per_lane);
    return (int)cudaGetLastError();
}

}  // namespace

// seeds: int64 [lanes] holding uint32 seeds; sample: a device pointer to the
// block's int64 stream sample; out: f32 [lanes, per_lane], fresh.  The
// geometry is ops/noise.py:launch_geometry's: elems a thread (1, 4 or 8),
// lane_threads × cta_lanes threads a CTA (kThreads), grid_x × grid_y CTAs.
// Returns the launch's cudaError_t.
extern "C" int fw_noise_uniform(const void* seeds, const void* sample, void* out,
                                int64_t lanes, int64_t per_lane, int elems,
                                int lane_threads, int cta_lanes, int64_t grid_x,
                                int64_t grid_y, void* stream) {
    if ((elems != 1 && elems != 4 && elems != 8) || lane_threads * cta_lanes != kThreads ||
        lanes <= 0 || per_lane <= 0 || lanes * per_lane > (int64_t)UINT32_MAX ||
        grid_y > 65535 || grid_x * cta_lanes < lanes ||
        grid_y * lane_threads * elems < per_lane) {
        return (int)cudaErrorInvalidValue;
    }
    const dim3 grid((unsigned)grid_x, (unsigned)grid_y);
    const dim3 block((unsigned)lane_threads, (unsigned)cta_lanes);
    const auto s = (cudaStream_t)stream;
    return elems == 8   ? launch<8>(seeds, sample, out, lanes, per_lane, grid, block, s)
           : elems == 4 ? launch<4>(seeds, sample, out, lanes, per_lane, grid, block, s)
                        : launch<1>(seeds, sample, out, lanes, per_lane, grid, block, s);
}

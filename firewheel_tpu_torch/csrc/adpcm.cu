// K4: IMA ADPCM (4-bit) encode of one chunk per instance, the serving
// fleet's "adpcm4" egress.
//
// Replaces firewheel_tpu/ops/adpcm_device.py:82 encode_ima_chunk, a
// lax.scan over the chunk's S samples (:140) with the nibbles packed
// outside it.  Its plain version is ops/adpcm_device.py:
// encode_ima_chunk_reference; the two are integer-exact and equal bit for
// bit.
//
// One thread per (instance, channel) lane carries the predictor and the
// step index in registers through the S samples (the recurrence is
// sequential), gathers each step from an [89] table in shared memory (the
// lanes' indices diverge, which would serialize a __constant__ read), and
// writes the block's 4-byte header and each group of 8 nibbles as one
// 32-bit word, low nibble first, groups round-robin over the channels: the
// wire layout of utils/adpcm.py:encode_ima.
//
// Bound: bytes.  int16 [B, S, No] in, uint8 [B, (4 + S/2)·No] out; at the
// fleet's B=8192, S=4096, No=2 that is 134 MB and 33.6 MB.  A thread reads
// x[b, s, ch] with a stride of No samples (simple, and cached in L1 over
// its 8-sample groups); staging tiles through shared memory is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ const int kImaStep[89] = {
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34, 37,
    41, 45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143, 157, 173,
    190, 209, 230, 253, 279, 307, 337, 371, 408, 449, 494, 544, 598, 658,
    724, 796, 876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066,
    2272, 2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358, 5894,
    6484, 7132, 7845, 8630, 9493, 10442, 11487, 12635, 13899, 15289,
    16818, 18500, 20350, 22385, 24623, 27086, 29794, 32767,
};

constexpr int kThreads = 64;

__global__ void __launch_bounds__(kThreads)
adpcm_encode_kernel(const int16_t* __restrict__ x, uint8_t* __restrict__ out,
                    int64_t lanes, int frames, int channels, int block_align) {
    __shared__ int step_table[89];
    for (int i = threadIdx.x; i < 89; i += blockDim.x) step_table[i] = kImaStep[i];
    __syncthreads();

    const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= lanes) return;
    const int64_t b = lane / channels;
    const int ch = (int)(lane - b * channels);
    const int16_t* xb = x + b * (int64_t)frames * channels + ch;
    uint8_t* row = out + b * (int64_t)block_align;

    // header: int16 LE predictor (sample 0), step index 0, reserved 0
    int pred = xb[0];
    int idx = 0;
    reinterpret_cast<uint32_t*>(row)[ch] = (uint32_t)(uint16_t)(int16_t)pred;

    // nibble s encodes sample s + 1; the last one the pad frame, a repeat
    // of sample S - 1
    uint32_t* payload = reinterpret_cast<uint32_t*>(row + 4 * channels);
    const int groups = frames / 8;
    for (int g = 0; g < groups; ++g) {
        uint32_t word = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int s = g * 8 + j + 1;
            const int target = xb[(int64_t)(s < frames ? s : frames - 1) * channels];
            const int step = step_table[idx];
            const int half = step >> 1, quarter = step >> 2;
            const int diff = target - pred;
            const int neg = diff < 0;
            int ad = neg ? -diff : diff;
            const int b4 = ad >= step;
            ad -= b4 * step;
            const int b2 = ad >= half;
            ad -= b2 * half;
            const int b1 = ad >= quarter;
            const int mag = b4 * 4 + b2 * 2 + b1;
            const int dq = (step >> 3) + b1 * quarter + b2 * half + b4 * step;
            pred = neg ? pred - dq : pred + dq;
            pred = pred < -32768 ? -32768 : (pred > 32767 ? 32767 : pred);
            idx += mag >= 4 ? 2 * mag - 6 : -1;
            idx = idx < 0 ? 0 : (idx > 88 ? 88 : idx);
            word |= (uint32_t)(mag + (neg ? 8 : 0)) << (4 * j);
        }
        payload[(int64_t)g * channels + ch] = word;
    }
}

}  // namespace

// x: int16 [batch, frames, channels] contiguous; out: uint8 [batch,
// (4 + frames/2)·channels], rows 4-byte aligned.  frames % 8 == 0 (the
// wrapper checks).  Returns the launch's cudaError_t.
extern "C" int fw_adpcm_encode(const void* x, void* out, int64_t batch, int frames,
                               int channels, void* stream) {
    const int64_t lanes = batch * channels;
    const int block_align = (4 + frames / 2) * channels;
    const int64_t blocks = (lanes + kThreads - 1) / kThreads;
    adpcm_encode_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const int16_t*>(x), static_cast<uint8_t*>(out), lanes, frames,
        channels, block_align);
    return (int)cudaGetLastError();
}

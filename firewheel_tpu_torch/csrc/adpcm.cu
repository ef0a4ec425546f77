// K4: IMA ADPCM (4-bit) encode of one chunk per instance, the serving
// fleet's "adpcm4" egress.
//
// Replaces firewheel_tpu/ops/adpcm_device.py:82 encode_ima_chunk, a
// lax.scan over the chunk's S samples (:140) with the nibbles packed
// outside it.  Its plain version is ops/adpcm_device.py:
// encode_ima_chunk_reference; the two are integer-exact and equal bit for
// bit.
//
// What bounds it on an H100: the recurrence.  By bytes, int16 [B, S, No] in
// and uint8 [B, (4 + S/2)·No] out, 134 MB and 33.6 MB at the fleet's
// B=8192, S=4096, No=2: 0.050 ms at 3.35 TB/s.  But each (instance,
// channel) lane carries its predictor and step index through its S samples
// in order, so no design beats S times the latency of one step's chain of
// dependent operations, whatever the bytes allow; and 16 384 lanes are
// only four warps an SM, one a scheduler, so nothing hides that latency.
// A first design read x[b, s, ch] from device memory inside the
// sample loop at a stride of No samples and walked a long chain a sample
// (the step table's shared-memory read, then the three successive
// comparisons of the quantizer, then dq and the clamps): ~250 cycles a
// sample on an H100.  This design, ~165 (PERF.md, Findings):
//
//  a. A CTA takes whole instances: 32 / No of them (one for No > 32), a
//     thread an (instance, channel) lane.  Their input rows, [S, No] int16
//     each, are contiguous; stages of 64 samples are copied with 16-byte
//     cp.async into a ring of kRing stages in shared memory, a commit group
//     each, kRing stages ahead of the recurrence, so no device-memory load
//     lies on the sample loop.  A group of 8 samples reads its targets
//     from shared memory into registers one group ahead.
//  b. The quantizer: the successive approximation's first bit b4 = |diff|
//     >= s, then its other two as the count of the thresholds q, h, h + q
//     (h = s >> 1, q = s >> 2; increasing for every step of the table,
//     s >= 7) that the remainder reaches, compared side by side, and dq =
//     (s >> 3) + b4·s + the largest of them reached (the reference's
//     b2·h + b1·q).  Each direction of diff clamps on its own side.
//  c. The step table off the loop-carried path.  The next index is one of
//     idx-1, idx+2, idx+4, idx+6, idx+8, clamped; their steps, each packed
//     with its index, are read from shared memory at the start of the
//     sample, while the quantizer runs, and the magnitude picks one (setp
//     and selp in PTX: as a C++ select nvcc made it a branch and moved the
//     reads after the quantizer).  No index arithmetic or clamp remains.
//  d. The output words of a stage (8 a lane: each group of 8 nibbles, low
//     first, groups round robin over the channels) go through shared
//     memory and leave as each instance's contiguous run of the row.
//
// The header (int16 LE predictor, which is sample 0, then step index 0 and
// a zero), the nibble order and the layout are utils/adpcm.py:encode_ima's
// wire format.

#include <cuda_pipeline.h>
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

constexpr int kMaxChannels = 64;   // a graph's outputs (core/node.py:MAX_PORTS)
constexpr int kStage = 64;         // samples a stage
constexpr int kGroups = kStage / 8;
constexpr int kRing = 4;           // stages in shared memory
constexpr int kRows = 89;          // the step indices

// The candidates of the indices that can follow index i, each packed as
// its step | the index << 16: i + 2, 4, 6, 8 (magnitudes 4..7) in up[i],
// i - 1 (magnitudes 0..3) in down[i], clamped to the table.
struct Rows {
    uint4 up[kRows];
    unsigned down[kRows];
};
constexpr int kRowsBytes = (sizeof(Rows) + 15) / 16 * 16;

struct Args {
    const int16_t* x;  // [batch, frames, channels]
    uint8_t* out;      // [batch, block_align]
    int64_t batch;
    int frames, channels, block_align;
    int inst;          // instances a CTA
    int row_pitch;     // bytes of an instance's row of a stage in shared memory
};

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

// Copies stage s of the CTA's `inst` instances into `slot`: each one's
// samples [64 s, 64 s + n) are n·No·2 contiguous bytes (a multiple of 16:
// n and S divide by 8), 16 bytes a copy, consecutive threads on
// consecutive copies.
__device__ void load_stage(const Args& a, int no, unsigned char* slot, int64_t b0, int inst,
                           int s, int t, int threads) {
    const int n = imin(kStage, a.frames - s * kStage);
    const int chunks = n * no / 8;  // 16-byte copies an instance
    const unsigned char* x = reinterpret_cast<const unsigned char*>(a.x);
    const int64_t row = static_cast<int64_t>(a.frames) * no * 2;
    const int64_t off = static_cast<int64_t>(s) * kStage * no * 2;
    for (int c = t; c < inst * chunks; c += threads) {
        const int i = c / chunks, k = c - i * chunks;
        __pipeline_memcpy_async(slot + i * a.row_pitch + 16 * k,
                                x + (b0 + i) * row + off + 16 * k, 16);
    }
}

__device__ void fill_rows(Rows* rows, int t, int threads) {
    auto pack = [](int k) {
        k = imin(imax(k, 0), 88);
        return static_cast<unsigned>(kImaStep[k]) | static_cast<unsigned>(k) << 16;
    };
    for (int i = t; i < kRows; i += threads) {
        rows->up[i] = make_uint4(pack(i + 2), pack(i + 4), pack(i + 6), pack(i + 8));
        rows->down[i] = pack(i - 1);
    }
}

// x >= t ? a : b as one setp and one selp.  Written as C++, nvcc turns
// the candidates' select tree into a branch on the magnitude and moves the
// candidates' reads into it, after the quantizer: back onto the
// loop-carried path (seen in the SASS of an earlier version).
__device__ __forceinline__ unsigned pick_ge(int x, int t, unsigned a, unsigned b) {
#ifdef __CUDA_ARCH__
    unsigned r;
    asm("{\n\t.reg .pred p;\n\tsetp.ge.s32 p, %1, %2;\n\tselp.b32 %0, %3, %4, p;\n\t}"
        : "=r"(r) : "r"(x), "r"(t), "r"(a), "r"(b));
    return r;
#else
    return x >= t ? a : b;
#endif
}

// One sample: the nibble for `target`; the predictor, the index and its
// step carried in registers.
__device__ __forceinline__ uint32_t encode(int target, int& pred, int& idx, int& step,
                                           const Rows* rows) {
    // the next index's candidates, read while the quantizer runs and
    // picked by its magnitude after
    const uint4 up = rows->up[idx];
    const unsigned down = rows->down[idx];
    const int q = step >> 2, h = step >> 1, hq = h + q, e = step >> 3;
    const int diff = target - pred;
    const bool neg = diff < 0;
    const int ad = neg ? -diff : diff;
    // the successive approximation's first bit; its other two are the
    // count of the thresholds q, h, h + q (increasing: s >= 7) that the
    // remainder reaches, compared side by side
    const bool b4 = ad >= step;
    const int r = b4 ? ad - step : ad;
    const bool p1 = r >= q, p2 = r >= h, p3 = r >= hq;
    // dq = e + b4·s + the largest of q, h, h + q reached (b2·h + b1·q),
    // added in the direction of diff; each direction clamps on its side
    const int base = e + (b4 ? step : 0);
    const int top = imax(imax(p1 ? q : 0, p2 ? h : 0), p3 ? hq : 0);
    pred = neg ? imax(pred - base - top, -32768) : imin(pred + base + top, 32767);
    // magnitude 4 + (p1 + p2 + p3) takes up.x..w, below 4 down
    const unsigned c = pick_ge(ad, step,
                               pick_ge(r, h, pick_ge(r, hq, up.w, up.z), pick_ge(r, q, up.y, up.x)),
                               down);
    step = static_cast<int>(c & 0xffff);
    idx = static_cast<int>(c >> 16);
    const int mag = (b4 ? 4 : 0) + (p1 ? 1 : 0) + (p2 ? 1 : 0) + (p3 ? 1 : 0);
    return static_cast<uint32_t>(mag + (neg ? 8 : 0));
}

// kNo: the channels fixed at compile time (1, 2), or 0 for a.channels
template <int kNo>
__global__ void __launch_bounds__(kMaxChannels) adpcm_encode_kernel(const Args a) {
    extern __shared__ __align__(16) unsigned char smem[];
    Rows* rows = reinterpret_cast<Rows*>(smem);
    unsigned char* ring = smem + kRowsBytes;
    const int slot_bytes = a.inst * a.row_pitch;
    uint32_t* words = reinterpret_cast<uint32_t*>(ring + kRing * slot_bytes);

    const int no = kNo ? kNo : a.channels;
    const int t = threadIdx.x, threads = blockDim.x;
    const int64_t b0 = static_cast<int64_t>(blockIdx.x) * a.inst;
    const int inst = static_cast<int>(a.batch - b0 < a.inst ? a.batch - b0 : a.inst);
    const int i = t / no, ch = t - i * no;
    const bool live = i < inst;
    const int stages = (a.frames + kStage - 1) / kStage;
    const int groups = a.frames / 8;

    // the first kRing stages in flight, a commit group each (empty past S)
#pragma unroll
    for (int s = 0; s < kRing; ++s) {
        if (s < stages) load_stage(a, no, ring + s * slot_bytes, b0, inst, s, t, threads);
        __pipeline_commit();
    }
    fill_rows(rows, t, threads);

    // the lane's samples in slot 0; sample j lies in slot (j / 64) % kRing
    const int16_t* lane =
        reinterpret_cast<const int16_t*>(ring + (live ? i : 0) * a.row_pitch) + ch;
    const int slot_elems = slot_bytes / 2;
    // the 8 samples from j0 on (the pad frame S repeats S - 1)
    auto fetch = [&](int j0, int (&v)[8]) {
        const unsigned j = static_cast<unsigned>(j0);
        if ((j % kStage) <= kStage - 8 && j0 + 7 < a.frames) {  // one slot
            const int16_t* p = lane + ((j / kStage) % kRing) * slot_elems + (j % kStage) * no;
#pragma unroll
            for (int k = 0; k < 8; ++k) v[k] = p[k * no];
        } else {
#pragma unroll
            for (int k = 0; k < 8; ++k) {
                const unsigned jk = static_cast<unsigned>(imin(j0 + k, a.frames - 1));
                v[k] = lane[((jk / kStage) % kRing) * slot_elems + (jk % kStage) * no];
            }
        }
    };

    int pred = 0, idx = 0, step = 7;  // the step of index 0
    int cur[8];
    uint8_t* row = a.out + (b0 + (live ? i : 0)) * a.block_align;
    for (int g = 0; g < groups; ++g) {
        const int s = g / kGroups, gl = g - s * kGroups;
        if (gl == 0) {
            __pipeline_wait_prior(kRing - 2);  // this thread's copies of stages s, s + 1
            __syncthreads();                   // and every thread's, and the rows
            if (s == 0) {
                // header: int16 LE predictor (sample 0), step index 0, reserved 0
                pred = lane[0];
                if (live) reinterpret_cast<uint32_t*>(row)[ch] = (uint16_t)(int16_t)pred;
                fetch(1, cur);
            }
        }
        // nibble n encodes sample n + 1; the next group's targets are read
        // now (stage s + 1 has landed), the registers a group ahead
        int nxt[8];
        fetch(8 * g + 9, nxt);
        uint32_t word = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) word |= encode(cur[k], pred, idx, step, rows) << (4 * k);
#pragma unroll
        for (int k = 0; k < 8; ++k) cur[k] = nxt[k];
        words[(i * kGroups + gl) * no + ch] = word;

        if (gl == kGroups - 1 || g == groups - 1) {
            // the stage's words, each instance's run of the row contiguous
            __syncthreads();
            const int n = gl + 1;
            uint32_t* payload = reinterpret_cast<uint32_t*>(a.out + b0 * a.block_align +
                                                            4 * no) + s * kGroups * no;
            for (int w = t; w < inst * n * no; w += threads) {
                const int wi = w / (n * no), k = w - wi * n * no;
                payload[wi * (a.block_align / 4) + k] = words[wi * kGroups * no + k];
            }
            // every thread has read slot s before it is refilled
            if (s + kRing < stages)
                load_stage(a, no, ring + (s % kRing) * slot_bytes, b0, inst, s + kRing, t,
                           threads);
            __pipeline_commit();
        }
    }
}

}  // namespace

// x: int16 [batch, frames, channels] contiguous and 16-byte aligned; out:
// uint8 [batch, (4 + frames/2)·channels], rows 4-byte aligned.  frames % 8
// == 0 and 1 <= channels <= 64 (the wrapper checks; cudaErrorInvalidValue
// otherwise).  Launches on `stream` and returns cudaGetLastError().
extern "C" int fw_adpcm_encode(const void* x, void* out, int64_t batch, int frames,
                               int channels, void* stream) {
    if (batch <= 0) return 0;
    if (frames <= 0 || frames % 8 || channels < 1 || channels > kMaxChannels ||
        (reinterpret_cast<uintptr_t>(x) & 15))
        return static_cast<int>(cudaErrorInvalidValue);
    Args a;
    a.x = static_cast<const int16_t*>(x);
    a.out = static_cast<uint8_t*>(out);
    a.batch = batch;
    a.frames = frames;
    a.channels = channels;
    a.block_align = (4 + frames / 2) * channels;
    a.inst = channels > 32 ? 1 : 32 / channels;
    a.row_pitch = kStage * channels * 2 + 16;
    const unsigned threads = a.inst * channels;
    const size_t shared = kRowsBytes + static_cast<size_t>(kRing) * a.inst * a.row_pitch +
                          4 * static_cast<size_t>(a.inst) * kGroups * channels;
    const unsigned blocks = static_cast<unsigned>((batch + a.inst - 1) / a.inst);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (channels == 2)
        adpcm_encode_kernel<2><<<blocks, threads, shared, s>>>(a);
    else if (channels == 1)
        adpcm_encode_kernel<1><<<blocks, threads, shared, s>>>(a);
    else
        adpcm_encode_kernel<0><<<blocks, threads, shared, s>>>(a);
    return static_cast<int>(cudaGetLastError());
}

// Staging of row-major [rows, frames] float arrays through shared memory
// for the backward kernels (K8, csrc/assoc_scan_bwd.cu; K9,
// csrc/sample_scan_bwd.cu): one warp a CTA, one row a thread, as K5
// (csrc/sample_scan.cu) stages its rows.
//
// A stage is 32 frames of the warp's 32 rows.  run_stages walks a row's
// stages forwards or backwards (the adjoints run backwards in time):
// each stage's input arrays are copied with cp.async into a slot of a ring
// of kRing slots, kRing stages ahead of the one being run (16-byte copies
// when every array's rows are 16-byte aligned and frames % 4 == 0, 4-byte
// copies otherwise); the body runs the thread's row of the stage in the
// slot; then the slot's output tiles go back to device memory with
// coalesced stores, and the slot is refilled.  A row's tile has a pitch of
// 32 + 4 floats (16-byte aligned rows; a quarter-warp's float4 copies of 8
// rows hit distinct banks); a body that reads each frame's predecessor
// finds the one before the stage in the first spare column, copied in the
// stage's group (load_halo), so that it reads no array but its tiles.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

// In a named namespace: the C entry points take structs that hold these,
// and a type of an unnamed namespace would keep them out of the library's
// exported symbols.
namespace bwd {

constexpr int kLanes = 32;          // rows a CTA: one warp, a thread each
constexpr int kStage = 32;          // frames a stage
constexpr int kPitch = kStage + 4;  // floats a row of a tile
constexpr int kRing = 2;            // slots of the ring

using Tile = float[kLanes][kPitch];

// A per-row operand, as K7's and K5's: rows are [outer, inner] (inner: the
// last axis of the caller's row shape); row r reads p[(r / inner) * so + (r
// % inner) * si], or v for every row when p is null (a number by value).
struct Operand {
    const float* p;
    int64_t so, si;
    float v;
};

__device__ __forceinline__ float at(const Operand& o, int64_t row, int64_t inner) {
    return o.p ? o.p[(row / inner) * o.so + (row % inner) * o.si] : o.v;
}

__device__ __forceinline__ int stage_frames(int frames, int s) {
    const int left = frames - s * kStage;
    return left < kStage ? left : kStage;
}

// Copies stage s of `rows` rows from row0 of `a` into `st`.  16-byte copies:
// thread t takes float4 t % 8 of rows t / 8, t / 8 + 4, ...; 4-byte copies:
// frame t of every row.
template <bool kVec>
__device__ void load_tile(const float* a, Tile& st, int64_t row0, int rows, int frames, int s,
                          int t) {
    const int nf = stage_frames(frames, s);
    const float* base = a + row0 * frames + static_cast<int64_t>(s) * kStage;
    if (kVec) {
        const int c = 4 * (t & 7);
        if (c >= nf) return;
#pragma unroll
        for (int j = 0; j < kLanes / 4; ++j) {
            const int r = (t >> 3) + 4 * j;
            if (r < rows)
                __pipeline_memcpy_async(&st[r][c], base + static_cast<int64_t>(r) * frames + c,
                                        16);
        }
    } else {
        if (t >= nf) return;
        for (int r = 0; r < rows; ++r)
            __pipeline_memcpy_async(&st[r][t], base + static_cast<int64_t>(r) * frames + t, 4);
    }
}

// Writes `st` to stage s of `a`, as load_tile reads it.
template <bool kVec>
__device__ void store_tile(float* a, const Tile& st, int64_t row0, int rows, int frames, int s,
                           int t) {
    const int nf = stage_frames(frames, s);
    float* base = a + row0 * frames + static_cast<int64_t>(s) * kStage;
    if (kVec) {
        const int c = 4 * (t & 7);
        if (c >= nf) return;
#pragma unroll
        for (int j = 0; j < kLanes / 4; ++j) {
            const int r = (t >> 3) + 4 * j;
            if (r < rows)
                *reinterpret_cast<float4*>(base + static_cast<int64_t>(r) * frames + c) =
                    *reinterpret_cast<const float4*>(&st[r][c]);
        }
    } else {
        if (t >= nf) return;
        for (int r = 0; r < rows; ++r) base[static_cast<int64_t>(r) * frames + t] = st[r][t];
    }
}

// Copies the frame before stage s (s > 0) of row t of `a` into column
// kStage of the tile's row t, past the stage's frames: a 4-byte copy in the
// stage's group, so that a body reads x[n - 1] for every frame of the
// stage from the tile.
__device__ __forceinline__ void load_halo(const float* a, Tile& st, int64_t row0, int rows,
                                          int frames, int s, int t) {
    if (s > 0 && t < rows)
        __pipeline_memcpy_async(&st[t][kStage],
                                a + (row0 + t) * frames + static_cast<int64_t>(s) * kStage - 1,
                                4);
}

// Runs body(slot, s, nf) over the stages of the warp's rows, last stage
// first when kReverse: before it, tiles 0..kIn-1 of the slot hold stage s
// of src[0..kIn-1] and, when kHalo >= 0, column kStage of tile kHalo the
// frame before the stage (load_halo); after it, tile out_tile[j] of the
// slot is stored to dst[j] for j < kOut.  `ring` is the CTA's kRing slots
// of kSlot tiles.  The body runs on every thread and does nothing past the
// warp's rows.  Ends with the warp's stores visible to the warp.
template <int kIn, int kOut, int kSlot, bool kVec, bool kReverse, int kHalo = -1, class Body>
__device__ void run_stages(const float* const (&src)[kIn], float* const (&dst)[kOut],
                           const int (&out_tile)[kOut], Tile (*ring)[kSlot], int64_t row0,
                           int rows, int frames, int t, Body body) {
    static_assert(kHalo < kIn, "the halo is a tile of an input");
    const int stages = (frames + kStage - 1) / kStage;
    auto stage_at = [&](int i) { return kReverse ? stages - 1 - i : i; };
    auto load = [&](Tile* slot, int s) {
        for (int k = 0; k < kIn; ++k) load_tile<kVec>(src[k], slot[k], row0, rows, frames, s, t);
        if constexpr (kHalo >= 0) load_halo(src[kHalo], slot[kHalo], row0, rows, frames, s, t);
    };
#pragma unroll
    for (int i = 0; i < kRing; ++i) {
        if (i < stages) load(ring[i], stage_at(i));
        __pipeline_commit();
    }
    for (int i = 0; i < stages; ++i) {
        const int s = stage_at(i);
        Tile* slot = ring[i % kRing];
        __pipeline_wait_prior(kRing - 1);  // this thread's copies of the stage landed
        __syncwarp();                      // and every thread's
        body(slot, s, stage_frames(frames, s));
        __syncwarp();
        for (int j = 0; j < kOut; ++j)
            store_tile<kVec>(dst[j], slot[out_tile[j]], row0, rows, frames, s, t);
        __syncwarp();  // every thread has read the slot before it is refilled
        if (i + kRing < stages) load(slot, stage_at(i + kRing));
        __pipeline_commit();
    }
    __pipeline_wait_prior(0);
    __syncwarp();
}

__host__ inline bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace bwd

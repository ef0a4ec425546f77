// Staging of row-major [rows, frames] float arrays through shared memory
// for the backward kernels (K8, csrc/assoc_scan_bwd.cu; K9,
// csrc/sample_scan_bwd.cu): one warp a CTA, one row a thread, as K5
// (csrc/sample_scan.cu) stages its rows.
//
// A stage is 32 frames of the warp's 32 rows.  run_sweeps walks a row's
// stages forwards, for a kernel with a checkpoint sweep, then backwards
// (the adjoints run backwards in time), through one ring: each stage's
// input arrays are copied with cp.async into a slot of a ring of kRing
// slots, kRing stages ahead of the one being run, across the two sweeps
// (16-byte copies when every array's rows are 16-byte aligned and frames %
// 4 == 0, 4-byte copies otherwise); the body runs the thread's row of the
// stage in the slot; then the slot's output tiles go back to device memory
// with coalesced stores, and the slot is refilled.  Two slots: three and
// four measured slower (PERF.md §6).  The tiles are dynamic shared
// memory (ring_bytes), so that the tiles a kernel adds beside the ring are
// its choice.
//
// A row's tile has a pitch of 32 + 4 floats (16-byte aligned rows).  The
// copies write a quarter-warp's float4s to 8 rows' distinct banks; a body
// reads its own row a float4 at a time (quad), which also hits 8 distinct
// 16-byte bank groups a quarter-warp, where a float a thread from the same
// column of 32 rows would meet 4 threads in each bank.  A body that reads
// each frame's predecessor finds the one before the stage in the first
// spare column, copied in the stage's group (load_halo), so that it reads
// no array but its tiles.

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
constexpr int kQuads = kStage / 4;  // float4s a row of a full stage

using Tile = float[kLanes][kPitch];

// A per-row operand, as K7's and K5's: rows are [outer, inner] (inner: the
// last axis of the caller's row shape); row r reads p[(r / inner) * so + (r
// % inner) * si], or v for every row when p is null (a number by value).
struct Operand {
    const float* p;
    int64_t so, si;
    float v;
};

// A row's place among the operands' rows, [row / inner, row % inner]:
// divided once for every operand a thread reads (a 64-bit division is a
// long sequence of instructions).
struct RowAt {
    int64_t q, r;
};

__device__ __forceinline__ RowAt row_at(int64_t row, int64_t inner) {
    return {row / inner, row % inner};
}

__device__ __forceinline__ float at(const Operand& o, RowAt w) {
    return o.p ? o.p[w.q * o.so + w.r * o.si] : o.v;
}

__device__ __forceinline__ int stage_frames(int frames, int s) {
    const int left = frames - s * kStage;
    return left < kStage ? left : kStage;
}

// Row t of a tile as float4s (quad q holds frames 4q .. 4q + 3).
__device__ __forceinline__ float4* quads(Tile& st, int t) {
    return reinterpret_cast<float4*>(st[t]);
}

// Bytes of dynamic shared memory a warp takes for kRing slots of kSlot
// tiles and kExtra tiles beside them.
constexpr size_t ring_bytes(int kRing, int kSlot, int kExtra) {
    return static_cast<size_t>(kRing * kSlot + kExtra) * sizeof(Tile);
}

// c ? a : b, both computed: a selp, which stays a select.  A ?: one of
// whose operands is computed for its side alone may compile to a branch,
// and a branch a frame splits an unrolled stage into blocks scheduled one
// frame at a time.
__device__ __forceinline__ float pick(bool c, float a, float b) {
#ifdef __CUDA_ARCH__
    float r;
    asm("{\n\t.reg .pred p;\n\tsetp.ne.u32 p, %1, 0;\n\tselp.f32 %0, %2, %3, p;\n\t}"
        : "=f"(r)
        : "r"(static_cast<unsigned>(c)), "f"(a), "f"(b));
    return r;
#else
    return c ? a : b;
#endif
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
        // the thread's rows 4 apart: a pointer stepped, not a 64-bit
        // product a copy
        const float* p = base + static_cast<int64_t>(t >> 3) * frames + c;
        const int64_t step = 4 * static_cast<int64_t>(frames);
#pragma unroll
        for (int j = 0; j < kLanes / 4; ++j, p += step) {
            const int r = (t >> 3) + 4 * j;
            if (r < rows) __pipeline_memcpy_async(&st[r][c], p, 16);
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
        float* p = base + static_cast<int64_t>(t >> 3) * frames + c;
        const int64_t step = 4 * static_cast<int64_t>(frames);
#pragma unroll
        for (int j = 0; j < kLanes / 4; ++j, p += step) {
            const int r = (t >> 3) + 4 * j;
            if (r < rows)
                *reinterpret_cast<float4*>(p) = *reinterpret_cast<const float4*>(&st[r][c]);
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

// Runs a warp's sweeps over its rows' stages through one ring: first, for
// kInF > 0, a forward sweep, fwd(slot, s, nf) over stages 0..n-1 with tiles
// 0..kInF-1 of the slot holding stage s of src[0..kInF-1]; then the
// backward sweep, bwd(slot, s, nf) over stages n-1..0 with tiles 0..kIn-1
// holding src[0..kIn-1] and, when kHalo >= 0, column kStage of tile kHalo
// the frame before the stage (load_halo), after which tile out_tile[j] of
// the slot is stored to dst[j] for j < kOut.  The ring loads kRing stages
// ahead across the two sweeps, so the backward sweep's first stages land
// while the forward one ends.  `ring` is the warp's kRing slots of kSlot
// tiles.  The bodies run on every thread and do nothing past the warp's
// rows.  Ends with the warp's stores visible to the warp.
template <int kInF, int kIn, int kOut, int kSlot, int kRing, bool kVec, int kHalo = -1,
          class Fwd, class Bwd>
__device__ __forceinline__ void run_sweeps(const float* const* src, float* const* dst,
                                           const int* out_tile, Tile (*ring)[kSlot],
                                           int64_t row0, int rows, int frames, int t, Fwd fwd,
                                           Bwd bwd) {
    static_assert(kHalo < kIn, "the halo is a tile of an input");
    static_assert(kIn <= kSlot && kInF <= kIn, "a slot holds the inputs");
    const int stages = (frames + kStage - 1) / kStage;
    const int first = kInF ? stages : 0;  // the forward sweep's visits
    const int visits = first + stages;
    auto stage_at = [&](int i) { return i < first ? i : stages - 1 - (i - first); };
    auto load = [&](Tile* slot, int i) {
        const int s = stage_at(i);
        if (i < first) {
#pragma unroll
            for (int k = 0; k < kInF; ++k)
                load_tile<kVec>(src[k], slot[k], row0, rows, frames, s, t);
            return;
        }
#pragma unroll
        for (int k = 0; k < kIn; ++k) load_tile<kVec>(src[k], slot[k], row0, rows, frames, s, t);
        if constexpr (kHalo >= 0) load_halo(src[kHalo], slot[kHalo], row0, rows, frames, s, t);
    };
#pragma unroll
    for (int i = 0; i < kRing; ++i) {
        if (i < visits) load(ring[i], i);
        __pipeline_commit();
    }
    for (int i = 0; i < visits; ++i) {
        const int s = stage_at(i);
        Tile* slot = ring[i % kRing];
        __pipeline_wait_prior(kRing - 1);  // this thread's copies of the stage landed
        __syncwarp();                      // and every thread's
        if (i < first) {
            fwd(slot, s, stage_frames(frames, s));
        } else {
            bwd(slot, s, stage_frames(frames, s));
            __syncwarp();
#pragma unroll
            for (int j = 0; j < kOut; ++j)
                store_tile<kVec>(dst[j], slot[out_tile[j]], row0, rows, frames, s, t);
        }
        __syncwarp();  // every thread has read the slot before it is refilled
        if (i + kRing < visits) load(slot, i + kRing);
        __pipeline_commit();
    }
    __pipeline_wait_prior(0);
    __syncwarp();
}

// A forward sweep's body for a kernel that has none.
struct NoSweep {
    __device__ void operator()(Tile*, int, int) const {}
};

__host__ inline bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Launches `kernel` over `total` rows, a warp of 32 a CTA, with `bytes` of
// dynamic shared memory, first raising the kernel's limit where they pass
// the default 48 KB.  Returns cudaGetLastError() (or the attribute's
// error).
template <class Kernel, class Args>
__host__ int launch_kernel(Kernel kernel, int64_t total, size_t bytes, cudaStream_t stream,
                           const Args& args) {
    const unsigned blocks = static_cast<unsigned>((total + kLanes - 1) / kLanes);
    if (bytes > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<blocks, kLanes, bytes, stream>>>(args);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace bwd

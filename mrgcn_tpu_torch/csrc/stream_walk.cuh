// The walk the block-sorted scatter kernels share (sorted_scatter.cu's
// block walk, fused_place_scatter.cu's split walk), for Hopper (sm_90a).
//
// A slab-padded edge stream carries one output block id per slab, and the
// ids never decrease. One CTA of 256 threads owns a (run of slabs with
// equal block ids, 32-lane tile of the output): it keeps the (RB, 32) f32
// tile of the block in shared memory, walks the run's slabs in stream
// order, and writes the tile once. Nothing is carried between CTAs and
// there are no atomics. Within a CTA warp w owns the rows r with
// r % 8 == w and each thread one lane, so every output element is summed
// by one thread in stream order: results are bit-identical from run to
// run. Offsets into the output are 64-bit.
//
// Each kernel stages a slab's values its own way and hands the per-edge
// work to for_owned_edges as a functor.

#pragma once

#include <cuda_runtime.h>

namespace stream_walk {

constexpr int kLanes = 32;                 // lanes per CTA: one per thread
constexpr int kThreads = 256;              // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxEdgeBlock = kThreads;    // one local index per thread
constexpr int kVecPerRow = kLanes / 4;     // float4s per tile row

// Whether some slab addresses output block b (blk[] is sorted).
__device__ __forceinline__ bool block_visited(const int* __restrict__ blk,
                                              int nslab, int b) {
    int lo = 0, hi = nslab;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (blk[mid] < b) lo = mid + 1; else hi = mid;
    }
    return lo < nslab && blk[lo] == b;
}

// Whether slab s opens a run of equal block ids; the CTAs of the other
// slabs have nothing to do.
__device__ __forceinline__ bool run_starts(const int* __restrict__ blk,
                                           int s) {
    return s == 0 || blk[s - 1] != blk[s];
}

// One past the last slab of the run that slab s_first opens.
__device__ __forceinline__ int run_end(const int* __restrict__ blk,
                                       int nslab, int s_first) {
    const int b = blk[s_first];
    int s_end = s_first + 1;
    while (s_end < nslab && blk[s_end] == b) ++s_end;
    return s_end;
}

// Zero the CTA's (RB, 32) shared-memory tile.
__device__ __forceinline__ void zero_tile(float* tile, int row_block,
                                          int tid) {
    for (int i = tid; i < row_block * kVecPerRow; i += kThreads)
        reinterpret_cast<float4*>(tile)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// Calls f(row, i) for the rows of output block b that lie inside
// [0, out_rows): i is the index of a float4 of the (RB, 32) tile and row
// its row of the output.
template <class F>
__device__ __forceinline__ void for_block_vectors(int b, int row_block,
                                                  long long out_rows,
                                                  int tid, F f) {
    const long long row0 = (long long)b * row_block;
    for (int i = tid; i < row_block * kVecPerRow; i += kThreads) {
        const long long row = row0 + i / kVecPerRow;
        if (row >= 0 && row < out_rows) f(row, i);
    }
}

// Lanes [lane0, lane0 + 32) of output block b take the shared-memory
// tile, with 16-byte stores.
__device__ __forceinline__ void store_block(float* __restrict__ out,
                                            const float* tile, int b,
                                            int row_block, long long out_rows,
                                            int L, int lane0, int tid) {
    for_block_vectors(b, row_block, out_rows, tid, [&](long long row, int i) {
        *reinterpret_cast<float4*>(
            out + row * L + lane0 + (i % kVecPerRow) * 4) =
            reinterpret_cast<const float4*>(tile)[i];
    });
}

// The same lanes of block b take zeros.
__device__ __forceinline__ void zero_block(float* __restrict__ out, int b,
                                           int row_block, long long out_rows,
                                           int L, int lane0, int tid) {
    for_block_vectors(b, row_block, out_rows, tid, [&](long long row, int i) {
        *reinterpret_cast<float4*>(
            out + row * L + lane0 + (i % kVecPerRow) * 4) =
            make_float4(0.f, 0.f, 0.f, 0.f);
    });
}

// One staged slab: s_local[e] is edge e's row inside the block, a value
// outside [0, RB) marking padding. Calls f(e, row) for the real edges this
// warp owns, 32 edges at a time, in stream order; all 32 lanes of the warp
// make the call together.
template <class F>
__device__ __forceinline__ void for_owned_edges(const int* s_local,
                                                int edge_block,
                                                int row_block, int lane,
                                                int warp, F f) {
    for (int e0 = 0; e0 < edge_block; e0 += 32) {
        const int e = e0 + lane;
        const int r = e < edge_block ? s_local[e] : row_block;
        unsigned own = __ballot_sync(
            0xffffffffu,
            (unsigned)r < (unsigned)row_block && r % kWarps == warp);
        while (own) {
            const int i = __ffs(own) - 1;
            own &= own - 1;
            f(e0 + i, __shfl_sync(0xffffffffu, r, i));
        }
    }
}

}  // namespace stream_walk

// Every kernel library exports the text of a CUDA error code.
extern "C" const char* mrgcn_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

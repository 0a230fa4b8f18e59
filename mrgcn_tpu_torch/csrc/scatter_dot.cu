// Block-sorted scatter-add fused with the same-address table dot, for
// Hopper (sm_90a).
//
// Computes, in one pass over a slab-padded edge stream whose per-slab block
// ids blk[] never decrease, with row(e) = blk[e / EB] * RB + local[e]:
//     out[row(e), j] += w[e] * dvn[e, j]                  j in [0, Lv)
//     dots[e]         = sum_j table[row(e), j] * dvn[e, j]
// A local index outside [0, RB) marks a padding edge: it adds nothing,
// reads no table row and gets dots[e] = 0. Every row of `out` is written
// (lanes >= Lv and blocks no slab addresses are zero-filled by the same
// launch), so the caller allocates `out` and `dots` uninitialised.
//
// Replaces: mrgcn_tpu/ops/pallas_gather.py::_scatter_dot_kernel (the TPU
// kernel behind pallas_gather.fused_scatter_dot). That kernel pads dvn to
// the table's width, accumulates with one-hot matmuls into a VMEM block
// carried across an in-order grid, gathers the table rows with a second
// one-hot matmul and writes each dot to 8 sublanes. Here dvn comes at its
// real width, the scatter is an add, the gather is a shared-memory read.
//
// What bounds it on the card: memory bandwidth. Per call it reads dvn once
// (E_pad x Lv f32) and the visited table blocks once, and writes `out`
// once; the unfused form reads dvn twice and gathers E_pad table rows from
// device memory on top.
//
// What the design does about it:
//  * One CTA per (run of equal block ids, 32-lane tile): the walk of
//    stream_walk.cuh, as in sorted_scatter.cu. Beside the (RB, 32) accumulator the CTA keeps the
//    same (RB, 32) tile of `table` in shared memory (2 x 64 KB at RB=512),
//    loaded once per run with 16-byte loads: an edge's table row is then a
//    shared-memory read at the address its message is added to.
//  * The owning warp of an edge (rows r % 8 == w) adds w[e] * dvn[e, lane]
//    to the accumulator and reduces table[row, lane] * dvn[e, lane] over its
//    32 lanes with a fixed shuffle tree; lane 0 stores the tile's partial
//    dot to partial[tile, e]. A second small kernel sums the partials over
//    the lane tiles in tile order. No float atomics anywhere: `out` and
//    `dots` are bit-identical from run to run.
//  * Lane tiles at or beyond Lv hold no data: their CTAs write zeros and
//    their partials are neither written nor summed.
//  * The next slab's dvn tile is loaded into registers (coalesced 4-byte
//    loads, any Lv and row stride) while the current one is consumed.
//    Offsets are 64-bit.

#include "stream_walk.cuh"

namespace {

using namespace stream_walk;

constexpr int kPrefetch = kMaxEdgeBlock / kWarps;  // edges per warp per slab

__global__ void __launch_bounds__(kThreads, 1)
scatter_dot_kernel(const float* __restrict__ dvn, long long ldv, int Lv,
                   const float* __restrict__ w,
                   const int* __restrict__ local,
                   const int* __restrict__ blk,
                   const float* __restrict__ table,
                   float* __restrict__ out, float* __restrict__ partial,
                   int nslab, int edge_block, int row_block,
                   long long out_rows, int L) {
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int lane0 = blockIdx.y * kLanes;

    if (zero_fill_cta(blk, nslab, out, row_block, out_rows, L, lane0, tid))
        return;
    const int s_first = blockIdx.x;
    if (!run_starts(blk, s_first)) return;
    const int b = blk[s_first];
    if (lane0 >= Lv) {                     // no data in these lanes
        zero_block(out, b, row_block, out_rows, L, lane0, tid);
        return;
    }
    const int s_end = run_end(blk, nslab, s_first);

    extern __shared__ float4 smem4[];
    float* acc = reinterpret_cast<float*>(smem4);         // (RB, 32)
    float* tbl = acc + row_block * kLanes;                // (RB, 32)
    float* stage = tbl + row_block * kLanes;              // (EB, 32)
    float* s_w = stage + edge_block * kLanes;             // (EB,)
    int* s_local = reinterpret_cast<int*>(s_w + edge_block);

    zero_tile(acc, row_block, tid);
    const long long row0 = (long long)b * row_block;
    for (int i = tid; i < row_block * kVecPerRow; i += kThreads) {
        const long long row = row0 + i / kVecPerRow;
        float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row >= 0 && row < out_rows)
            t = __ldg(reinterpret_cast<const float4*>(
                table + row * L + lane0 + (i % kVecPerRow) * 4));
        reinterpret_cast<float4*>(tbl)[i] = t;
    }

    const int col = lane0 + lane;
    const long long E_pad = (long long)nslab * edge_block;
    float* tile_partial = partial + (long long)blockIdx.y * E_pad;

    float pre[kPrefetch];
    int pre_local = row_block;
    float pre_w = 0.f;
    auto prefetch = [&](int s) {
        const long long e0 = (long long)s * edge_block;
#pragma unroll
        for (int j = 0; j < kPrefetch; ++j) {
            const int e = warp + j * kWarps;
            pre[j] = (e < edge_block && col < Lv)
                ? __ldg(dvn + (e0 + e) * ldv + col) : 0.f;
        }
        if (tid < edge_block) {
            pre_local = __ldg(local + e0 + tid);
            pre_w = __ldg(w + e0 + tid);
        }
    };

    prefetch(s_first);
    for (int s = s_first; s < s_end; ++s) {
        __syncthreads();  // tiles loaded / previous slab fully consumed
#pragma unroll
        for (int j = 0; j < kPrefetch; ++j) {
            const int e = warp + j * kWarps;
            if (e < edge_block) stage[e * kLanes + lane] = pre[j];
        }
        if (tid < edge_block) {
            s_local[tid] = pre_local;
            s_w[tid] = pre_w;
            // padding edges have no owning warp: their dot is zero
            if ((unsigned)pre_local >= (unsigned)row_block)
                tile_partial[(long long)s * edge_block + tid] = 0.f;
        }
        __syncthreads();
        if (s + 1 < s_end) prefetch(s + 1);

        for_owned_edges(s_local, edge_block, row_block, lane, warp,
                        [&](int e, int row) {
            const float d = stage[e * kLanes + lane];
            acc[row * kLanes + lane] += s_w[e] * d;
            float p = tbl[row * kLanes + lane] * d;
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                p += __shfl_xor_sync(0xffffffffu, p, off);
            if (lane == 0) tile_partial[(long long)s * edge_block + e] = p;
        });
    }
    __syncthreads();
    store_block(out, acc, b, row_block, out_rows, L, lane0, tid);
}

// dots[e] = partial[0, e] + partial[1, e] + ... in tile order.
__global__ void sum_partials_kernel(const float* __restrict__ partial,
                                    float* __restrict__ dots,
                                    long long E_pad, int n_tiles) {
    const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= E_pad) return;
    float sum = 0.f;
    for (int t = 0; t < n_tiles; ++t) sum += partial[t * E_pad + e];
    dots[e] = sum;
}

}  // namespace

extern "C" {

// Lanes a CTA covers and the largest edge block it takes; the Python
// wrapper checks its arguments against these.
int mrgcn_scatter_dot_lane_tile() { return kLanes; }
int mrgcn_scatter_dot_max_edge_block() { return kMaxEdgeBlock; }

size_t mrgcn_scatter_dot_smem_bytes(int row_block, int edge_block) {
    return (size_t)2 * row_block * kLanes * sizeof(float)
         + (size_t)edge_block * kLanes * sizeof(float)
         + (size_t)edge_block * (sizeof(float) + sizeof(int));
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// `dvn` is (nslab * edge_block, Lv) with row stride ldv floats; `table` and
// `out` are (out_rows, L), L a multiple of 32, Lv <= L; `partial` is scratch
// of ceil(Lv / 32) * nslab * edge_block floats; `dots` has nslab *
// edge_block entries. Writes every element of `out` and `dots`.
int mrgcn_scatter_dot_f32(const float* dvn, long long ldv, int Lv,
                          const float* w, const int* local, const int* blk,
                          const float* table, float* out, float* dots,
                          float* partial, int nslab, int edge_block,
                          int row_block, long long out_rows, int L,
                          void* stream) {
    const size_t smem = mrgcn_scatter_dot_smem_bytes(row_block, edge_block);
    cudaError_t err = cudaFuncSetAttribute(
        scatter_dot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const long long out_blocks = (out_rows + row_block - 1) / row_block;
    const dim3 grid((unsigned)(nslab + out_blocks), (unsigned)(L / kLanes));
    scatter_dot_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        dvn, ldv, Lv, w, local, blk, table, out, partial, nslab, edge_block,
        row_block, out_rows, L);
    err = cudaGetLastError();
    if (err != cudaSuccess || nslab == 0) return (int)err;
    const long long E_pad = (long long)nslab * edge_block;
    const int n_tiles = (Lv + kLanes - 1) / kLanes;
    sum_partials_kernel<<<(unsigned)((E_pad + 255) / 256), 256, 0,
                          (cudaStream_t)stream>>>(partial, dots, E_pad,
                                                  n_tiles);
    return (int)cudaGetLastError();
}

}  // extern "C"

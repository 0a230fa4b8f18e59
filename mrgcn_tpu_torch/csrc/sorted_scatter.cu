// Block-sorted scatter-add for Hopper (sm_90a): two routes for one
// function.
//
// Computes  out[blk[s] * RB + local[s, j]] += msgs[s * EB + j]  for every
// slab s of EB edges, where the per-slab block ids blk[] never decrease and
// a local index outside [0, RB) marks a padding edge.
//
// Replaces: mrgcn_tpu/ops/pallas_gather.py::_scatter_kernel (the TPU kernel
// behind pallas_gather.sorted_scatter). That kernel walks the grid in order
// and carries a VMEM accumulator of one whole (RB, L) output block from one
// grid step to the next, flushing it when the block id changes.
//
// What bounds it on the card: memory bandwidth. It does one add per byte
// pair moved. At the multimodal NC path's dense bwd_h stream it reads 186
// MB of messages (363,008 x 128 f32) and writes 12.8 MB (25,088 rows).
//
// What the design does about it:
//  * Streams whose real scatter rows never decrease (the planner's
//    Stream.rows_sorted: every stream a path hands this function) take
//    the row-segmented walk of row_walk.cuh (place_rows_kernel without
//    placement): one warp a chunk of 128 edges, each message line read
//    once with 16-byte loads (8 lines' loads in flight a warp at L = 128),
//    the current row's sum in registers, each row written once, zeros
//    included, rows that cross a chunk summed in chunk order by the carry
//    pass. Every row of `out` is written: the caller allocates it
//    uninitialised. At the dense bwd_h stream that is 2,836 warps; the
//    block walk below gives the same stream 49 runs x 4 lane tiles = 196
//    CTAs.
//  * Other block-sorted streams (the whole contract of the TPU function;
//    no path of the port makes one) take the block walk: one CTA per (run
//    of equal block ids, 32-lane tile), the walk of stream_walk.cuh. A run
//    is owned by exactly one CTA, so nothing is carried between CTAs and
//    no global atomics are needed. The (RB, 32) f32 accumulator lives in
//    shared memory: 64 KB at RB=512, where the whole (512, 128) block
//    would be 256 KB, above the 227 KB a CTA may have. Each slab's (EB,
//    32) message tile is read once, coalesced, 16 bytes a thread; the next
//    slab's tile is loaded into registers while the current one is
//    accumulated. Warp w owns the rows r with r % 8 == w and each thread
//    one lane, so every output element is summed by one thread in stream
//    order. Blocks no slab addresses are left as the caller allocated
//    them (the wrapper zero-fills).
//  * Both routes are deterministic (no atomics: the same bits every run)
//    and compute offsets in 64 bits (blk * RB * L exceeds 2^31 at
//    link-prediction scale).

#include "row_walk.cuh"

namespace {

using namespace stream_walk;

constexpr int kPrefetch = kMaxEdgeBlock * kVecPerRow / kThreads;

__global__ void __launch_bounds__(kThreads, 2)
sorted_scatter_kernel(const float* __restrict__ msgs,
                      const int* __restrict__ local,
                      const int* __restrict__ blk,
                      float* __restrict__ out,
                      int nslab, int edge_block, int row_block,
                      long long out_rows, int L) {
    const int s_first = blockIdx.x;
    if (!run_starts(blk, s_first)) return;
    const int s_end = run_end(blk, nslab, s_first);

    extern __shared__ float4 smem4[];
    float* acc = reinterpret_cast<float*>(smem4);         // (RB, 32)
    float* stage = acc + row_block * kLanes;              // (EB, 32)
    int* s_local = reinterpret_cast<int*>(stage + edge_block * kLanes);

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int lane0 = blockIdx.y * kLanes;
    const int n_vec = edge_block * kVecPerRow;

    zero_tile(acc, row_block, tid);

    float4 pre[kPrefetch];
    int pre_local = row_block;
    auto prefetch = [&](int s) {
        const float* base = msgs + (long long)s * edge_block * L + lane0;
#pragma unroll
        for (int j = 0; j < kPrefetch; ++j) {
            const int c = tid + j * kThreads;
            if (c < n_vec) {
                const int e = c / kVecPerRow;
                const int q = c % kVecPerRow;
                pre[j] = __ldg(reinterpret_cast<const float4*>(
                    base + (long long)e * L + q * 4));
            }
        }
        pre_local = tid < edge_block
            ? __ldg(local + (long long)s * edge_block + tid) : row_block;
    };

    prefetch(s_first);
    for (int s = s_first; s < s_end; ++s) {
        __syncthreads();  // zeroing done / previous slab fully consumed
#pragma unroll
        for (int j = 0; j < kPrefetch; ++j) {
            const int c = tid + j * kThreads;
            if (c < n_vec) reinterpret_cast<float4*>(stage)[c] = pre[j];
        }
        if (tid < edge_block) s_local[tid] = pre_local;
        __syncthreads();
        if (s + 1 < s_end) prefetch(s + 1);

        for_owned_edges(s_local, edge_block, row_block, lane, warp,
                        [&](int e, int row) {
            acc[row * kLanes + lane] += stage[e * kLanes + lane];
        });
    }
    __syncthreads();
    store_block(out, acc, blk[s_first], row_block, out_rows, L, lane0, tid);
}

}  // namespace

extern "C" {

// Lanes a CTA covers and the largest edge block it takes; the Python
// wrapper checks its arguments against these.
int mrgcn_sorted_scatter_lane_tile() { return kLanes; }
int mrgcn_sorted_scatter_max_edge_block() { return kMaxEdgeBlock; }

size_t mrgcn_sorted_scatter_smem_bytes(int row_block, int edge_block) {
    return (size_t)row_block * kLanes * sizeof(float)
         + (size_t)edge_block * kLanes * sizeof(float)
         + (size_t)edge_block * sizeof(int);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// `out` must already hold zeros in every block no slab addresses.
int mrgcn_sorted_scatter_f32(const float* msgs, const int* local,
                             const int* blk, float* out, int nslab,
                             int edge_block, int row_block,
                             long long out_rows, int L, void* stream) {
    const size_t smem = mrgcn_sorted_scatter_smem_bytes(row_block,
                                                        edge_block);
    cudaError_t err = cudaFuncSetAttribute(
        sorted_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)nslab, (unsigned)(L / kLanes));
    sorted_scatter_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        msgs, local, blk, out, nslab, edge_block, row_block, out_rows, L);
    return (int)cudaGetLastError();
}

// The row-segmented route, for a stream whose real scatter rows never
// decrease: edges a warp walks (the wrapper sizes the scratch from it:
// nchunks = max(1, ceil(nslab * edge_block / chunk)) lines of L floats for
// `head` and for `tail`, 3 nchunks ints for `meta`).
int mrgcn_sorted_scatter_rows_chunk() { return row_walk::kRowsChunk; }

// Two launches on `stream` (the segmented pass, then the carry pass);
// returns cudaGetLastError() (0 on success). `msgs` (nslab * edge_block,
// L) contiguous and `out` (out_rows, L), both 16-byte aligned, L a
// multiple of 32, nslab * edge_block < 2^31 - 128. Writes every element of
// `out`.
int mrgcn_sorted_scatter_rows_f32(const float* msgs, const int* local,
                                  const int* blk, float* out, float* head,
                                  float* tail, int* meta, int nslab,
                                  int edge_block, int row_block,
                                  int out_rows, int L, void* stream) {
    return (int)row_walk::launch_place_rows<false>(
        msgs, L, L, nullptr, nullptr, L, local, blk, out, head, tail, meta,
        nslab, edge_block, row_block, out_rows, L, 4, (cudaStream_t)stream);
}

}  // extern "C"

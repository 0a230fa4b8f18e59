// Fused place-scatter for Hopper (sm_90a): scale, sub-row placement and
// block-sorted scatter-add in one pass.
//
// Computes, for every edge e of a slab-padded stream,
//     out[blk[e / EB] * RB + local[e], place[e] * (L / k) + j]
//         += norm[e] * V[e, j]                         for j in [0, Lv)
// where the per-slab block ids blk[] never decrease and a local index
// outside [0, RB) marks a padding edge. Every row of `out` is written:
// blocks no slab addresses are zero-filled by the same launch, so the
// caller allocates `out` uninitialised.
//
// Replaces: mrgcn_tpu/ops/pallas_gather.py::_fused_place_kernel (the TPU
// kernel behind pallas_gather.fused_place_scatter). That kernel receives
// [v | norm | place] packed as lanes of one array, builds each edge's
// L-lane line with lane rolls and selects, and accumulates slabs into a
// VMEM-resident output block with one-hot matmuls, carried from one grid
// step to the next. None of that is carried over: per-edge scalars are
// plain arrays here, the placement is an address computation, and the
// accumulation is an add.
//
// What bounds it on the card: memory bandwidth (one multiply-add per four
// bytes of V). The (E_pad, L) line array that an expand pass followed by
// sorted_scatter writes and reads again never exists: V is read once at
// its real width, `out` is written once.
//
// What the design does about it:
//  * One CTA per (run of equal block ids, 32-lane tile of the output):
//    the walk of stream_walk.cuh, as in sorted_scatter.cu. A run is owned
//    by one CTA, nothing is carried between CTAs, no atomics. The (RB, 32)
//    f32 accumulator lives in shared memory (64 KB at RB=512).
//  * A CTA reads only what lands in its lane tile: an edge whose slot
//    [place * L/k, place * L/k + Lv) misses the tile is skipped, both its
//    V row (never loaded) and its accumulation. Over the L/32 tiles V is
//    read once.
//  * Warp w loads the V values of edges 32w .. 32w+31 of the next slab
//    into registers (coalesced 4-byte loads, any Lv and row stride) while
//    the current slab is accumulated. Its lanes hold those edges' local,
//    place and norm, loaded one slab further ahead and passed round by
//    shuffle, so the value loads wait on no other load.
//  * Determinism: warp w owns the rows r with r % 8 == w and each thread
//    one lane, so every output element is summed by one thread in stream
//    order. Results are bit-identical from run to run.
//  * CTAs with blockIdx.x >= nslab zero-fill the blocks no slab visits
//    (binary search in blk[]); a block is written by exactly one CTA per
//    lane tile. Offsets are 64-bit.

#include "stream_walk.cuh"

namespace {

using namespace stream_walk;

constexpr int kPrefetch = kMaxEdgeBlock / kWarps;  // edges a warp fetches

__global__ void __launch_bounds__(kThreads, 2)
fused_place_scatter_kernel(const float* __restrict__ V, long long ldv,
                           int Lv, const int* __restrict__ place,
                           const float* __restrict__ norm,
                           const int* __restrict__ local,
                           const int* __restrict__ blk,
                           float* __restrict__ out, int nslab,
                           int edge_block, int row_block,
                           long long out_rows, int L, int sub) {
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int lane0 = blockIdx.y * kLanes;

    if (zero_fill_cta(blk, nslab, out, row_block, out_rows, L, lane0, tid))
        return;
    const int s_first = blockIdx.x;
    if (!run_starts(blk, s_first)) return;
    const int s_end = run_end(blk, nslab, s_first);

    extern __shared__ float4 smem4[];
    float* acc = reinterpret_cast<float*>(smem4);         // (RB, 32)
    float* stage = acc + row_block * kLanes;              // (256, 32)
    int* s_local = reinterpret_cast<int*>(stage + kMaxEdgeBlock * kLanes);

    zero_tile(acc, row_block, tid);

    // An edge lands in this tile when its slot [p * sub, p * sub + Lv)
    // meets [lane0, lane0 + 32).
    auto in_tile = [&](int p) {
        const int lo = p * sub;
        return lo < lane0 + kLanes && lo + Lv > lane0;
    };

    // Thread t holds the scalars of edge t of the slab being fetched, one
    // slab ahead of the values: the value loads then depend on registers
    // only, so a warp issues its 32 loads back to back.
    int sc_local = row_block, sc_place = 0;
    float sc_norm = 0.f;
    auto load_scalars = [&](int s) {
        sc_local = row_block;
        if (tid < edge_block) {
            const long long eg = (long long)s * edge_block + tid;
            sc_local = __ldg(local + eg);
            sc_place = __ldg(place + eg);
            sc_norm = __ldg(norm + eg);
        }
    };

    // Warp w fetches the values of edges 32w .. 32w+31 of slab s, whose
    // scalars its own lanes hold; an edge outside the tile is not read.
    float pre[kPrefetch];
    int pre_local = row_block;
    auto load_values = [&](int s) {
        const bool real = (unsigned)sc_local < (unsigned)row_block
            && in_tile(sc_place);
        pre_local = real ? sc_local : row_block;
        const float* base = V + ((long long)s * edge_block + warp * 32) * ldv;
#pragma unroll
        for (int j = 0; j < kPrefetch; ++j) {
            const bool live = __shfl_sync(0xffffffffu, real, j);
            const int col = lane0 + lane
                - __shfl_sync(0xffffffffu, sc_place, j) * sub;
            const float nrm = __shfl_sync(0xffffffffu, sc_norm, j);
            pre[j] = (live && col >= 0 && col < Lv)
                ? nrm * __ldg(base + j * ldv + col) : 0.f;
        }
    };

    load_scalars(s_first);
    load_values(s_first);
    if (s_first + 1 < s_end) load_scalars(s_first + 1);
    for (int s = s_first; s < s_end; ++s) {
        __syncthreads();  // zeroing done / previous slab fully consumed
#pragma unroll
        for (int j = 0; j < kPrefetch; ++j)
            stage[(warp * 32 + j) * kLanes + lane] = pre[j];
        if (tid < edge_block) s_local[tid] = pre_local;
        __syncthreads();
        if (s + 1 < s_end) {
            load_values(s + 1);
            if (s + 2 < s_end) load_scalars(s + 2);
        }

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
int mrgcn_fused_place_scatter_lane_tile() { return kLanes; }
int mrgcn_fused_place_scatter_max_edge_block() { return kMaxEdgeBlock; }

size_t mrgcn_fused_place_scatter_smem_bytes(int row_block, int edge_block) {
    (void)edge_block;  // the stage always holds kMaxEdgeBlock edges
    return (size_t)row_block * kLanes * sizeof(float)
         + (size_t)kMaxEdgeBlock * kLanes * sizeof(float)
         + (size_t)kMaxEdgeBlock * sizeof(int);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Writes every row of `out` (out_rows, L): L a multiple of 32, sub = L / k,
// Lv <= sub. `V` is (nslab * edge_block, Lv) with row stride ldv floats.
int mrgcn_fused_place_scatter_f32(const float* V, long long ldv, int Lv,
                                  const int* place, const float* norm,
                                  const int* local, const int* blk,
                                  float* out, int nslab, int edge_block,
                                  int row_block, long long out_rows, int L,
                                  int k, void* stream) {
    const size_t smem = mrgcn_fused_place_scatter_smem_bytes(row_block,
                                                             edge_block);
    cudaError_t err = cudaFuncSetAttribute(
        fused_place_scatter_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const long long out_blocks = (out_rows + row_block - 1) / row_block;
    const dim3 grid((unsigned)(nslab + out_blocks), (unsigned)(L / kLanes));
    fused_place_scatter_kernel<<<grid, kThreads, smem,
                                 (cudaStream_t)stream>>>(
        V, ldv, Lv, place, norm, local, blk, out, nslab, edge_block,
        row_block, out_rows, L, L / k);
    return (int)cudaGetLastError();
}

}  // extern "C"

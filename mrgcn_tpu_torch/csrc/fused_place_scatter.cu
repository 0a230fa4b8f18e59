// Fused place-scatter for Hopper (sm_90a): scale, sub-row placement and
// block-sorted scatter-add in one pass, on two routes.
//
// Computes, for every edge e of a slab-padded stream,
//     out[blk[e / EB] * RB + local[e], place[e] * (L / k) + j]
//         += norm[e] * V[e, j]                         for j in [0, Lv)
// where the per-slab block ids blk[] never decrease and a local index
// outside [0, RB) marks a padding edge. Every row of `out` is written
// (rows and lanes no edge reaches are zero-filled by the same launches),
// so the caller allocates `out` uninitialised.
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
// its real width, `out` is written once. The main path's streams are
// narrow and have few block runs (the NC forward stream: 358,144 padded
// edges, 16 values an edge, 13 runs over 1,399 slabs), so a design that
// gives a run to one CTA fills 52 of 132 SMs and is bound by the latency
// of its walk, not by bytes.
//
// What the design does about it:
//  * Streams whose real scatter rows never decrease (the planner's
//    Stream.rows_sorted: every stream but the relation-constant ones of
//    dense plans) take the row-segmented walk of row_walk.cuh,
//    place_rows_kernel with placement: one warp a chunk of 128 edges, the
//    current packed row's line in registers (a lane holds 4 of its 128
//    columns at k = 8), each edge's values added by the lanes of its slot,
//    each row written once whole, rows that cross a chunk summed in chunk
//    order by the carry pass, whose pieces are whole L-lane lines. The
//    NC streams' 16 values an edge are loaded 8 edges to a warp
//    instruction and handed to the slot's lanes by shuffle. Slots may
//    interleave within a row in any order: every lane adds what lands in
//    its columns, in stream order. 2,798 warps at the NC forward stream.
//  * Relation-constant streams (not sorted by row) take the split walk,
//    fused_place_split_kernel: the walk of stream_walk.cuh (one CTA per
//    piece of a run and 32-lane tile, the (RB, 32) f32 accumulator in
//    shared memory, warp w owning the rows r % 8 == w, each thread one
//    lane) over pieces of at most S slabs, so a long run is summed by
//    several CTAs. The slab array is cut into segments of S slabs; a CTA
//    walks one segment, one piece per run it meets. A piece whose run
//    lies inside the segment writes its block to `out`; a piece of a run
//    that crosses a segment boundary writes its (RB, 32) partial to slot
//    2g (the run continues from before segment g) or 2g + 1 (it starts in
//    g and goes on) of a workspace: a segment holds at most one of each.
//    split_sum_kernel then sums each such block's partials in segment
//    order and writes it: a fixed order, no atomics. The wrapper takes S
//    from the SM count: S = ceil(nslab * L/32 / (2 * SMs)), at least 4,
//    so the segments give about two CTAs an SM (two fit, at 97 KB of
//    shared memory each); runs up to S slabs stay whole, longer ones are
//    cut. The run lengths need not be known on the host (reading blk[]
//    there would wait for the card). The NC dense forward stream: 13 runs
//    of about 135 slabs, S = 27, 264 working CTAs.
//    A CTA reads only what lands in its lane tile: an edge whose slot
//    [place * L/k, place * L/k + Lv) misses the tile is skipped, both its
//    V row (never loaded) and its accumulation. Warp w loads the V values
//    of edges 32w .. 32w+31 of the next slab into registers (coalesced
//    4-byte loads, any Lv and row stride) while the current slab is
//    accumulated; its lanes hold those edges' local, place and norm,
//    loaded one slab further ahead and passed round by shuffle. CTAs past
//    the segments zero-fill the blocks no slab visits (binary search in
//    blk[]).
//  * Both routes are deterministic (the same bits every run) and compute
//    offsets in 64 bits.

#include "row_walk.cuh"

namespace {

using namespace stream_walk;

constexpr int kPrefetch = kMaxEdgeBlock / kWarps;  // edges a warp fetches

// The first slab whose block id is >= b (blk[] is sorted).
__device__ __forceinline__ int first_slab_at(const int* __restrict__ blk,
                                             int nslab, int b) {
    int lo = 0, hi = nslab;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (blk[mid] < b) lo = mid + 1; else hi = mid;
    }
    return lo;
}

__global__ void __launch_bounds__(kThreads, 2)
fused_place_split_kernel(const float* __restrict__ V, long long ldv, int Lv,
                         const int* __restrict__ place,
                         const float* __restrict__ norm,
                         const int* __restrict__ local,
                         const int* __restrict__ blk,
                         float* __restrict__ out, float* __restrict__ partial,
                         int nslab, int edge_block, int row_block,
                         long long out_rows, int L, int sub, int seg_slabs) {
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int lane0 = blockIdx.y * kLanes;
    const int nseg = (nslab + seg_slabs - 1) / seg_slabs;

    if ((int)blockIdx.x >= nseg) {
        // block b = blockIdx.x - nseg, when no slab addresses it
        const int b = blockIdx.x - nseg;
        if (!block_visited(blk, nslab, b))
            zero_block(out, b, row_block, out_rows, L, lane0, tid);
        return;
    }
    const int g = blockIdx.x;
    const int seg_lo = g * seg_slabs;
    const int seg_hi = min(nslab, seg_lo + seg_slabs);

    extern __shared__ float4 smem4[];
    float* acc = reinterpret_cast<float*>(smem4);         // (RB, 32)
    float* stage = acc + row_block * kLanes;              // (256, 32)
    int* s_local = reinterpret_cast<int*>(stage + kMaxEdgeBlock * kLanes);

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

    // one piece per run the segment meets
    for (int s_first = seg_lo; s_first < seg_hi;) {
        const int b = blk[s_first];
        int s_end = s_first + 1;
        while (s_end < seg_hi && blk[s_end] == b) ++s_end;
        const bool from_before = s_first == seg_lo && s_first > 0
            && blk[s_first - 1] == b;
        const bool goes_on = s_end == seg_hi && s_end < nslab
            && blk[s_end] == b;

        __syncthreads();  // the previous piece's tile is stored
        zero_tile(acc, row_block, tid);
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
        if (from_before || goes_on) {
            // the (RB, L) slot's lanes [lane0, lane0 + 32)
            float* slot = partial
                + (2LL * g + (from_before ? 0 : 1)) * row_block * L + lane0;
            for (int i = tid; i < row_block * kVecPerRow; i += kThreads)
                *reinterpret_cast<float4*>(
                    slot + (long long)(i / kVecPerRow) * L
                    + (i % kVecPerRow) * 4) =
                    reinterpret_cast<const float4*>(acc)[i];
        } else {
            store_block(out, acc, b, row_block, out_rows, L, lane0, tid);
        }
        s_first = s_end;
    }
}

// Blocks whose run crosses a segment boundary: the first piece's partial
// (slot 2 g_first + 1) plus the continuing pieces' (slot 2 g, g after it),
// in segment order, float4 by float4. CTA (b, part) takes every
// gridDim.y-th float4 of block b's (RB, L) rows from `part` on.
__global__ void __launch_bounds__(256)
split_sum_kernel(const float* __restrict__ partial,
                 const int* __restrict__ blk, float* __restrict__ out,
                 int nslab, int row_block, long long out_rows, int L,
                 int seg_slabs) {
    const int b = blockIdx.x;
    const int first = first_slab_at(blk, nslab, b);
    if (first == nslab || blk[first] != b) return;
    const int last = first_slab_at(blk, nslab, b + 1) - 1;
    const int g0 = first / seg_slabs, g1 = last / seg_slabs;
    if (g0 == g1) return;                  // written whole by its piece
    const int per_row = L / 4;
    const long long slot4 = (long long)row_block * per_row;
    const float4* p = reinterpret_cast<const float4*>(partial);
    for (long long i = blockIdx.y * 256LL + threadIdx.x; i < slot4;
         i += gridDim.y * 256LL) {
        const long long row = (long long)b * row_block + i / per_row;
        if (row >= out_rows) break;
        float4 s = p[(2LL * g0 + 1) * slot4 + i];
        for (int g = g0 + 1; g <= g1; ++g) {
            const float4 t = p[2LL * g * slot4 + i];
            s.x += t.x; s.y += t.y; s.z += t.z; s.w += t.w;
        }
        reinterpret_cast<float4*>(out + row * L)[i % per_row] = s;
    }
}

}  // namespace

extern "C" {

// Lanes a CTA of the split walk covers and the largest edge block it
// takes; the Python wrapper checks its arguments against these.
int mrgcn_fused_place_scatter_lane_tile() { return kLanes; }
int mrgcn_fused_place_scatter_max_edge_block() { return kMaxEdgeBlock; }

size_t mrgcn_fused_place_scatter_smem_bytes(int row_block, int edge_block) {
    (void)edge_block;  // the stage always holds kMaxEdgeBlock edges
    return (size_t)row_block * kLanes * sizeof(float)
         + (size_t)kMaxEdgeBlock * kLanes * sizeof(float)
         + (size_t)kMaxEdgeBlock * sizeof(int);
}

// The split walk: two launches on `stream` (the segment walk, then the
// partials' sum); returns cudaGetLastError() (0 on success). Writes every
// row of `out` (out_rows, L): L a multiple of 32, sub = L / k, Lv <= sub.
// `V` is (nslab * edge_block, Lv) with row stride ldv floats. `partial`
// holds 2 * ceil(nslab / seg_slabs) * row_block * L floats; `sum_parts`
// CTAs share a block's sum.
int mrgcn_fused_place_split_f32(const float* V, long long ldv, int Lv,
                                const int* place, const float* norm,
                                const int* local, const int* blk, float* out,
                                float* partial, int nslab, int edge_block,
                                int row_block, long long out_rows, int L,
                                int k, int seg_slabs, int sum_parts,
                                void* stream) {
    if (seg_slabs < 1 || sum_parts < 1 || L % kLanes || k <= 0
        || L % k || Lv > L / k)
        return (int)cudaErrorInvalidValue;
    const size_t smem = mrgcn_fused_place_scatter_smem_bytes(row_block,
                                                             edge_block);
    cudaError_t err = cudaFuncSetAttribute(
        fused_place_split_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = (cudaStream_t)stream;
    const long long out_blocks = (out_rows + row_block - 1) / row_block;
    const int nseg = (nslab + seg_slabs - 1) / seg_slabs;
    const dim3 grid((unsigned)(nseg + out_blocks), (unsigned)(L / kLanes));
    fused_place_split_kernel<<<grid, kThreads, smem, s>>>(
        V, ldv, Lv, place, norm, local, blk, out, partial, nslab, edge_block,
        row_block, out_rows, L, L / k, seg_slabs);
    err = cudaGetLastError();
    if (err != cudaSuccess || nseg < 2 || out_blocks == 0) return (int)err;
    split_sum_kernel<<<dim3((unsigned)out_blocks, (unsigned)sum_parts), 256,
                       0, s>>>(partial, blk, out, nslab, row_block, out_rows,
                               L, seg_slabs);
    return (int)cudaGetLastError();
}

// The row-segmented route, for a stream whose real scatter rows never
// decrease: edges a warp walks (the wrapper sizes the scratch from it:
// nchunks = max(1, ceil(nslab * edge_block / chunk)) lines of L floats for
// `head` and for `tail`, 3 nchunks ints for `meta`).
int mrgcn_fused_place_rows_chunk() { return row_walk::kRowsChunk; }

// Two launches on `stream` (the segmented pass, then the carry pass);
// returns cudaGetLastError() (0 on success). `out` (out_rows, L) 16-byte
// aligned, L a multiple of 32, Lv <= L / k, nslab * edge_block < 2^31 -
// 128. vec = 4 takes 16-byte loads of V (its pointer 16-byte aligned;
// ldv, Lv and L / k multiples of 4); vec = 1 takes any. Writes every
// element of `out`.
int mrgcn_fused_place_rows_f32(const float* V, long long ldv, int Lv,
                               const int* place, const float* norm,
                               const int* local, const int* blk, float* out,
                               float* head, float* tail, int* meta,
                               int nslab, int edge_block, int row_block,
                               int out_rows, int L, int k, int vec,
                               void* stream) {
    if (k <= 0 || L % k) return (int)cudaErrorInvalidValue;
    return (int)row_walk::launch_place_rows<true>(
        V, ldv, Lv, place, norm, L / k, local, blk, out, head, tail, meta,
        nslab, edge_block, row_block, out_rows, L, vec,
        (cudaStream_t)stream);
}

}  // extern "C"

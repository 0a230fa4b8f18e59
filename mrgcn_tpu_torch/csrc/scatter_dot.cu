// Block-sorted scatter-add fused with the same-address table dot, for
// Hopper (sm_90a): two kernels for one function.
//
// Computes, in one pass over a slab-padded edge stream whose per-slab block
// ids blk[] never decrease, with row(e) = blk[e / EB] * RB + local[e]:
//     out[row(e), j] += w[e] * dvn[e, j]                  j in [0, Lv)
//     dots[e]         = sum_j table[row(e), j] * dvn[e, j]
// A local index outside [0, RB) marks a padding edge: it adds nothing,
// reads no table row and gets dots[e] = 0. Every row of `out` is written
// (lanes >= Lv and rows no edge visits are zero-filled by the same
// launch), so the caller allocates `out` and `dots` uninitialised.
//
// Replaces: mrgcn_tpu/ops/pallas_gather.py::_scatter_dot_kernel (the TPU
// kernel behind pallas_gather.fused_scatter_dot). That kernel pads dvn to
// the table's width, accumulates with one-hot matmuls into a VMEM block
// carried across an in-order grid, gathers the table rows with a second
// one-hot matmul and writes each dot to 8 sublanes. Here dvn comes at its
// real width and neither product is a matmul.
//
// What bounds it on the card: memory bandwidth. Per call it must read dvn
// once (E_pad x Lv f32: 450 MB of the 487 MB at link prediction's bwd_h
// shape, 562,176 x 200), the visited table rows once, and write `out` and
// `dots` once.
//
// Two routes:
//
//  * scatter_dot_rows_kernel, for streams whose real scatter rows never
//    decrease along the stream (the planner's Stream.rows_sorted: every
//    dst-sorted bwd_h stream of identity_basis plans). All edges of one
//    output row are then contiguous, so the scatter half is a segmented
//    sum. One warp takes a chunk of kRowsChunk consecutive edges. It walks
//    them in order, 16-byte loads across each dvn row (kInFlight rows'
//    loads issued before any is used), keeps sum w_e dvn_e of the current
//    row in registers, loads that row's table line into registers once
//    when the row starts, reduces each edge's dot over the whole row with
//    a fixed xor-shuffle tree, and writes the row once when it ends,
//    zeros included; the rows between two visited rows are zeroed by the
//    warp that meets the later one. No shared memory, no per-lane-tile
//    partials: each edge's dot is final where it is computed.
//    A row whose edges cross a chunk boundary (a hub row spans many
//    chunks) is not written by kernel 1: each chunk writes its piece of
//    that row to a scratch line (`tail` where the row starts in the chunk,
//    `head` where it continues from an earlier one), and
//    scatter_dot_carry_kernel, launched next, sums the pieces in chunk
//    order and writes the row (one CTA a row, one column a thread: the
//    pieces' loads are independent). Long rows are so cut into pieces of
//    at most kRowsChunk edges that separate warps sum. No float atomics:
//    `out` and `dots` are bit-identical from run to run.
//    Grid: one warp per chunk (4,392 warps at the bwd_h shape), no warp
//    idle by design; every warp's rows are found from local[] and blk[]
//    by the kernel itself (the row before the chunk and the row after it
//    by a warp ballot over the neighbouring edges).
//
//  * scatter_dot_kernel (the general route, any block-sorted stream): one
//    CTA per (run of equal block ids, 32-lane tile), the walk of
//    stream_walk.cuh, as in sorted_scatter.cu. Beside the (RB, 32)
//    accumulator the CTA keeps the same (RB, 32) tile of `table` in shared
//    memory (2 x 64 KB at RB=512), loaded once per run with 16-byte loads:
//    an edge's table row is then a shared-memory read at the address its
//    message is added to. The owning warp of an edge (rows r % 8 == w) adds
//    w[e] * dvn[e, lane] to the accumulator and reduces table[row, lane] *
//    dvn[e, lane] over its 32 lanes with a fixed shuffle tree; lane 0
//    stores the tile's partial dot to partial[tile, e]. A second small
//    kernel sums the partials over the lane tiles in tile order. Lane
//    tiles at or beyond Lv hold no data: their CTAs write zeros and their
//    partials are neither written nor summed. The next slab's dvn tile is
//    loaded into registers (coalesced 4-byte loads, any Lv and row stride)
//    while the current one is consumed. On the bwd_h stream this route
//    gives 29 runs x 7 lane tiles = 203 working CTAs of one per SM: it is
//    parallelism-bound, which is why the sorted route exists.
//
// Offsets into dvn, table and out are 64-bit.

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

// ---------------------------------------------------------------------------
// The row-segmented route (row-sorted streams)
// ---------------------------------------------------------------------------

constexpr int kRowsThreads = 256;
constexpr int kRowsWarps = kRowsThreads / 32;
constexpr int kRowsChunk = 128;    // edges a warp walks
constexpr int kRowsMaxWidth = 512; // widest dvn row a warp holds
constexpr unsigned kFull = 0xffffffffu;

// The table row edge e scatters to, or -1 for padding and for rows outside
// [0, out_rows).
__device__ __forceinline__ int edge_row(const int* __restrict__ local,
                                        const int* __restrict__ blk, int e,
                                        int edge_block, int row_block,
                                        int out_rows) {
    const int l = __ldg(local + e);
    if ((unsigned)l >= (unsigned)row_block) return -1;
    const long long r =
        (long long)__ldg(blk + e / edge_block) * row_block + l;
    return (r >= 0 && r < out_rows) ? (int)r : -1;
}

// The row of the last real edge before e0 (-1 if none), and of the first
// real edge at or after e1 (-1 if none): a warp ballot over 32 edges at a
// time. The planner's streams pad only the tail of a block's run, so one or
// two ballots find it.
__device__ __forceinline__ int row_before(const int* __restrict__ local,
                                          const int* __restrict__ blk,
                                          int e0, int edge_block,
                                          int row_block, int out_rows,
                                          int lane) {
    for (int s = e0; s > 0; s -= 32) {
        const int e = s - 32 + lane;
        const int r = e >= 0 ? edge_row(local, blk, e, edge_block,
                                        row_block, out_rows) : -1;
        const unsigned m = __ballot_sync(kFull, r >= 0);
        if (m) return __shfl_sync(kFull, r, 31 - __clz(m));
    }
    return -1;
}

__device__ __forceinline__ int row_after(const int* __restrict__ local,
                                         const int* __restrict__ blk, int e1,
                                         int E, int edge_block,
                                         int row_block, int out_rows,
                                         int lane) {
    for (int s = e1; s < E; s += 32) {
        const int e = s + lane;
        const int r = e < E ? edge_row(local, blk, e, edge_block, row_block,
                                       out_rows) : -1;
        const unsigned m = __ballot_sync(kFull, r >= 0);
        if (m) return __shfl_sync(kFull, r, __ffs(m) - 1);
    }
    return -1;
}

// Rows [a, b) of `out` (L floats each, L a multiple of 32) take zeros,
// 16 bytes a lane.
__device__ __forceinline__ void zero_rows(float* __restrict__ out,
                                          long long a, long long b, int L,
                                          int lane) {
    if (b <= a) return;
    const int per_row = L / 4;
    float4* o = reinterpret_cast<float4*>(out + a * L);
    const long long n = (b - a) * per_row;
    for (long long i = lane; i < n; i += 32)
        o[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// A lane holds NV vectors of VEC floats of a row: vector v covers columns
// (v * 32 + lane) * VEC .. + VEC. Loads are masked at Lv (with VEC = 4,
// Lv is a multiple of 4, so a vector is in or out whole).
template <int VEC, int NV>
__device__ __forceinline__ void load_line(const float* __restrict__ p,
                                          int Lv, int lane, float* x,
                                          bool streaming) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
        const int col = (v * 32 + lane) * VEC;
        if constexpr (VEC == 4) {
            float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
            if (col < Lv) {
                const float4* q = reinterpret_cast<const float4*>(p + col);
                t = streaming ? __ldcs(q) : __ldg(q);
            }
            x[4 * v] = t.x; x[4 * v + 1] = t.y;
            x[4 * v + 2] = t.z; x[4 * v + 3] = t.w;
        } else {
            x[v] = col < Lv ? (streaming ? __ldcs(p + col) : __ldg(p + col))
                            : 0.f;
        }
    }
}

// Columns [0, Lv) of a scratch line take the lane's values.
template <int VEC, int NV>
__device__ __forceinline__ void store_piece(float* __restrict__ p, int Lv,
                                            int lane, const float* x) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
        const int col = (v * 32 + lane) * VEC;
        if (col >= Lv) continue;
        if constexpr (VEC == 4)
            *reinterpret_cast<float4*>(p + col) =
                make_float4(x[4 * v], x[4 * v + 1], x[4 * v + 2],
                            x[4 * v + 3]);
        else
            p[col] = x[v];
    }
}

// Row `row` of `out` takes the lane's values in [0, Lv) and zeros up to L.
template <int VEC, int NV>
__device__ __forceinline__ void store_row(float* __restrict__ out,
                                          long long row, int Lv, int L,
                                          int lane, const float* x) {
    float* p = out + row * L;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
        const int col = (v * 32 + lane) * VEC;
        if (col >= L) continue;
        const bool in = col < Lv;
        if constexpr (VEC == 4)
            *reinterpret_cast<float4*>(p + col) = in
                ? make_float4(x[4 * v], x[4 * v + 1], x[4 * v + 2],
                              x[4 * v + 3])
                : make_float4(0.f, 0.f, 0.f, 0.f);
        else
            p[col] = in ? x[v] : 0.f;
    }
    for (int col = (NV * 32 + lane) * VEC; col < L; col += 32 * VEC) {
        if constexpr (VEC == 4)
            *reinterpret_cast<float4*>(p + col) =
                make_float4(0.f, 0.f, 0.f, 0.f);
        else
            p[col] = 0.f;
    }
}

// Chunk c's record for the carry pass: its first and last real row (-1:
// none) and whether its last row's piece went to `tail`.
struct ChunkMeta {
    int first, last, has_tail;
};

template <int VEC, int NV>
__global__ void __launch_bounds__(kRowsThreads)
scatter_dot_rows_kernel(const float* __restrict__ dvn, long long ldv, int Lv,
                        const float* __restrict__ w,
                        const int* __restrict__ local,
                        const int* __restrict__ blk,
                        const float* __restrict__ table,
                        float* __restrict__ out, float* __restrict__ dots,
                        float* __restrict__ head, float* __restrict__ tail,
                        ChunkMeta* __restrict__ meta, int E, int edge_block,
                        int row_block, int out_rows, int L, int nchunks) {
    constexpr int W = NV * VEC;   // floats of a row a lane holds
    // dvn rows whose loads are in flight together
    constexpr int kInFlight = W >= 16 ? 2 : (W >= 8 ? 4 : 8);
    const int lane = threadIdx.x & 31;
    const int c = blockIdx.x * kRowsWarps + (threadIdx.x >> 5);
    if (c >= nchunks) return;
    const int e0 = c * kRowsChunk;
    const int e1 = min(e0 + kRowsChunk, E);
    const int prev = row_before(local, blk, e0, edge_block, row_block,
                                out_rows, lane);
    const int next = row_after(local, blk, e1, E, edge_block, row_block,
                               out_rows, lane);

    float acc[W], tb[W];
    int cur = -1, first = -1, has_tail = 0;

    // The current row ends: its sum goes to `out`, or, where the row
    // crosses a chunk boundary, to this chunk's scratch line.
    auto flush = [&](bool chunk_end) {
        if (cur == first && prev == cur)
            store_piece<VEC, NV>(head + (long long)c * Lv, Lv, lane, acc);
        else if (chunk_end && next == cur) {
            store_piece<VEC, NV>(tail + (long long)c * Lv, Lv, lane, acc);
            has_tail = 1;
        } else {
            store_row<VEC, NV>(out, cur, Lv, L, lane, acc);
        }
    };

    for (int g = e0; g < e1; g += 32) {
        const int my_e = g + lane;
        const int my_r = my_e < e1 ? edge_row(local, blk, my_e, edge_block,
                                              row_block, out_rows) : -1;
        const float my_w = my_r >= 0 ? __ldg(w + my_e) : 0.f;
        float my_dot = 0.f;
        if (__ballot_sync(kFull, my_r >= 0)) {
            const int n = min(32, e1 - g);
            for (int j = 0; j < n; j += kInFlight) {
                float d[kInFlight][W];
                int ru[kInFlight];
#pragma unroll
                for (int u = 0; u < kInFlight; ++u) {
                    ru[u] = __shfl_sync(kFull, my_r, j + u);
                    if (ru[u] >= 0)
                        load_line<VEC, NV>(dvn + (long long)(g + j + u) * ldv,
                                           Lv, lane, d[u], true);
                }
#pragma unroll
                for (int u = 0; u < kInFlight; ++u) {
                    const float wu = __shfl_sync(kFull, my_w, j + u);
                    const int R = ru[u];
                    if (R < 0) continue;            // padding (warp-uniform)
                    if (R != cur) {
                        if (cur >= 0) {
                            flush(false);
                            zero_rows(out, (long long)cur + 1, R, L, lane);
                        } else {
                            first = R;
                            if (prev != R)
                                zero_rows(out, (long long)prev + 1, R, L,
                                          lane);
                        }
                        cur = R;
#pragma unroll
                        for (int i = 0; i < W; ++i) acc[i] = 0.f;
                        load_line<VEC, NV>(table + (long long)R * L, Lv,
                                           lane, tb, false);
                    }
                    float p = 0.f;
#pragma unroll
                    for (int i = 0; i < W; ++i) {
                        acc[i] = fmaf(wu, d[u][i], acc[i]);
                        p = fmaf(tb[i], d[u][i], p);
                    }
#pragma unroll
                    for (int off = 16; off > 0; off >>= 1)
                        p += __shfl_xor_sync(kFull, p, off);
                    if (lane == j + u) my_dot = p;
                }
            }
        }
        if (my_e < e1) dots[my_e] = my_dot;
    }
    if (cur >= 0) {
        flush(true);
        if (next < 0) zero_rows(out, (long long)cur + 1, out_rows, L, lane);
    } else if (prev < 0 && next < 0 && c == 0) {
        zero_rows(out, 0, out_rows, L, lane);      // no real edge at all
    }
    if (lane == 0) meta[c] = ChunkMeta{first, cur, has_tail};
}

// Rows that cross chunk boundaries, one CTA per chunk: where row R starts
// in chunk c (its has_tail), warp 0 finds the chain of chunks after c that
// continue R (a ballot over 32 records at a time), then each thread sums
// its columns of c's tail piece and of those chunks' head pieces, in chunk
// order, and writes the row, zeros from Lv on. The pieces' loads do not
// depend on each other, so a hub row's hundreds of pieces stream in.
constexpr int kCarryThreads = 256;

__global__ void __launch_bounds__(kCarryThreads)
scatter_dot_carry_kernel(const float* __restrict__ head,
                         const float* __restrict__ tail,
                         const ChunkMeta* __restrict__ meta,
                         float* __restrict__ out, int Lv, int L,
                         int nchunks) {
    const int c = blockIdx.x;
    if (!meta[c].has_tail) return;
    const int R = meta[c].last;
    __shared__ int s_end;
    if (threadIdx.x < 32) {
        // one past the last chunk holding a piece of R: the first chunk
        // that does not carry R through its end either ends R (inclusive)
        // or starts another row (exclusive); chunks without a real edge
        // pass
        const int lane = threadIdx.x;
        int end = nchunks;
        for (int base = c + 1; base < nchunks; base += 32) {
            const int c2 = base + lane;
            int at = -1;
            if (c2 < nchunks) {
                const ChunkMeta m = meta[c2];
                if (m.first >= 0 && !(m.first == R && m.last == R))
                    at = m.first == R ? c2 + 1 : c2;
            }
            const unsigned hit = __ballot_sync(kFull, at >= 0);
            if (hit) {
                end = __shfl_sync(kFull, at, __ffs(hit) - 1);
                break;
            }
        }
        if (lane == 0) s_end = end;
    }
    __syncthreads();
    const int end = s_end;
    for (int col = threadIdx.x; col < L; col += kCarryThreads) {
        float s = 0.f;
        if (col < Lv) {
            s = tail[(long long)c * Lv + col];
#pragma unroll 8
            for (int c2 = c + 1; c2 < end; ++c2)
                if (meta[c2].first >= 0)
                    s += head[(long long)c2 * Lv + col];
        }
        out[(long long)R * L + col] = s;
    }
}

template <int VEC, int NV>
cudaError_t launch_rows(const float* dvn, long long ldv, int Lv,
                        const float* w, const int* local, const int* blk,
                        const float* table, float* out, float* dots,
                        float* head, float* tail, ChunkMeta* meta, int E,
                        int edge_block, int row_block, int out_rows, int L,
                        int nchunks, cudaStream_t s) {
    const unsigned ctas = (unsigned)((nchunks + kRowsWarps - 1) / kRowsWarps);
    scatter_dot_rows_kernel<VEC, NV><<<ctas, kRowsThreads, 0, s>>>(
        dvn, ldv, Lv, w, local, blk, table, out, dots, head, tail, meta, E,
        edge_block, row_block, out_rows, L, nchunks);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    scatter_dot_carry_kernel<<<(unsigned)nchunks, kCarryThreads, 0, s>>>(
        head, tail, meta, out, Lv, L, nchunks);
    return cudaGetLastError();
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

// The row-segmented route: edges a warp walks (the wrapper sizes the
// scratch from it: ceil(E / chunk), at least 1, chunks of `head` and `tail`
// lines of Lv floats, and of 3-int records) and the widest dvn row it
// takes.
int mrgcn_scatter_dot_rows_chunk() { return kRowsChunk; }
int mrgcn_scatter_dot_rows_max_width() { return kRowsMaxWidth; }

// The same function for a stream whose real scatter rows never decrease:
// two launches on `stream` (the segmented pass, then the carry pass); returns
// cudaGetLastError() (0 on success). vec = 4 takes 16-byte loads: dvn's
// pointer 16-byte aligned, ldv and Lv multiples of 4; vec = 1 takes any.
// `table` and `out` are (out_rows, L), L a multiple of 32, both 16-byte
// aligned; Lv <= min(L, 512); nslab * edge_block < 2^31 - 128. `head` and
// `tail` hold nchunks * Lv floats, `meta` 3 * nchunks ints. Writes every
// element of `out` and `dots`.
int mrgcn_scatter_dot_rows_f32(const float* dvn, long long ldv, int Lv,
                               const float* w, const int* local,
                               const int* blk, const float* table, float* out,
                               float* dots, float* head, float* tail,
                               int* meta, int nslab, int edge_block,
                               int row_block, int out_rows, int L, int vec,
                               void* stream) {
    const long long E = (long long)nslab * edge_block;
    if (E >= (1LL << 31) - kRowsChunk || Lv > kRowsMaxWidth || Lv > L
        || L % 32 || (vec != 1 && vec != 4) || (vec == 4 && Lv % 4))
        return (int)cudaErrorInvalidValue;
    int nchunks = (int)((E + kRowsChunk - 1) / kRowsChunk);
    if (nchunks == 0) nchunks = 1;          // chunk 0 zero-fills `out`
    ChunkMeta* m = reinterpret_cast<ChunkMeta*>(meta);
    cudaStream_t s = (cudaStream_t)stream;
    const int per = 32 * vec;               // columns a vector slot covers
    const int slots = Lv <= per ? 1 : Lv <= 2 * per ? 2 : Lv <= 4 * per ? 4
                    : Lv <= 8 * per ? 8 : 16;
#define MRGCN_ROWS(V, N)                                                     \
    launch_rows<V, N>(dvn, ldv, Lv, w, local, blk, table, out, dots, head,   \
                      tail, m, (int)E, edge_block, row_block, out_rows, L,   \
                      nchunks, s)
    cudaError_t err;
    if (vec == 4)
        err = slots == 1 ? MRGCN_ROWS(4, 1) : slots == 2 ? MRGCN_ROWS(4, 2)
                                                         : MRGCN_ROWS(4, 4);
    else
        err = slots == 1 ? MRGCN_ROWS(1, 1) : slots == 2 ? MRGCN_ROWS(1, 2)
            : slots == 4 ? MRGCN_ROWS(1, 4) : slots == 8 ? MRGCN_ROWS(1, 8)
                                                         : MRGCN_ROWS(1, 16);
#undef MRGCN_ROWS
    return (int)err;
}

}  // extern "C"

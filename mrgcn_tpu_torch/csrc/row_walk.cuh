// The row-segmented walk the scatters share on row-sorted streams
// (scatter_dot.cu, sorted_scatter.cu, fused_place_scatter.cu), for Hopper
// (sm_90a).
//
// A slab-padded edge stream whose real scatter rows never decrease along
// the stream (the planner's Stream.rows_sorted) keeps all edges of one
// output row together, so a scatter-add over it is a segmented sum. One
// warp takes a chunk of kRowsChunk consecutive edges, walks them in
// order, keeps the current row's sum in registers and writes the row once
// when it ends, zeros included; the rows between two visited rows are
// zeroed by the warp that meets the later one, the rows before the first
// and after the last by the warps that hold those edges. A row whose edges
// cross a chunk boundary is not written by its chunks: each writes its
// piece to a scratch line (`tail` where the row starts in the chunk,
// `head` where it continues from an earlier one), and carry_kernel,
// launched next, sums the pieces in chunk order and writes the row (one
// CTA a chunk that starts such a row, one column a thread). No float
// atomics: results are bit-identical from run to run. Each warp finds the
// rows around its chunk from local[] and blk[] itself (a ballot over the
// neighbouring edges).
//
// place_rows_kernel is that walk for sorted_scatter (full lines) and
// fused_place_scatter (norm-scaled values at a sub-row slot);
// scatter_dot.cu adds the per-edge table dot to it in its own kernel.

#pragma once

#include "stream_walk.cuh"

namespace row_walk {

constexpr int kRowsThreads = 256;
constexpr int kRowsWarps = kRowsThreads / 32;
constexpr int kRowsChunk = 128;    // edges a warp walks
constexpr int kRowsMaxWidth = 512; // widest row a warp holds in registers
constexpr unsigned kFull = 0xffffffffu;

// The row edge e scatters to, or -1 for padding and for rows outside
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
// time. The planner's streams pad only the tail of a block's run, so a few
// ballots find it.
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

// Rows that cross chunk boundaries, one CTA per chunk: where row R starts
// in chunk c (its has_tail), warp 0 finds the chain of chunks after c that
// continue R (a ballot over 32 records at a time), then each thread sums
// its columns of c's tail piece and of those chunks' head pieces, in chunk
// order, and writes the row: columns [0, piece) from the pieces (lines of
// `piece` floats), zeros from there to L. The pieces' loads do not depend
// on each other, so a hub row's hundreds of pieces stream in.
constexpr int kCarryThreads = 256;

__global__ void __launch_bounds__(kCarryThreads)
carry_kernel(const float* __restrict__ head, const float* __restrict__ tail,
             const ChunkMeta* __restrict__ meta, float* __restrict__ out,
             int piece, int L, int nchunks) {
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
        if (col < piece) {
            s = tail[(long long)c * piece + col];
#pragma unroll 8
            for (int c2 = c + 1; c2 < end; ++c2)
                if (meta[c2].first >= 0)
                    s += head[(long long)c2 * piece + col];
        }
        out[(long long)R * L + col] = s;
    }
}

// ---------------------------------------------------------------------------
// place_rows_kernel: sorted_scatter and fused_place_scatter
// ---------------------------------------------------------------------------
//
// out[row(e), place[e] * sub + j] += norm[e] * V[e, j] for j < Lv (with
// PLACED), or out[row(e), j] += V[e, j] for j < L (without: sorted_scatter,
// V the full message lines). A lane holds W = NV * VEC columns of the
// output line: vector v covers columns c0 + (v * 32 + lane) * VEC .. + VEC
// of a 32 * W-column tile starting at c0 = blockIdx.y * 32 * W (lines
// wider than the tile take several tiles along gridDim.y, each walking the
// stream for its columns). Each lane first loads the scalars of 4 of the
// chunk's 128 edges and of the 32 edges on either side, all before any is
// used: one trip to memory, not one per group of edges; the chunk's rows,
// slot offsets and norms then wait in shared memory. Then the values, on
// one of two paths:
//  * Q = 0, any width: one edge at a time the lanes whose columns lie in
//    the edge's slot load them from V (16-byte loads with VEC = 4; the
//    slot starts at a multiple of 4 and Lv is one, so a vector is in or
//    out whole) and add them; kInFlight edges' loads are issued before
//    any is used (32 floats a lane in flight).
//  * Q > 0, narrow values (Lv <= 32, VEC = 4, a line of up to 128 lanes,
//    Q = Lv / 4 rounded up to a power of 2): an edge's values are Q
//    float4s, so one 16-byte load a lane covers 32 / Q edges, and 8 such
//    loads cover half the chunk at Lv = 16 (4 KB a trip to memory, where
//    the path above, 8 edges in flight, would move 512 bytes). The batch
//    goes to shared memory, and the lanes of each edge's slot read its
//    float4s there, edge by edge in stream order, so the sums' order is
//    that of the stream whatever the slots: the NC streams' Lv = 16 of 128
//    lanes at k = 8.
// Both add each edge's values into the current row's line in stream
// order; 3 blocks of 8 warps fit an SM (at most 80 registers a thread,
// 44 KB of shared memory a block).
template <int VEC, int NV>
__device__ __forceinline__ void load_slot(const float* __restrict__ p,
                                          int off, int Lv, int lane,
                                          float* x, bool live) {
    // off: the edge's slot start minus the tile's first column
#pragma unroll
    for (int v = 0; v < NV; ++v) {
        const int j = (v * 32 + lane) * VEC - off;
        const bool in = live && j >= 0 && j < Lv;
        if constexpr (VEC == 4) {
            float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
            if (in) t = __ldcs(reinterpret_cast<const float4*>(p + j));
            x[4 * v] = t.x; x[4 * v + 1] = t.y;
            x[4 * v + 2] = t.z; x[4 * v + 3] = t.w;
        } else {
            x[v] = in ? __ldcs(p + j) : 0.f;
        }
    }
}

// The tile's columns of one line (`p` its column 0) take the lane's values.
template <int VEC, int NV>
__device__ __forceinline__ void store_cols(float* __restrict__ p, int c0,
                                           int L, int lane, const float* x) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
        const int col = c0 + (v * 32 + lane) * VEC;
        if (col >= L) continue;
        if constexpr (VEC == 4)
            *reinterpret_cast<float4*>(p + col) =
                make_float4(x[4 * v], x[4 * v + 1], x[4 * v + 2],
                            x[4 * v + 3]);
        else
            p[col] = x[v];
    }
}

// Rows [a, b) of `out` take zeros in the tile's columns [c0, c0 + tw),
// 16 bytes a lane.
__device__ __forceinline__ void zero_cols(float* __restrict__ out,
                                          long long a, long long b, int c0,
                                          int tw, int L, int lane) {
    const int n4 = min(tw, L - c0) / 4;
    for (long long r = a; r < b; ++r) {
        float4* o = reinterpret_cast<float4*>(out + r * L + c0);
        for (int i = lane; i < n4; i += 32)
            o[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
}

// The row of an edge with local index l in a slab of block b, or -1.
__device__ __forceinline__ int row_of(int l, int b, int row_block,
                                      int out_rows) {
    if ((unsigned)l >= (unsigned)row_block) return -1;
    const long long r = (long long)b * row_block + l;
    return (r >= 0 && r < out_rows) ? (int)r : -1;
}

template <int VEC, int NV, bool PLACED, int Q>
__global__ void __launch_bounds__(kRowsThreads, 3)
place_rows_kernel(const float* __restrict__ V, long long ldv, int Lv,
                  const int* __restrict__ place,
                  const float* __restrict__ norm, int sub,
                  const int* __restrict__ local,
                  const int* __restrict__ blk, float* __restrict__ out,
                  float* __restrict__ head, float* __restrict__ tail,
                  ChunkMeta* __restrict__ meta, int E, int edge_block,
                  int row_block, int out_rows, int L, int nchunks) {
    constexpr int W = NV * VEC;          // columns a lane holds
    constexpr int kTile = 32 * W;        // columns a warp holds
    constexpr int kPer = kRowsChunk / 32;  // edges whose scalars a lane loads
    static_assert(Q == 0 || (VEC == 4 && NV == 1), "narrow path: one float4");
    // each warp's chunk: every edge's row (-1: padding), slot start minus
    // the tile's first column, and norm; on the narrow path a batch of
    // values (edge t's float4 d at t * Q + d)
    __shared__ int s_row[kRowsWarps][kRowsChunk];
    __shared__ int s_off[kRowsWarps][PLACED ? kRowsChunk : 1];
    __shared__ float s_nrm[kRowsWarps][PLACED ? kRowsChunk : 1];
    __shared__ float4 s_val[kRowsWarps][Q ? 256 : 1];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int c = blockIdx.x * kRowsWarps + warp;
    if (c >= nchunks) return;
    const int c0 = blockIdx.y * kTile;
    const int e0 = c * kRowsChunk;
    const int e1 = min(e0 + kRowsChunk, E);

    // the scalars of edges e0 + 32 q + lane, and of the 32 edges before
    // and after the chunk: every load issued before any is used
    {
        int lq[kPer], bq[kPer], pq[kPer];
        float nq[kPer];
#pragma unroll
        for (int q = 0; q < kPer; ++q) {
            const int e = e0 + 32 * q + lane;
            const bool in = e < e1;
            lq[q] = in ? __ldg(local + e) : row_block;
            bq[q] = in ? __ldg(blk + e / edge_block) : 0;
            if (PLACED) {
                pq[q] = in ? __ldg(place + e) : 0;
                nq[q] = in ? __ldg(norm + e) : 0.f;
            }
        }
#pragma unroll
        for (int q = 0; q < kPer; ++q) {
            s_row[warp][32 * q + lane] =
                row_of(lq[q], bq[q], row_block, out_rows);
            if (PLACED) {
                s_off[warp][32 * q + lane] = pq[q] * sub - c0;
                s_nrm[warp][32 * q + lane] = nq[q];
            }
        }
    }
    const int e_before = e0 - 32 + lane, e_after = e1 + lane;
    const int l_before = e_before >= 0 ? __ldg(local + e_before) : row_block;
    const int b_before = e_before >= 0
        ? __ldg(blk + e_before / edge_block) : 0;
    const int l_after = e_after < E ? __ldg(local + e_after) : row_block;
    const int b_after = e_after < E ? __ldg(blk + e_after / edge_block) : 0;
    __syncwarp();

    // the row of the last real edge before the chunk and of the first one
    // after it (-1: none); further windows only past padding
    int prev, next;
    {
        const int r = row_of(l_before, b_before, row_block, out_rows);
        const unsigned m = __ballot_sync(kFull, r >= 0);
        prev = m ? __shfl_sync(kFull, r, 31 - __clz(m))
                 : row_before(local, blk, e0 - 32, edge_block, row_block,
                              out_rows, lane);
    }
    {
        const int r = row_of(l_after, b_after, row_block, out_rows);
        const unsigned m = __ballot_sync(kFull, r >= 0);
        next = m ? __shfl_sync(kFull, r, __ffs(m) - 1)
                 : row_after(local, blk, e1 + 32, E, edge_block, row_block,
                             out_rows, lane);
    }

    float acc[W];
    int cur = -1, first = -1, has_tail = 0;

    // The current row ends: its sum goes to `out`, or, where the row
    // crosses a chunk boundary, to this chunk's scratch line.
    auto flush = [&](bool chunk_end) {
        float* dst = out + (long long)cur * L;
        if (cur == first && prev == cur) {
            dst = head + (long long)c * L;
        } else if (chunk_end && next == cur) {
            dst = tail + (long long)c * L;
            has_tail = 1;
        }
        store_cols<VEC, NV>(dst, c0, L, lane, acc);
    };
    // An edge of row R != cur comes: the current row ends, the rows
    // between take zeros (none where R continues the row before the
    // chunk), R's sum starts.
    auto start_row = [&](int R) {
        long long a = (long long)prev + 1;
        if (cur >= 0) {
            flush(false);
            a = (long long)cur + 1;
        } else {
            first = R;
            if (prev == R) a = R;
        }
        zero_cols(out, a, R, c0, kTile, L, lane);
        cur = R;
#pragma unroll
        for (int i = 0; i < W; ++i) acc[i] = 0.f;
    };

    const int n_edges = e1 - e0;
    if constexpr (Q == 0) {
        constexpr int kInFlight = W >= 16 ? 2 : (W >= 8 ? 4 : 8);
        for (int j = 0; j < n_edges; j += kInFlight) {
            float x[kInFlight][W];
            int ru[kInFlight];
#pragma unroll
            for (int u = 0; u < kInFlight; ++u) {
                ru[u] = s_row[warp][j + u];
                load_slot<VEC, NV>(V + (long long)(e0 + j + u) * ldv,
                                   PLACED ? s_off[warp][j + u] : -c0, Lv,
                                   lane, x[u], ru[u] >= 0);
            }
#pragma unroll
            for (int u = 0; u < kInFlight; ++u) {
                const int R = ru[u];
                if (R < 0) continue;                // padding (warp-uniform)
                if (R != cur) start_row(R);
                const float nu = PLACED ? s_nrm[warp][j + u] : 1.f;
#pragma unroll
                for (int i = 0; i < W; ++i)
                    acc[i] = PLACED ? fmaf(nu, x[u][i], acc[i])
                                    : acc[i] + x[u][i];
            }
        }
    } else {
        constexpr int G = 32 / Q;            // edges a load instruction covers
        constexpr int kEdges = 8 * G < kRowsChunk ? 8 * G : kRowsChunk;
        constexpr int kLoads = kEdges / G;   // 16-byte loads a lane a batch
        const int qd = lane % Q;             // the float4 of an edge it loads
        for (int b0 = 0; b0 < n_edges; b0 += kEdges) {
            float4 xv[kLoads];
#pragma unroll
            for (int i = 0; i < kLoads; ++i) {
                const int el = b0 + i * G + lane / Q;
                xv[i] = make_float4(0.f, 0.f, 0.f, 0.f);
                if (s_row[warp][el] >= 0 && 4 * qd < Lv)
                    xv[i] = __ldcs(reinterpret_cast<const float4*>(
                        V + (long long)(e0 + el) * ldv + 4 * qd));
            }
            __syncwarp();   // the previous batch's values are consumed
#pragma unroll
            for (int i = 0; i < kLoads; ++i)
                s_val[warp][32 * i + lane] = xv[i];
            __syncwarp();
            const int nb = min(kEdges, n_edges - b0);
            for (int t = 0; t < nb; ++t) {            // edges in order
                const int R = s_row[warp][b0 + t];
                if (R < 0) continue;                // padding (warp-uniform)
                if (R != cur) start_row(R);
                // this lane's columns are the edge's float4 d
                const int d = lane
                    - (PLACED ? s_off[warp][b0 + t] : -c0) / 4;
                if (d >= 0 && d < Q && 4 * d < Lv) {
                    const float4 v = s_val[warp][t * Q + d];
                    const float nu = PLACED ? s_nrm[warp][b0 + t] : 1.f;
                    acc[0] = PLACED ? fmaf(nu, v.x, acc[0]) : acc[0] + v.x;
                    acc[1] = PLACED ? fmaf(nu, v.y, acc[1]) : acc[1] + v.y;
                    acc[2] = PLACED ? fmaf(nu, v.z, acc[2]) : acc[2] + v.z;
                    acc[3] = PLACED ? fmaf(nu, v.w, acc[3]) : acc[3] + v.w;
                }
            }
        }
    }
    if (cur >= 0) {
        flush(true);
        if (next < 0)
            zero_cols(out, (long long)cur + 1, out_rows, c0, kTile, L, lane);
    } else if (prev < 0 && next < 0 && c == 0) {
        zero_cols(out, 0, out_rows, c0, kTile, L, lane);  // no real edge
    }
    if (lane == 0 && blockIdx.y == 0)
        meta[c] = ChunkMeta{first, cur, has_tail};
}

template <int VEC, int NV, bool PLACED, int Q>
cudaError_t launch_place_rows_as(const float* V, long long ldv, int Lv,
                                 const int* place, const float* norm,
                                 int sub, const int* local, const int* blk,
                                 float* out, float* head, float* tail,
                                 ChunkMeta* meta, int E, int edge_block,
                                 int row_block, int out_rows, int L,
                                 int nchunks, cudaStream_t s) {
    const unsigned ctas = (unsigned)((nchunks + kRowsWarps - 1) / kRowsWarps);
    const unsigned tiles = (unsigned)((L + 32 * NV * VEC - 1)
                                      / (32 * NV * VEC));
    place_rows_kernel<VEC, NV, PLACED, Q><<<dim3(ctas, tiles), kRowsThreads,
                                            0, s>>>(
        V, ldv, Lv, place, norm, sub, local, blk, out, head, tail, meta, E,
        edge_block, row_block, out_rows, L, nchunks);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    carry_kernel<<<(unsigned)nchunks, kCarryThreads, 0, s>>>(
        head, tail, meta, out, L, L, nchunks);
    return cudaGetLastError();
}

// The row-segmented scatter: two launches on `s` (the segmented pass over
// column tiles, then the carry pass). `out` is (out_rows, L), L a multiple
// of 32, 16-byte aligned; every element is written. `head` and `tail` hold
// nchunks * L floats, `meta` nchunks records, nchunks = max(1, ceil(E /
// kRowsChunk)), E = nslab * edge_block < 2^31 - kRowsChunk. vec = 4 takes
// 16-byte loads of V (V's pointer 16-byte aligned, ldv, Lv and sub
// multiples of 4); vec = 1 takes any. Without PLACED, Lv = sub = L and
// place, norm are not read.
template <bool PLACED>
cudaError_t launch_place_rows(const float* V, long long ldv, int Lv,
                              const int* place, const float* norm, int sub,
                              const int* local, const int* blk, float* out,
                              float* head, float* tail, int* meta, int nslab,
                              int edge_block, int row_block, int out_rows,
                              int L, int vec, cudaStream_t s) {
    const long long E = (long long)nslab * edge_block;
    if (E >= (1LL << 31) - kRowsChunk || out_rows < 0 || L <= 0 || L % 32
        || Lv > sub || sub > L || (vec != 1 && vec != 4)
        || (vec == 4 && (Lv % 4 || sub % 4 || ldv % 4)))
        return cudaErrorInvalidValue;
    int nchunks = (int)((E + kRowsChunk - 1) / kRowsChunk);
    if (nchunks == 0) nchunks = 1;          // chunk 0 zero-fills `out`
    ChunkMeta* m = reinterpret_cast<ChunkMeta*>(meta);
#define MRGCN_PLACE_ROWS(VEC, NV, Q)                                         \
    launch_place_rows_as<VEC, NV, PLACED, Q>(V, ldv, Lv, place, norm, sub,  \
                                             local, blk, out, head, tail,   \
                                             m, (int)E, edge_block,         \
                                             row_block, out_rows, L,        \
                                             nchunks, s)
    // narrow values: Q float4s an edge; else the narrowest tile that
    // holds the line, up to kRowsMaxWidth columns
    if (vec == 4 && L <= 128 && Lv <= 32)
        return Lv <= 4 ? MRGCN_PLACE_ROWS(4, 1, 1)
             : Lv <= 8 ? MRGCN_PLACE_ROWS(4, 1, 2)
             : Lv <= 16 ? MRGCN_PLACE_ROWS(4, 1, 4)
             : MRGCN_PLACE_ROWS(4, 1, 8);
    if (vec == 4)
        return L <= 128 ? MRGCN_PLACE_ROWS(4, 1, 0)
             : L <= 256 ? MRGCN_PLACE_ROWS(4, 2, 0)
             : MRGCN_PLACE_ROWS(4, 4, 0);
    return L <= 32 ? MRGCN_PLACE_ROWS(1, 1, 0)
         : L <= 64 ? MRGCN_PLACE_ROWS(1, 2, 0)
         : L <= 128 ? MRGCN_PLACE_ROWS(1, 4, 0)
         : L <= 256 ? MRGCN_PLACE_ROWS(1, 8, 0)
         : MRGCN_PLACE_ROWS(1, 16, 0);
#undef MRGCN_PLACE_ROWS
}

}  // namespace row_walk

// Row-sorted scatter-add fused with the same-address table dot, for
// Hopper (sm_90a).
//
// Computes, in one pass over a slab-padded edge stream whose real scatter
// rows never decrease along the stream (the planner's Stream.rows_sorted:
// every dst-sorted bwd_h stream of identity_basis plans), with
// row(e) = blk[e / EB] * RB + local[e]:
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
// What the design does about it: the row-segmented walk of row_walk.cuh.
// scatter_dot_rows_kernel walks a warp's chunk of kRowsChunk edges in
// order, 16-byte loads across each dvn row (kInFlight rows' loads issued
// before any is used), keeps sum w_e dvn_e of the current row in
// registers, loads that row's table line into registers once when the row
// starts, reduces each edge's dot over the whole row with a fixed
// xor-shuffle tree, and writes the row once when it ends, zeros included.
// No shared memory, no per-lane-tile partials: each edge's dot is final
// where it is computed. Rows that cross a chunk boundary (a hub row spans
// many chunks) go to the shared carry pass (row_walk::carry_kernel, lines
// of Lv floats). No float atomics: `out` and `dots` are bit-identical from
// run to run. Grid: one warp per chunk (4,392 warps at the bwd_h shape).
// Offsets into dvn, table and out are 64-bit.

#include "row_walk.cuh"

namespace {

using namespace row_walk;

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
    carry_kernel<<<(unsigned)nchunks, kCarryThreads, 0, s>>>(
        head, tail, meta, out, Lv, L, nchunks);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

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

// Fused transformer MLP for Hopper (sm_90a), forward and backward:
//   out = bf16(gelu_tanh(x W1 + b1)) W2 + b2
// with x (M, d) bf16, W1 (d, hd), W2 (hd, d), b1, b2 bf16, f32 sums, out
// bf16. The backward recomputes the hidden activations:
//   h_pre = x W1 + b1, hb = bf16(gelu(h_pre)),
//   dW2 = hb^T do, db2 = sum_rows do, dh = do W2^T,
//   dh_pre = gelu'(h_pre) dh (f32), dx = bf16(dh_pre) W1^T,
//   dW1 = x^T bf16(dh_pre), db1 = sum_rows dh_pre,
// with the weight gradients in f32.
//
// Replaces: mrgcn_tpu/ops/fused_mlp.py::_fwd_kernel and ::_bwd_kernel (the
// TPU kernels behind fused_mlp). Those keep the (rows, 4d) hidden tensor
// in VMEM and carry dW1, db1, dW2, db2 in f32 VMEM blocks from one step of
// an in-order grid to the next.
//
// What bounds it on the card: at the text encoder's shapes (M = 1,024,000
// rows, d = 128, hd = 512) the forward does 4 d hd FLOP a row against
// 4 d bytes moved, ~340 FLOP a byte, past the H100's bf16 ridge (~295):
// the tensor cores bound it once the (M, hd) hidden tensor stays out of
// device memory (268 GFLOP forward, 5 products = 671 GFLOP backward). So
// the products must run on wgmma, fed without stalls. In the way: the
// weights (256 KB at d = 128, hd = 512) do not fit in shared memory beside
// the row tiles, so they are re-read from L2 for every block of rows; the
// gelu work (524 M hidden elements a pass) sits between the two products
// of each chunk; and the weight gradients are sums over all M rows.
//
// What the design does about it:
//  * Every operand tile arrives by TMA (cp.async.bulk.tensor, completing
//    on an mbarrier) in the 128-byte swizzle (hopper.cuh). W1 and W2 are
//    read in place: W1's chunk (d x 64) is the B of x W1 read MN-major and
//    the B of dh_pre W1^T read K-major, W2's chunk (64 x d) likewise; no
//    transposed copy is made. Every product is wgmma m64nNk16 bf16 -> f32.
//  * Forward and dx (mlp_rows_kernel<Bwd>): persistent blocks of consumer
//    warpgroups (three forward, 192 rows a block step; two in dx, whose
//    159 registers a thread leave no room for a third) and one producer
//    warp that keeps a 3-stage ring of (W1 chunk, W2 chunk) pairs and a
//    double-buffered row tile in flight. A stage is freed by the consumer
//    warps' arrivals on its `empty` barrier, so the warpgroups wait for
//    each other only through the ring. Per 64-column chunk a warpgroup
//    forms x W1c (and dO W2c^T) from shared memory, applies gelu (gelu' *
//    dh) to the accumulator in registers, packs it to the bf16 A fragment
//    and multiplies it into its (64, d) output accumulator: the hidden
//    activations never leave the registers. The output is staged through
//    the row tile's own buffer and stored 16 bytes a thread.
//  * Weight gradients (mlp_bwd_dw_kernel): a block owns one 64-column
//    hidden chunk and one row segment (one block an SM, one wave), keeps
//    its W1 and W2 chunks resident and walks the segment's 64-row tiles
//    through a 4-stage ring. Two recompute warpgroups take alternate tiles
//    and form h_pre^T and dh^T with the chunk's weights as register A
//    fragments, then hb^T and bf16(dh_pre)^T into shared memory; a third
//    warpgroup accumulates dW1c^T += dh_pre^T x and dW2c += hb^T do in
//    registers across the segment (operands read K- and MN-major by the
//    descriptors, not moved by the threads). db1 comes from the f32
//    dh_pre; db2's columns are spread over the chunk blocks. Each block
//    writes its f32 partials once; a second pass sums them over segments
//    in a fixed order: deterministic, no atomics.
//  * Seven products in the backward where five would do (h_pre and dh are
//    formed by both backward kernels): one recompute shared by dx and the
//    weight gradients needs the hidden width split over a cluster and dx's
//    f32 partials summed across it, 28 KB of distributed shared memory a
//    block a tile, some 4 GB a call at these shapes (PERF.md).
//  * gelu: one tanh.approx.f32 per hidden element per pass (relative
//    error at most 2^-11), shared by gelu and gelu' in the backward.
//  * Limits: d a multiple of 16 up to 128, hd a multiple of 64, M >= 1
//    (the wrapper checks).

#include "hopper.cuh"

namespace {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int kChunk = 64;                  // hidden columns a step
constexpr int kMaxD = 128;
constexpr int kDimTiles = kMaxD / 8;
constexpr int kWgThreads = 128;             // a warpgroup
constexpr int kTileBytes = 2 * kBoxBytes;   // 64 rows x 128 columns, 16 KB

// ---- the rows kernel (forward, dx) ----------------------------------------
// Consumer warpgroups (64 rows each) of a block: three in the forward,
// two in dx.
constexpr int kFwdWarpgroups = 3;
constexpr int kBwdWarpgroups = 2;
constexpr int kStages = 3;                          // weight chunks in flight
constexpr int kChunkBytes = 2 * kTileBytes;         // W1 chunk, W2 chunk

// ---- the weight-gradient kernel -------------------------------------------
constexpr int kSegRows = 64;                        // rows a step
constexpr int kRecompute = 2;            // warpgroups forming hb, dh_pre
constexpr int kDwStages = 4;                        // (x, do) tiles in flight
constexpr int kPairs = 2;                           // (hb, dh_pre) tiles
constexpr int kDwThreads = (kRecompute + 1) * kWgThreads;

// The rows kernel's geometry and shared memory: the ring of weight
// chunks, then two row buffers (each: per warpgroup its x tile and,
// backward, its do tile), then the barriers.
template <bool Bwd>
struct Rows {
    static constexpr int kWarpgroups = Bwd ? kBwdWarpgroups : kFwdWarpgroups;
    static constexpr int kTile = kWarpgroups * 64;          // rows a step
    static constexpr int kThreads = kWarpgroups * kWgThreads + 32;
    static constexpr int kOperands = Bwd ? 2 : 1;
    static constexpr size_t kRowBuf =
        (size_t)kWarpgroups * kOperands * kTileBytes;
    static constexpr size_t kRows = (size_t)kStages * kChunkBytes;
    static constexpr size_t kBars = kRows + 2 * kRowBuf;
    static constexpr size_t kBytes = kBars + (2 * kStages + 4) * 8;
};

// Shared memory of the weight-gradient kernel: W1 chunk, W2 chunk, the
// ring of (x, do) tiles, the (hb, dh_pre) tile pairs, the db1 / db2
// partials, b1's chunk, barriers.
constexpr size_t kDwRing = 2 * kTileBytes;
constexpr size_t kDwH = kDwRing + (size_t)kDwStages * 2 * kTileBytes;
constexpr size_t kDwRed = kDwH + (size_t)kPairs * 2 * kBoxBytes;
constexpr size_t kDwBias = kDwRed + (size_t)(kRecompute * kChunk
                                             + kWgThreads) * sizeof(float);
constexpr size_t kDwBars = kDwBias + kChunk * sizeof(float);
constexpr size_t kDwBytes = kDwBars + (1 + 2 * kDwStages + 2 * kPairs) * 8;

// ---- gelu -----------------------------------------------------------------

constexpr float kGeluC = 0.7978845608028654f;    // sqrt(2 / pi)
constexpr float kGeluA = 0.044715f;

__device__ __forceinline__ float tanh_approx(float x) {
    float y;
    asm("tanh.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// tanh(sqrt(2 / pi) (x + 0.044715 x^3)), the one transcendental of both
__device__ __forceinline__ float gelu_tanh_of(float x) {
    return tanh_approx(x * fmaf(kGeluC * kGeluA, x * x, kGeluC));
}

__device__ __forceinline__ float gelu(float x, float th) {
    const float hx = 0.5f * x;
    return fmaf(hx, th, hx);
}

__device__ __forceinline__ float gelu_grad(float x, float th) {
    return fmaf(0.5f, th, 0.5f)
         + 0.5f * x * fmaf(-th, th, 1.f)
                    * fmaf(3.f * kGeluA * kGeluC, x * x, kGeluC);
}

// ---- tiles ----------------------------------------------------------------

// Hidden chunk c of the weights: W1[0:128, 64c:64c+64] as two boxes of 64
// rows (one 128-row tile: d along rows, the chunk's columns along the
// 128-byte lines), then W2[64c:64c+64, 0:128] as two boxes of 64 columns.
__device__ __forceinline__ void load_chunk(char* dst, const CUtensorMap* w1,
                                           const CUtensorMap* w2,
                                           uint64_t* bar, int c) {
    tma_load_box(dst, w1, bar, c * kChunk, 0, 0);
    tma_load_box(dst + kBoxBytes, w1, bar, c * kChunk, 64, 0);
    load_tile(dst + kTileBytes, w2, bar, c * kChunk, 0);
}

// byte offset of the 16-byte chunk q of row r in a swizzled box
__device__ __forceinline__ int swizzled(int r, int q) {
    return r * 128 + ((q ^ (r & 7)) << 4);
}

// acc = A B over d = 128 (zeros past d), 64 x 64, A's fragments given
// (ldmatrix_a_*), B a K-major tile whose 64 rows are acc's columns:
// h^T = W1c^T x^T (B = x), dh^T = W2c dO^T (B = do)
__device__ __forceinline__ void issue_rs_k_major(float (&acc)[8][4],
                                                 const uint32_t (&a)[8][4],
                                                 const char* B) {
#pragma unroll
    for (int kk = 0; kk < kMaxD / 16; ++kk)
        wgmma_rs_n64<0>(acc, a[kk], desc_k_major(B, 0, kk), kk > 0);
}

// h = X W1c (64 rows x the chunk's 64 columns) over d = 128, both
// operands in shared memory (W1c MN-major: d along its rows)
__device__ __forceinline__ void issue_hidden(float (&h)[8][4], const char* X,
                                             const char* W1c) {
#pragma unroll
    for (int kk = 0; kk < kMaxD / 16; ++kk)
        wgmma_ss_n64<0, 1>(h, desc_k_major(X, 0, kk),
                           desc_mn_major(W1c, kk * 16), kk > 0);
}

// dh = dO W2c^T (64 rows x the chunk's 64 columns)
__device__ __forceinline__ void issue_dhidden(float (&dh)[8][4],
                                              const char* dO,
                                              const char* W2c) {
#pragma unroll
    for (int kk = 0; kk < kMaxD / 16; ++kk)
        wgmma_ss_n64<0, 0>(dh, desc_k_major(dO, 0, kk),
                           desc_k_major(W2c, 0, kk), kk > 0);
}

// The warpgroup's 64 rows of acc (+ bias) as bf16 into its row tile S (no
// product reads it any more; rows of 256 bytes, the 16-byte chunk c of
// row r at chunk c ^ (r % 8)), then to rows row0.. of the (M, d) output,
// 16 bytes a thread. A warp writes and reads back only its own 16 rows.
__device__ __forceinline__ void store_rows(bf16* dst, char* S,
                                           const float (&acc)[kDimTiles][4],
                                           const bf16* bias, long long row0,
                                           long long M, int d) {
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    char* mine = S + 16 * warp * 256;
#pragma unroll
    for (int dt = 0; dt < kDimTiles; ++dt) {
        float b0 = 0.f, b1 = 0.f;
        const int col = dt * 8 + 2 * t;
        if (bias && col < d) {
            const __nv_bfloat162 bb =
                *reinterpret_cast<const __nv_bfloat162*>(bias + col);
            b0 = __low2float(bb);
            b1 = __high2float(bb);
        }
        char* p = mine + g * 256 + ((dt ^ g) << 4) + t * 4;
        *reinterpret_cast<uint32_t*>(p) = pack2(acc[dt][0] + b0,
                                                acc[dt][1] + b1);
        *reinterpret_cast<uint32_t*>(p + 8 * 256) =
            pack2(acc[dt][2] + b0, acc[dt][3] + b1);
    }
    __syncwarp();
#pragma unroll
    for (int i = lane; i < 16 * kDimTiles; i += 32) {
        const int rl = ((i >> 7) << 3) + (i & 7);
        const int c = (i >> 3) & 15;
        const long long r = row0 + 16 * warp + rl;
        if (r < M && c * 8 < d)
            *reinterpret_cast<uint4*>(dst + r * d + c * 8) =
                *reinterpret_cast<const uint4*>(
                    mine + rl * 256 + ((c ^ (rl & 7)) << 4));
    }
}

// ---------------------------------------------------------------------------
// Forward (Bwd = false): out = bf16(gelu(x W1 + b1)) W2 + b2.
// dx (Bwd = true): dx = bf16(gelu'(x W1 + b1) * (do W2^T)) W1^T.
// Persistent: block b walks the row tiles (192 rows forward, 128 dx) b,
// b + gridDim.x, ...
// ---------------------------------------------------------------------------
template <bool Bwd>
__global__ void __launch_bounds__(Rows<Bwd>::kThreads, 1)
mlp_rows_kernel(const __grid_constant__ CUtensorMap map_x,
                const __grid_constant__ CUtensorMap map_do,
                const __grid_constant__ CUtensorMap map_w1,
                const __grid_constant__ CUtensorMap map_w2,
                const bf16* __restrict__ b1, const bf16* __restrict__ b2,
                bf16* __restrict__ out, long long M, int d, int hd) {
    typedef Rows<Bwd> L;
    extern __shared__ __align__(1024) char smem[];
    char* ring = smem;
    char* rows = smem + L::kRows;
    uint64_t* full_w = reinterpret_cast<uint64_t*>(smem + L::kBars);
    uint64_t* empty_w = full_w + kStages;
    uint64_t* full_x = empty_w + kStages;
    uint64_t* empty_x = full_x + 2;
    const int chunks = hd / kChunk;
    const long long tiles = (M + L::kTile - 1) / L::kTile;
    const int wg = threadIdx.x / kWgThreads;
    // a stage or row buffer is free once every consumer warp has arrived
    constexpr int kConsumerWarps = L::kWarpgroups * 4;

    if (threadIdx.x == 0) {
#pragma unroll
        for (int s = 0; s < kStages; ++s) {
            mbar_init(&full_w[s], 1);
            mbar_init(&empty_w[s], kConsumerWarps);
        }
#pragma unroll
        for (int b = 0; b < 2; ++b) {
            mbar_init(&full_x[b], 1);
            mbar_init(&empty_x[b], kConsumerWarps);
        }
        mbar_init_fence();
    }
    __syncthreads();

    if (wg == L::kWarpgroups) {
        // the producer warp; one lane issues every load
        if ((threadIdx.x & 31) != 0) return;
        int step = 0, j = 0;
        for (long long tile = blockIdx.x; tile < tiles;
             tile += gridDim.x, ++j) {
            const int b = j & 1;
            mbar_wait(&empty_x[b], ((j >> 1) & 1) ^ 1);
            mbar_expect(&full_x[b], (int)L::kRowBuf);
            char* dst = rows + b * L::kRowBuf;
#pragma unroll
            for (int w = 0; w < L::kWarpgroups; ++w) {
                const int row = (int)(tile * L::kTile + w * 64);
                load_tile(dst + w * L::kOperands * kTileBytes, &map_x,
                          &full_x[b], row, 0);
                if (Bwd)
                    load_tile(dst + (w * L::kOperands + 1) * kTileBytes,
                              &map_do, &full_x[b], row, 0);
            }
            for (int c = 0; c < chunks; ++c, ++step) {
                const int s = step % kStages;
                mbar_wait(&empty_w[s], ((step / kStages) & 1) ^ 1);
                mbar_expect(&full_w[s], kChunkBytes);
                load_chunk(ring + s * kChunkBytes, &map_w1, &map_w2,
                           &full_w[s], c);
            }
        }
        return;
    }

    const int lane = threadIdx.x & 31, t = lane & 3;
    int step = 0, j = 0;
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++j) {
        const int b = j & 1;
        mbar_wait(&full_x[b], (j >> 1) & 1);
        char* X = rows + b * L::kRowBuf + wg * L::kOperands * kTileBytes;
        const char* dO = X + kTileBytes;
        float acc[kDimTiles][4];
#pragma unroll
        for (int dt = 0; dt < kDimTiles; ++dt)
            acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

        for (int c = 0; c < chunks; ++c, ++step) {
            const int s = step % kStages;
            mbar_wait(&full_w[s], (step / kStages) & 1);
            const char* W1c = ring + s * kChunkBytes;
            const char* W2c = W1c + kTileBytes;
            float h[8][4], dh[8][4];
            wgmma_fence();
            issue_hidden(h, X, W1c);
            if (Bwd) issue_dhidden(dh, dO, W2c);
            wgmma_commit();
            wgmma_wait(h);
            if (Bwd) wgmma_wait(dh);
            const bf16* bias = b1 + c * kChunk + 2 * t;
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
                const __nv_bfloat162 bb = __ldg(
                    reinterpret_cast<const __nv_bfloat162*>(bias + nt * 8));
                const float bias2[2] = {__low2float(bb), __high2float(bb)};
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float x = h[nt][e] + bias2[e & 1];
                    const float th = gelu_tanh_of(x);
                    h[nt][e] = Bwd ? gelu_grad(x, th) * dh[nt][e]
                                   : gelu(x, th);
                }
            }
            uint32_t a[4][4];
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) to_a(a[kk], h, kk);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                if (Bwd)
                    wgmma_rs_n128<0>(acc, a[kk], desc_k_major(W1c, 0, kk), 1);
                else
                    wgmma_rs_n128<1>(acc, a[kk], desc_mn_major(W2c, kk * 16),
                                     1);
            }
            wgmma_commit();
            wgmma_wait(acc);
            __syncwarp();
            if (lane == 0) mbar_arrive(&empty_w[s]);
        }
        // every product reading X is complete: X stages the output
        store_rows(out, X, acc, Bwd ? nullptr : b2, tile * L::kTile + wg * 64,
                   M, d);
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty_x[b]);
    }
}

// ---------------------------------------------------------------------------
// Partial weight gradients of hidden chunk blockIdx.x over row segment
// blockIdx.y (rows [y seg_rows, (y + 1) seg_rows) cut at M; seg_rows a
// multiple of 64). part[y] holds [dW1 (d, hd) | dW2 (hd, d) | db1 (hd) |
// db2 (d)]; this block writes its chunk's columns of dW1 and db1, rows of
// dW2, and a slice of db2's columns.
//
// Roles: recompute warpgroup r (r < kRecompute) keeps W1c^T and W2c as A
// fragments in registers and takes the segment's tiles r, r + kRecompute,
// ...: it forms h_pre^T = W1c^T x^T and dh^T = W2c do^T (hidden columns
// as rows), writes hb^T and bf16(dh_pre)^T into the tile pair i % 2, and
// sums db1. The last warpgroup takes every tile in order: dW1c^T +=
// dh_pre^T x and dW2c += hb^T do, both m64n128 (A K-major, B MN-major),
// and its db2 columns while they run; it frees the tile pair and the
// (x, do) stage, and its first thread refills the stage.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void named_sync(int id, int threads) {
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

__global__ void __launch_bounds__(kDwThreads, 1)
mlp_bwd_dw_kernel(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_do,
                  const __grid_constant__ CUtensorMap map_w1,
                  const __grid_constant__ CUtensorMap map_w2,
                  const bf16* __restrict__ b1, float* __restrict__ part,
                  long long M, int d, int hd, long long seg_rows) {
    const int c = blockIdx.x;
    const long long r_begin = (long long)blockIdx.y * seg_rows;
    const long long r_end = min(M, r_begin + seg_rows);
    const int steps = (int)((r_end - r_begin + kSegRows - 1) / kSegRows);
    extern __shared__ __align__(1024) char smem[];
    char* W1c = smem;
    char* W2c = W1c + kTileBytes;
    char* ring = smem + kDwRing;
    char* pairs = smem + kDwH;                 // pair p: hb, then dh_pre
    float* red = reinterpret_cast<float*>(smem + kDwRed);
    float* b1s = reinterpret_cast<float*>(smem + kDwBias);
    uint64_t* wbar = reinterpret_cast<uint64_t*>(smem + kDwBars);
    uint64_t* full = wbar + 1;                 // an (x, do) stage arrived
    uint64_t* empty = full + kDwStages;        // the stage is free
    uint64_t* hfull = empty + kDwStages;       // a tile pair is written
    uint64_t* hempty = hfull + kPairs;         // the tile pair is free
    const int wg = threadIdx.x / kWgThreads;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    constexpr int kProducts = kRecompute;      // the products warpgroup
    const int issuer = kProducts * kWgThreads;
    auto load_stage = [&](int i) {
        const int s = i % kDwStages;
        const int row = (int)(r_begin + (long long)i * kSegRows);
        char* X = ring + s * 2 * kTileBytes;
        mbar_expect(&full[s], 2 * kTileBytes);
        load_tile(X, &map_x, &full[s], row, 0);
        load_tile(X + kTileBytes, &map_do, &full[s], row, 0);
    };
    if (threadIdx.x == 0) {
        mbar_init(wbar, 1);
#pragma unroll
        for (int s = 0; s < kDwStages; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 4);
        }
#pragma unroll
        for (int p = 0; p < kPairs; ++p) {
            mbar_init(&hfull[p], 4);
            mbar_init(&hempty[p], 4);
        }
        mbar_init_fence();
        mbar_expect(wbar, kChunkBytes);
        load_chunk(W1c, &map_w1, &map_w2, wbar, c);
        for (int i = 0; i < kDwStages && i < steps; ++i) load_stage(i);
    }
    if (threadIdx.x < kChunk)
        b1s[threadIdx.x] = __bfloat162float(b1[c * kChunk + threadIdx.x]);
    __syncthreads();
    mbar_wait(wbar, 0);

    if (wg == kProducts) {
        // dW1c^T (hidden x d) and dW2c (hidden x d), over the whole segment
        float dw1t[kDimTiles][4], dw2[kDimTiles][4];
        // db2: block c of the segment's blocks sums columns [c w, c w + w)
        // of do, w = d / chunks rounded up (a multiple of 8 divides 128);
        // thread -> (column, row group)
        const int chunks = hd / kChunk;
        int w = (d + chunks - 1) / chunks;
        while (kWgThreads % w) ++w;
        const int db2_groups = kWgThreads / w;
        const int tid = threadIdx.x - issuer;
        const int db2_group = tid / w;
        const int db2_col = c * w + tid % w;
        float db2 = 0.f;
#pragma unroll
        for (int dt = 0; dt < kDimTiles; ++dt)
#pragma unroll
            for (int e = 0; e < 4; ++e) dw1t[dt][e] = dw2[dt][e] = 0.f;
        for (int i = 0; i < steps; ++i) {
            const int s = i % kDwStages, p = i % kPairs;
            mbar_wait(&full[s], (i / kDwStages) & 1);
            mbar_wait(&hfull[p], (i / kPairs) & 1);
            const char* X = ring + s * 2 * kTileBytes;
            const char* dO = X + kTileBytes;
            const char* Hs = pairs + p * 2 * kBoxBytes;
            const char* dHs = Hs + kBoxBytes;
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kSegRows / 16; ++kk) {
                wgmma_ss_n128<0, 1>(dw1t, desc_k_major(dHs, 0, kk),
                                    desc_mn_major(X, kk * 16), 1);
                wgmma_ss_n128<0, 1>(dw2, desc_k_major(Hs, 0, kk),
                                    desc_mn_major(dO, kk * 16), 1);
            }
            wgmma_commit();
            // db2 over this block's columns while the products run: rows
            // db2_group, + db2_groups, ... of the tile (past M: zeros)
            if (db2_col < d) {
                const char* col = dO + (db2_col >> 6) * kBoxBytes
                                + (db2_col & 7) * 2;
                const int q = (db2_col & 63) >> 3;
                for (int r = db2_group; r < kSegRows; r += db2_groups)
                    db2 += __bfloat162float(*reinterpret_cast<const bf16*>(
                        col + swizzled(r, q)));
            }
            wgmma_wait(dw1t);
            wgmma_wait(dw2);
            fence_proxy_async();
            __syncwarp();
            if (lane == 0) {
                mbar_arrive(&hempty[p]);
                mbar_arrive(&empty[s]);
            }
            // the stage is free once all four warps are done with it
            if (threadIdx.x == issuer && i + kDwStages < steps) {
                mbar_wait(&empty[s], (i / kDwStages) & 1);
                load_stage(i + kDwStages);
            }
        }
        // rows 16 warp + g (+ 8) of the chunk, columns 8 dt + 2 t (+ 1)
        float* p1 = part + (long long)blockIdx.y * (2LL * d * hd + hd + d);
        float* p2 = p1 + (long long)d * hd;
        const long long j = (long long)c * kChunk + 16 * warp + g;
#pragma unroll
        for (int dt = 0; dt < kDimTiles; ++dt) {
            const int col = dt * 8 + 2 * t;
            if (col >= d) break;
            p1[col * (long long)hd + j] = dw1t[dt][0];
            p1[(col + 1) * (long long)hd + j] = dw1t[dt][1];
            p1[col * (long long)hd + j + 8] = dw1t[dt][2];
            p1[(col + 1) * (long long)hd + j + 8] = dw1t[dt][3];
            *reinterpret_cast<float2*>(p2 + j * d + col) =
                make_float2(dw2[dt][0], dw2[dt][1]);
            *reinterpret_cast<float2*>(p2 + (j + 8) * d + col) =
                make_float2(dw2[dt][2], dw2[dt][3]);
        }
        // db2: the row groups of each column in order
        float* groups = red + kRecompute * kChunk;
        groups[tid] = db2;
        named_sync(2, kWgThreads);
        if (tid < w && db2_col < d) {
            float v = 0.f;
            for (int k = 0; k < db2_groups; ++k) v += groups[k * w + tid];
            p1[2LL * d * hd + hd + db2_col] = v;
        }
        return;
    }

    // recompute warpgroup wg: tiles wg, wg + kRecompute, ...
    uint32_t w1a[8][4], w2a[8][4];
    ldmatrix_a_mn_major(w1a, W1c);
    ldmatrix_a_k_major(w2a, W2c);
    // this thread's hidden columns: j0 = 16 warp + g and j0 + 8
    const int j0 = 16 * warp + g;
    const float bias[2] = {b1s[j0], b1s[j0 + 8]};
    float db1[2] = {0.f, 0.f};
    for (int i = wg; i < steps; i += kRecompute) {
        const int s = i % kDwStages, p = i % kPairs;
        mbar_wait(&full[s], (i / kDwStages) & 1);
        const char* X = ring + s * 2 * kTileBytes;
        const char* dO = X + kTileBytes;
        float ht[8][4], dht[8][4];      // (hidden column, row of the tile)
        wgmma_fence();
        issue_rs_k_major(ht, w1a, X);
        issue_rs_k_major(dht, w2a, dO);
        wgmma_commit();
        wgmma_wait(ht);
        wgmma_wait(dht);
        mbar_wait(&hempty[p], ((i / kPairs) & 1) ^ 1);
        char* Hs = pairs + p * 2 * kBoxBytes;
        char* dHs = Hs + kBoxBytes;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
            float hv[4], dv[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float x = ht[nt][e] + bias[e >> 1];
                const float th = gelu_tanh_of(x);
                hv[e] = gelu(x, th);
                dv[e] = gelu_grad(x, th) * dht[nt][e];
            }
            db1[0] += dv[0] + dv[1];
            db1[1] += dv[2] + dv[3];
            const int lo = swizzled(j0, nt) + 4 * t;
            const int hi = swizzled(j0 + 8, nt) + 4 * t;
            *reinterpret_cast<uint32_t*>(Hs + lo) = pack2(hv[0], hv[1]);
            *reinterpret_cast<uint32_t*>(Hs + hi) = pack2(hv[2], hv[3]);
            *reinterpret_cast<uint32_t*>(dHs + lo) = pack2(dv[0], dv[1]);
            *reinterpret_cast<uint32_t*>(dHs + hi) = pack2(dv[2], dv[3]);
        }
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(&hfull[p]);
    }
    // db1 over this thread's columns of the tiles (over t), then in order
    // over the recompute warpgroups
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        float v = db1[h];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (t == 0) red[wg * kChunk + j0 + 8 * h] = v;
    }
    named_sync(1, kRecompute * kWgThreads);
    if (threadIdx.x >= kChunk) return;
    float v = 0.f;
    for (int r = 0; r < kRecompute; ++r) v += red[r * kChunk + threadIdx.x];
    part[(long long)blockIdx.y * (2LL * d * hd + hd + d) + 2LL * d * hd
         + c * kChunk + threadIdx.x] = v;
}

// out[i] = sum over segments s (in order) of part[s * n + i]
__global__ void sum_segments_kernel(const float* __restrict__ part,
                                    float* __restrict__ out, long long n,
                                    int segments) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float s = 0.f;
    for (int k = 0; k < segments; ++k) s += part[(long long)k * n + i];
    out[i] = s;
}

// The tensor maps of x, do (M, d), W1 (d, hd) and W2 (hd, d): each a
// (1, rows, cols) tensor in boxes of 64 x 64. do may be null.
int make_maps(CUtensorMap* mx, CUtensorMap* mdo, CUtensorMap* mw1,
              CUtensorMap* mw2, const void* x, const void* dout,
              const void* w1, const void* w2, long long M, int d, int hd) {
    int err = make_map(mx, x, 1, (int)M, d, M * d, d);
    if (!err && dout) err = make_map(mdo, dout, 1, (int)M, d, M * d, d);
    if (!err) err = make_map(mw1, w1, 1, d, hd, (long long)d * hd, hd);
    if (!err) err = make_map(mw2, w2, 1, hd, d, (long long)hd * d, d);
    return err;
}

bool shape_ok(long long M, int d, int hd) {
    return M > 0 && M < (1LL << 31) - Rows<false>::kTile && d > 0
        && d <= kMaxD
        && d % 16 == 0 && hd > 0 && hd % kChunk == 0;
}

}  // namespace

extern "C" {

// The geometry the wrapper's launch plan assumes: {max d, hidden chunk,
// rows a block step of the forward kernel, of the dx kernel, rows a step
// of the weight-gradient kernel}.
void mrgcn_mlp_geometry(int* out) {
    out[0] = kMaxD;
    out[1] = kChunk;
    out[2] = Rows<false>::kTile;
    out[3] = Rows<true>::kTile;
    out[4] = kSegRows;
}

// x (M, d), w1 (d, hd), b1 (hd), w2 (hd, d), b2 (d), out (M, d):
// contiguous bf16, 16-byte aligned. `blocks` persistent blocks (at most
// the number of 128-row tiles). Returns a cudaError_t (0 on success).
int mrgcn_mlp_fwd_bf16(const void* x, const void* w1, const void* b1,
                       const void* w2, const void* b2, void* out,
                       long long M, int d, int hd, int blocks,
                       void* stream) {
    static bool done[64];
    if (!shape_ok(M, d, hd) || blocks < 1) return (int)cudaErrorInvalidValue;
    const size_t smem = Rows<false>::kBytes;
    int err = allow_smem((const void*)mlp_rows_kernel<false>, smem, done);
    if (err) return err;
    CUtensorMap mx, mw1, mw2;
    if ((err = make_maps(&mx, nullptr, &mw1, &mw2, x, nullptr, w1, w2, M, d,
                         hd)))
        return err;
    mlp_rows_kernel<false><<<blocks, Rows<false>::kThreads, smem,
                             (cudaStream_t)stream>>>(
        mx, mx, mw1, mw2, (const bf16*)b1, (const bf16*)b2, (bf16*)out, M, d,
        hd);
    return (int)cudaGetLastError();
}

// Backward. x, dout, dx (M, d); w1 (d, hd); w2 (hd, d); b1 (hd):
// contiguous bf16, 16-byte aligned. part: f32 scratch of segments x
// (2 d hd + hd + d); grads: f32 (2 d hd + hd + d) = [dW1 | dW2 | db1 | db2].
// Three launches on `stream`: dx (`blocks` persistent blocks), the
// weight partials of (hd / 64) x segments blocks over row segments of
// seg_rows rows (a multiple of 64; segments x seg_rows >= M), their sum.
int mrgcn_mlp_bwd_bf16(const void* x, const void* w1, const void* b1,
                       const void* w2, const void* dout, void* dx, void* part,
                       void* grads, long long M, int d, int hd, int blocks,
                       int segments, long long seg_rows, void* stream) {
    static bool done[2][64];
    if (!shape_ok(M, d, hd) || blocks < 1 || segments < 1
        || seg_rows % kSegRows || (long long)segments * seg_rows < M
        || (long long)(segments - 1) * seg_rows >= M)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const size_t smem = Rows<true>::kBytes;
    int err = allow_smem((const void*)mlp_rows_kernel<true>, smem, done[0]);
    if (err) return err;
    err = allow_smem((const void*)mlp_bwd_dw_kernel, kDwBytes, done[1]);
    if (err) return err;
    CUtensorMap mx, mdo, mw1, mw2;
    if ((err = make_maps(&mx, &mdo, &mw1, &mw2, x, dout, w1, w2, M, d, hd)))
        return err;
    mlp_rows_kernel<true><<<blocks, Rows<true>::kThreads, smem, s>>>(
        mx, mdo, mw1, mw2, (const bf16*)b1, nullptr, (bf16*)dx, M, d, hd);
    err = (int)cudaGetLastError();
    if (err) return err;
    mlp_bwd_dw_kernel<<<dim3(hd / kChunk, segments), kDwThreads, kDwBytes,
                        s>>>(mx, mdo, mw1, mw2, (const bf16*)b1, (float*)part,
                             M, d, hd, seg_rows);
    err = (int)cudaGetLastError();
    if (err) return err;
    const long long n = 2LL * d * hd + hd + d;
    sum_segments_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
        (const float*)part, (float*)grads, n, segments);
    return (int)cudaGetLastError();
}

const char* mrgcn_mlp_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

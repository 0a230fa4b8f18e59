// Fused attention core for Hopper (sm_90a), forward and backward, for the
// text encoder's sequences (up to 512 tokens, its tokenizer's limit), one
// head. Several heads (H > 1, kernel #12) run fused_attention_heads.cu,
// which repeats this file's arithmetic head by head.
//
// Forward, per sequence n and head h (q already multiplied by
// 1/sqrt(d), d the head's width):
//   s[i, j] = q[i] . k[j]            (bf16 inputs, f32 sums)
//   s[i, j] = -1e9 where key j is padding (valid[n, j] == 0)
//   p = softmax_j(s)                 (f32)
//   out[i] = sum_j p[i, j] v[j]      (p through bf16, f32 sums, stored bf16)
// Backward recomputes p, then
//   dv = bf16(p)^T do, dp = do v^T, ds = p (dp - rowsum(dp p)),
//   ds = 0 at padding keys, dq = bf16(ds) k, dk = bf16(ds)^T q.
//
// Replaces: mrgcn_tpu/ops/attention.py::_fwd_kernel and ::_bwd_kernel (the
// TPU kernels behind fused_attention, single-head). Those run G = 8
// sequences per step of an in-order grid with the (L, L) probabilities
// held in VMEM, and pad L and d to 128 and N to a multiple of 8. It is
// also the one-head case of mrgcn_tpu/models/encoders.py::
// _flash_attention_fn (every MRGCN path builds one head).
//
// Layout: q, k, v (and dout) are (N, L, d), or (N, L, 1, d) as flax lays
// a head out, read by strides through 4-d tensor maps, no permute copy;
// out, dq, dk, dv are written in the same contiguous layout. The grid
// walks (sequence, head, row tile); the wrapper hands it H = 1. A head
// narrower than 128 columns is filled with zeros by the copy engine, and
// the score products take only the 16-column steps that hold any of it:
// the kernels are templates on that count (KS = 1, 2, 4, 8 for d up to
// 16, 32, 64, 128), as a bound known only at run time kept ptxas from
// issuing a chain's wgmma back to back (#7 at one head 17-34 % slower on
// the H100). The second products run over all 128 columns.
//
// Masking follows the plain chain (xla_attention): a padding key's logit
// is replaced by -1e9, not offset by it, so a sequence whose keys are all
// padding gets an exactly uniform softmax over its L keys, and its logit
// gradient at padding keys is zero. Keys past L do not exist: ragged L and
// d are masked here, not padded by the caller.
//
// What bounds it on the card: at the text encoder's shapes (N = 8,000
// sequences, L = d = 128, bf16) the forward moves 3 x 32 KB in and 32 KB
// out per sequence for 8.4 MFLOP, about 64 FLOP per byte, below the
// H100's ~295 FLOP/byte ridge: memory and latency bound, not tensor bound.
// So the design spends tensor work (scores are recomputed, nine products
// in the backward where five would do) to keep every (L, L) tensor on
// the chip, and its first concern is how the bytes reach shared memory.
//
// The design: one tiled family for every 1 <= L <= 512, three kernels.
// No second family remains: the kernels that held a whole sequence of
// L <= 128 in one block (synchronous loads, mma.sync from 16- and 32-bit
// shared loads) took 0.98-1.02 ms forward / 4.4-4.8 ms backward at
// N = 8,000, L = d = 128 where this family takes 0.35-0.39 / 1.04-1.09, and
// the exact-pass kernels for 128 < L <= 512 took 7.1 / 23.7-24.0 ms at
// N = 2,000, L = 512 where it takes 0.48-0.52 / 2.0 (H100 80GB HBM3, 700 W).
//  * Tiles of 64 rows x 128 columns arrive by TMA (cp.async.bulk.tensor,
//    two boxes of 64 columns a tile, issued by one thread, completing on
//    an mbarrier): the copy engine computes the addresses, writes the
//    128-byte swizzle the tensor cores read, and fills rows past L and
//    columns past d with zeros. Loads issued by the threads themselves
//    (cp.async, 16 bytes a thread) filled shared memory at no more than
//    about 2.5 TB/s whatever the source, device memory or L2, and held
//    the forward at 0.51 ms where TMA gives 0.35 (H100 80GB HBM3, 700 W).
//    The tensor maps are built on the host per call
//    (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint: no -lcuda).
//  * A thread block owns 64 rows of one sequence a warpgroup and walks
//    the other side in tiles of 64 rows through a two-stage ring: tile
//    i + 1 (and i + 2, once tile i's stage is free) is in flight while
//    tile i is multiplied. Two blocks (about 98 KB each) share an SM.
//  * Products are wgmma.mma_async m64nNk16 bf16 -> f32: the tensor cores
//    read both operands of s = q k^T (and of dp = do v^T, s^T = k q^T, dp^T
//    = v do^T) from shared memory once a warpgroup; the second product of
//    each chain (p v, ds k, p^T do, ds^T q) takes its A operand from
//    registers, where the first product's accumulator already has the
//    layout, and its B operand from the same tile read MN-major
//    (transposed by the descriptor, not by the threads).
//  * Key tiles whose keys are all padding are not loaded, scored or
//    multiplied: a block finds the tiles with a valid key from the mask
//    (a ballot per 32 keys). Their probabilities are exactly 0 wherever
//    the sequence has one valid key. A sequence with no valid key walks
//    every tile (the uniform softmax). In the backward, the dk / dv rows
//    of a skipped key tile are written as zeros. A tile whose 64 keys are
//    all valid skips the masking arithmetic.
//  * Forward: two warpgroups (128 query rows) a block, also where L <= 64
//    (the second then multiplies nothing; a 64-row block was no faster
//    there); online softmax over the key tiles (running max and sum in log2
//    units: ex2 on logits scaled by log2 e, one reciprocal a row).
//  * Backward, dq kernel: one warpgroup; it walks the live key tiles
//    twice. Walk 1 sums each row's max, sum and D = rowsum(dp p) online;
//    walk 2 forms ds and dq += ds k. With at most two live tiles (every
//    L <= 128) both stay in the ring and walk 2 loads nothing. D is summed
//    from the same dp the second walk meets, so a row with one valid key
//    has ds = 0 exactly, as the plain version has. Each row's (max,
//    1 / sum, D) goes to f32 scratch (3, N H, L).
//  * Backward, dk / dv kernel: key-major. It owns 64 key rows and walks
//    all query tiles with their rows' statistics, recomputes s^T = k q^T
//    and dp^T = v do^T 32 queries at a time, and so holds p^T and ds^T in
//    registers in the layout dv += p^T do and dk += ds^T q take as their A
//    operand: nothing is transposed through shared memory.
//  * Output tiles are staged in shared memory (over an operand tile, XOR
//    swizzled) and stored 16 bytes a thread along d.
//  * Deterministic: every output element is summed by one thread in a
//    fixed order; no atomics on device memory.
//  * Limits: L <= 512, d <= 128 and a multiple of 8 (the wrapper checks).
//    Heads: H >= 1 here; the wrapper sends only H = 1.

#include <math.h>

#include "hopper.cuh"

namespace {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int kWarps = 4;              // one warpgroup
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;              // rows of a tile
constexpr int kStages = 2;             // tile pairs in the ring
constexpr int kMaxL = 512;             // the text encoder's max_len
constexpr int kMaxTiles = kMaxL / kTile;
constexpr int kMaxD = 128;             // columns of a tile
constexpr int kDimTiles = kMaxD / 8;
// A tile in shared memory is two boxes of 64 rows x 64 columns (128 bytes
// a row), each in the 128-byte swizzle (hopper.cuh)
constexpr int kTileBytes = 2 * kBoxBytes;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMasked = -1e9f * kLog2e;   // a padding key's logit, log2 units

// s = X[rows 0..63] Y[rows y0..y0+8 NT-1]^T over the tiles' first 16 KS
// columns (the others hold zeros)
template <int NT, int KS>
__device__ __forceinline__ void issue_scores(float (&s)[NT][4], const char* X,
                                             const char* Y, int y0) {
    static_assert(NT == 8 || NT == 4, "64 or 32 columns");
    static_assert(KS >= 1 && KS <= kMaxD / 16, "1 to 8 k steps");
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
        if constexpr (NT == 8)
            wgmma_ss_n64(s, desc_k_major(X, 0, kk), desc_k_major(Y, y0, kk),
                         kk > 0);
        else
            wgmma_ss_n32(s, desc_k_major(X, 0, kk), desc_k_major(Y, y0, kk),
                         kk > 0);
    }
}

// ---- softmax pieces -----------------------------------------------------------

__device__ __forceinline__ float quad_max(float x) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// What a block knows of its sequence's keys
struct KeyPlan {
    int count;          // key tiles to walk: tiles[0..count)
    unsigned walked;    // the same as a bit mask
    unsigned full;      // tiles whose 64 keys are all valid
};

// key_ok[j] for the keys of one sequence, rounded up to whole tiles: 1
// valid, 0 padding, -1 past the end. tiles[] lists the key tiles to walk,
// in order: those with a valid key, or all of them where the sequence has
// none. bits[0] and bits[1] are scratch. Every thread of the block calls
// it (it synchronises).
__device__ __forceinline__ KeyPlan plan_key_tiles(signed char* key_ok,
                                                  int* tiles, unsigned* bits,
                                                  const uint8_t* valid,
                                                  int L) {
    if (threadIdx.x == 0) {
        bits[0] = 0u;
        bits[1] = 0xffffffffu;
    }
    __syncthreads();
    const int T = (L + kTile - 1) / kTile;
    for (int j = threadIdx.x; j < T * kTile; j += blockDim.x) {
        const int ok = j < L ? (valid[j] ? 1 : 0) : -1;
        key_ok[j] = (signed char)ok;
        const unsigned any = __ballot_sync(0xffffffffu, ok > 0);
        if ((threadIdx.x & 31) == 0) {
            if (any) atomicOr(&bits[0], 1u << (j / kTile));
            if (~any) atomicAnd(&bits[1], ~(1u << (j / kTile)));
        }
    }
    __syncthreads();
    KeyPlan plan;
    plan.walked = bits[0] ? bits[0] : (1u << T) - 1u;
    plan.full = bits[1];
    plan.count = __popc(plan.walked);
    if (threadIdx.x == 0) {
        int count = 0;
        for (int t = 0; t < T; ++t)
            if ((plan.walked >> t) & 1u) tiles[count++] = t;
    }
    __syncthreads();
    return plan;
}

// Logit in log2 units of score x at a key whose status is ok: a padding
// key's is -1e9 (scaled), a key's past the end -inf.
__device__ __forceinline__ float logit2(float x, int ok) {
    return ok > 0 ? x * kLog2e : (ok == 0 ? kMasked : -INFINITY);
}

// Scores of a 64-key tile -> what prob() takes, and the rows' maxima in
// log2 units into mt. Full (every key valid): the scores stay as they
// are. Else they become masked logits in log2 units, so that a row of
// padding keys alone has the same logit at each and a uniform softmax.
// `ok` points at the status of the key of this thread's first column.
template <bool Full, int NT>
__device__ __forceinline__ void tile_logits(float (&s)[NT][4],
                                            const signed char* ok,
                                            float (&mt)[2]) {
    mt[0] = mt[1] = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
        int ok0 = 1, ok1 = 1;
        if (!Full) {
            ok0 = ok[nt * 8];
            ok1 = ok[nt * 8 + 1];
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            if (!Full) s[nt][e] = logit2(s[nt][e], e & 1 ? ok1 : ok0);
            mt[e >> 1] = fmaxf(mt[e >> 1], s[nt][e]);
        }
    }
    if (Full) {
        mt[0] *= kLog2e;
        mt[1] *= kLog2e;
    }
}

// exp2(logit - m) from what tile_logits left
template <bool Full>
__device__ __forceinline__ float prob(float x, float m) {
    return Full ? ex2(fmaf(x, kLog2e, -m)) : ex2(x - m);
}

// The warpgroup's 64 rows of acc (each times scale[row half]) as bf16 into
// a shared tile no product reads any more (rows of 256 bytes, the 16-byte
// chunk c of row r at chunk c ^ (r % 8)), then to rows row0.. of an
// (L, d) matrix, 16 bytes a thread. A warp writes and reads
// back only its own 16 rows. Rows of dst are ld elements apart.
__device__ __forceinline__ void store_rows(bf16* dst, char* S,
                                           const float (&acc)[kDimTiles][4],
                                           float scale0, float scale1,
                                           int row0, int L, int d,
                                           long long ld) {
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    char* mine = S + 16 * warp * 256;          // rows 16 warp .. + 15
#pragma unroll
    for (int dt = 0; dt < kDimTiles; ++dt) {
        char* p = mine + g * 256 + ((dt ^ g) << 4) + t * 4;
        *reinterpret_cast<uint32_t*>(p) =
            pack2(acc[dt][0] * scale0, acc[dt][1] * scale0);
        *reinterpret_cast<uint32_t*>(p + 8 * 256) =
            pack2(acc[dt][2] * scale1, acc[dt][3] * scale1);
    }
    __syncwarp();
#pragma unroll
    for (int i = lane; i < 16 * kDimTiles; i += 32) {
        const int rl = ((i >> 7) << 3) + (i & 7);
        const int c = (i >> 3) & 15;
        const int r = row0 + 16 * warp + rl;
        if (r < L && c * 8 < d)
            *reinterpret_cast<uint4*>(dst + (long long)r * ld + c * 8) =
                *reinterpret_cast<const uint4*>(
                    mine + rl * 256 + ((c ^ (rl & 7)) << 4));
    }
}

// One key tile of the forward for a warpgroup's 64 query rows (tile Qw):
// scores against Ks, the online softmax update of (m, l) and of the
// accumulator o, then o += p Vs. First: nothing is accumulated yet.
template <bool Full, int KS>
__device__ __forceinline__ void forward_tile(float (&o)[kDimTiles][4],
                                             float (&m)[2], float (&l)[2],
                                             const char* Qw, const char* Ks,
                                             const char* Vs,
                                             const signed char* ok,
                                             bool first) {
    float s[kTile / 8][4];
    wgmma_fence();
    issue_scores<kTile / 8, KS>(s, Qw, Ks, 0);
    wgmma_commit();
    wgmma_wait(s);
    float mt[2];
    tile_logits<Full>(s, ok, mt);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        // every walked tile has a key inside the sequence, so the new max
        // is finite
        const float mn = fmaxf(m[h], quad_max(mt[h]));
        if (!first) {
            const float alpha = ex2(m[h] - mn);
            l[h] *= alpha;
#pragma unroll
            for (int dt = 0; dt < kDimTiles; ++dt) {
                o[dt][2 * h] *= alpha;
                o[dt][2 * h + 1] *= alpha;
            }
        }
        m[h] = mn;
    }
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float p = prob<Full>(s[nt][e], m[e >> 1]);
            s[nt][e] = p;
            l[e >> 1] += p;
        }
    }
    uint32_t pa[kTile / 16][4];
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) to_a(pa[kk], s, kk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
        wgmma_rs_n128(o, pa[kk], desc_mn_major(Vs, kk * 16), 1);
    wgmma_commit();
    wgmma_wait(o);
}

// ---------------------------------------------------------------------------
// Forward: a block of two warpgroups owns 128 query rows of one head of
// one sequence (64 a warpgroup) and walks the live key tiles with an
// online softmax. KS: the score products' k steps (16 columns each).
// ---------------------------------------------------------------------------
constexpr int kFwdWarpgroups = 2;
template <int KS>
__global__ void __launch_bounds__(kFwdWarpgroups * kThreads, 2)
attention_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const uint8_t* __restrict__ valid,
                     bf16* __restrict__ out, int L, int H, int d,
                     int row_tiles) {
    const int seq = blockIdx.x / row_tiles;      // (sequence, head)
    const int n = seq / H, h = seq % H;
    const int q0 = (blockIdx.x % row_tiles) * (kFwdWarpgroups * kTile);
    extern __shared__ __align__(1024) char smem[];
    char* Qs = smem;                   // a tile a warpgroup
    // stage s of the ring: a K tile, then a V tile
    char* ring = Qs + kFwdWarpgroups * kTileBytes;
    signed char* key_ok =
        reinterpret_cast<signed char*>(ring + kStages * 2 * kTileBytes);
    __shared__ int tiles[kMaxTiles];
    __shared__ unsigned bits[2];
    __shared__ __align__(8) uint64_t bars[1 + kStages];   // Q, the stages

    if (threadIdx.x == 0) {
#pragma unroll
        for (int b = 0; b < 1 + kStages; ++b) mbar_init(&bars[b], 1);
        mbar_init_fence();
        mbar_expect(&bars[0], kFwdWarpgroups * kTileBytes);
#pragma unroll
        for (int w = 0; w < kFwdWarpgroups; ++w)
            load_tile_head(Qs + w * kTileBytes, &map_q, &bars[0],
                           q0 + w * kTile, n, h);
    }
    // (its barriers order the other threads after the initialisation)
    const KeyPlan plan =
        plan_key_tiles(key_ok, tiles, bits, valid + (long long)n * L, L);
    // step i takes stage i % 2, that stage's use i / 2
    auto issue = [&](int i) {
        if (i < plan.count && threadIdx.x == 0) {
            char* Ks = ring + (i & 1) * 2 * kTileBytes;
            uint64_t* bar = &bars[1 + (i & 1)];
            mbar_expect(bar, 2 * kTileBytes);
            load_tile_head(Ks, &map_k, bar, tiles[i] * kTile, n, h);
            load_tile_head(Ks + kTileBytes, &map_v, bar, tiles[i] * kTile, n,
                           h);
        }
    };
    issue(0);
    issue(1);

    const int t = threadIdx.x & 3;
    const int wg = threadIdx.x / kThreads;
    char* Qw = Qs + wg * kTileBytes;
    // a warpgroup whose rows are all past L multiplies nothing
    const bool active = q0 + wg * kTile < L;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    float o[kDimTiles][4];
#pragma unroll
    for (int dt = 0; dt < kDimTiles; ++dt)
        o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;

    mbar_wait(&bars[0], 0);
    for (int i = 0; i < plan.count; ++i) {
        mbar_wait(&bars[1 + (i & 1)], (i >> 1) & 1);
        if (active) {
            const char* Ks = ring + (i & 1) * 2 * kTileBytes;
            const signed char* ok = key_ok + tiles[i] * kTile + 2 * t;
            if ((plan.full >> tiles[i]) & 1u)
                forward_tile<true, KS>(o, m, l, Qw, Ks, Ks + kTileBytes, ok,
                                       i == 0);
            else
                forward_tile<false, KS>(o, m, l, Qw, Ks, Ks + kTileBytes, ok,
                                        i == 0);
        }
        __syncthreads();               // the stage is free
        issue(i + 2);
    }
    if (!active) return;
    const float inv0 = 1.f / quad_sum(l[0]);
    const float inv1 = 1.f / quad_sum(l[1]);
    store_rows(out + ((long long)n * L * H + h) * d, Qw, o, inv0, inv1,
               q0 + wg * kTile, L, d, (long long)H * d);
}

// One key tile of the dq kernel's first walk: the rows' running max, sum
// and D = sum of p dp, online
template <bool Full>
__device__ __forceinline__ void stats_tile(float (&m)[2], float (&l)[2],
                                           float (&D)[2],
                                           float (&sc)[kTile / 8][4],
                                           const float (&dp)[kTile / 8][4],
                                           const signed char* ok,
                                           bool first) {
    float mt[2];
    tile_logits<Full>(sc, ok, mt);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const float mn = fmaxf(m[h], quad_max(mt[h]));
        if (!first) {
            const float alpha = ex2(m[h] - mn);
            l[h] *= alpha;
            D[h] *= alpha;
        }
        m[h] = mn;
    }
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float p = prob<Full>(sc[nt][e], m[e >> 1]);
            l[e >> 1] += p;
            D[e >> 1] += p * dp[nt][e];
        }
    }
}

// ds = p (dp - D), 0 at padding keys, into dp. Rows: m, inv, D belong to
// the accumulator's rows (dq kernel). The scores are consumed.
template <bool Full>
__device__ __forceinline__ void ds_tile_rows(float (&sc)[kTile / 8][4],
                                             float (&dp)[kTile / 8][4],
                                             const float (&m)[2],
                                             const float (&inv)[2],
                                             const float (&D)[2],
                                             const signed char* ok) {
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
        int ok0 = 1, ok1 = 1;
        if (!Full) {
            ok0 = ok[nt * 8];
            ok1 = ok[nt * 8 + 1];
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int h = e >> 1;
            const int oke = e & 1 ? ok1 : ok0;
            const float x = Full ? sc[nt][e] : logit2(sc[nt][e], oke);
            const float p = prob<Full>(x, m[h]) * inv[h];
            dp[nt][e] = oke > 0 ? p * (dp[nt][e] - D[h]) : 0.f;
        }
    }
}

// ---------------------------------------------------------------------------
// Backward, dq: a block owns 64 query rows of one head of one sequence and
// walks the live key tiles twice: first each row's max, sum and D, then ds
// and dq. The rows' (max, 1 / sum, D) go to stats (3, N H, L) for the
// dk / dv kernel.
// ---------------------------------------------------------------------------
template <int KS>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_do,
                        const uint8_t* __restrict__ valid,
                        bf16* __restrict__ dq, float* __restrict__ stats,
                        int N, int L, int H, int d, int row_tiles) {
    const int seq = blockIdx.x / row_tiles;      // (sequence, head)
    const int n = seq / H, h = seq % H;
    const int q0 = (blockIdx.x % row_tiles) * kTile;
    const long long NH = (long long)N * H;
    extern __shared__ __align__(1024) char smem[];
    char* Qs = smem;
    char* dOs = Qs + kTileBytes;
    char* ring = dOs + kTileBytes;     // stage s: K tile, then V tile
    signed char* key_ok =
        reinterpret_cast<signed char*>(ring + kStages * 2 * kTileBytes);
    __shared__ int tiles[kMaxTiles];
    __shared__ unsigned bits[2];
    __shared__ __align__(8) uint64_t bars[1 + kStages];   // Q and dO, stages

    if (threadIdx.x == 0) {
#pragma unroll
        for (int b = 0; b < 1 + kStages; ++b) mbar_init(&bars[b], 1);
        mbar_init_fence();
        mbar_expect(&bars[0], 2 * kTileBytes);
        load_tile_head(Qs, &map_q, &bars[0], q0, n, h);
        load_tile_head(dOs, &map_do, &bars[0], q0, n, h);
    }
    const KeyPlan plan =
        plan_key_tiles(key_ok, tiles, bits, valid + (long long)n * L, L);
    const int count = plan.count;
    // step s of the two walks meets tile s % count; up to kStages tiles
    // stay where the first walk put them
    const int steps = 2 * count;
    const bool resident = count <= kStages;
    auto loads = [&](int s) { return s < steps && (!resident || s < count); };
    // a loading step s takes stage s % 2, that stage's use s / 2
    auto issue = [&](int s) {
        if (loads(s) && threadIdx.x == 0) {
            const int i = s < count ? s : s - count;
            char* Ks = ring + (s & 1) * 2 * kTileBytes;
            uint64_t* bar = &bars[1 + (s & 1)];
            mbar_expect(bar, 2 * kTileBytes);
            load_tile_head(Ks, &map_k, bar, tiles[i] * kTile, n, h);
            load_tile_head(Ks + kTileBytes, &map_v, bar, tiles[i] * kTile, n,
                           h);
        }
    };
    issue(0);
    issue(1);

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;

    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};           // the sum, then its reciprocal
    float D[2] = {0.f, 0.f};
    float acc[kDimTiles][4];
#pragma unroll
    for (int dt = 0; dt < kDimTiles; ++dt)
        acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

    mbar_wait(&bars[0], 0);
    for (int s = 0; s < steps; ++s) {
        if (loads(s)) mbar_wait(&bars[1 + (s & 1)], (s >> 1) & 1);
        if (s == count) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                l[r] = 1.f / quad_sum(l[r]);
                D[r] = quad_sum(D[r]) * l[r];
            }
        }
        const int i = s < count ? s : s - count;
        const int stage = resident ? i : (s & 1);
        const char* Ks = ring + stage * 2 * kTileBytes;
        const char* Vs = Ks + kTileBytes;
        const signed char* ok = key_ok + tiles[i] * kTile + 2 * t;
        const bool full = (plan.full >> tiles[i]) & 1u;
        float sc[kTile / 8][4], dp[kTile / 8][4];
        wgmma_fence();
        issue_scores<kTile / 8, KS>(sc, Qs, Ks, 0);
        issue_scores<kTile / 8, KS>(dp, dOs, Vs, 0);
        wgmma_commit();
        wgmma_wait(sc);
        wgmma_wait(dp);
        if (s < count) {
            if (full) stats_tile<true>(m, l, D, sc, dp, ok, s == 0);
            else stats_tile<false>(m, l, D, sc, dp, ok, s == 0);
        } else {
            if (full) ds_tile_rows<true>(sc, dp, m, l, D, ok);
            else ds_tile_rows<false>(sc, dp, m, l, D, ok);
            uint32_t da[kTile / 16][4];
#pragma unroll
            for (int kk = 0; kk < kTile / 16; ++kk) to_a(da[kk], dp, kk);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kTile / 16; ++kk)
                wgmma_rs_n128(acc, da[kk], desc_mn_major(Ks, kk * 16), 1);
            wgmma_commit();
            wgmma_wait(acc);
        }
        __syncthreads();               // the stage is free
        issue(s + 2);
    }
    if (t == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int row = q0 + 16 * warp + g + 8 * r;
            if (row < L) {
                const long long i = (long long)seq * L + row;
                stats[i] = m[r];
                stats[NH * L + i] = l[r];
                stats[2 * NH * L + i] = D[r];
            }
        }
    }
    store_rows(dq + ((long long)n * L * H + h) * d, Qs, acc, 1.f, 1.f, q0, L,
               d, (long long)H * d);
}

// p^T into sc and ds^T into dp for 32 query columns of the key-major
// kernel: the statistics st (max, 1 / sum, D of the tile's 64 query
// rows; a row past L has max 0 and 1 / sum 0) belong to the columns, the
// key status ok0 / ok1 to this thread's two rows.
template <bool Full>
__device__ __forceinline__ void ds_tile_columns(float (&sc)[4][4],
                                                float (&dp)[4][4],
                                                const float* st, int ok0,
                                                int ok1) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
        const float2 mj = *reinterpret_cast<const float2*>(st + nt * 8);
        const float2 ij =
            *reinterpret_cast<const float2*>(st + kTile + nt * 8);
        const float2 Dj =
            *reinterpret_cast<const float2*>(st + 2 * kTile + nt * 8);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int oke = e >> 1 ? ok1 : ok0;
            const float x = Full ? sc[nt][e] : logit2(sc[nt][e], oke);
            const float p = prob<Full>(x, e & 1 ? mj.y : mj.x)
                          * (e & 1 ? ij.y : ij.x);
            sc[nt][e] = p;
            dp[nt][e] =
                oke > 0 ? p * (dp[nt][e] - (e & 1 ? Dj.y : Dj.x)) : 0.f;
        }
    }
}

// ---------------------------------------------------------------------------
// Backward, dk and dv: key-major. A block owns 64 key rows of one head of
// one sequence and walks all query tiles with their (max, 1 / sum, D) from
// stats: s^T = k q^T and dp^T = v do^T give p^T and ds^T in registers, the
// A operands of dv += p^T do and dk += ds^T q. A key tile without a valid
// key (in a sequence that has one) gets zeros.
// ---------------------------------------------------------------------------
template <int KS>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkv_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_do,
                         const uint8_t* __restrict__ valid,
                         const float* __restrict__ stats,
                         bf16* __restrict__ dk, bf16* __restrict__ dv,
                         int N, int L, int H, int d, int row_tiles) {
    const int seq = blockIdx.x / row_tiles;      // (sequence, head)
    const int n = seq / H, h = seq % H;
    const int kt = blockIdx.x % row_tiles;
    const long long NH = (long long)N * H;
    const long long ld = (long long)H * d;      // row stride of dk, dv
    const int k0 = kt * kTile;
    extern __shared__ __align__(1024) char smem[];
    char* Ks = smem;
    char* Vs = Ks + kTileBytes;
    char* ring = Vs + kTileBytes;      // stage s: Q tile, then dO tile
    float* rowstats =                  // stage s: max, 1 / sum, D of 64 rows
        reinterpret_cast<float*>(ring + kStages * 2 * kTileBytes);
    signed char* key_ok =
        reinterpret_cast<signed char*>(rowstats + kStages * 3 * kTile);
    __shared__ int tiles[kMaxTiles];
    __shared__ unsigned bits[2];
    __shared__ __align__(8) uint64_t bars[1 + kStages];   // K and V, stages

    if (threadIdx.x == 0) {
#pragma unroll
        for (int b = 0; b < 1 + kStages; ++b) mbar_init(&bars[b], 1);
        mbar_init_fence();
    }
    const KeyPlan plan =
        plan_key_tiles(key_ok, tiles, bits, valid + (long long)n * L, L);
    const long long base = (long long)n * L * ld + (long long)h * d;
    if (!((plan.walked >> kt) & 1u)) {
        const int vecs = d >> 3;
        const int rows = min(kTile, L - k0);
        const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
        for (int i = threadIdx.x; i < rows * vecs; i += kThreads) {
            const long long at = base + (long long)(k0 + i / vecs) * ld
                               + (long long)(i % vecs) * 8;
            *reinterpret_cast<uint4*>(dk + at) = zero;
            *reinterpret_cast<uint4*>(dv + at) = zero;
        }
        return;
    }

    // step s takes stage s % 2, that stage's use s / 2
    auto issue = [&](int s) {
        if (s < row_tiles && threadIdx.x == 0) {
            char* Qt = ring + (s & 1) * 2 * kTileBytes;
            uint64_t* bar = &bars[1 + (s & 1)];
            mbar_expect(bar, 2 * kTileBytes);
            load_tile_head(Qt, &map_q, bar, s * kTile, n, h);
            load_tile_head(Qt + kTileBytes, &map_do, bar, s * kTile, n, h);
        }
    };
    if (threadIdx.x == 0) {
        mbar_expect(&bars[0], 2 * kTileBytes);
        load_tile_head(Ks, &map_k, &bars[0], k0, n, h);
        load_tile_head(Vs, &map_v, &bars[0], k0, n, h);
    }
    issue(0);
    issue(1);
    // The query rows' statistics go through registers a step ahead of
    // their use: thread i carries values i and i + 128 of a tile's 3 x 64
    // (0 for rows past L).
    float ahead[2];
    auto read_stats = [&](int s) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int i = threadIdx.x + r * kThreads;
            const int row = s * kTile + (i & (kTile - 1));
            ahead[r] = i < 3 * kTile && s < row_tiles && row < L
                ? stats[(i / kTile) * NH * L + (long long)seq * L + row]
                : 0.f;
        }
    };
    auto write_stats = [&](int s) {
        float* st = rowstats + (s & 1) * 3 * kTile;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int i = threadIdx.x + r * kThreads;
            if (i < 3 * kTile) st[i] = ahead[r];
        }
    };
    read_stats(0);
    write_stats(0);
    read_stats(1);

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int ok0 = key_ok[k0 + 16 * warp + g];
    const int ok1 = key_ok[k0 + 16 * warp + g + 8];
    const bool full = (plan.full >> kt) & 1u;

    float dva[kDimTiles][4], dka[kDimTiles][4];
#pragma unroll
    for (int dt = 0; dt < kDimTiles; ++dt) {
        dva[dt][0] = dva[dt][1] = dva[dt][2] = dva[dt][3] = 0.f;
        dka[dt][0] = dka[dt][1] = dka[dt][2] = dka[dt][3] = 0.f;
    }

    __syncthreads();                   // the first tile's statistics
    mbar_wait(&bars[0], 0);
    for (int s = 0; s < row_tiles; ++s) {
        mbar_wait(&bars[1 + (s & 1)], (s >> 1) & 1);
        const char* Qt = ring + (s & 1) * 2 * kTileBytes;
        const char* dOt = Qt + kTileBytes;
        const float* st = rowstats + (s & 1) * 3 * kTile + 2 * t;
        // 32 query rows at a time: keys (rows) x queries (columns)
#pragma unroll 1
        for (int c0 = 0; c0 < kTile; c0 += 32) {
            float sc[4][4], dp[4][4];
            wgmma_fence();
            issue_scores<4, KS>(sc, Ks, Qt, c0);
            issue_scores<4, KS>(dp, Vs, dOt, c0);
            wgmma_commit();
            wgmma_wait(sc);
            wgmma_wait(dp);
            if (full) ds_tile_columns<true>(sc, dp, st + c0, ok0, ok1);
            else ds_tile_columns<false>(sc, dp, st + c0, ok0, ok1);
            uint32_t pa[2][4], da[2][4];
#pragma unroll
            for (int kk = 0; kk < 2; ++kk) {
                to_a(pa[kk], sc, kk);
                to_a(da[kk], dp, kk);
            }
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 2; ++kk) {
                wgmma_rs_n128(dva, pa[kk],
                              desc_mn_major(dOt, c0 + kk * 16), 1);
                wgmma_rs_n128(dka, da[kk],
                              desc_mn_major(Qt, c0 + kk * 16), 1);
            }
            wgmma_commit();
            wgmma_wait(dva);
            wgmma_wait(dka);
        }
        write_stats(s + 1);            // the other stage's: read a step ago
        read_stats(s + 2);
        __syncthreads();               // the stage is free
        issue(s + 2);
    }
    store_rows(dv + base, Vs, dva, 1.f, 1.f, k0, L, d, ld);
    store_rows(dk + base, Ks, dka, 1.f, 1.f, k0, L, d, ld);
}

// Shared memory of a block: `resident` resident tiles, the ring of kStages
// pairs of tiles, `extra` bytes, the keys' status.
size_t block_smem(int resident, int extra) {
    return (size_t)(resident + kStages * 2) * kTileBytes + extra + kMaxL;
}

// the kernels' limits (the wrapper raises on them with a message)
bool shape_ok(int N, int L, int H, int d) {
    return N > 0 && L > 0 && L <= kMaxL && H > 0 && d > 0 && d <= kMaxD
        && d % 8 == 0;
}

// The tensor maps of q, k, v: (N, L, H, d) with element strides
// s[0..2] = (over N, over L, over H), s[3..5] for k, s[6..8] for v
int make_qkv_maps(CUtensorMap* mq, CUtensorMap* mk, CUtensorMap* mv,
                  const void* q, const void* k, const void* v, int N, int L,
                  int H, int d, const long long* s) {
    int err = make_map_heads(mq, q, N, L, H, d, s[0], s[1], s[2]);
    if (!err) err = make_map_heads(mk, k, N, L, H, d, s[3], s[4], s[5]);
    if (!err) err = make_map_heads(mv, v, N, L, H, d, s[6], s[7], s[8]);
    return err;
}

template <int KS>
int launch_fwd(const CUtensorMap& mq, const CUtensorMap& mk,
               const CUtensorMap& mv, const void* valid, void* out, int N,
               int L, int H, int d, cudaStream_t stream) {
    static bool done[64];
    const size_t smem = block_smem(kFwdWarpgroups, 0);
    int err = allow_smem((const void*)attention_fwd_kernel<KS>, smem, done);
    if (err) return err;
    const int rows = kFwdWarpgroups * kTile;
    const int row_tiles = (L + rows - 1) / rows;
    attention_fwd_kernel<KS><<<(unsigned)N * H * row_tiles,
                               kFwdWarpgroups * kThreads, smem, stream>>>(
        mq, mk, mv, (const uint8_t*)valid, (bf16*)out, L, H, d, row_tiles);
    return (int)cudaGetLastError();
}

template <int KS>
int launch_bwd(const CUtensorMap& mq, const CUtensorMap& mk,
               const CUtensorMap& mv, const CUtensorMap& mdo,
               const void* valid, void* dq, void* dk, void* dv, void* stats,
               int N, int L, int H, int d, cudaStream_t stream) {
    static bool done[2][64];
    const size_t smem = block_smem(2, kStages * 3 * kTile * sizeof(float));
    int err = allow_smem((const void*)attention_bwd_dq_kernel<KS>, smem,
                         done[0]);
    if (err) return err;
    err = allow_smem((const void*)attention_bwd_dkv_kernel<KS>, smem,
                     done[1]);
    if (err) return err;
    const int row_tiles = (L + kTile - 1) / kTile;
    const unsigned grid = (unsigned)N * H * row_tiles;
    attention_bwd_dq_kernel<KS><<<grid, kThreads, smem, stream>>>(
        mq, mk, mv, mdo, (const uint8_t*)valid, (bf16*)dq, (float*)stats, N,
        L, H, d, row_tiles);
    err = (int)cudaGetLastError();
    if (err) return err;
    attention_bwd_dkv_kernel<KS><<<grid, kThreads, smem, stream>>>(
        mq, mk, mv, mdo, (const uint8_t*)valid, (const float*)stats,
        (bf16*)dk, (bf16*)dv, N, L, H, d, row_tiles);
    return (int)cudaGetLastError();
}

// the score products' k steps for head width d: 16 columns a step, rounded
// up to 1, 2, 4 or 8 (the columns past d are zeros)
int k_steps(int d) {
    const int ks = (d + 15) / 16;
    return ks <= 1 ? 1 : ks <= 2 ? 2 : ks <= 4 ? 4 : 8;
}

}  // namespace

extern "C" {

// f32 scratch the backward needs: each row's (max, 1 / sum, D) for every
// (sequence, head)
long long mrgcn_attention_bwd_scratch_floats(int N, int L, int H) {
    return 3LL * N * L * H;
}

// q, k, v: (N, L, H, d) bf16 with element strides `strides` (q's over N,
// L and H, then k's, then v's; multiples of 8), a contiguous last dim and a
// 16-byte aligned start; valid: (N, L) uint8; out: contiguous (N, L, H, d).
// One block of two warpgroups per (sequence, head, 128 query rows).
// Launches on `stream`; returns a cudaError_t (0 on success).
int mrgcn_attention_fwd_bf16(const void* q, const void* k, const void* v,
                             const void* valid, void* out, int N, int L,
                             int H, int d, const long long* strides,
                             void* stream) {
    if (!shape_ok(N, L, H, d)) return (int)cudaErrorInvalidValue;
    // binds the device's context to this thread before the tensor maps are
    // encoded (a libcuda call: autograd's worker threads may lack it)
    int err = (int)cudaFree(nullptr);
    if (err) return err;
    CUtensorMap mq, mk, mv;
    if ((err = make_qkv_maps(&mq, &mk, &mv, q, k, v, N, L, H, d, strides)))
        return err;
    cudaStream_t s = (cudaStream_t)stream;
    switch (k_steps(d)) {
        case 1: return launch_fwd<1>(mq, mk, mv, valid, out, N, L, H, d, s);
        case 2: return launch_fwd<2>(mq, mk, mv, valid, out, N, L, H, d, s);
        case 4: return launch_fwd<4>(mq, mk, mv, valid, out, N, L, H, d, s);
        default: return launch_fwd<8>(mq, mk, mv, valid, out, N, L, H, d, s);
    }
}

// As the forward, plus dout (contiguous (N, L, H, d)) in and dq, dk, dv
// (contiguous (N, L, H, d) bf16) out; stats: f32 scratch of
// mrgcn_attention_bwd_scratch_floats(N, L, H). Two launches: dq (and the
// rows' statistics), then dk and dv, one block per (sequence, head, 64
// rows).
int mrgcn_attention_bwd_bf16(const void* q, const void* k, const void* v,
                             const void* valid, const void* dout, void* dq,
                             void* dk, void* dv, void* stats, int N, int L,
                             int H, int d, const long long* strides,
                             void* stream) {
    if (!shape_ok(N, L, H, d)) return (int)cudaErrorInvalidValue;
    int err = (int)cudaFree(nullptr);     // as in the forward
    if (err) return err;
    CUtensorMap mq, mk, mv, mdo;
    if ((err = make_qkv_maps(&mq, &mk, &mv, q, k, v, N, L, H, d, strides)))
        return err;
    if ((err = make_map_heads(&mdo, dout, N, L, H, d, (long long)L * H * d,
                              (long long)H * d, d)))
        return err;
    cudaStream_t s = (cudaStream_t)stream;
    switch (k_steps(d)) {
        case 1: return launch_bwd<1>(mq, mk, mv, mdo, valid, dq, dk, dv,
                                     stats, N, L, H, d, s);
        case 2: return launch_bwd<2>(mq, mk, mv, mdo, valid, dq, dk, dv,
                                     stats, N, L, H, d, s);
        case 4: return launch_bwd<4>(mq, mk, mv, mdo, valid, dq, dk, dv,
                                     stats, N, L, H, d, s);
        default: return launch_bwd<8>(mq, mk, mv, mdo, valid, dq, dk, dv,
                                      stats, N, L, H, d, s);
    }
}

const char* mrgcn_attention_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

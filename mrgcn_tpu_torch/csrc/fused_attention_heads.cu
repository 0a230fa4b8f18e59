// Multi-head attention core for Hopper (sm_90a), forward and backward: the
// H > 1 calls of ops/attention.py (kernel #12). One head (H = 1) runs
// fused_attention.cu (#6 / #7), whose arithmetic this file repeats head by
// head.
//
// Forward, per sequence n and head h (q already multiplied by 1/sqrt(d),
// d the head's width):
//   s[i, j] = q[i] . k[j]            (bf16 inputs, f32 sums)
//   s[i, j] = -1e9 where key j is padding (valid[n, j] == 0)
//   p = softmax_j(s)                 (f32)
//   out[i] = sum_j p[i, j] v[j]      (p through bf16, f32 sums, stored bf16)
// Backward recomputes p, then
//   dv = bf16(p)^T do, dp = do v^T, ds = p (dp - rowsum(dp p)),
//   ds = 0 at padding keys, dq = bf16(ds) k, dk = bf16(ds)^T q.
//
// Replaces: the multi-head path of
// mrgcn_tpu/models/encoders.py::_flash_attention_fn, which calls the Pallas
// TPU FlashAttention kernels (forward, dq, dkv) on (N, H, L, d) with segment
// ids from the key mask: the same math on every row a caller can observe
// (flash lets padding queries attend padding keys; those rows reach no
// output). q, k, v (and dout) are (N, L, H, d) as flax lays them out, read
// by strides through 4-d tensor maps; out, dq, dk, dv are written in the
// same contiguous layout.
//
// What bounds it on the card: the bytes are those of one head of width
// H d, and so is the tensor work; what grows with H is the softmax, whose
// ex2 count is H x (keys x queries). At the text encoder's widths (D = 128
// split into 8 heads, L = 512) the ex2 units (16 a clock an SM) need more
// time than the bytes. The single-head tiling (one head padded to 128
// columns a tile, one block a head, second products over 128 columns)
// spent 8x the tensor work and 8x the blocks at H = 8.
//
// The design: a block owns a group of G heads of one sequence.
//  * Each head of a group has its own slab in shared memory: 64 rows x
//    dpad columns, dpad the head width rounded up to a power of two
//    >= 16, in the swizzle whose span is one slab row (32, 64 or 128
//    bytes; two 64-column boxes at dpad = 128). One TMA box a head a tile
//    fills it; the copy engine writes zeros past d and past L. A tile
//    holds G dpad <= 128 columns, so the group's q, k and v rows are read
//    from device memory once, with no padding columns in them where d is
//    a power of two. Each slab is a whole canonical wgmma layout: an
//    MN-major B operand (v in p v; k, do, q in the backward) narrower than
//    64 columns cannot be addressed by moving a descriptor's start inside
//    a 128-byte swizzle atom.
//  * Every product runs at the head's width: scores take dpad / 16 k
//    steps (n = 64 keys, or 32 queries in the key-major kernel), the
//    second products n = dpad (wgmma m64n16 .. m64n128).
//  * Per head, the order of every sum is the single-head kernel's: key
//    tiles of 64, the live-tile skip, the online softmax in log2 units
//    (ex2, one reciprocal a row), D summed from the same dp the second
//    walk meets. So each head of a call equals, bit for bit, the
//    single-head kernel run on that head alone.
//  * Forward: two warpgroups (128 query rows) a block, two blocks an SM,
//    each warpgroup walks its heads in order for each key tile; head j's
//    p v is in flight while head j + 1's scores are multiplied. The
//    softmax of one warpgroup overlaps the products of the SM's three
//    others.
//  * Backward, dq kernel: one warpgroup, 64 query rows, the two walks of
//    the single-head kernel for every head of the group; (max, 1 / sum,
//    D) of each row and head to f32 scratch (3, N H, L).
//  * Backward, dk / dv kernel: key-major, 64 key rows, every query tile
//    with its rows' statistics (cp.async into a two-stage buffer a step
//    ahead); four products a head at n = 32 and n = dpad. In both
//    backward kernels head j's second products are in flight while head
//    j + 1's scores are multiplied.
//  * The groups (below): ops/attention.head_plan states them, and the
//    entry points check the plan they are handed against (H, d).
//  * Deterministic: every output element is summed by one thread in a
//    fixed order; no atomics on device memory.
//  * Limits: L <= 512, d <= 128 and a multiple of 8 (the wrapper checks),
//    H >= 2 (one head is fused_attention.cu's).

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
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMasked = -1e9f * kLog2e;   // a padding key's logit, log2 units
constexpr int kDkvChunk = 32;          // query rows of a key-major step

// ---- the group plan (ops/attention.head_plan states the same) --------------
//
// Heads a block and blocks an SM, as measured at D = 128 in 2, 4 and 8
// heads (N = 8,000, L = 128 and N = 2,000, L = 512; H100 80GB HBM3,
// 700 W): the forward two blocks of two warpgroups an SM (128 registers),
// 64 columns a tile below dpad = 64 (128-column tiles at one block an SM,
// or with the next head's scores in flight, ptxas serialized the products
// and took 1.2-1.4x the time). The backward's products run in short
// dependent chains, so blocks an SM count more than heads a block: two
// heads a block up to dpad = 32, else one, at three or four blocks an SM
// (128 columns at two blocks took 1.6x the time at H = 8); every count
// the largest at which ptxas spills nothing.

// a head's width rounded up to a power of two >= 16
__host__ __device__ constexpr int pad_width(int d) {
    return d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : 128;
}
__host__ __device__ constexpr int fwd_group(int dpad) {
    return dpad <= 32 ? 64 / dpad : kMaxD / dpad;
}
__host__ __device__ constexpr int bwd_group(int dpad) {
    return dpad <= 32 ? 2 : 1;
}
// the backward kernels' blocks an SM (their registers' bound)
constexpr int dq_blocks(int dpad) {
    return dpad == 128 ? 2 : dpad == 32 ? 3 : 4;
}
constexpr int dkv_blocks(int dpad) { return dpad == 128 ? 2 : 3; }
__host__ __device__ constexpr int swizzle_bytes(int dpad) {
    return dpad >= 64 ? 128 : 2 * dpad;
}

// ---- a head's slab ----------------------------------------------------------

// A slab: 64 rows x DP bf16 columns, in the swizzle of one slab row
// (DP <= 64: rows of 2 DP bytes, 8 rows a swizzle atom), or two 64-column
// boxes in the 128-byte swizzle (DP = 128: hopper.cuh's tile)
template <int DP>
__host__ __device__ constexpr int slab_bytes() {
    static_assert(DP == 16 || DP == 32 || DP == 64 || DP == 128, "dpad");
    return kTile * DP * 2;
}

// the descriptors' layout field of a slab of width DP <= 64: 128-, 64-,
// 32-byte swizzle
template <int DP>
__host__ __device__ constexpr uint64_t swizzle_mode() {
    return DP == 64 ? 1 : DP == 32 ? 2 : 3;
}

// K-major operand (k along the slab's columns): rows row0.. (a multiple of
// 8), columns 16 kk..
template <int DP>
__device__ __forceinline__ uint64_t desc_k(const char* slab, int row0,
                                           int kk) {
    if constexpr (DP == 128) {
        return desc_k_major(slab, row0, kk);
    } else {
        constexpr int atom = 8 * 2 * DP;
        const uint32_t at = shared_address(slab) + (row0 >> 3) * atom
                          + kk * 32;
        return (uint64_t)((at & 0x3FFFF) >> 4) | ((uint64_t)1 << 16)
             | ((uint64_t)(atom >> 4) << 32)              // next 8 of m / n
             | (swizzle_mode<DP>() << 62);
    }
}

// MN-major B operand (k along the slab's rows k0.., n along all DP
// columns: one swizzle atom wide below DP = 128, so the field for the next
// atom of n is never read)
template <int DP>
__device__ __forceinline__ uint64_t desc_mn(const char* slab, int k0) {
    if constexpr (DP == 128) {
        return desc_mn_major(slab, k0);
    } else {
        constexpr int atom = 8 * 2 * DP;
        const uint32_t at = shared_address(slab) + (k0 >> 3) * atom;
        return (uint64_t)((at & 0x3FFFF) >> 4)
             | ((uint64_t)(slab_bytes<DP>() >> 4) << 16)
             | ((uint64_t)(atom >> 4) << 32)              // next 8 of k
             | (swizzle_mode<DP>() << 62);
    }
}

// Rows row.. (64) of head h of sequence n of a mapped (N, L, H, d) tensor
// (make_slab_map) into a slab; zeros outside (L, d). One thread calls it.
template <int DP>
__device__ __forceinline__ void load_slab(char* dst, const CUtensorMap* map,
                                          uint64_t* bar, int row, int n,
                                          int h) {
    if constexpr (DP == 128)
        load_tile_head(dst, map, bar, row, n, h);
    else
        tma_load_box_4d(dst, map, bar, 0, h, row, n);
}

// ---- wgmma at n = 16, 32 (A from registers) ---------------------------------

template <int TransB>
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[2][4],
        const uint32_t (&a)[4], uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0,%1,%2,%3,%4,%5,%6,%7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate),
          "n"(TransB));
}

template <int TransB>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[4][4],
        const uint32_t (&a)[4], uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate),
          "n"(TransB));
}

// acc += a (16 rows of k, from registers) b (a slab read MN-major from row
// k0): the second products, n = DP
template <int DP>
__device__ __forceinline__ void second_product(float (&acc)[DP / 8][4],
                                               const uint32_t (&a)[4],
                                               const char* slab, int k0) {
    const uint64_t b = desc_mn<DP>(slab, k0);
    if constexpr (DP == 16) wgmma_rs_n16<1>(acc, a, b, 1);
    else if constexpr (DP == 32) wgmma_rs_n32<1>(acc, a, b, 1);
    else if constexpr (DP == 64) wgmma_rs_n64<1>(acc, a, b, 1);
    else wgmma_rs_n128<1>(acc, a, b, 1);
}

// s = X[rows 0..63] Y[rows y0..y0+8 NT-1]^T over one head's DP columns
template <int NT, int DP>
__device__ __forceinline__ void issue_scores(float (&s)[NT][4], const char* X,
                                             const char* Y, int y0) {
    static_assert(NT == 8 || NT == 4, "64 or 32 columns");
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
        if constexpr (NT == 8)
            wgmma_ss_n64(s, desc_k<DP>(X, 0, kk), desc_k<DP>(Y, y0, kk),
                         kk > 0);
        else
            wgmma_ss_n32(s, desc_k<DP>(X, 0, kk), desc_k<DP>(Y, y0, kk),
                         kk > 0);
    }
}

// wait for every product issued, then pin the accumulators of all heads
template <int G, int NT>
__device__ __forceinline__ void wgmma_wait_all(float (&d)[G][NT][4]) {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < G; ++j)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                asm volatile("" : "+f"(d[j][nt][e]) :: "memory");
}

// ---- softmax pieces (the single-head kernel's, fused_attention.cu) ----------

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
// none. Every thread of the block calls it (it synchronises).
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

__device__ __forceinline__ float logit2(float x, int ok) {
    return ok > 0 ? x * kLog2e : (ok == 0 ? kMasked : -INFINITY);
}

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

template <bool Full>
__device__ __forceinline__ float prob(float x, float m) {
    return Full ? ex2(fmaf(x, kLog2e, -m)) : ex2(x - m);
}

// The warpgroup's 64 rows of G heads' accumulators (head j times
// scale[j][row half]) as bf16 into a shared buffer no product reads any
// more (rows of G DP bf16, head j's columns at j DP; the 16-byte chunk c of
// row r at chunk c ^ (r % 8), within rows of fewer than 8 chunks
// c ^ (r % chunks)), then the first gh heads' d columns to rows row0.. of
// an (L, H, d) sequence at head h0, 16 bytes a thread. A warp writes and
// reads back only its own 16 rows.
template <int DP, int G>
__device__ __forceinline__ void store_heads(bf16* seq, char* S,
                                            const float (&acc)[G][DP / 8][4],
                                            const float (&scale)[G][2],
                                            int row0, int L, int H, int h0,
                                            int gh, int d) {
    constexpr int kChunks = G * DP / 8;          // 16-byte chunks a row
    constexpr int kRow = kChunks * 16;
    constexpr int kMix = (kChunks < 8 ? kChunks : 8) - 1;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    char* mine = S + 16 * warp * kRow;           // rows 16 warp .. + 15
#pragma unroll
    for (int j = 0; j < G; ++j) {
#pragma unroll
        for (int dt = 0; dt < DP / 8; ++dt) {
            const int c = j * (DP / 8) + dt;
            char* p0 = mine + g * kRow + ((c ^ (g & kMix)) << 4) + t * 4;
            char* p1 = mine + (g + 8) * kRow + ((c ^ ((g + 8) & kMix)) << 4)
                     + t * 4;
            *reinterpret_cast<uint32_t*>(p0) =
                pack2(acc[j][dt][0] * scale[j][0], acc[j][dt][1] * scale[j][0]);
            *reinterpret_cast<uint32_t*>(p1) =
                pack2(acc[j][dt][2] * scale[j][1], acc[j][dt][3] * scale[j][1]);
        }
    }
    __syncwarp();
    for (int i = lane; i < 16 * kChunks; i += 32) {
        const int rl = i / kChunks, c = i % kChunks;
        const int j = c / (DP / 8), col = (c % (DP / 8)) * 8;
        const int r = row0 + 16 * warp + rl;
        if (r < L && j < gh && col < d)
            *reinterpret_cast<uint4*>(seq + ((long long)r * H + h0 + j) * d
                                      + col) =
                *reinterpret_cast<const uint4*>(
                    mine + rl * kRow + ((c ^ (rl & kMix)) << 4));
    }
}

// ---- forward ----------------------------------------------------------------

// One key tile of the forward for a warpgroup's 64 query rows and its
// group's gh heads (slabs of Qw, Ks, Vs): per head the single-head
// kernel's scores, online softmax update and o += p V. Head j's p V is
// left in flight while head j + 1's scores are multiplied; all are done
// on return.
template <bool Full, int DP, int G>
__device__ __forceinline__ void forward_tile(float (&o)[G][DP / 8][4],
                                             float (&m)[G][2],
                                             float (&l)[G][2],
                                             const char* Qw, const char* Ks,
                                             const char* Vs,
                                             const signed char* ok,
                                             bool first, int gh) {
    constexpr int S = slab_bytes<DP>();
#pragma unroll
    for (int j = 0; j < G; ++j) {
        if (j < gh) {
            float s[kTile / 8][4];
            wgmma_fence();
            issue_scores<kTile / 8, DP>(s, Qw + j * S, Ks + j * S, 0);
            wgmma_commit();
            wgmma_wait(s);
            float mt[2];
            tile_logits<Full>(s, ok, mt);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                // every walked tile has a key inside the sequence, so the
                // new max is finite
                const float mn = fmaxf(m[j][h], quad_max(mt[h]));
                if (!first) {
                    const float alpha = ex2(m[j][h] - mn);
                    l[j][h] *= alpha;
#pragma unroll
                    for (int dt = 0; dt < DP / 8; ++dt) {
                        o[j][dt][2 * h] *= alpha;
                        o[j][dt][2 * h + 1] *= alpha;
                    }
                }
                m[j][h] = mn;
            }
#pragma unroll
            for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float p = prob<Full>(s[nt][e], m[j][e >> 1]);
                    s[nt][e] = p;
                    l[j][e >> 1] += p;
                }
            }
            uint32_t pa[kTile / 16][4];
#pragma unroll
            for (int kk = 0; kk < kTile / 16; ++kk) to_a(pa[kk], s, kk);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kTile / 16; ++kk)
                second_product<DP>(o[j], pa[kk], Vs + j * S, kk * 16);
            wgmma_commit();
        }
    }
    wgmma_wait_all(o);
}

// A block of two warpgroups owns 128 query rows of one group of heads of
// one sequence (64 rows a warpgroup) and walks the live key tiles.
// G: the heads a block can hold (the call's group size gsize <= G).
constexpr int kFwdWarpgroups = 2;
template <int DP, int G>
__global__ void __launch_bounds__(kFwdWarpgroups * kThreads, 2)
heads_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 const uint8_t* __restrict__ valid, bf16* __restrict__ out,
                 int L, int H, int d, int gsize, int groups, int row_tiles) {
    constexpr int S = slab_bytes<DP>(), T = G * S;
    const int item = blockIdx.x / row_tiles;        // (sequence, group)
    const int n = item / groups, h0 = (item % groups) * gsize;
    const int gh = min(gsize, H - h0);
    const int q0 = (blockIdx.x % row_tiles) * (kFwdWarpgroups * kTile);
    extern __shared__ __align__(1024) char smem[];
    char* Qs = smem;                   // a tile a warpgroup
    char* ring = Qs + kFwdWarpgroups * T;   // stage: a K tile, a V tile
    signed char* key_ok =
        reinterpret_cast<signed char*>(ring + kStages * 2 * T);
    __shared__ int tiles[kMaxTiles];
    __shared__ unsigned bits[2];
    __shared__ __align__(8) uint64_t bars[1 + kStages];   // Q, the stages

    if (threadIdx.x == 0) {
#pragma unroll
        for (int b = 0; b < 1 + kStages; ++b) mbar_init(&bars[b], 1);
        mbar_init_fence();
        mbar_expect(&bars[0], kFwdWarpgroups * gh * S);
        for (int w = 0; w < kFwdWarpgroups; ++w)
            for (int j = 0; j < gh; ++j)
                load_slab<DP>(Qs + w * T + j * S, &map_q, &bars[0],
                              q0 + w * kTile, n, h0 + j);
    }
    const KeyPlan plan =
        plan_key_tiles(key_ok, tiles, bits, valid + (long long)n * L, L);
    // step i takes stage i % 2, that stage's use i / 2
    auto issue = [&](int i) {
        if (i < plan.count && threadIdx.x == 0) {
            char* Ks = ring + (i & 1) * 2 * T;
            uint64_t* bar = &bars[1 + (i & 1)];
            mbar_expect(bar, 2 * gh * S);
            for (int j = 0; j < gh; ++j) {
                load_slab<DP>(Ks + j * S, &map_k, bar, tiles[i] * kTile, n,
                              h0 + j);
                load_slab<DP>(Ks + T + j * S, &map_v, bar, tiles[i] * kTile,
                              n, h0 + j);
            }
        }
    };
    issue(0);
    issue(1);

    const int t = threadIdx.x & 3;
    const int wg = threadIdx.x / kThreads;
    char* Qw = Qs + wg * T;
    // a warpgroup whose rows are all past L multiplies nothing
    const bool active = q0 + wg * kTile < L;
    float m[G][2], l[G][2], o[G][DP / 8][4];
#pragma unroll
    for (int j = 0; j < G; ++j) {
        m[j][0] = m[j][1] = -INFINITY;
        l[j][0] = l[j][1] = 0.f;
#pragma unroll
        for (int dt = 0; dt < DP / 8; ++dt)
            o[j][dt][0] = o[j][dt][1] = o[j][dt][2] = o[j][dt][3] = 0.f;
    }

    mbar_wait(&bars[0], 0);
    for (int i = 0; i < plan.count; ++i) {
        mbar_wait(&bars[1 + (i & 1)], (i >> 1) & 1);
        if (active) {
            const char* Ks = ring + (i & 1) * 2 * T;
            const signed char* ok = key_ok + tiles[i] * kTile + 2 * t;
            if ((plan.full >> tiles[i]) & 1u)
                forward_tile<true, DP, G>(o, m, l, Qw, Ks, Ks + T, ok,
                                          i == 0, gh);
            else
                forward_tile<false, DP, G>(o, m, l, Qw, Ks, Ks + T, ok,
                                           i == 0, gh);
        }
        __syncthreads();               // the stage is free
        issue(i + 2);
    }
    if (!active) return;
    float inv[G][2];
#pragma unroll
    for (int j = 0; j < G; ++j) {
        inv[j][0] = 1.f / quad_sum(l[j][0]);
        inv[j][1] = 1.f / quad_sum(l[j][1]);
    }
    store_heads<DP, G>(out + (long long)n * L * H * d, Qw, o, inv,
                       q0 + wg * kTile, L, H, h0, gh, d);
}

// ---- backward, dq -----------------------------------------------------------

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

// ds = p (dp - D), 0 at padding keys, into dp (rows: the accumulator's)
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

// One walk step of the dq kernel for every head of the group: the first
// walk's statistics, or the second's ds and dq += ds K (head j's left in
// flight while head j + 1's scores are multiplied; all done on return)
template <bool Full, int DP, int G>
__device__ __forceinline__ void dq_step(float (&acc)[G][DP / 8][4],
                                        float (&m)[G][2], float (&l)[G][2],
                                        float (&D)[G][2], const char* Qs,
                                        const char* dOs, const char* Ks,
                                        const char* Vs,
                                        const signed char* ok, bool stats,
                                        bool first, int gh) {
    constexpr int S = slab_bytes<DP>();
#pragma unroll
    for (int j = 0; j < G; ++j) {
        if (j < gh) {
            float sc[kTile / 8][4], dp[kTile / 8][4];
            wgmma_fence();
            issue_scores<kTile / 8, DP>(sc, Qs + j * S, Ks + j * S, 0);
            issue_scores<kTile / 8, DP>(dp, dOs + j * S, Vs + j * S, 0);
            wgmma_commit();
            wgmma_wait(sc);
            wgmma_wait(dp);
            if (stats) {
                stats_tile<Full>(m[j], l[j], D[j], sc, dp, ok, first);
            } else {
                ds_tile_rows<Full>(sc, dp, m[j], l[j], D[j], ok);
                uint32_t da[kTile / 16][4];
#pragma unroll
                for (int kk = 0; kk < kTile / 16; ++kk) to_a(da[kk], dp, kk);
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < kTile / 16; ++kk)
                    second_product<DP>(acc[j], da[kk], Ks + j * S, kk * 16);
                wgmma_commit();
            }
        }
    }
    wgmma_wait_all(acc);
}

// A block owns 64 query rows of one group of heads of one sequence and
// walks the live key tiles twice: first each row's max, sum and D, then ds
// and dq. The rows' (max, 1 / sum, D) go to stats (3, N H, L).
template <int DP, int G>
__global__ void __launch_bounds__(kThreads, dq_blocks(DP))
heads_bwd_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_do,
                    const uint8_t* __restrict__ valid, bf16* __restrict__ dq,
                    float* __restrict__ stats, int N, int L, int H, int d,
                    int gsize, int groups, int row_tiles) {
    constexpr int S = slab_bytes<DP>(), T = G * S;
    const int item = blockIdx.x / row_tiles;        // (sequence, group)
    const int n = item / groups, h0 = (item % groups) * gsize;
    const int gh = min(gsize, H - h0);
    const int q0 = (blockIdx.x % row_tiles) * kTile;
    const long long NHL = (long long)N * H * L;
    extern __shared__ __align__(1024) char smem[];
    char* Qs = smem;
    char* dOs = Qs + T;
    char* ring = dOs + T;              // stage s: K tile, then V tile
    signed char* key_ok =
        reinterpret_cast<signed char*>(ring + kStages * 2 * T);
    __shared__ int tiles[kMaxTiles];
    __shared__ unsigned bits[2];
    __shared__ __align__(8) uint64_t bars[1 + kStages];   // Q and dO, stages

    if (threadIdx.x == 0) {
#pragma unroll
        for (int b = 0; b < 1 + kStages; ++b) mbar_init(&bars[b], 1);
        mbar_init_fence();
        mbar_expect(&bars[0], 2 * gh * S);
        for (int j = 0; j < gh; ++j) {
            load_slab<DP>(Qs + j * S, &map_q, &bars[0], q0, n, h0 + j);
            load_slab<DP>(dOs + j * S, &map_do, &bars[0], q0, n, h0 + j);
        }
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
            char* Ks = ring + (s & 1) * 2 * T;
            uint64_t* bar = &bars[1 + (s & 1)];
            mbar_expect(bar, 2 * gh * S);
            for (int j = 0; j < gh; ++j) {
                load_slab<DP>(Ks + j * S, &map_k, bar, tiles[i] * kTile, n,
                              h0 + j);
                load_slab<DP>(Ks + T + j * S, &map_v, bar, tiles[i] * kTile,
                              n, h0 + j);
            }
        }
    };
    issue(0);
    issue(1);

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;

    float m[G][2], l[G][2], D[G][2];   // l: the sum, then its reciprocal
    float acc[G][DP / 8][4];
#pragma unroll
    for (int j = 0; j < G; ++j) {
        m[j][0] = m[j][1] = -INFINITY;
        l[j][0] = l[j][1] = D[j][0] = D[j][1] = 0.f;
#pragma unroll
        for (int dt = 0; dt < DP / 8; ++dt)
            acc[j][dt][0] = acc[j][dt][1] = acc[j][dt][2] = acc[j][dt][3] =
                0.f;
    }

    mbar_wait(&bars[0], 0);
    for (int s = 0; s < steps; ++s) {
        if (loads(s)) mbar_wait(&bars[1 + (s & 1)], (s >> 1) & 1);
        if (s == count) {
#pragma unroll
            for (int j = 0; j < G; ++j)
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    l[j][r] = 1.f / quad_sum(l[j][r]);
                    D[j][r] = quad_sum(D[j][r]) * l[j][r];
                }
        }
        const int i = s < count ? s : s - count;
        const int stage = resident ? i : (s & 1);
        const char* Ks = ring + stage * 2 * T;
        const signed char* ok = key_ok + tiles[i] * kTile + 2 * t;
        if ((plan.full >> tiles[i]) & 1u)
            dq_step<true, DP, G>(acc, m, l, D, Qs, dOs, Ks, Ks + T, ok,
                                 s < count, s == 0, gh);
        else
            dq_step<false, DP, G>(acc, m, l, D, Qs, dOs, Ks, Ks + T, ok,
                                  s < count, s == 0, gh);
        __syncthreads();               // the stage is free
        issue(s + 2);
    }
    if (t == 0) {
#pragma unroll
        for (int j = 0; j < G; ++j) {
            if (j < gh) {
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    const int row = q0 + 16 * warp + g + 8 * r;
                    if (row < L) {
                        const long long i =
                            ((long long)n * H + h0 + j) * L + row;
                        stats[i] = m[j][r];
                        stats[NHL + i] = l[j][r];
                        stats[2 * NHL + i] = D[j][r];
                    }
                }
            }
        }
    }
    float one[G][2];
#pragma unroll
    for (int j = 0; j < G; ++j) one[j][0] = one[j][1] = 1.f;
    store_heads<DP, G>(dq + (long long)n * L * H * d, Qs, acc, one, q0, L,
                       H, h0, gh, d);
}

// ---- backward, dk and dv ----------------------------------------------------

// p^T into sc and ds^T into dp for 8 NT query columns of the key-major
// kernel: the statistics st (max, 1 / sum, D of the tile's 64 query
// rows; a row past L has max 0 and 1 / sum 0) belong to the columns, the
// key status ok0 / ok1 to this thread's two rows.
template <bool Full, int NT>
__device__ __forceinline__ void ds_tile_columns(float (&sc)[NT][4],
                                                float (&dp)[NT][4],
                                                const float* st, int ok0,
                                                int ok1) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
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

// kDkvChunk query rows (from c0) of one query tile for every head of the
// group: s^T = k q^T and dp^T = v do^T give p^T and ds^T, then dv += p^T do
// and dk += ds^T q (head j's left in flight while head j + 1's scores are
// multiplied; all done on return). st: the stage's statistics, (head, 3,
// 64) floats, this thread's column offset applied.
template <bool Full, int DP, int G>
__device__ __forceinline__ void dkv_step(float (&dva)[G][DP / 8][4],
                                         float (&dka)[G][DP / 8][4],
                                         const char* Ks, const char* Vs,
                                         const char* Qt, const char* dOt,
                                         const float* st, int c0, int ok0,
                                         int ok1, int gh) {
    constexpr int S = slab_bytes<DP>();
    constexpr int NT = kDkvChunk / 8, KK = kDkvChunk / 16;
#pragma unroll
    for (int j = 0; j < G; ++j) {
        if (j < gh) {
            float sc[NT][4], dp[NT][4];
            wgmma_fence();
            issue_scores<NT, DP>(sc, Ks + j * S, Qt + j * S, c0);
            issue_scores<NT, DP>(dp, Vs + j * S, dOt + j * S, c0);
            wgmma_commit();
            wgmma_wait(sc);
            wgmma_wait(dp);
            ds_tile_columns<Full>(sc, dp, st + j * 3 * kTile + c0, ok0, ok1);
            uint32_t pa[KK][4], da[KK][4];
#pragma unroll
            for (int kk = 0; kk < KK; ++kk) {
                to_a(pa[kk], sc, kk);
                to_a(da[kk], dp, kk);
            }
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < KK; ++kk) {
                second_product<DP>(dva[j], pa[kk], dOt + j * S,
                                   c0 + kk * 16);
                second_product<DP>(dka[j], da[kk], Qt + j * S, c0 + kk * 16);
            }
            wgmma_commit();
        }
    }
    wgmma_wait_all(dva);
    wgmma_wait_all(dka);
}

__device__ __forceinline__ void cp_async_4(float* dst, const float* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(shared_address(dst)), "l"(src) : "memory");
}

// Key-major: a block owns 64 key rows of one group of heads of one
// sequence and walks all query tiles with their rows' (max, 1 / sum, D)
// from stats. A key tile without a valid key (in a sequence that has one)
// gets zeros.
template <int DP, int G>
__global__ void __launch_bounds__(kThreads, dkv_blocks(DP))
heads_bwd_dkv_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_do,
                     const uint8_t* __restrict__ valid,
                     const float* __restrict__ stats,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int N,
                     int L, int H, int d, int gsize, int groups,
                     int row_tiles) {
    constexpr int S = slab_bytes<DP>(), T = G * S;
    constexpr int kStatFloats = G * 3 * kTile;      // a stage's
    const int item = blockIdx.x / row_tiles;        // (sequence, group)
    const int n = item / groups, h0 = (item % groups) * gsize;
    const int gh = min(gsize, H - h0);
    const int kt = blockIdx.x % row_tiles;
    const long long NHL = (long long)N * H * L;
    const int k0 = kt * kTile;
    extern __shared__ __align__(1024) char smem[];
    char* Ks = smem;
    char* Vs = Ks + T;
    char* ring = Vs + T;               // stage s: Q tile, then dO tile
    float* rowstats =                  // stage s: (head, max / inv / D, row)
        reinterpret_cast<float*>(ring + kStages * 2 * T);
    signed char* key_ok =
        reinterpret_cast<signed char*>(rowstats + kStages * kStatFloats);
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
    bf16* const dk_seq = dk + (long long)n * L * H * d;
    bf16* const dv_seq = dv + (long long)n * L * H * d;
    if (!((plan.walked >> kt) & 1u)) {
        const int vecs = d >> 3;
        const int rows = min(kTile, L - k0);
        const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
        for (int i = threadIdx.x; i < rows * gh * vecs; i += kThreads) {
            const int r = i / (gh * vecs), j = (i / vecs) % gh;
            const long long at = ((long long)(k0 + r) * H + h0 + j) * d
                               + (long long)(i % vecs) * 8;
            *reinterpret_cast<uint4*>(dk_seq + at) = zero;
            *reinterpret_cast<uint4*>(dv_seq + at) = zero;
        }
        return;
    }

    // step s takes stage s % 2, that stage's use s / 2
    auto issue = [&](int s) {
        if (s < row_tiles && threadIdx.x == 0) {
            char* Qt = ring + (s & 1) * 2 * T;
            uint64_t* bar = &bars[1 + (s & 1)];
            mbar_expect(bar, 2 * gh * S);
            for (int j = 0; j < gh; ++j) {
                load_slab<DP>(Qt + j * S, &map_q, bar, s * kTile, n, h0 + j);
                load_slab<DP>(Qt + T + j * S, &map_do, bar, s * kTile, n,
                              h0 + j);
            }
        }
    };
    // the query rows' statistics of step s into its stage, a step ahead of
    // their use (cp.async; 0 for rows past L: max 0, 1 / sum 0, D 0)
    auto fetch_stats = [&](int s) {
        if (s < row_tiles) {
            float* st = rowstats + (s & 1) * kStatFloats;
            for (int i = threadIdx.x; i < gh * 3 * kTile; i += kThreads) {
                const int j = i / (3 * kTile), w = (i / kTile) % 3;
                const int row = s * kTile + (i & (kTile - 1));
                if (row < L)
                    cp_async_4(st + i, stats + w * NHL
                               + ((long long)n * H + h0 + j) * L + row);
                else
                    st[i] = 0.f;
            }
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
    if (threadIdx.x == 0) {
        mbar_expect(&bars[0], 2 * gh * S);
        for (int j = 0; j < gh; ++j) {
            load_slab<DP>(Ks + j * S, &map_k, &bars[0], k0, n, h0 + j);
            load_slab<DP>(Vs + j * S, &map_v, &bars[0], k0, n, h0 + j);
        }
    }
    issue(0);
    issue(1);
    fetch_stats(0);
    fetch_stats(1);

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int ok0 = key_ok[k0 + 16 * warp + g];
    const int ok1 = key_ok[k0 + 16 * warp + g + 8];
    const bool full = (plan.full >> kt) & 1u;

    float dva[G][DP / 8][4], dka[G][DP / 8][4];
#pragma unroll
    for (int j = 0; j < G; ++j)
#pragma unroll
        for (int dt = 0; dt < DP / 8; ++dt) {
            dva[j][dt][0] = dva[j][dt][1] = dva[j][dt][2] = dva[j][dt][3] =
                0.f;
            dka[j][dt][0] = dka[j][dt][1] = dka[j][dt][2] = dka[j][dt][3] =
                0.f;
        }

    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();                   // the first tile's statistics
    mbar_wait(&bars[0], 0);
    for (int s = 0; s < row_tiles; ++s) {
        mbar_wait(&bars[1 + (s & 1)], (s >> 1) & 1);
        const char* Qt = ring + (s & 1) * 2 * T;
        const float* st = rowstats + (s & 1) * kStatFloats + 2 * t;
        // kDkvChunk query rows at a time: keys (rows) x queries (columns)
#pragma unroll 1
        for (int c0 = 0; c0 < kTile; c0 += kDkvChunk) {
            if (full)
                dkv_step<true, DP, G>(dva, dka, Ks, Vs, Qt, Qt + T, st, c0,
                                      ok0, ok1, gh);
            else
                dkv_step<false, DP, G>(dva, dka, Ks, Vs, Qt, Qt + T, st, c0,
                                       ok0, ok1, gh);
        }
        // the next step's statistics (fetched a step ago) are in
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        __syncthreads();               // the stage is free
        issue(s + 2);
        fetch_stats(s + 2);
    }
    float one[G][2];
#pragma unroll
    for (int j = 0; j < G; ++j) one[j][0] = one[j][1] = 1.f;
    store_heads<DP, G>(dv_seq, Vs, dva, one, k0, L, H, h0, gh, d);
    store_heads<DP, G>(dk_seq, Ks, dka, one, k0, L, H, h0, gh, d);
}

// ---- host side --------------------------------------------------------------

// the kernels' limits (the wrapper raises on them with a message)
bool shape_ok(int N, int L, int H, int d) {
    return N > 0 && L > 0 && L <= kMaxL && H > 1 && d > 0 && d <= kMaxD
        && d % 8 == 0;
}

// The plan the wrapper hands over (dpad, heads a block, swizzle bytes)
// against the one (H, d) gives: heads = G of the forward or the backward
bool plan_ok(int H, int d, int dpad, int heads, int swizzle, bool fwd) {
    const int want = pad_width(d);
    const int g = fwd ? fwd_group(want) : bwd_group(want);
    return dpad == want && heads == (H < g ? H : g)
        && swizzle == swizzle_bytes(want);
}

// The tensor map of an (N, L, H, d) bf16 tensor with element strides (sn,
// sl, sh, 1) in slabs of width dpad: boxes of 64 rows x min(dpad, 64)
// columns of one head of one sequence, in the swizzle of a box row.
int make_slab_map(CUtensorMap* map, const void* base, int N, int L, int H,
                  int d, long long sn, long long sl, long long sh,
                  int dpad) {
    EncodeTiled encode = tensor_map_encoder();
    if (!encode) return (int)cudaErrorSymbolNotFound;
    const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)H, (cuuint64_t)L,
                                (cuuint64_t)N};
    const cuuint64_t bytes[3] = {(cuuint64_t)sh * 2, (cuuint64_t)sl * 2,
                                 (cuuint64_t)sn * 2};
    const cuuint32_t box[4] = {(cuuint32_t)(dpad < 64 ? dpad : 64), 1,
                               kBoxRows, 1};
    const cuuint32_t steps[4] = {1, 1, 1, 1};
    const CUtensorMapSwizzle swizzle =
        dpad >= 64 ? CU_TENSOR_MAP_SWIZZLE_128B
        : dpad == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
    const CUresult rc = encode(
        map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
        dims, bytes, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return rc == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// q, k, v: s[0..2] = (over N, over L, over H) of q, s[3..5] of k, s[6..8]
// of v
int make_qkv_maps(CUtensorMap* mq, CUtensorMap* mk, CUtensorMap* mv,
                  const void* q, const void* k, const void* v, int N, int L,
                  int H, int d, const long long* s, int dpad) {
    int err = make_slab_map(mq, q, N, L, H, d, s[0], s[1], s[2], dpad);
    if (!err) err = make_slab_map(mk, k, N, L, H, d, s[3], s[4], s[5], dpad);
    if (!err) err = make_slab_map(mv, v, N, L, H, d, s[6], s[7], s[8], dpad);
    return err;
}

// a block's shared memory: `tiles` tiles of G slabs, `extra` bytes, the
// keys' status
template <int DP, int G>
size_t block_smem(int tiles, int extra) {
    return (size_t)tiles * G * slab_bytes<DP>() + extra + kMaxL;
}

template <int DP>
int launch_fwd(const CUtensorMap& mq, const CUtensorMap& mk,
               const CUtensorMap& mv, const void* valid, void* out, int N,
               int L, int H, int d, int gsize, cudaStream_t stream) {
    constexpr int G = fwd_group(DP);
    static bool done[64];
    const size_t smem = block_smem<DP, G>(kFwdWarpgroups + 2 * kStages, 0);
    int err = allow_smem((const void*)heads_fwd_kernel<DP, G>, smem, done);
    if (err) return err;
    const int rows = kFwdWarpgroups * kTile;
    const int row_tiles = (L + rows - 1) / rows;
    const int groups = (H + gsize - 1) / gsize;
    heads_fwd_kernel<DP, G><<<(unsigned)N * groups * row_tiles,
                              kFwdWarpgroups * kThreads, smem, stream>>>(
        mq, mk, mv, (const uint8_t*)valid, (bf16*)out, L, H, d, gsize, groups,
        row_tiles);
    return (int)cudaGetLastError();
}

template <int DP>
int launch_bwd(const CUtensorMap& mq, const CUtensorMap& mk,
               const CUtensorMap& mv, const CUtensorMap& mdo,
               const void* valid, void* dq, void* dk, void* dv, void* stats,
               int N, int L, int H, int d, int gsize, cudaStream_t stream) {
    constexpr int G = bwd_group(DP);
    static bool done[2][64];
    const size_t smem_dq = block_smem<DP, G>(2 + 2 * kStages, 0);
    const size_t smem_dkv = block_smem<DP, G>(
        2 + 2 * kStages, kStages * G * 3 * kTile * (int)sizeof(float));
    int err = allow_smem((const void*)heads_bwd_dq_kernel<DP, G>, smem_dq,
                         done[0]);
    if (err) return err;
    err = allow_smem((const void*)heads_bwd_dkv_kernel<DP, G>, smem_dkv,
                     done[1]);
    if (err) return err;
    const int row_tiles = (L + kTile - 1) / kTile;
    const int groups = (H + gsize - 1) / gsize;
    const unsigned grid = (unsigned)N * groups * row_tiles;
    heads_bwd_dq_kernel<DP, G><<<grid, kThreads, smem_dq, stream>>>(
        mq, mk, mv, mdo, (const uint8_t*)valid, (bf16*)dq, (float*)stats, N,
        L, H, d, gsize, groups, row_tiles);
    err = (int)cudaGetLastError();
    if (err) return err;
    heads_bwd_dkv_kernel<DP, G><<<grid, kThreads, smem_dkv, stream>>>(
        mq, mk, mv, mdo, (const uint8_t*)valid, (const float*)stats,
        (bf16*)dk, (bf16*)dv, N, L, H, d, gsize, groups, row_tiles);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// f32 scratch the backward needs: each row's (max, 1 / sum, D) for every
// (sequence, head)
long long mrgcn_attention_heads_bwd_scratch_floats(int N, int L, int H) {
    return 3LL * N * L * H;
}

// q, k, v: (N, L, H, d) bf16, H >= 2, with element strides `strides` (q's
// over N, L and H, then k's, then v's; multiples of 8), a contiguous last
// dim and a 16-byte aligned start; valid: (N, L) uint8; out: contiguous
// (N, L, H, d). (dpad, heads, swizzle): the wrapper's head_plan, checked
// against (H, d). One block of two warpgroups per (sequence, group of
// heads, 128 query rows). Launches on `stream`; returns a cudaError_t (0
// on success).
int mrgcn_attention_heads_fwd_bf16(const void* q, const void* k,
                                   const void* v, const void* valid,
                                   void* out, int N, int L, int H, int d,
                                   const long long* strides, int dpad,
                                   int heads, int swizzle, void* stream) {
    if (!shape_ok(N, L, H, d) || !plan_ok(H, d, dpad, heads, swizzle, true))
        return (int)cudaErrorInvalidValue;
    // binds the device's context to this thread before the tensor maps are
    // encoded (a libcuda call: autograd's worker threads may lack it)
    int err = (int)cudaFree(nullptr);
    if (err) return err;
    CUtensorMap mq, mk, mv;
    if ((err = make_qkv_maps(&mq, &mk, &mv, q, k, v, N, L, H, d, strides,
                             dpad)))
        return err;
    cudaStream_t s = (cudaStream_t)stream;
    switch (dpad) {
        case 16: return launch_fwd<16>(mq, mk, mv, valid, out, N, L, H, d,
                                       heads, s);
        case 32: return launch_fwd<32>(mq, mk, mv, valid, out, N, L, H, d,
                                       heads, s);
        case 64: return launch_fwd<64>(mq, mk, mv, valid, out, N, L, H, d,
                                       heads, s);
        default: return launch_fwd<128>(mq, mk, mv, valid, out, N, L, H, d,
                                        heads, s);
    }
}

// As the forward, plus dout (contiguous (N, L, H, d)) in and dq, dk, dv
// (contiguous (N, L, H, d) bf16) out; stats: f32 scratch of
// mrgcn_attention_heads_bwd_scratch_floats(N, L, H); (dpad, heads,
// swizzle): the backward's plan. Two launches: dq (and the rows'
// statistics), then dk and dv, one block per (sequence, group of heads, 64
// rows).
int mrgcn_attention_heads_bwd_bf16(const void* q, const void* k,
                                   const void* v, const void* valid,
                                   const void* dout, void* dq, void* dk,
                                   void* dv, void* stats, int N, int L, int H,
                                   int d, const long long* strides, int dpad,
                                   int heads, int swizzle, void* stream) {
    if (!shape_ok(N, L, H, d) || !plan_ok(H, d, dpad, heads, swizzle, false))
        return (int)cudaErrorInvalidValue;
    int err = (int)cudaFree(nullptr);     // as in the forward
    if (err) return err;
    CUtensorMap mq, mk, mv, mdo;
    if ((err = make_qkv_maps(&mq, &mk, &mv, q, k, v, N, L, H, d, strides,
                             dpad)))
        return err;
    if ((err = make_slab_map(&mdo, dout, N, L, H, d, (long long)L * H * d,
                             (long long)H * d, d, dpad)))
        return err;
    cudaStream_t s = (cudaStream_t)stream;
    switch (dpad) {
        case 16: return launch_bwd<16>(mq, mk, mv, mdo, valid, dq, dk, dv,
                                       stats, N, L, H, d, heads, s);
        case 32: return launch_bwd<32>(mq, mk, mv, mdo, valid, dq, dk, dv,
                                       stats, N, L, H, d, heads, s);
        case 64: return launch_bwd<64>(mq, mk, mv, mdo, valid, dq, dk, dv,
                                       stats, N, L, H, d, heads, s);
        default: return launch_bwd<128>(mq, mk, mv, mdo, valid, dq, dk, dv,
                                        stats, N, L, H, d, heads, s);
    }
}

const char* mrgcn_attention_heads_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

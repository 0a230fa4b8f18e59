// Fused single-head attention core for Hopper (sm_90a), forward and
// backward, for the text encoder's sequences (up to 512 tokens, its
// tokenizer's limit).
//
// Forward, per sequence n (q already multiplied by 1/sqrt(d)):
//   s[i, j] = q[i] . k[j]            (bf16 inputs, f32 sums)
//   s[i, j] = -1e9 where key j is padding (valid[n, j] == 0)
//   p = softmax_j(s)                 (f32)
//   out[i] = sum_j bf16(p[i, j]) v[j] (f32 sums, stored bf16)
// Backward recomputes p, then
//   dv = bf16(p)^T do, dp = do v^T, ds = p (dp - rowsum(dp p)),
//   ds = 0 at padding keys, dq = bf16(ds) k, dk = bf16(ds)^T q.
//
// Replaces: mrgcn_tpu/ops/attention.py::_fwd_kernel and ::_bwd_kernel (the
// TPU kernels behind fused_attention). Those run G = 8 sequences per step
// of an in-order grid with the (L, L) probabilities held in VMEM, and pad L
// and d to 128 and N to a multiple of 8.
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
//
// What the design does about it:
//  * Up to L = 128 (the DMG-width slice's strings): one CTA per sequence,
//    8 warps, each owning 16 query rows. The whole sequence's K and V
//    (and, backward, Q and dO) sit in shared memory, so every input byte
//    is read from device memory once and the (L, L) scores never leave
//    the chip: the forward keeps them in registers, the backward puts bf16
//    P^T and dS^T in shared memory for dK and dV, which are then whole
//    products in the same CTA. Shared memory is 102 KB forward at
//    L = d = 128 (two CTAs per SM), 205 KB backward (one).
//  * Longer sequences (up to 512, the text encoder's limit): one CTA
//    per (sequence, 128 rows), the other side walked in chunks of 64 rows.
//    The softmax statistics come from exact passes (row max, then row
//    sum) so p is the same exp(s - max) / sum; the backward's dq kernel
//    also stores each row's (max, sum, D = rowsum(dp p)) in f32 scratch,
//    and a second kernel over key tiles sums dK and dV over query chunks
//    in order. Scores are recomputed per pass: more tensor work, still no
//    (L, L) tensor in device memory, no atomics.
//  * Products are mma.sync m16n8k16 bf16 -> f32 tensor-core instructions
//    with fragments loaded from shared memory rows padded by 16 bytes.
//    Scores become the A operand of the next product without leaving
//    registers (the accumulator layout of one product is the operand
//    layout of the next).
//  * Deterministic: every output element is summed by one thread in a
//    fixed order.
//  * Limits: L <= 512, d <= 128 and a multiple of 8 (the wrapper checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxL = 128;            // longest sequence run in one CTA
constexpr int kMaxD = 128;
constexpr int kPad = 8;               // bf16 elements added to each row
constexpr int kMaxKeyTiles = kMaxL / 8;
constexpr int kMaxDimTiles = kMaxD / 8;
constexpr float kMasked = -1e9f;

__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// two consecutive bf16 (lower address in the low half)
__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 from separate addresses
__device__ __forceinline__ uint32_t ld_split(const bf16* lo, const bf16* hi) {
    const uint32_t a = *reinterpret_cast<const uint16_t*>(lo);
    const uint32_t b = *reinterpret_cast<const uint16_t*>(hi);
    return a | (b << 16);
}

// c += a b for one 16x16 (a, row-major) by 16x8 (b, col-major) bf16 tile
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of the 16x16 block at (i0, k0) of a row-major matrix
__device__ __forceinline__ void ld_a(uint32_t a[4], const bf16* base,
                                     int ld, int i0, int k0, int g, int t) {
    const bf16* p = base + (i0 + g) * ld + k0 + 2 * t;
    a[0] = ld_pair(p);
    a[1] = ld_pair(p + 8 * ld);
    a[2] = ld_pair(p + 8);
    a[3] = ld_pair(p + 8 * ld + 8);
}

// Rows [0, Lp) x cols [0, Dp) of an (L, d) matrix with row stride `sl`
// into shared memory (row stride `ld`), zero outside (L, d). 16-byte loads.
__device__ void load_rows(bf16* dst, int ld, const bf16* src, long long sl,
                          int L, int d, int Lp, int Dp) {
    const int vecs = Dp / 8;
    for (int i = threadIdx.x; i < Lp * vecs; i += kThreads) {
        const int r = i / vecs;
        const int c = (i % vecs) * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (r < L && c < d)
            v = __ldg(reinterpret_cast<const uint4*>(src + r * sl + c));
        *reinterpret_cast<uint4*>(dst + r * ld + c) = v;
    }
}

// key_ok[j]: 1 valid key, 0 padding key, -1 past the end of the sequence
__device__ void load_keys(int* key_ok, const uint8_t* valid, int L, int Lp) {
    for (int j = threadIdx.x; j < Lp; j += kThreads)
        key_ok[j] = j < L ? (valid[j] ? 1 : 0) : -1;
}

// Scores of the warp's 16 query rows against every key, masked and turned
// into f32 probabilities in place. Thread (g, t) holds, per key tile nt,
// rows g (s[nt][0..1]) and g + 8 (s[nt][2..3]) at keys nt*8 + 2t + {0, 1}.
__device__ __forceinline__ void softmax_rows(
        float s[kMaxKeyTiles][4], const bf16* Qs, const bf16* Ks, int ld,
        const int* key_ok, int r0, int Lp, int Dp, int g, int t) {
#pragma unroll
    for (int nt = 0; nt < kMaxKeyTiles; ++nt)
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kMaxD / 16; ++kk) {
        if (kk * 16 >= Dp) break;
        uint32_t a[4];
        ld_a(a, Qs, ld, r0, kk * 16, g, t);
#pragma unroll
        for (int nt = 0; nt < kMaxKeyTiles; ++nt) {
            if (nt * 8 >= Lp) break;
            const bf16* kb = Ks + (nt * 8 + g) * ld + kk * 16 + 2 * t;
            mma(s[nt], a, ld_pair(kb), ld_pair(kb + 8));
        }
    }
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kMaxKeyTiles; ++nt) {
        if (nt * 8 >= Lp) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int ok = key_ok[nt * 8 + 2 * t + (e & 1)];
            const float x = ok > 0 ? s[nt][e] : (ok == 0 ? kMasked : -INFINITY);
            s[nt][e] = x;
            if (e < 2) m0 = fmaxf(m0, x); else m1 = fmaxf(m1, x);
        }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
    }
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kMaxKeyTiles; ++nt) {
        if (nt * 8 >= Lp) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float p = expf(s[nt][e] - (e < 2 ? m0 : m1));
            s[nt][e] = p;
            if (e < 2) l0 += p; else l1 += p;
        }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
#pragma unroll
    for (int nt = 0; nt < kMaxKeyTiles; ++nt) {
        if (nt * 8 >= Lp) break;
        s[nt][0] /= l0;
        s[nt][1] /= l0;
        s[nt][2] /= l1;
        s[nt][3] /= l1;
    }
}

// Accumulator tiles (key-tile layout) -> bf16 A fragments over keys
__device__ __forceinline__ void to_a(uint32_t a[kMaxL / 16][4],
                                     const float s[kMaxKeyTiles][4], int Lp) {
#pragma unroll
    for (int kk = 0; kk < kMaxL / 16; ++kk) {
        if (kk * 16 >= Lp) break;
        a[kk][0] = pack2(s[2 * kk][0], s[2 * kk][1]);
        a[kk][1] = pack2(s[2 * kk][2], s[2 * kk][3]);
        a[kk][2] = pack2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        a[kk][3] = pack2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
}

// acc[dt] (rows r0+g, r0+g+8; cols dt*8+2t+{0,1}) -> bf16 rows of a
// contiguous (L, d) matrix
__device__ __forceinline__ void store_rows(bf16* dst,
                                           const float acc[kMaxDimTiles][4],
                                           int r0, int L, int d, int g, int t) {
    const int row0 = r0 + g;
    const int row1 = row0 + 8;
#pragma unroll
    for (int dt = 0; dt < kMaxDimTiles; ++dt) {
        const int col = dt * 8 + 2 * t;
        if (col >= d) break;
        if (row0 < L)
            *reinterpret_cast<uint32_t*>(dst + row0 * d + col) =
                pack2(acc[dt][0], acc[dt][1]);
        if (row1 < L)
            *reinterpret_cast<uint32_t*>(dst + row1 * d + col) =
                pack2(acc[dt][2], acc[dt][3]);
    }
}

// acc[dt] += A (16 x Lp, given as fragments) times B (Lp x Dp, row-major
// in shared memory: B(k, n) = base[k * ld + n])
__device__ __forceinline__ void mma_rowmajor_b(
        float acc[kMaxDimTiles][4], const uint32_t a[kMaxL / 16][4],
        const bf16* base, int ld, int Lp, int Dp, int g, int t) {
#pragma unroll
    for (int dt = 0; dt < kMaxDimTiles; ++dt)
        acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kMaxL / 16; ++kk) {
        if (kk * 16 >= Lp) break;
#pragma unroll
        for (int dt = 0; dt < kMaxDimTiles; ++dt) {
            if (dt * 8 >= Dp) break;
            const bf16* b = base + (kk * 16 + 2 * t) * ld + dt * 8 + g;
            mma(acc[dt], a[kk], ld_split(b, b + ld),
                ld_split(b + 8 * ld, b + 9 * ld));
        }
    }
}

__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const uint8_t* __restrict__ valid,
                     bf16* __restrict__ out, int L, int d,
                     long long q_sn, long long q_sl, long long k_sn,
                     long long k_sl, long long v_sn, long long v_sl) {
    const long long n = blockIdx.x;
    const int Lp = round16(L), Dp = round16(d);
    const int ld = Dp + kPad;
    extern __shared__ uint4 smem_u4[];
    bf16* Qs = reinterpret_cast<bf16*>(smem_u4);
    bf16* Ks = Qs + Lp * ld;
    bf16* Vs = Ks + Lp * ld;
    int* key_ok = reinterpret_cast<int*>(Vs + Lp * ld);

    load_rows(Qs, ld, q + n * q_sn, q_sl, L, d, Lp, Dp);
    load_rows(Ks, ld, k + n * k_sn, k_sl, L, d, Lp, Dp);
    load_rows(Vs, ld, v + n * v_sn, v_sl, L, d, Lp, Dp);
    load_keys(key_ok, valid + n * L, L, Lp);
    __syncthreads();

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = warp * 16;
    if (r0 >= Lp) return;

    float s[kMaxKeyTiles][4];
    softmax_rows(s, Qs, Ks, ld, key_ok, r0, Lp, Dp, g, t);
    uint32_t pa[kMaxL / 16][4];
    to_a(pa, s, Lp);
    float o[kMaxDimTiles][4];
    mma_rowmajor_b(o, pa, Vs, ld, Lp, Dp, g, t);
    store_rows(out + n * L * d, o, r0, L, d, g, t);
}

__global__ void __launch_bounds__(kThreads)
attention_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const uint8_t* __restrict__ valid,
                     const bf16* __restrict__ dout, bf16* __restrict__ dq,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int L,
                     int d, long long q_sn, long long q_sl, long long k_sn,
                     long long k_sl, long long v_sn, long long v_sl) {
    const long long n = blockIdx.x;
    const int Lp = round16(L), Dp = round16(d);
    const int ld = Dp + kPad;
    const int lt = Lp + kPad;
    extern __shared__ uint4 smem_u4[];
    bf16* Qs = reinterpret_cast<bf16*>(smem_u4);
    bf16* Ks = Qs + Lp * ld;
    bf16* Vs = Ks + Lp * ld;
    bf16* dOs = Vs + Lp * ld;
    bf16* Pt = dOs + Lp * ld;          // Pt[key][query] = bf16(p)
    bf16* dSt = Pt + Lp * lt;          // dSt[key][query] = bf16(ds)
    int* key_ok = reinterpret_cast<int*>(dSt + Lp * lt);

    const long long base = n * L * d;
    load_rows(Qs, ld, q + n * q_sn, q_sl, L, d, Lp, Dp);
    load_rows(Ks, ld, k + n * k_sn, k_sl, L, d, Lp, Dp);
    load_rows(Vs, ld, v + n * v_sn, v_sl, L, d, Lp, Dp);
    load_rows(dOs, ld, dout + base, d, L, d, Lp, Dp);
    load_keys(key_ok, valid + n * L, L, Lp);
    __syncthreads();

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = warp * 16;

    // query rows r0..r0+15: p, dp, ds; P^T and dS^T to shared; dq
    if (r0 < Lp) {
        float s[kMaxKeyTiles][4];
        softmax_rows(s, Qs, Ks, ld, key_ok, r0, Lp, Dp, g, t);
        float dp[kMaxKeyTiles][4];
#pragma unroll
        for (int nt = 0; nt < kMaxKeyTiles; ++nt)
            dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kMaxD / 16; ++kk) {
            if (kk * 16 >= Dp) break;
            uint32_t a[4];
            ld_a(a, dOs, ld, r0, kk * 16, g, t);
#pragma unroll
            for (int nt = 0; nt < kMaxKeyTiles; ++nt) {
                if (nt * 8 >= Lp) break;
                const bf16* vb = Vs + (nt * 8 + g) * ld + kk * 16 + 2 * t;
                mma(dp[nt], a, ld_pair(vb), ld_pair(vb + 8));
            }
        }
        float D0 = 0.f, D1 = 0.f;
#pragma unroll
        for (int nt = 0; nt < kMaxKeyTiles; ++nt) {
            if (nt * 8 >= Lp) break;
            D0 += s[nt][0] * dp[nt][0] + s[nt][1] * dp[nt][1];
            D1 += s[nt][2] * dp[nt][2] + s[nt][3] * dp[nt][3];
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
            D0 += __shfl_xor_sync(0xffffffffu, D0, off);
            D1 += __shfl_xor_sync(0xffffffffu, D1, off);
        }
#pragma unroll
        for (int nt = 0; nt < kMaxKeyTiles; ++nt) {
            if (nt * 8 >= Lp) break;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int j = nt * 8 + 2 * t + (e & 1);
                const int i = r0 + g + (e >> 1) * 8;
                const float p = s[nt][e];
                const float ds = key_ok[j] > 0
                    ? p * (dp[nt][e] - (e < 2 ? D0 : D1)) : 0.f;
                dp[nt][e] = ds;
                Pt[j * lt + i] = __float2bfloat16_rn(p);
                dSt[j * lt + i] = __float2bfloat16_rn(ds);
            }
        }
        uint32_t da[kMaxL / 16][4];
        to_a(da, dp, Lp);
        float acc[kMaxDimTiles][4];
        mma_rowmajor_b(acc, da, Ks, ld, Lp, Dp, g, t);
        store_rows(dq + base, acc, r0, L, d, g, t);
    }
    __syncthreads();

    // key rows r0..r0+15: dv = P^T dO, dk = dS^T Q
    if (r0 < Lp) {
        uint32_t a[kMaxL / 16][4];
        float acc[kMaxDimTiles][4];
#pragma unroll
        for (int kk = 0; kk < kMaxL / 16; ++kk)
            if (kk * 16 < Lp) ld_a(a[kk], Pt, lt, r0, kk * 16, g, t);
        mma_rowmajor_b(acc, a, dOs, ld, Lp, Dp, g, t);
        store_rows(dv + base, acc, r0, L, d, g, t);
#pragma unroll
        for (int kk = 0; kk < kMaxL / 16; ++kk)
            if (kk * 16 < Lp) ld_a(a[kk], dSt, lt, r0, kk * 16, g, t);
        mma_rowmajor_b(acc, a, Qs, ld, Lp, Dp, g, t);
        store_rows(dk + base, acc, r0, L, d, g, t);
    }
}

// ---------------------------------------------------------------------------
// Sequences longer than kMaxL: one CTA per (sequence, tile of 128 rows),
// the other side walked in chunks of 64 rows through shared memory.
// Forward and dq take the softmax statistics in exact passes (row max,
// then row sum, then the product) rather than an online rescale, so p is
// exp(s - max) / sum as in the short kernels. dk and dv come from a second
// kernel over key tiles that reads the rows' (max, sum, D) from scratch.
// ---------------------------------------------------------------------------

constexpr int kTile = kWarps * 16;     // rows per CTA: 16 per warp
constexpr int kChunk = 64;             // keys (or queries) per chunk
constexpr int kChunkTiles = kChunk / 8;
constexpr int kMaxLongL = 512;     // the text encoder's max_len

__host__ __device__ inline int round64(int x) { return (x + 63) & ~63; }

// logit of score x at a key whose status is ok (1 valid, 0 padding, -1
// past the end of the sequence)
__device__ __forceinline__ float masked(float x, int ok) {
    return ok > 0 ? x : (ok == 0 ? kMasked : -INFINITY);
}

// s[nt] = rows r0..r0+15 of X times rows 0..63 of Y, transposed: X Y^T
// over d (both row-major in shared memory, row stride ld)
__device__ __forceinline__ void chunk_scores(float s[kChunkTiles][4],
                                             const bf16* X, const bf16* Y,
                                             int ld, int r0, int Dp, int g,
                                             int t) {
#pragma unroll
    for (int nt = 0; nt < kChunkTiles; ++nt)
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kMaxD / 16; ++kk) {
        if (kk * 16 >= Dp) break;
        uint32_t a[4];
        ld_a(a, X, ld, r0, kk * 16, g, t);
#pragma unroll
        for (int nt = 0; nt < kChunkTiles; ++nt) {
            const bf16* yb = Y + (nt * 8 + g) * ld + kk * 16 + 2 * t;
            mma(s[nt], a, ld_pair(yb), ld_pair(yb + 8));
        }
    }
}

__device__ __forceinline__ void chunk_to_a(uint32_t a[kChunk / 16][4],
                                           const float s[kChunkTiles][4]) {
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
        a[kk][0] = pack2(s[2 * kk][0], s[2 * kk][1]);
        a[kk][1] = pack2(s[2 * kk][2], s[2 * kk][3]);
        a[kk][2] = pack2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        a[kk][3] = pack2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
}

// acc[dt] += A (16 x 64, fragments) times rows 0..63 of B (row-major)
__device__ __forceinline__ void chunk_mma(float acc[kMaxDimTiles][4],
                                          const uint32_t a[kChunk / 16][4],
                                          const bf16* base, int ld, int Dp,
                                          int g, int t) {
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
#pragma unroll
        for (int dt = 0; dt < kMaxDimTiles; ++dt) {
            if (dt * 8 >= Dp) break;
            const bf16* b = base + (kk * 16 + 2 * t) * ld + dt * 8 + g;
            mma(acc[dt], a[kk], ld_split(b, b + ld),
                ld_split(b + 8 * ld, b + 9 * ld));
        }
    }
}

__device__ __forceinline__ void zero_acc(float acc[kMaxDimTiles][4]) {
#pragma unroll
    for (int dt = 0; dt < kMaxDimTiles; ++dt)
        acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
}

// Row max (m) and row sum (l) of the softmax of the warp's 16 query rows
// in Qs against every key, the keys loaded chunk by chunk into Ks. Every
// thread of the CTA calls it (it synchronises).
__device__ __forceinline__ void row_stats(
        float m[2], float l[2], const bf16* Qs, bf16* Ks,
        const bf16* kn, long long k_sl, const int* key_ok, int L, int d,
        int Dp, int ld, int r0, int g, int t) {
    const int Lk = round64(L);
    m[0] = m[1] = -INFINITY;
    for (int pass = 0; pass < 2; ++pass) {
        l[0] = l[1] = 0.f;
        for (int c0 = 0; c0 < Lk; c0 += kChunk) {
            __syncthreads();
            load_rows(Ks, ld, kn + c0 * k_sl, k_sl, L - c0, d, kChunk, Dp);
            __syncthreads();
            float s[kChunkTiles][4];
            chunk_scores(s, Qs, Ks, ld, r0, Dp, g, t);
#pragma unroll
            for (int nt = 0; nt < kChunkTiles; ++nt) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float x = masked(
                        s[nt][e], key_ok[c0 + nt * 8 + 2 * t + (e & 1)]);
                    if (pass == 0) m[e >> 1] = fmaxf(m[e >> 1], x);
                    else l[e >> 1] += expf(x - m[e >> 1]);
                }
            }
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                if (pass == 0)
                    m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], off));
                else
                    l[h] += __shfl_xor_sync(0xffffffffu, l[h], off);
            }
        }
    }
}

__global__ void __launch_bounds__(kThreads)
attention_fwd_long_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const uint8_t* __restrict__ valid,
                          bf16* __restrict__ out, int L, int d,
                          long long q_sn, long long q_sl, long long k_sn,
                          long long k_sl, long long v_sn, long long v_sl) {
    const long long n = blockIdx.x;
    const int q0 = blockIdx.y * kTile;
    const int Lk = round64(L), Dp = round16(d), ld = Dp + kPad;
    extern __shared__ uint4 smem_u4[];
    bf16* Qs = reinterpret_cast<bf16*>(smem_u4);
    bf16* Ks = Qs + kTile * ld;
    bf16* Vs = Ks + kChunk * ld;
    int* key_ok = reinterpret_cast<int*>(Vs + kChunk * ld);
    const bf16* kn = k + n * k_sn;
    const bf16* vn = v + n * v_sn;

    load_rows(Qs, ld, q + n * q_sn + q0 * q_sl, q_sl, L - q0, d, kTile, Dp);
    load_keys(key_ok, valid + n * L, L, Lk);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = warp * 16;
    float m[2], l[2];
    row_stats(m, l, Qs, Ks, kn, k_sl, key_ok, L, d, Dp, ld, r0, g, t);

    float o[kMaxDimTiles][4];
    zero_acc(o);
    for (int c0 = 0; c0 < Lk; c0 += kChunk) {
        __syncthreads();
        load_rows(Ks, ld, kn + c0 * k_sl, k_sl, L - c0, d, kChunk, Dp);
        load_rows(Vs, ld, vn + c0 * v_sl, v_sl, L - c0, d, kChunk, Dp);
        __syncthreads();
        float s[kChunkTiles][4];
        chunk_scores(s, Qs, Ks, ld, r0, Dp, g, t);
#pragma unroll
        for (int nt = 0; nt < kChunkTiles; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int ok = key_ok[c0 + nt * 8 + 2 * t + (e & 1)];
                s[nt][e] = expf(masked(s[nt][e], ok) - m[e >> 1]) / l[e >> 1];
            }
        }
        uint32_t pa[kChunk / 16][4];
        chunk_to_a(pa, s);
        chunk_mma(o, pa, Vs, ld, Dp, g, t);
    }
    store_rows(out + n * L * d + (long long)q0 * d, o, r0, L - q0, d, g, t);
}

// dq for a tile of 128 query rows, and the rows' (max, sum, D) into
// stats (3, N, L) for the dk/dv kernel
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_long_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const uint8_t* __restrict__ valid,
                             const bf16* __restrict__ dout,
                             bf16* __restrict__ dq, float* __restrict__ stats,
                             int N, int L, int d, long long q_sn,
                             long long q_sl, long long k_sn, long long k_sl,
                             long long v_sn, long long v_sl) {
    const long long n = blockIdx.x;
    const int q0 = blockIdx.y * kTile;
    const int Lk = round64(L), Dp = round16(d), ld = Dp + kPad;
    extern __shared__ uint4 smem_u4[];
    bf16* Qs = reinterpret_cast<bf16*>(smem_u4);
    bf16* dOs = Qs + kTile * ld;
    bf16* Ks = dOs + kTile * ld;
    bf16* Vs = Ks + kChunk * ld;
    int* key_ok = reinterpret_cast<int*>(Vs + kChunk * ld);
    const bf16* kn = k + n * k_sn;
    const bf16* vn = v + n * v_sn;
    const long long base = n * L * d + (long long)q0 * d;

    load_rows(Qs, ld, q + n * q_sn + q0 * q_sl, q_sl, L - q0, d, kTile, Dp);
    load_rows(dOs, ld, dout + base, d, L - q0, d, kTile, Dp);
    load_keys(key_ok, valid + n * L, L, Lk);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = warp * 16;
    float m[2], l[2];
    row_stats(m, l, Qs, Ks, kn, k_sl, key_ok, L, d, Dp, ld, r0, g, t);

    // pass D (the rows' sum of p dp), then pass dq
    float D[2] = {0.f, 0.f};
    float acc[kMaxDimTiles][4];
    zero_acc(acc);
    for (int pass = 0; pass < 2; ++pass) {
        for (int c0 = 0; c0 < Lk; c0 += kChunk) {
            __syncthreads();
            load_rows(Ks, ld, kn + c0 * k_sl, k_sl, L - c0, d, kChunk, Dp);
            load_rows(Vs, ld, vn + c0 * v_sl, v_sl, L - c0, d, kChunk, Dp);
            __syncthreads();
            float s[kChunkTiles][4], dp[kChunkTiles][4];
            chunk_scores(s, Qs, Ks, ld, r0, Dp, g, t);
            chunk_scores(dp, dOs, Vs, ld, r0, Dp, g, t);
#pragma unroll
            for (int nt = 0; nt < kChunkTiles; ++nt) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int h = e >> 1;
                    const int ok = key_ok[c0 + nt * 8 + 2 * t + (e & 1)];
                    const float p = expf(masked(s[nt][e], ok) - m[h]) / l[h];
                    if (pass == 0) D[h] += p * dp[nt][e];
                    else dp[nt][e] = ok > 0 ? p * (dp[nt][e] - D[h]) : 0.f;
                }
            }
            if (pass == 1) {
                uint32_t da[kChunk / 16][4];
                chunk_to_a(da, dp);
                chunk_mma(acc, da, Ks, ld, Dp, g, t);
            }
        }
        if (pass == 0) {
#pragma unroll
            for (int off = 1; off < 4; off <<= 1) {
                D[0] += __shfl_xor_sync(0xffffffffu, D[0], off);
                D[1] += __shfl_xor_sync(0xffffffffu, D[1], off);
            }
        }
    }
    store_rows(dq + base, acc, r0, L - q0, d, g, t);
    if (t == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = q0 + r0 + g + 8 * h;
            if (row < L) {
                const long long i = n * L + row;
                stats[i] = m[h];
                stats[(long long)N * L + i] = l[h];
                stats[2LL * N * L + i] = D[h];
            }
        }
    }
}

// dv = P^T dO and dk = dS^T Q for a tile of 128 key rows, walking the
// queries in chunks with their (max, sum, D) from stats
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkv_long_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const uint8_t* __restrict__ valid,
                              const bf16* __restrict__ dout,
                              const float* __restrict__ stats,
                              bf16* __restrict__ dk, bf16* __restrict__ dv,
                              int N, int L, int d, long long q_sn,
                              long long q_sl, long long k_sn,
                              long long k_sl, long long v_sn,
                              long long v_sl) {
    const long long n = blockIdx.x;
    const int k0 = blockIdx.y * kTile;
    const int Lq = round64(L), Dp = round16(d), ld = Dp + kPad;
    extern __shared__ uint4 smem_u4[];
    bf16* Ks = reinterpret_cast<bf16*>(smem_u4);
    bf16* Vs = Ks + kTile * ld;
    bf16* Qs = Vs + kTile * ld;
    bf16* dOs = Qs + kChunk * ld;
    float* sm = reinterpret_cast<float*>(dOs + kChunk * ld);
    float* sl = sm + kChunk;
    float* sD = sl + kChunk;
    int* q_ok = reinterpret_cast<int*>(sD + kChunk);
    const bf16* qn = q + n * q_sn;
    const long long seq = n * L * d;

    load_rows(Ks, ld, k + n * k_sn + k0 * k_sl, k_sl, L - k0, d, kTile, Dp);
    load_rows(Vs, ld, v + n * v_sn + k0 * v_sl, v_sl, L - k0, d, kTile, Dp);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = warp * 16;
    int key_ok[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int j = k0 + r0 + g + 8 * h;
        key_ok[h] = j < L ? (valid[n * L + j] ? 1 : 0) : -1;
    }

    for (int pass = 0; pass < 2; ++pass) {      // 0: dv, 1: dk
        float acc[kMaxDimTiles][4];
        zero_acc(acc);
        for (int c0 = 0; c0 < Lq; c0 += kChunk) {
            __syncthreads();
            load_rows(Qs, ld, qn + c0 * q_sl, q_sl, L - c0, d, kChunk, Dp);
            load_rows(dOs, ld, dout + seq + (long long)c0 * d, d, L - c0, d,
                      kChunk, Dp);
            for (int j = threadIdx.x; j < kChunk; j += kThreads) {
                const int row = c0 + j;
                const bool in = row < L;
                const long long i = n * L + row;
                sm[j] = in ? stats[i] : 0.f;
                sl[j] = in ? stats[(long long)N * L + i] : 1.f;
                sD[j] = in ? stats[2LL * N * L + i] : 0.f;
                q_ok[j] = in;
            }
            __syncthreads();
            // keys (rows) x queries (columns) of this chunk
            float s[kChunkTiles][4], dp[kChunkTiles][4];
            chunk_scores(s, Ks, Qs, ld, r0, Dp, g, t);
            if (pass == 1) chunk_scores(dp, Vs, dOs, ld, r0, Dp, g, t);
#pragma unroll
            for (int nt = 0; nt < kChunkTiles; ++nt) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int ok = key_ok[e >> 1];
                    const int j = nt * 8 + 2 * t + (e & 1);
                    const float p = ok >= 0 && q_ok[j]
                        ? expf(masked(s[nt][e], ok) - sm[j]) / sl[j] : 0.f;
                    if (pass == 0) s[nt][e] = p;
                    else dp[nt][e] = ok > 0 ? p * (dp[nt][e] - sD[j]) : 0.f;
                }
            }
            uint32_t a[kChunk / 16][4];
            if (pass == 0) {
                chunk_to_a(a, s);
                chunk_mma(acc, a, dOs, ld, Dp, g, t);
            } else {
                chunk_to_a(a, dp);
                chunk_mma(acc, a, Qs, ld, Dp, g, t);
            }
        }
        store_rows((pass == 0 ? dv : dk) + seq + (long long)k0 * d, acc, r0,
                   L - k0, d, g, t);
    }
}

size_t fwd_long_smem(int L, int d) {
    return (size_t)(kTile + 2 * kChunk) * (round16(d) + kPad) * sizeof(bf16)
         + (size_t)round64(L) * sizeof(int);
}

size_t bwd_long_smem(int L, int d) {
    const size_t tiles = (size_t)(2 * kTile + 2 * kChunk)
                       * (round16(d) + kPad) * sizeof(bf16);
    const size_t dq = tiles + (size_t)round64(L) * sizeof(int);
    const size_t dkv = tiles + (size_t)kChunk * 4 * sizeof(float);
    return dq > dkv ? dq : dkv;
}

}  // namespace

extern "C" {

int mrgcn_attention_max_len() { return kMaxLongL; }
int mrgcn_attention_max_dim() { return kMaxD; }

size_t mrgcn_attention_fwd_smem_bytes(int L, int d) {
    if (L > kMaxL) return fwd_long_smem(L, d);
    const int Lp = round16(L), Dp = round16(d);
    return (size_t)3 * Lp * (Dp + kPad) * sizeof(bf16) + Lp * sizeof(int);
}

size_t mrgcn_attention_bwd_smem_bytes(int L, int d) {
    if (L > kMaxL) return bwd_long_smem(L, d);
    const int Lp = round16(L), Dp = round16(d);
    return (size_t)4 * Lp * (Dp + kPad) * sizeof(bf16)
         + (size_t)2 * Lp * (Lp + kPad) * sizeof(bf16) + Lp * sizeof(int);
}

// f32 scratch the backward needs: the rows' (max, sum, D) past kMaxL
long long mrgcn_attention_bwd_scratch_floats(int N, int L) {
    return L > kMaxL ? 3LL * N * L : 0;
}

static int set_smem(const void* kernel, size_t smem) {
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// q, k, v: (N, L, d) bf16 with the given element strides over N and L and
// a contiguous last dim; valid: (N, L) uint8; out: contiguous (N, L, d).
// L <= kMaxL: one CTA per sequence; longer: one per (sequence, 128 rows).
// Launches on `stream`; returns cudaGetLastError() (0 on success).
int mrgcn_attention_fwd_bf16(const void* q, const void* k, const void* v,
                             const void* valid, void* out, int N, int L,
                             int d, long long q_sn, long long q_sl,
                             long long k_sn, long long k_sl, long long v_sn,
                             long long v_sl, void* stream) {
    const size_t smem = mrgcn_attention_fwd_smem_bytes(L, d);
    cudaStream_t s = (cudaStream_t)stream;
    if (L <= kMaxL) {
        int err = set_smem((const void*)attention_fwd_kernel, smem);
        if (err) return err;
        attention_fwd_kernel<<<N, kThreads, smem, s>>>(
            (const bf16*)q, (const bf16*)k, (const bf16*)v,
            (const uint8_t*)valid, (bf16*)out, L, d, q_sn, q_sl, k_sn, k_sl,
            v_sn, v_sl);
    } else {
        int err = set_smem((const void*)attention_fwd_long_kernel, smem);
        if (err) return err;
        const dim3 grid(N, (L + kTile - 1) / kTile);
        attention_fwd_long_kernel<<<grid, kThreads, smem, s>>>(
            (const bf16*)q, (const bf16*)k, (const bf16*)v,
            (const uint8_t*)valid, (bf16*)out, L, d, q_sn, q_sl, k_sn, k_sl,
            v_sn, v_sl);
    }
    return (int)cudaGetLastError();
}

// As the forward, plus dout (contiguous (N, L, d)) in and dq, dk, dv
// (contiguous (N, L, d) bf16) out; stats: f32 scratch of
// mrgcn_attention_bwd_scratch_floats(N, L) (unused up to kMaxL).
int mrgcn_attention_bwd_bf16(const void* q, const void* k, const void* v,
                             const void* valid, const void* dout, void* dq,
                             void* dk, void* dv, void* stats, int N, int L,
                             int d, long long q_sn, long long q_sl,
                             long long k_sn, long long k_sl, long long v_sn,
                             long long v_sl, void* stream) {
    const size_t smem = mrgcn_attention_bwd_smem_bytes(L, d);
    cudaStream_t s = (cudaStream_t)stream;
    if (L <= kMaxL) {
        int err = set_smem((const void*)attention_bwd_kernel, smem);
        if (err) return err;
        attention_bwd_kernel<<<N, kThreads, smem, s>>>(
            (const bf16*)q, (const bf16*)k, (const bf16*)v,
            (const uint8_t*)valid, (const bf16*)dout, (bf16*)dq, (bf16*)dk,
            (bf16*)dv, L, d, q_sn, q_sl, k_sn, k_sl, v_sn, v_sl);
        return (int)cudaGetLastError();
    }
    int err = set_smem((const void*)attention_bwd_dq_long_kernel, smem);
    if (err) return err;
    err = set_smem((const void*)attention_bwd_dkv_long_kernel, smem);
    if (err) return err;
    const dim3 grid(N, (L + kTile - 1) / kTile);
    attention_bwd_dq_long_kernel<<<grid, kThreads, smem, s>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v,
        (const uint8_t*)valid, (const bf16*)dout, (bf16*)dq, (float*)stats,
        N, L, d, q_sn, q_sl, k_sn, k_sl, v_sn, v_sl);
    err = (int)cudaGetLastError();
    if (err) return err;
    attention_bwd_dkv_long_kernel<<<grid, kThreads, smem, s>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v,
        (const uint8_t*)valid, (const bf16*)dout, (const float*)stats,
        (bf16*)dk, (bf16*)dv, N, L, d, q_sn, q_sl, k_sn, k_sl, v_sn, v_sl);
    return (int)cudaGetLastError();
}

const char* mrgcn_attention_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

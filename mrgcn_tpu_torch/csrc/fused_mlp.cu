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
// rows, d = 128, hd = 512) each row block does 4 d hd FLOP per row in the
// forward against 4 d bytes in and 2 d bytes out: ~340 FLOP per byte, at
// the H100's bf16 ridge. Keeping the hidden tensor (1 GB in bf16) out of
// device memory is the point; after that the tensor-core rate of
// mma.sync (a fraction of wgmma's) bounds it.
//
// What the design does about it:
//  * Forward: one CTA per 128 rows, 8 warps of 16 rows. The hidden
//    dimension is walked in chunks of 64: each chunk's W1 and W2 slices go
//    to shared memory, the chunk's hidden activations stay in registers
//    (the accumulator layout of x W1 is the operand layout of h W2) and
//    are summed into the (16, d) output tile each warp holds.
//  * Backward, dx: the same walk, recomputing h_pre and dh per chunk and
//    summing dh_pre W1^T into registers.
//  * Backward, weights: CTAs run in no order, so nothing is carried
//    between them. CTA (chunk c, row segment s) walks its segment's rows
//    in order and keeps its slices of dW1, dW2 and db1 (and, for c = 0,
//    db2) in registers; each writes one f32 partial per segment, and a
//    second pass sums the partials over segments in a fixed order. The
//    result is deterministic and needs no atomics.
//  * Limits: d a multiple of 16 up to 128, hd a multiple of 64 (the
//    wrapper checks). Products are mma.sync m16n8k16 bf16 -> f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 128;       // rows per CTA (forward, dx)
constexpr int kSegRows = 64;     // rows per step of the weight-gradient CTAs
constexpr int kChunk = 64;       // hidden columns per chunk
constexpr int kMaxD = 128;
constexpr int kPad = 8;          // bf16 elements added to each smem row
constexpr int kDimTiles = kMaxD / 8;

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ld_split(const bf16* lo, const bf16* hi) {
    const uint32_t a = *reinterpret_cast<const uint16_t*>(lo);
    const uint32_t b = *reinterpret_cast<const uint16_t*>(hi);
    return a | (b << 16);
}

__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of the 16x16 block at (i0, k0): A(i, k) = base[i * ld + k]
__device__ __forceinline__ void ld_a(uint32_t a[4], const bf16* base,
                                     int ld, int i0, int k0, int g, int t) {
    const bf16* p = base + (i0 + g) * ld + k0 + 2 * t;
    a[0] = ld_pair(p);
    a[1] = ld_pair(p + 8 * ld);
    a[2] = ld_pair(p + 8);
    a[3] = ld_pair(p + 8 * ld + 8);
}

// A fragment of the 16x16 block at (i0, k0) of a transposed matrix:
// A(i, k) = base[k * ld + i]
__device__ __forceinline__ void ld_a_t(uint32_t a[4], const bf16* base,
                                       int ld, int i0, int k0, int g, int t) {
    const bf16* p = base + (k0 + 2 * t) * ld + i0 + g;
    a[0] = ld_split(p, p + ld);
    a[1] = ld_split(p + 8, p + ld + 8);
    a[2] = ld_split(p + 8 * ld, p + 9 * ld);
    a[3] = ld_split(p + 8 * ld + 8, p + 9 * ld + 8);
}

// B fragment (16x8 at (k0, n0)) when B^T is row-major: B(k, n) = base[n * ld + k]
__device__ __forceinline__ void ld_b_t(uint32_t& b0, uint32_t& b1,
                                       const bf16* base, int ld, int k0,
                                       int n0, int g, int t) {
    const bf16* p = base + (n0 + g) * ld + k0 + 2 * t;
    b0 = ld_pair(p);
    b1 = ld_pair(p + 8);
}

// B fragment when B is row-major: B(k, n) = base[k * ld + n]
__device__ __forceinline__ void ld_b(uint32_t& b0, uint32_t& b1,
                                     const bf16* base, int ld, int k0,
                                     int n0, int g, int t) {
    const bf16* p = base + (k0 + 2 * t) * ld + n0 + g;
    b0 = ld_split(p, p + ld);
    b1 = ld_split(p + 8 * ld, p + 9 * ld);
}

__device__ __forceinline__ float gelu_tanh(float x) {
    const float c = 0.7978845608028654f;     // sqrt(2 / pi)
    const float cdf = 0.5f * (1.f + tanhf(c * (x + 0.044715f * (x * x * x))));
    return x * cdf;
}

__device__ __forceinline__ float gelu_tanh_grad(float x) {
    const float c = 0.7978845608028654f;
    const float th = tanhf(c * (x + 0.044715f * (x * x * x)));
    return 0.5f * (1.f + th)
         + x * 0.5f * (1.f - th * th) * c * (1.f + 3.f * 0.044715f * x * x);
}

// rows [r_begin, r_end) of a contiguous (*, cols) matrix, starting at
// column c0, into `nrows` rows of shared memory (row stride ld); zero
// beyond r_end. cols and c0 multiples of 8.
__device__ void load_tile(bf16* dst, int ld, const bf16* src, long long cols,
                          long long r_begin, long long r_end, int nrows,
                          int c0, int width) {
    const int vecs = width / 8;
    for (int i = threadIdx.x; i < nrows * vecs; i += kThreads) {
        const int r = i / vecs;
        const int c = (i % vecs) * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (r_begin + r < r_end)
            v = __ldg(reinterpret_cast<const uint4*>(
                src + (r_begin + r) * cols + c0 + c));
        *reinterpret_cast<uint4*>(dst + r * ld + c) = v;
    }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
}

// h[nt] (nt < 8) = rows r0..r0+15 of X (smem, ld) times the chunk's 64
// hidden columns, with the chunk given transposed: Wt(h, k) = Wt[h * ld + k]
__device__ __forceinline__ void chunk_product(float h[8][4], const bf16* X,
                                              const bf16* Wt, int ld, int r0,
                                              int d, int g, int t) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) h[nt][0] = h[nt][1] = h[nt][2] = h[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kMaxD / 16; ++kk) {
        if (kk * 16 >= d) break;
        uint32_t a[4];
        ld_a(a, X, ld, r0, kk * 16, g, t);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
            uint32_t b0, b1;
            ld_b_t(b0, b1, Wt, ld, kk * 16, nt * 8, g, t);
            mma(h[nt], a, b0, b1);
        }
    }
}

// o[dt] += (16 x 64 chunk, as fragments) times Bt^T, Bt(n, k) = Bt[n * ldc + k]
__device__ __forceinline__ void chunk_out(float o[kDimTiles][4],
                                          const uint32_t a[4][4],
                                          const bf16* Bt, int ldc, int d,
                                          int g, int t) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int dt = 0; dt < kDimTiles; ++dt) {
            if (dt * 8 >= d) break;
            uint32_t b0, b1;
            ld_b_t(b0, b1, Bt, ldc, kk * 16, dt * 8, g, t);
            mma(o[dt], a[kk], b0, b1);
        }
    }
}

__device__ __forceinline__ void store_rows(bf16* dst, const float o[kDimTiles][4],
                                           const float* bias, long long row0,
                                           long long M, int d, int g, int t) {
#pragma unroll
    for (int dt = 0; dt < kDimTiles; ++dt) {
        const int col = dt * 8 + 2 * t;
        if (col >= d) break;
        const float b0 = bias ? bias[col] : 0.f;
        const float b1 = bias ? bias[col + 1] : 0.f;
        if (row0 + g < M)
            *reinterpret_cast<uint32_t*>(dst + (row0 + g) * d + col) =
                pack2(o[dt][0] + b0, o[dt][1] + b1);
        if (row0 + g + 8 < M)
            *reinterpret_cast<uint32_t*>(dst + (row0 + g + 8) * d + col) =
                pack2(o[dt][2] + b0, o[dt][3] + b1);
    }
}

__global__ void __launch_bounds__(kThreads)
mlp_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1t,
               const bf16* __restrict__ b1, const bf16* __restrict__ w2t,
               const bf16* __restrict__ b2, bf16* __restrict__ out,
               long long M, int d, int hd) {
    const long long row_base = (long long)blockIdx.x * kRows;
    const int ld = d + kPad, ldc = kChunk + kPad;
    extern __shared__ uint4 smem_u4[];
    bf16* Xs = reinterpret_cast<bf16*>(smem_u4);   // (kRows, ld)
    bf16* W1s = Xs + kRows * ld;                   // (kChunk, ld): W1^T rows
    bf16* W2s = W1s + kChunk * ld;                 // (d, ldc): W2^T slice
    float* b1s = reinterpret_cast<float*>(W2s + d * ldc);
    float* b2s = b1s + kChunk;

    load_tile(Xs, ld, x, d, row_base, M, kRows, 0, d);
    for (int j = threadIdx.x; j < d; j += kThreads)
        b2s[j] = __bfloat162float(b2[j]);

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = warp * 16;

    float o[kDimTiles][4];
    zero(o);
    for (int c = 0; c < hd; c += kChunk) {
        __syncthreads();
        load_tile(W1s, ld, w1t, d, c, c + kChunk, kChunk, 0, d);
        load_tile(W2s, ldc, w2t, hd, 0, d, d, c, kChunk);
        for (int j = threadIdx.x; j < kChunk; j += kThreads)
            b1s[j] = __bfloat162float(b1[c + j]);
        __syncthreads();

        float h[8][4];
        chunk_product(h, Xs, W1s, ld, r0, d, g, t);
        uint32_t ha[4][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
            const int col = nt * 8 + 2 * t;
            h[nt][0] = gelu_tanh(h[nt][0] + b1s[col]);
            h[nt][1] = gelu_tanh(h[nt][1] + b1s[col + 1]);
            h[nt][2] = gelu_tanh(h[nt][2] + b1s[col]);
            h[nt][3] = gelu_tanh(h[nt][3] + b1s[col + 1]);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            ha[kk][0] = pack2(h[2 * kk][0], h[2 * kk][1]);
            ha[kk][1] = pack2(h[2 * kk][2], h[2 * kk][3]);
            ha[kk][2] = pack2(h[2 * kk + 1][0], h[2 * kk + 1][1]);
            ha[kk][3] = pack2(h[2 * kk + 1][2], h[2 * kk + 1][3]);
        }
        chunk_out(o, ha, W2s, ldc, d, g, t);
    }
    store_rows(out, o, b2s, row_base + r0, M, d, g, t);
}

__global__ void __launch_bounds__(kThreads)
mlp_bwd_dx_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1t,
                  const bf16* __restrict__ w1, const bf16* __restrict__ w2,
                  const bf16* __restrict__ b1, const bf16* __restrict__ dout,
                  bf16* __restrict__ dx, long long M, int d, int hd) {
    const long long row_base = (long long)blockIdx.x * kRows;
    const int ld = d + kPad, ldc = kChunk + kPad;
    extern __shared__ uint4 smem_u4[];
    bf16* Xs = reinterpret_cast<bf16*>(smem_u4);   // (kRows, ld)
    bf16* dOs = Xs + kRows * ld;                   // (kRows, ld)
    bf16* W1ts = dOs + kRows * ld;                 // (kChunk, ld): W1^T rows
    bf16* W2s = W1ts + kChunk * ld;                // (kChunk, ld): W2 rows
    bf16* W1s = W2s + kChunk * ld;                 // (d, ldc): W1 slice
    float* b1s = reinterpret_cast<float*>(W1s + d * ldc);

    load_tile(Xs, ld, x, d, row_base, M, kRows, 0, d);
    load_tile(dOs, ld, dout, d, row_base, M, kRows, 0, d);

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = warp * 16;

    float acc[kDimTiles][4];
    zero(acc);
    for (int c = 0; c < hd; c += kChunk) {
        __syncthreads();
        load_tile(W1ts, ld, w1t, d, c, c + kChunk, kChunk, 0, d);
        load_tile(W2s, ld, w2, d, c, c + kChunk, kChunk, 0, d);
        load_tile(W1s, ldc, w1, hd, 0, d, d, c, kChunk);
        for (int j = threadIdx.x; j < kChunk; j += kThreads)
            b1s[j] = __bfloat162float(b1[c + j]);
        __syncthreads();

        float h[8][4], dh[8][4];
        chunk_product(h, Xs, W1ts, ld, r0, d, g, t);
        chunk_product(dh, dOs, W2s, ld, r0, d, g, t);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
            const int col = nt * 8 + 2 * t;
#pragma unroll
            for (int e = 0; e < 4; ++e)
                dh[nt][e] *= gelu_tanh_grad(h[nt][e] + b1s[col + (e & 1)]);
        }
        uint32_t da[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            da[kk][0] = pack2(dh[2 * kk][0], dh[2 * kk][1]);
            da[kk][1] = pack2(dh[2 * kk][2], dh[2 * kk][3]);
            da[kk][2] = pack2(dh[2 * kk + 1][0], dh[2 * kk + 1][1]);
            da[kk][3] = pack2(dh[2 * kk + 1][2], dh[2 * kk + 1][3]);
        }
        chunk_out(acc, da, W1s, ldc, d, g, t);
    }
    store_rows(dx, acc, nullptr, row_base + r0, M, d, g, t);
}

// Partial weight gradients of hidden chunk blockIdx.x over row segment
// blockIdx.y. part[seg] holds [dW1 (d, hd) | dW2 (hd, d) | db1 (hd) | db2 (d)].
__global__ void __launch_bounds__(kThreads)
mlp_bwd_dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1t,
                  const bf16* __restrict__ w2, const bf16* __restrict__ b1,
                  const bf16* __restrict__ dout, float* __restrict__ part,
                  long long M, int d, int hd, long long seg_rows) {
    const int c = blockIdx.x * kChunk;
    const long long r_begin = (long long)blockIdx.y * seg_rows;
    const long long r_end = min(M, r_begin + seg_rows);
    const int ld = d + kPad, ldc = kChunk + kPad;
    extern __shared__ uint4 smem_u4[];
    bf16* W1ts = reinterpret_cast<bf16*>(smem_u4);  // (kChunk, ld)
    bf16* W2s = W1ts + kChunk * ld;                 // (kChunk, ld)
    bf16* Xs = W2s + kChunk * ld;                   // (kSegRows, ld)
    bf16* dOs = Xs + kSegRows * ld;                 // (kSegRows, ld)
    bf16* Hs = dOs + kSegRows * ld;                 // (kSegRows, ldc)
    bf16* dHs = Hs + kSegRows * ldc;                // (kSegRows, ldc)
    float* b1s = reinterpret_cast<float*>(dHs + kSegRows * ldc);
    float* red = b1s + kChunk;                      // (4, kChunk)

    load_tile(W1ts, ld, w1t, d, c, c + kChunk, kChunk, 0, d);
    load_tile(W2s, ld, w2, d, c, c + kChunk, kChunk, 0, d);
    for (int j = threadIdx.x; j < kChunk; j += kThreads)
        b1s[j] = __bfloat162float(b1[c + j]);

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int band = warp & 3;            // 16-row band of the row step
    const int half = warp >> 2;           // which 32 hidden / 64 d columns
    const bool owns_dw1 = warp * 16 < d;  // d band of dW1

    float acc1[8][4], acc2[8][4], db1[4][2];
    zero(acc1);
    zero(acc2);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) db1[nt][0] = db1[nt][1] = 0.f;
    float db2 = 0.f;

    for (long long rb = r_begin; rb < r_end; rb += kSegRows) {
        __syncthreads();
        load_tile(Xs, ld, x, d, rb, r_end, kSegRows, 0, d);
        load_tile(dOs, ld, dout, d, rb, r_end, kSegRows, 0, d);
        __syncthreads();

        // rows band*16.., hidden half*32..: h_pre, dh -> Hs, dHs, db1
        float h[4][4], dh[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
            h[nt][0] = h[nt][1] = h[nt][2] = h[nt][3] = 0.f;
            dh[nt][0] = dh[nt][1] = dh[nt][2] = dh[nt][3] = 0.f;
        }
#pragma unroll
        for (int kk = 0; kk < kMaxD / 16; ++kk) {
            if (kk * 16 >= d) break;
            uint32_t ax[4], ad[4];
            ld_a(ax, Xs, ld, band * 16, kk * 16, g, t);
            ld_a(ad, dOs, ld, band * 16, kk * 16, g, t);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
                uint32_t b0, b1v;
                ld_b_t(b0, b1v, W1ts, ld, kk * 16, half * 32 + nt * 8, g, t);
                mma(h[nt], ax, b0, b1v);
                ld_b_t(b0, b1v, W2s, ld, kk * 16, half * 32 + nt * 8, g, t);
                mma(dh[nt], ad, b0, b1v);
            }
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
            const int col = half * 32 + nt * 8 + 2 * t;
            float hv[4], dv[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float hp = h[nt][e] + b1s[col + (e & 1)];
                hv[e] = gelu_tanh(hp);
                dv[e] = gelu_tanh_grad(hp) * dh[nt][e];
            }
            db1[nt][0] += dv[0] + dv[2];
            db1[nt][1] += dv[1] + dv[3];
            const int row = band * 16 + g;
            *reinterpret_cast<uint32_t*>(Hs + row * ldc + col) = pack2(hv[0], hv[1]);
            *reinterpret_cast<uint32_t*>(Hs + (row + 8) * ldc + col) = pack2(hv[2], hv[3]);
            *reinterpret_cast<uint32_t*>(dHs + row * ldc + col) = pack2(dv[0], dv[1]);
            *reinterpret_cast<uint32_t*>(dHs + (row + 8) * ldc + col) = pack2(dv[2], dv[3]);
        }
        if (c == 0 && threadIdx.x < d) {
            float s = 0.f;
            for (int r = 0; r < kSegRows; ++r)
                s += __bfloat162float(dOs[r * ld + threadIdx.x]);
            db2 += s;
        }
        __syncthreads();

        // dW1[dband, chunk] += X^T dH; dW2[chunk band, d half] += H^T dO
#pragma unroll
        for (int kk = 0; kk < kSegRows / 16; ++kk) {
            uint32_t a[4];
            if (owns_dw1) {
                ld_a_t(a, Xs, ld, warp * 16, kk * 16, g, t);
#pragma unroll
                for (int nt = 0; nt < 8; ++nt) {
                    uint32_t b0, b1v;
                    ld_b(b0, b1v, dHs, ldc, kk * 16, nt * 8, g, t);
                    mma(acc1[nt], a, b0, b1v);
                }
            }
            ld_a_t(a, Hs, ldc, band * 16, kk * 16, g, t);
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
                const int dt = half * 8 + nt;
                if (dt * 8 >= d) break;
                uint32_t b0, b1v;
                ld_b(b0, b1v, dOs, ld, kk * 16, dt * 8, g, t);
                mma(acc2[nt], a, b0, b1v);
            }
        }
    }

    float* p = part + (long long)blockIdx.y * (2LL * d * hd + hd + d);
    if (owns_dw1) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
            const int row = warp * 16 + g;
            const int col = c + nt * 8 + 2 * t;
            p[(long long)row * hd + col] = acc1[nt][0];
            p[(long long)row * hd + col + 1] = acc1[nt][1];
            p[(long long)(row + 8) * hd + col] = acc1[nt][2];
            p[(long long)(row + 8) * hd + col + 1] = acc1[nt][3];
        }
    }
    float* p2 = p + (long long)d * hd;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
        const int dt = half * 8 + nt;
        if (dt * 8 >= d) break;
        const int row = c + band * 16 + g;
        const int col = dt * 8 + 2 * t;
        p2[(long long)row * d + col] = acc2[nt][0];
        p2[(long long)row * d + col + 1] = acc2[nt][1];
        p2[(long long)(row + 8) * d + col] = acc2[nt][2];
        p2[(long long)(row + 8) * d + col + 1] = acc2[nt][3];
    }
    // db1: sum the warp's rows (over g), then the four row bands in order
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            float v = db1[nt][e];
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            v += __shfl_xor_sync(0xffffffffu, v, 8);
            v += __shfl_xor_sync(0xffffffffu, v, 16);
            if (g == 0) red[band * kChunk + half * 32 + nt * 8 + 2 * t + e] = v;
        }
    }
    __syncthreads();
    float* p3 = p2 + (long long)hd * d;
    for (int j = threadIdx.x; j < kChunk; j += kThreads)
        p3[c + j] = ((red[j] + red[kChunk + j]) + red[2 * kChunk + j])
                  + red[3 * kChunk + j];
    if (c == 0 && threadIdx.x < d) p3[hd + threadIdx.x] = db2;
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

size_t fwd_smem(int d) {
    return ((size_t)kRows * (d + kPad) + (size_t)kChunk * (d + kPad)
            + (size_t)d * (kChunk + kPad)) * sizeof(bf16)
         + (size_t)(kChunk + d) * sizeof(float);
}

size_t dx_smem(int d) {
    return ((size_t)2 * kRows * (d + kPad) + (size_t)2 * kChunk * (d + kPad)
            + (size_t)d * (kChunk + kPad)) * sizeof(bf16)
         + (size_t)kChunk * sizeof(float);
}

size_t dw_smem(int d) {
    return ((size_t)2 * kChunk * (d + kPad) + (size_t)2 * kSegRows * (d + kPad)
            + (size_t)2 * kSegRows * (kChunk + kPad)) * sizeof(bf16)
         + (size_t)5 * kChunk * sizeof(float);
}

}  // namespace

extern "C" {

int mrgcn_mlp_max_dim() { return kMaxD; }
int mrgcn_mlp_hidden_chunk() { return kChunk; }
int mrgcn_mlp_segment_rows() { return kSegRows; }

// x (M, d), w1t = W1^T (hd, d), b1 (hd), w2t = W2^T (d, hd), b2 (d),
// out (M, d): contiguous bf16. Returns cudaGetLastError() (0 on success).
int mrgcn_mlp_fwd_bf16(const void* x, const void* w1t, const void* b1,
                       const void* w2t, const void* b2, void* out,
                       long long M, int d, int hd, void* stream) {
    const size_t smem = fwd_smem(d);
    cudaError_t err = cudaFuncSetAttribute(
        mlp_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const unsigned blocks = (unsigned)((M + kRows - 1) / kRows);
    mlp_fwd_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
        (const bf16*)x, (const bf16*)w1t, (const bf16*)b1, (const bf16*)w2t,
        (const bf16*)b2, (bf16*)out, M, d, hd);
    return (int)cudaGetLastError();
}

// Backward. x, dout, dx (M, d); w1 (d, hd) and w1t = W1^T; w2 (hd, d);
// b1 (hd): contiguous bf16. part: f32 scratch of segments x
// (2 d hd + hd + d); grads: f32 (2 d hd + hd + d) = [dW1 | dW2 | db1 | db2].
// Three launches on `stream`: dx, the per-segment partials, their sum.
int mrgcn_mlp_bwd_bf16(const void* x, const void* w1, const void* w1t,
                       const void* b1, const void* w2, const void* dout,
                       void* dx, void* part, void* grads, long long M, int d,
                       int hd, int segments, long long seg_rows,
                       void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    size_t smem = dx_smem(d);
    cudaError_t err = cudaFuncSetAttribute(
        mlp_bwd_dx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const unsigned blocks = (unsigned)((M + kRows - 1) / kRows);
    mlp_bwd_dx_kernel<<<blocks, kThreads, smem, s>>>(
        (const bf16*)x, (const bf16*)w1t, (const bf16*)w1, (const bf16*)w2,
        (const bf16*)b1, (const bf16*)dout, (bf16*)dx, M, d, hd);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    smem = dw_smem(d);
    err = cudaFuncSetAttribute(
        mlp_bwd_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    mlp_bwd_dw_kernel<<<dim3(hd / kChunk, segments), kThreads, smem, s>>>(
        (const bf16*)x, (const bf16*)w1t, (const bf16*)w2, (const bf16*)b1,
        (const bf16*)dout, (float*)part, M, d, hd, seg_rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    const long long n = 2LL * d * hd + hd + d;
    sum_segments_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
        (const float*)part, (float*)grads, n, segments);
    return (int)cudaGetLastError();
}

const char* mrgcn_mlp_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

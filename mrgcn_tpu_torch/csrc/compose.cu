// The compose kernels for Hopper (sm_90a): the compose backward and
// forward over the composed identity table, and a table copy.
//
// With D = d_t viewed (R, K), P = packed viewed (B, K), C = comp (R, B) and
// K = rows * L columns (1,638,400 at R=121, B=40, rows=12,800, L=128):
//
//   compose_grad:   d_comp   = D P^T   (R, B)      a reduction over all of K
//                   d_packed = C^T D   (B, K)
//   compose_table:  out      = C P     (R, K)      the forward compose
//   canonical_copy: out      = x                   a copy of the (R*rows, L) table
//
// Replaces: mrgcn_tpu/ops/pallas_gather.py::_compose_grad_kernel (behind
// compose_grad_pass), benchmarks/micro_compose_kernel.py::compose_table and
// benchmarks/micro_compose_fusion.py::canonical. The TPU compose_grad kernel
// walks rows/32 chunks in grid order and keeps d_comp in VMEM across the
// whole grid, a serial accumulator; here the long axis K is cut into chunks
// of CW columns that persistent thread blocks take in turn.
//
// What bounds them on the card: bytes. compose_grad moves (R + 2 B) K
// floats once (1.317 GB at DMG width, 0.393 ms at 3.35 TB/s) for 4 R B K
// operations; compose_table (R + B) K floats (1.055 GB, 0.315 ms, three
// quarters of it the written table) for 2 R B K. In f32 FMA (67 TFLOP/s)
// compose_grad's operations alone would take 0.473 ms, so the products
// run on the tensor cores: three TF32 passes (below) at 495 TFLOP/s take
// 0.19 ms of issue, under the byte floor. On the card (PERF.md, PR 7)
// mma.sync's products and the preparation of their operands, not the
// bytes, set compose_grad's time.
//
// Precision: the TPU kernel pins Precision.HIGHEST (full f32). Each
// operand is split into a TF32 high part hi = rna(x) and a low part
// lo = rna(x - hi), rna being cvt.rna.tf32.f32's rounding, and every
// product accumulates lo*hi + hi*lo + hi*hi in f32, small terms first
// ("3xTF32"): about 21 bits of each product where one TF32 pass keeps 11.
//
// The layout choice for the operand that is MN-major: tf32 wgmma reads
// shared-memory operands only K-major, and here D is MN-major in
// d_packed = C^T D and P is MN-major in C P. The kernels use
// mma.sync.m16n8k8.tf32 instead, whose fragments each thread loads from
// shared memory itself, from any layout: the 3xTF32 split passes every
// element through registers anyway, and one D tile in one layout serves
// both of compose_grad's products. The two products read D with the row
// and the column on opposite lane bits (the contraction index is always
// lane % 4), and no row padding keeps both reads free of bank conflicts;
// an XOR swizzle does (swz below): within a row, 4-float groups are
// permuted by the row's low three bits, so 16-byte copies stay whole.
//
// What the design does:
//  * Staged asynchronous loads: a ring of kStages chunk tiles in shared
//    memory filled by cp.async (16 bytes a thread, zero-filled past K);
//    while chunk i is multiplied, chunks i+1 and i+2 are in flight. A
//    persistent grid takes chunks i, i + G, i + 2G, ...
//  * An operand that several warps read is split once into fragment order
//    in shared memory (hi and lo of a lane's fragment in one 16-byte
//    load): C for d_packed once per CTA, the chunk of P for d_comp and
//    for compose_table once per chunk.
//  * compose_grad (one 512-thread CTA per SM) reads each D tile once from
//    device memory for both products, which run side by side on different
//    warps. Warps 0-7, d_packed^T = D^T C: M = the chunk's columns, N = b,
//    k = r; every kPart k-steps' products start from zero and are added
//    to the sum in f32, since the tensor core's own accumulation truncates
//    (over R = 475 terms one accumulator missed the f32 bound). Warps
//    8-15, d_comp: 16 rows of R by up to five 8-wide tiles of B a warp (R
//    padded to 16 and B to 8 in shared memory only), summed over the chunk
//    in registers and added into the CTA's (R, B) partial in shared
//    memory, each entry owned by one thread. The small and the large
//    terms go to two accumulators: two independent chains of the tensor
//    core's latency. No float atomics: every CTA writes its partial once
//    at the end and a second small kernel sums the G partials in CTA
//    order, so two launches on the same input give the same bits.
//    Alternatives measured on the card while this design was chosen: 8
//    or 12 warps, operands split in registers instead of in shared
//    memory, two row tiles a d_comp warp, d_packed's rows split over
//    pairs of warps: all slower or no faster.
//  * compose_table (two 256-thread CTAs per SM): warp w takes the 16-row
//    tiles w, w + 8, ... of the chunk's (R, CW) output, its C fragments
//    read from device memory (C is small and stays in L1), stages each
//    tile in its own shared-memory tile and sends every row's 256-byte
//    piece to device memory with a bulk copy of the Tensor Memory
//    Accelerator (cp.async.bulk): faster on the card than whole 16-byte
//    stores from the same staging, which beat stores straight from the
//    fragments.
//  * R, B and the last chunk are masked, never padded in device memory;
//    L need only be a multiple of 4. P may be row-strided: ldp floats
//    between its rows (a row slice of a larger packed parameter).
//  * canonical_copy: bound by bytes alone (read once, write once), so the
//    design keeps bytes in flight: each thread issues kCopyDepth
//    independent 16-byte loads before its first store, and every block
//    copies one whole tile (16 KB): the grid covers the table, as
//    PyTorch's own copy does; the ragged rest (vectors past the last whole
//    tile, then the last n % 4 floats) goes one element a thread across
//    the grid. A persistent grid of 8 blocks an SM with 8 loads a thread
//    and evict-first hints on loads and stores measured slower than both
//    PR 4's one-load grid-stride kernel and clone() (PERF.md, PR 6).

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kGradThreads = 512;      // compose_grad: 16 warps, 1 CTA an SM
constexpr int kGradWarps = kGradThreads / 32;
constexpr int kPackedWarps = 8;        // warps 0-7 d_packed, 8-15 d_comp
constexpr int kNP = 3;                 // 8-wide tiles of B a d_packed warp
constexpr int kNQ = 5;                 // 8-wide tiles of B a d_comp warp
constexpr int kPart = 4;               // d_packed k-steps a partial sum
constexpr int kTableThreads = 256;     // compose_table: 8 warps, 2 CTAs an SM
constexpr int kTableWarps = kTableThreads / 32;
constexpr int kStages = 3;             // chunk tiles in the ring
constexpr int kTableCW = 64;           // compose_table's chunk width
constexpr int kStageStride = kTableCW + 8;   // staged output row, floats
constexpr int kCopyThreads = 256;
constexpr int kCopyDepth = 4;          // 16-byte loads in flight a thread
constexpr size_t kSmemLimit = 227 * 1024;  // one thread block's, on Hopper

__host__ __device__ constexpr int up(int x, int m) {
    return (x + m - 1) / m * m;
}

// --------------------------------------------------------------------------
// device helpers: swizzle, cp.async, the 3xTF32 split and product
// --------------------------------------------------------------------------

// The XOR of a row's 4-float groups in a swizzled (rows, CW) tile: the
// row's low three bits, so both fragment reads (row on lane / 4 or on
// lane % 4) hit 32 distinct banks. Column c of row r lies at c ^ swz(r).
template <int CW>
__device__ __forceinline__ int swz(int r) {
    constexpr int mask = (CW - 1) & ~3;
    return (((r & 3) << 3) | (r & 4)) & mask;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Columns [c0, c0 + CW) of `nrows` rows of G (row stride ld floats) into
// the swizzled tile S by NT threads; columns at or beyond K read zero.
template <int NT, int CW>
__device__ __forceinline__ void load_tile(float* S,
                                          const float* __restrict__ G,
                                          int nrows, long long ld,
                                          long long K, long long c0,
                                          int tid) {
    constexpr int Q = CW / 4;
    for (int i = tid; i < nrows * Q; i += NT) {
        const int r = i / Q, q = i % Q;
        const long long col = c0 + 4 * q;
        const bool ok = col < K;
        cp_async16(S + r * CW + ((4 * q) ^ swz<CW>(r)),
                   ok ? G + (long long)r * ld + col : G, ok);
    }
}

// Zero rows [from, to) of each of the ring's kStages tiles (stride `tile`
// floats): rows the loads never write and the products read.
template <int NT, int CW>
__device__ __forceinline__ void zero_rows(float* S, int tile, int from,
                                          int to, int tid) {
    const int n = (to - from) * CW;
    for (int i = tid; i < kStages * n; i += NT)
        S[(i / n) * tile + from * CW + i % n] = 0.f;
}

// `bytes` (a multiple of 16) from shared memory to device memory by a
// bulk copy; returns once the copy has read shared memory.
__device__ __forceinline__ void bulk_store(float* dst, const float* src,
                                           int bytes) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(src));
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], "
                 "%2;\n" :: "l"(dst), "r"(s), "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// TF32 round to nearest, ties away from zero: the bits cvt.rna.tf32.f32
// gives for every finite x, in two integer operations (the conversion
// instruction issued more slowly on the card)
__device__ __forceinline__ uint32_t rna_tf32(float x) {
    return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + O(2^-22 x): hi = rna(x), lo = rna(x - hi)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    hi = rna_tf32(x);
    lo = rna_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32, the small terms first; b is a fragment split in
// advance: (hi b0, hi b1, lo b0, lo b1)
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint4& b) {
    mma(c, al, b.x, b.y);
    mma(c, ah, b.z, b.w);
    mma(c, ah, b.x, b.y);
}

// The same with the small terms into cs and the large into c: two
// independent chains of the tensor core's latency, and the small terms
// summed apart from the large ones.
__device__ __forceinline__ void mma3s(float (&c)[4], float (&cs)[4],
                                      const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4],
                                      const uint4& b) {
    mma(cs, al, b.x, b.y);
    mma(cs, ah, b.z, b.w);
    mma(c, ah, b.x, b.y);
}

__device__ __forceinline__ const uint4& fragment(const uint32_t* F,
                                                 int tile, int lane) {
    return *reinterpret_cast<const uint4*>(F + (tile * 32 + lane) * 4);
}

// The A fragment of rows m0 + g (+ 8) and columns k0 + t (+ 4) of the
// (rows, cols) matrix X, masked, split: a0 (g, t), a1 (g + 8, t),
// a2 (g, t + 4), a3 (g + 8, t + 4).
__device__ __forceinline__ void a_fragment(const float* __restrict__ X,
                                           int rows, int cols, int m0,
                                           int k0, int g, int t,
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int m = m0 + g + (j & 1) * 8, k = k0 + t + (j >> 1) * 4;
        split(m < rows && k < cols ? __ldg(X + m * cols + k) : 0.f, hi[j],
              lo[j]);
    }
}

// --------------------------------------------------------------------------
// compose_grad: d_comp partials and d_packed in one read of D
// --------------------------------------------------------------------------

// Shared-memory layout of compose_grad_kernel, in 4-byte words.
struct GradLayout {
    int MR, NB, KR;       // 16-row tiles of R, 8-wide tiles of B, 8-deep of R
    int Rp, Bp;           // D and P rows held in a stage
    __host__ __device__ GradLayout(int R, int B)
        : MR(up(R, 16) / 16), NB(up(B, 8) / 8), KR(up(R, 8) / 8),
          Rp(up(R, 16)), Bp(up(B, 8)) {}
    // C's fragments (d_packed), the CTA's d_comp partial, P's fragments
    // (d_comp), the ring
    __host__ __device__ int frag_words() const { return KR * NB * 128; }
    __host__ __device__ int acc_words() const { return Rp * Bp; }
    __host__ __device__ int pfrag_words(int CW) const { return Bp * CW * 2; }
    __host__ __device__ int stage_words(int CW) const {
        return (Rp + Bp) * CW;
    }
    __host__ __device__ size_t words(int CW) const {
        return (size_t)frag_words() + acc_words()
             + pfrag_words(CW) + (size_t)kStages * stage_words(CW);
    }
};

// Named barrier of the d_comp warps alone (0 is __syncthreads).
__device__ __forceinline__ void sync_comp_warps() {
    asm volatile("bar.sync 1, %0;\n"
                 :: "n"(kGradThreads - kPackedWarps * 32) : "memory");
}

template <int CW>
__global__ void __launch_bounds__(kGradThreads, 1)
compose_grad_kernel(const float* __restrict__ d_t,
                    const float* __restrict__ packed, long long ldp,
                    const float* __restrict__ comp,
                    float* __restrict__ d_packed,
                    float* __restrict__ partial, int R, int B, long long K,
                    long long n_chunks) {
    constexpr int NC = CW / 8;          // 8-deep k-steps over a chunk
    constexpr int nComp = kGradWarps - kPackedWarps;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const GradLayout lay(R, B);
    const int Rp = lay.Rp, Bp = lay.Bp, NB = lay.NB, MR = lay.MR,
              KR = lay.KR;
    const int stage = lay.stage_words(CW);

    extern __shared__ float4 smem4[];
    uint32_t* F = reinterpret_cast<uint32_t*>(smem4);     // C, (KR, NB)
    float* Acc = reinterpret_cast<float*>(F + lay.frag_words());  // (Rp, Bp)
    uint32_t* PF = reinterpret_cast<uint32_t*>(Acc + lay.acc_words());
    float* ring = reinterpret_cast<float*>(PF + lay.pfrag_words(CW));

    // C as d_packed's B operand (k = r, n = b), split once: tile (ks, nt)
    for (int idx = tid; idx < KR * NB * 32; idx += kGradThreads) {
        const int l = idx & 31, tile = idx >> 5;
        const int ks = tile / NB, b = (tile % NB) * 8 + (l >> 2);
        const int r = ks * 8 + (l & 3);
        uint32_t* f = F + idx * 4;
        split(r < R && b < B ? comp[r * B + b] : 0.f, f[0], f[2]);
        split(r + 4 < R && b < B ? comp[(r + 4) * B + b] : 0.f, f[1],
              f[3]);
    }
    for (int i = tid; i < Rp * Bp; i += kGradThreads) Acc[i] = 0.f;
    zero_rows<kGradThreads, CW>(ring, stage, R, Rp, tid);
    zero_rows<kGradThreads, CW>(ring + Rp * CW, stage, B, Bp, tid);

    for (int s = 0; s < kStages - 1; ++s) {
        const long long c = blockIdx.x + (long long)s * gridDim.x;
        if (c < n_chunks) {
            load_tile<kGradThreads, CW>(ring + s * stage, d_t, R, K, K,
                                        c * CW, tid);
            load_tile<kGradThreads, CW>(ring + s * stage + Rp * CW, packed,
                                        B, ldp, K, c * CW, tid);
        }
        cp_async_commit();
    }

    // fragment reads of rows 8 i + t (+ 4) (d_packed) and of rows whose
    // r & 7 is g (d_comp) see a per-thread swizzle
    const int st0 = swz<CW>(t), st1 = swz<CW>(t + 4), sg = swz<CW>(g);

    int it = 0;
    for (long long c = blockIdx.x; c < n_chunks; c += gridDim.x, ++it) {
        cp_async_wait<kStages - 2>();
        __syncthreads();   // chunk c has landed; chunk c - G is consumed
        {
            const long long cn = c + (long long)(kStages - 1) * gridDim.x;
            float* S = ring + ((it + kStages - 1) % kStages) * stage;
            if (cn < n_chunks) {
                load_tile<kGradThreads, CW>(S, d_t, R, K, K, cn * CW, tid);
                load_tile<kGradThreads, CW>(S + Rp * CW, packed, B, ldp, K,
                                            cn * CW, tid);
            }
            cp_async_commit();
        }
        const float* Ds = ring + (it % kStages) * stage;
        const float* Ps = Ds + Rp * CW;
        const long long c0 = c * CW;

        if (warp < kPackedWarps) {
            // d_packed^T[col, b] = sum_r D[r, col] C[r, b]: M = the
            // chunk's columns, N = b, k = r; a warp takes 16 columns by up
            // to kNP tiles of B. Every kPart k-steps' products start from
            // zero and are added to the sum in f32: the tensor core's own
            // accumulation truncates, and over R = 475 terms a single
            // accumulator missed the f32 bound (PERF.md, PR 7)
            const int groups = (NB + kNP - 1) / kNP;
            for (int item = warp; item < (CW / 16) * groups;
                 item += kPackedWarps) {
                const int m0 = (item / groups) * 16 + g;
                const int n0 = (item % groups) * kNP;
                const int c00 = m0 ^ st0, c01 = (m0 + 8) ^ st0;
                const int c10 = m0 ^ st1, c11 = (m0 + 8) ^ st1;
                float acc[kNP][4] = {};
                for (int k2 = 0; k2 < KR; k2 += kPart) {
                    float part[kNP][4] = {};
                    float parts[kNP][4] = {};
#pragma unroll
                    for (int ks = k2; ks < k2 + kPart; ++ks) {
                        if (ks >= KR) break;
                        const float* d0 = Ds + (ks * 8 + t) * CW;
                        const float* d1 = d0 + 4 * CW;
                        uint32_t ah[4], al[4];
                        split(d0[c00], ah[0], al[0]);
                        split(d0[c01], ah[1], al[1]);
                        split(d1[c10], ah[2], al[2]);
                        split(d1[c11], ah[3], al[3]);
#pragma unroll
                        for (int j = 0; j < kNP; ++j)
                            if (n0 + j < NB)
                                mma3s(part[j], parts[j], ah, al,
                                      fragment(F, ks * NB + n0 + j, lane));
                    }
#pragma unroll
                    for (int j = 0; j < kNP; ++j)
#pragma unroll
                        for (int e = 0; e < 4; ++e)
                            acc[j][e] += parts[j][e] + part[j][e];
                }
                const long long col = c0 + m0;
#pragma unroll
                for (int j = 0; j < kNP; ++j) {
                    const int b = (n0 + j) * 8 + 2 * t;
                    // c0 (col, b), c1 (col, b + 1), c2 / c3 at col + 8
                    float* o = d_packed + b * K + col;
                    if (col < K) {
                        if (b < B) o[0] = acc[j][0];
                        if (b + 1 < B) o[K] = acc[j][1];
                    }
                    if (col + 8 < K) {
                        if (b < B) o[8] = acc[j][2];
                        if (b + 1 < B) o[K + 8] = acc[j][3];
                    }
                }
            }
        } else {
            // P as d_comp's B operand (k = the chunk's columns, n = b),
            // split once for the d_comp warps: tile (nt, ks)
            const int ctid = tid - kPackedWarps * 32;
            for (int idx = ctid; idx < NB * NC * 32; idx += nComp * 32) {
                const int l = idx & 31, tile = idx >> 5;
                const int row = (tile / NC) * 8 + (l >> 2);
                const int k0 = ((tile % NC) * 8 + (l & 3)) ^ swz<CW>(l >> 2);
                uint32_t* f = PF + idx * 4;
                split(Ps[row * CW + k0], f[0], f[2]);
                split(Ps[row * CW + (k0 ^ 4)], f[1], f[3]);
            }
            sync_comp_warps();
            // d_comp[r, b] += sum_c D[r, c] P[b, c]: M = r, N = b, k = the
            // chunk's columns; a warp takes 16 rows of R by up to kNQ tiles
            // of B and adds them into the CTA's partial
            const int groups = (NB + kNQ - 1) / kNQ;
            for (int item = warp - kPackedWarps; item < MR * groups;
                 item += nComp) {
                const int r0 = (item / groups) * 16 + g;
                const int n0 = (item % groups) * kNQ;
                const float* a = Ds + r0 * CW;
                float acc[kNQ][4] = {}, accs[kNQ][4] = {};
#pragma unroll
                for (int ks = 0; ks < NC; ++ks) {
                    const int k0 = (ks * 8 + t) ^ sg, k1 = k0 ^ 4;
                    uint32_t ah[4], al[4];
                    split(a[k0], ah[0], al[0]);
                    split(a[8 * CW + k0], ah[1], al[1]);
                    split(a[k1], ah[2], al[2]);
                    split(a[8 * CW + k1], ah[3], al[3]);
#pragma unroll
                    for (int j = 0; j < kNQ; ++j)
                        if (n0 + j < NB)
                            mma3s(acc[j], accs[j], ah, al,
                                  fragment(PF, (n0 + j) * NC + ks, lane));
                }
#pragma unroll
                for (int j = 0; j < kNQ; ++j) {
                    if (n0 + j < NB) {
                        float* o = Acc + r0 * Bp + (n0 + j) * 8 + 2 * t;
                        o[0] += acc[j][0] + accs[j][0];
                        o[1] += acc[j][1] + accs[j][1];
                        o[8 * Bp] += acc[j][2] + accs[j][2];
                        o[8 * Bp + 1] += acc[j][3] + accs[j][3];
                    }
                }
            }
        }
    }
    cp_async_wait<0>();
    __syncthreads();
    float* mine = partial + (long long)blockIdx.x * R * B;
    for (int i = tid; i < R * B; i += kGradThreads)
        mine[i] = Acc[(i / B) * Bp + i % B];
}

// out[i] = partial[0, i] + partial[1, i] + ... in CTA order.
__global__ void sum_partials_kernel(const float* __restrict__ partial,
                                    float* __restrict__ out, int n,
                                    int n_parts) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float sum = 0.f;
    for (int g = 0; g < n_parts; ++g) sum += partial[(long long)g * n + i];
    out[i] = sum;
}

// --------------------------------------------------------------------------
// compose_table: out = C P, written relation-major
// --------------------------------------------------------------------------

// Shared-memory layout of compose_table_kernel, in 4-byte words: P's
// fragments, the ring, one staging tile a warp.
struct TableLayout {
    int MT, KS, Bp;       // 16-row tiles of R, 8-deep k-steps over B
    __host__ __device__ TableLayout(int R, int B)
        : MT(up(R, 16) / 16), KS(up(B, 8) / 8), Bp(up(B, 8)) {}
    __host__ __device__ int pfrag_words() const {
        return Bp * kTableCW * 2;
    }
    __host__ __device__ size_t words() const {
        return (size_t)pfrag_words() + (size_t)kStages * Bp * kTableCW
             + (size_t)kTableWarps * 16 * kStageStride;
    }
};

__global__ void __launch_bounds__(kTableThreads, 2)
compose_table_kernel(const float* __restrict__ comp,
                     const float* __restrict__ pk, long long ldp,
                     float* __restrict__ out, int R, int B, long long K,
                     long long n_chunks) {
    constexpr int CW = kTableCW;
    constexpr int NC = CW / 8;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const TableLayout lay(R, B);
    const int MT = lay.MT, KS = lay.KS, Bp = lay.Bp;
    const int stage = Bp * CW;

    extern __shared__ float4 smem4[];
    uint32_t* PF = reinterpret_cast<uint32_t*>(smem4);    // P, (KS, NC)
    float* ring = reinterpret_cast<float*>(PF + lay.pfrag_words());
    float* St = ring + kStages * stage + warp * 16 * kStageStride;

    zero_rows<kTableThreads, CW>(ring, stage, B, Bp, tid);
    for (int s = 0; s < kStages - 1; ++s) {
        const long long c = blockIdx.x + (long long)s * gridDim.x;
        if (c < n_chunks)
            load_tile<kTableThreads, CW>(ring + s * stage, pk, B, ldp, K,
                                         c * CW, tid);
        cp_async_commit();
    }

    int it = 0;
    for (long long c = blockIdx.x; c < n_chunks; c += gridDim.x, ++it) {
        cp_async_wait<kStages - 2>();
        __syncthreads();   // chunk c has landed; P's last fragments are read
        {
            // the stage of chunk c - G was read by the last split pass
            const long long cn = c + (long long)(kStages - 1) * gridDim.x;
            if (cn < n_chunks)
                load_tile<kTableThreads, CW>(
                    ring + ((it + kStages - 1) % kStages) * stage, pk, B,
                    ldp, K, cn * CW, tid);
            cp_async_commit();
        }
        const float* Ps = ring + (it % kStages) * stage;
        // P as the B operand (k = b, n = the chunk's columns), split once
        // for all warps: tile (ks, nt)
        for (int idx = tid; idx < KS * NC * 32; idx += kTableThreads) {
            const int l = idx & 31, tile = idx >> 5;
            const int r = (tile / NC) * 8 + (l & 3);
            const int n = (tile % NC) * 8 + (l >> 2);
            uint32_t* f = PF + idx * 4;
            split(Ps[r * CW + (n ^ swz<CW>(r))], f[0], f[2]);
            split(Ps[(r + 4) * CW + (n ^ swz<CW>(r + 4))], f[1], f[3]);
        }
        __syncthreads();   // the fragments are ready
        const long long c0 = c * CW;
        for (int mt = warp; mt < MT; mt += kTableWarps) {
            float acc[NC][4] = {};
            for (int ks = 0; ks < KS; ++ks) {
                uint32_t ah[4], al[4];
                a_fragment(comp, R, B, mt * 16, ks * 8, g, t, ah, al);
#pragma unroll
                for (int nt = 0; nt < NC; ++nt)
                    mma3(acc[nt], ah, al, fragment(PF, ks * NC + nt, lane));
            }
            // the 16 x CW tile through this warp's staging tile, then each
            // row's piece (256 bytes) to device memory by one bulk copy of
            // the Tensor Memory Accelerator: no thread holds the stores.
            // The staging tile is reused once the copies have read it
            __syncwarp();
#pragma unroll
            for (int nt = 0; nt < NC; ++nt) {
                float* s = St + g * kStageStride + nt * 8 + 2 * t;
                *reinterpret_cast<float2*>(s) =
                    make_float2(acc[nt][0], acc[nt][1]);
                *reinterpret_cast<float2*>(s + 8 * kStageStride) =
                    make_float2(acc[nt][2], acc[nt][3]);
            }
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            __syncwarp();
            const int r = mt * 16 + lane;
            if (lane < 16 && r < R && c0 < K)
                bulk_store(out + (long long)r * K + c0,
                           St + lane * kStageStride,
                           (int)(K - c0 < CW ? K - c0 : CW) * 4);
            __syncwarp();
        }
    }
    cp_async_wait<0>();
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// --------------------------------------------------------------------------
// canonical_copy
// --------------------------------------------------------------------------

__global__ void __launch_bounds__(kCopyThreads)
copy_kernel(const float* __restrict__ x, float* __restrict__ out,
            long long n) {
    constexpr long long kTile = (long long)kCopyThreads * kCopyDepth;
    const long long n4 = n / 4;
    const long long tiles = n4 / kTile;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    float4* o4 = reinterpret_cast<float4*>(out);
    if (blockIdx.x < tiles) {
        const long long base = blockIdx.x * kTile + threadIdx.x;
        float4 v[kCopyDepth];
#pragma unroll
        for (int k = 0; k < kCopyDepth; ++k)
            v[k] = __ldg(x4 + base + k * kCopyThreads);
#pragma unroll
        for (int k = 0; k < kCopyDepth; ++k)
            o4[base + k * kCopyThreads] = v[k];
    }
    // the ragged rest, one element a thread over the whole grid
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    for (long long i = tiles * kTile + t0; i < n4; i += stride)
        o4[i] = __ldg(x4 + i);
    for (long long i = n4 * 4 + t0; i < n; i += stride) out[i] = x[i];
}

// --------------------------------------------------------------------------
// host side
// --------------------------------------------------------------------------

// Per-device settings are read or made once a process: a launch then
// spends no driver call on them.
constexpr int kMaxDevices = 64;

int current_device() {
    int dev = 0;
    return cudaGetDevice(&dev) == cudaSuccess && dev >= 0
                   && dev < kMaxDevices ? dev : -1;
}

int sm_count() {
    static int cached[kMaxDevices];
    const int dev = current_device();
    if (dev >= 0 && cached[dev]) return cached[dev];
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount,
                               dev < 0 ? 0 : dev) != cudaSuccess || n <= 0)
        return 1;
    if (dev >= 0) cached[dev] = n;
    return n;
}

// Lets a block of `kernel` take a block's whole shared memory, once a
// device (`done` is the kernel's own record).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, bool (&done)[kMaxDevices]) {
    const int dev = current_device();
    if (dev >= 0 && done[dev]) return cudaSuccess;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmemLimit);
    if (err == cudaSuccess && dev >= 0) done[dev] = true;
    return err;
}

size_t grad_smem(int R, int B, int CW) {
    return GradLayout(R, B).words(CW) * 4;
}

size_t table_smem(int R, int B) { return TableLayout(R, B).words() * 4; }

template <int CW>
cudaError_t launch_grad(const float* d_t, const float* packed, long long ldp,
                        const float* comp, float* d_packed, float* partial,
                        int R, int B, long long K, int ctas,
                        cudaStream_t stream) {
    static bool allowed[kMaxDevices];
    const size_t smem = grad_smem(R, B, CW);
    const cudaError_t err = allow_smem(compose_grad_kernel<CW>, allowed);
    if (err != cudaSuccess) return err;
    const long long n_chunks = (K + CW - 1) / CW;
    compose_grad_kernel<CW><<<ctas, kGradThreads, smem, stream>>>(
        d_t, packed, ldp, comp, d_packed, partial, R, B, K, n_chunks);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* mrgcn_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// compose_grad's chunk width for these R and B: the widest whose ring fits
// a thread block's shared memory (0: none does).
int mrgcn_compose_grad_chunk(int R, int B) {
    if (R <= 0 || B <= 0) return 0;
    for (int cw : {64, 32, 16})
        if (grad_smem(R, B, cw) <= kSmemLimit) return cw;
    return 0;
}

// Dynamic shared memory of a launch, in bytes (reported beside ptxas').
size_t mrgcn_compose_grad_smem(int R, int B) {
    const int cw = mrgcn_compose_grad_chunk(R, B);
    return cw ? grad_smem(R, B, cw) : 0;
}

size_t mrgcn_compose_table_smem(int R, int B) { return table_smem(R, B); }

// The thread blocks a compose_grad launch over K columns uses: the Python
// wrapper sizes the `partial` workspace from it.
int mrgcn_compose_grad_ctas(int R, int B, long long K) {
    const int cw = mrgcn_compose_grad_chunk(R, B);
    if (cw == 0 || K <= 0) return 0;
    const long long n_chunks = (K + cw - 1) / cw;
    const int sms = sm_count();
    return n_chunks < sms ? (int)n_chunks : sms;
}

// compose_table's chunk width (0: comp's fragments and the ring do not fit
// a thread block's shared memory).
int mrgcn_compose_table_chunk(int R, int B) {
    if (R <= 0 || B <= 0) return 0;
    return table_smem(R, B) <= kSmemLimit ? kTableCW : 0;
}

// d_comp (R, B) = D P^T and d_packed (B, K) = C^T D for D = d_t (R, K),
// P = packed (B rows of K, ldp floats apart), C = comp (R, B); K and ldp
// multiples of 4, d_t and packed 16-byte aligned. `partial` is scratch of
// mrgcn_compose_grad_ctas(R, B, K) * R * B floats. Launches on `stream`
// and returns cudaGetLastError() (0 on success).
int mrgcn_compose_grad_f32(const float* d_t, const float* packed,
                           long long ldp, const float* comp, float* d_packed,
                           float* d_comp, float* partial, int R, int B,
                           long long K, void* stream) {
    const int cw = mrgcn_compose_grad_chunk(R, B);
    const int ctas = mrgcn_compose_grad_ctas(R, B, K);
    if (cw == 0 || ctas == 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err;
    if (cw == 64)
        err = launch_grad<64>(d_t, packed, ldp, comp, d_packed, partial, R,
                              B, K, ctas, s);
    else if (cw == 32)
        err = launch_grad<32>(d_t, packed, ldp, comp, d_packed, partial, R,
                              B, K, ctas, s);
    else
        err = launch_grad<16>(d_t, packed, ldp, comp, d_packed, partial, R,
                              B, K, ctas, s);
    if (err != cudaSuccess) return (int)err;
    const int n = R * B;
    sum_partials_kernel<<<(n + 255) / 256, 256, 0, s>>>(partial, d_comp, n,
                                                        ctas);
    return (int)cudaGetLastError();
}

// out (R, K) = comp (R, B) @ pk (B rows of K, ldp floats apart); K and ldp
// multiples of 4, pk and out 16-byte aligned.
int mrgcn_compose_table_f32(const float* comp, const float* pk,
                            long long ldp, float* out, int R, int B,
                            long long K, void* stream) {
    if (mrgcn_compose_table_chunk(R, B) == 0 || K <= 0)
        return (int)cudaErrorInvalidValue;
    static bool allowed[kMaxDevices];
    const size_t smem = table_smem(R, B);
    cudaError_t err = allow_smem(compose_table_kernel, allowed);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, compose_table_kernel, kTableThreads, smem);
    if (err != cudaSuccess) return (int)err;
    const long long n_chunks = (K + kTableCW - 1) / kTableCW;
    long long ctas = (long long)(per_sm > 0 ? per_sm : 1) * sm_count();
    if (ctas > n_chunks) ctas = n_chunks;
    compose_table_kernel<<<(unsigned)ctas, kTableThreads, smem,
                           (cudaStream_t)stream>>>(comp, pk, ldp, out, R, B,
                                                   K, n_chunks);
    return (int)cudaGetLastError();
}

// out[i] = x[i] for i < n: kCopyDepth 16-byte loads a thread in flight
// where both pointers are 16-byte aligned (the caller checks), the last
// n % 4 values one by one.
int mrgcn_canonical_copy_f32(const float* x, float* out, long long n,
                             void* stream) {
    if (n <= 0) return 0;
    const long long tile = (long long)kCopyThreads * kCopyDepth;
    long long blocks = n / 4 / tile;          // one whole tile a block
    if (blocks < 1) blocks = 1;               // and the rest
    copy_kernel<<<(unsigned)blocks, kCopyThreads, 0, (cudaStream_t)stream>>>(
        x, out, n);
    return (int)cudaGetLastError();
}

}  // extern "C"

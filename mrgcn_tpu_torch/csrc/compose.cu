// The compose kernels for Hopper (sm_90a): the fused compose backward and
// the two layout experiments over the same composed identity table.
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
// of CW columns that thread blocks take in parallel.
//
// What bounds them on the card: compose_grad does 4 R B K operations on
// (R + 2 B) K floats, 24 operations a byte at R=121, B=40: above the card's
// 20 f32 operations a byte, so f32 FMA issue bounds it, closely followed by
// memory. compose_table (2 R B K operations, (R + B) K floats) and the copy
// are bound by memory.
//
// What the design does about it:
//  * compose_grad: a persistent grid of one CTA per SM; CTA i takes chunks
//    i, i + G, i + 2G, ... A chunk of D (R, CW) and of P (B, CW) is loaded
//    once into shared memory with 16-byte loads (rows padded by 4 floats, so
//    a row's 16-byte units fall on other banks than its neighbours'), comp
//    sits there whole. Both products then read the chunk from shared
//    memory: D is read once from device memory for the two of them.
//      - d_packed: a thread owns 4 b's x 4 columns; per r one 16-byte read
//        of D and one of comp feed 16 FMAs.
//      - d_comp: a warp owns 32 r's x 16 b's, a thread 4 x 4 of them
//        (interleaved, so the warp's reads hit distinct banks or broadcast)
//        and walks the chunk's columns four at a time: 8 16-byte reads feed
//        64 FMAs. The CTA's (R, B) partial accumulates in shared memory over
//        all its chunks, each entry owned by one thread.
//    No float atomics: every CTA writes its partial to a workspace and a
//    second small kernel sums the G partials in CTA order, so two launches
//    on the same input give the same bits. R and B are masked, never padded
//    in device memory. f32 FMA only, no tensor cores: the TPU kernel pins
//    full f32 precision.
//  * compose_table: the same 4 x 4 thread tile with comp transposed in
//    shared memory, persistent CTAs over column chunks.
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

#include <initializer_list>

namespace {

constexpr int kGradThreads = 384;
constexpr int kGradWarps = kGradThreads / 32;
constexpr int kTableThreads = 256;
constexpr int kCopyThreads = 256;
constexpr int kCopyDepth = 4;          // 16-byte loads in flight a thread
constexpr int kPad = 4;                    // floats added to a shared row
constexpr size_t kSmemLimit = 227 * 1024;  // one thread block's, on Hopper

inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& x) {
    acc.x = fmaf(a, x.x, acc.x);
    acc.y = fmaf(a, x.y, acc.y);
    acc.z = fmaf(a, x.z, acc.z);
    acc.w = fmaf(a, x.w, acc.w);
}

__device__ __forceinline__ float dot4(float acc, const float4& a,
                                      const float4& b) {
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    return fmaf(a.w, b.w, acc);
}

// Columns [c0, c0 + CW) of `nrows` rows of the (nrows, K) array G into the
// shared tile S (row stride CW + kPad); columns at or beyond K read zero.
template <int CW>
__device__ __forceinline__ void load_chunk(float* S, const float* __restrict__ G,
                                           int nrows, long long K,
                                           long long c0, int tid,
                                           int nthreads) {
    constexpr int Q = CW / 4;
    constexpr int CWp = CW + kPad;
    for (int i = tid; i < nrows * Q; i += nthreads) {
        const int r = i / Q, q = i % Q;
        const long long col = c0 + q * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (col < K)
            v = __ldg(reinterpret_cast<const float4*>(G + (long long)r * K
                                                      + col));
        *reinterpret_cast<float4*>(S + r * CWp + q * 4) = v;
    }
}

// out[m, c0 + c] = sum_k A[k, m] * X[k, c] for m < M and the chunk's columns
// c: A (depth, lda) and the chunk X (depth, CW + kPad) lie in shared memory,
// `out` (M, ldo) in device memory. A thread owns 4 m's x 4 columns.
template <int CW>
__device__ __forceinline__ void left_product(const float* A, int lda,
                                             const float* X, int depth,
                                             int M, float* __restrict__ out,
                                             long long ldo, long long c0,
                                             int tid, int nthreads) {
    constexpr int Q = CW / 4;
    constexpr int CWp = CW + kPad;
    const int m_tiles = (M + 3) / 4;
    for (int task = tid; task < m_tiles * Q; task += nthreads) {
        const int mt = task / Q, q = task % Q;
        float4 acc0 = make_float4(0.f, 0.f, 0.f, 0.f);
        float4 acc1 = acc0, acc2 = acc0, acc3 = acc0;
        for (int k = 0; k < depth; ++k) {
            const float4 x = *reinterpret_cast<const float4*>(X + k * CWp
                                                              + q * 4);
            const float4 a = *reinterpret_cast<const float4*>(A + k * lda
                                                              + mt * 4);
            fma4(acc0, a.x, x);
            fma4(acc1, a.y, x);
            fma4(acc2, a.z, x);
            fma4(acc3, a.w, x);
        }
        const long long col = c0 + q * 4;
        if (col >= ldo) continue;
        const int m0 = mt * 4;
        float* o = out + (long long)m0 * ldo + col;
        *reinterpret_cast<float4*>(o) = acc0;
        if (m0 + 1 < M) *reinterpret_cast<float4*>(o + ldo) = acc1;
        if (m0 + 2 < M) *reinterpret_cast<float4*>(o + 2 * ldo) = acc2;
        if (m0 + 3 < M) *reinterpret_cast<float4*>(o + 3 * ldo) = acc3;
    }
}

// Shared-memory layout of compose_grad_kernel, in floats.
struct GradLayout {
    int Rp, Bp16, Bp4;
    __host__ __device__ GradLayout(int R, int B)
        : Rp((R + 31) / 32 * 32), Bp16((B + 15) / 16 * 16),
          Bp4((B + 3) / 4 * 4) {}
    __host__ __device__ size_t floats(int R, int CW) const {
        return (size_t)(Rp + Bp16) * (CW + kPad) + (size_t)R * Bp4
             + (size_t)Rp * Bp16;
    }
};

template <int CW>
__global__ void __launch_bounds__(kGradThreads, 1)
compose_grad_kernel(const float* __restrict__ d_t,
                    const float* __restrict__ packed,
                    const float* __restrict__ comp,
                    float* __restrict__ d_packed,
                    float* __restrict__ partial, int R, int B, long long K,
                    long long n_chunks) {
    constexpr int CWp = CW + kPad;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const GradLayout lay(R, B);
    const int Rp = lay.Rp, Bp16 = lay.Bp16, Bp4 = lay.Bp4;

    extern __shared__ float4 smem4[];
    float* Ds = reinterpret_cast<float*>(smem4);   // (Rp, CWp)
    float* Ps = Ds + Rp * CWp;                     // (Bp16, CWp)
    float* Cs = Ps + Bp16 * CWp;                   // (R, Bp4): comp
    float* Acc = Cs + R * Bp4;                     // (Rp, Bp16): d_comp

    // rows beyond R and B stay zero for the whole kernel: the d_comp tiles
    // read them unmasked
    for (int i = tid; i < (Rp - R) * CWp; i += kGradThreads)
        Ds[R * CWp + i] = 0.f;
    for (int i = tid; i < (Bp16 - B) * CWp; i += kGradThreads)
        Ps[B * CWp + i] = 0.f;
    for (int i = tid; i < R * Bp4; i += kGradThreads) {
        const int r = i / Bp4, b = i % Bp4;
        Cs[i] = b < B ? __ldg(comp + r * B + b) : 0.f;
    }
    for (int i = tid; i < Rp * Bp16; i += kGradThreads) Acc[i] = 0.f;

    const int lane_r = lane & 7, lane_b = lane >> 3;
    const int b_groups = Bp16 / 16;
    const int warp_tasks = (Rp / 32) * b_groups;

    for (long long chunk = blockIdx.x; chunk < n_chunks;
         chunk += gridDim.x) {
        const long long c0 = chunk * CW;
        __syncthreads();          // the previous chunk is fully consumed
        load_chunk<CW>(Ds, d_t, R, K, c0, tid, kGradThreads);
        load_chunk<CW>(Ps, packed, B, K, c0, tid, kGradThreads);
        __syncthreads();

        // d_packed[b, chunk] = sum_r comp[r, b] D[r, chunk]
        left_product<CW>(Cs, Bp4, Ds, R, B, d_packed, K, c0, tid,
                         kGradThreads);

        // d_comp[r, b] += sum_c D[r, c] P[b, c] over the chunk's columns
        for (int wt = warp; wt < warp_tasks; wt += kGradWarps) {
            const int r0 = (wt / b_groups) * 32 + lane_r;
            const int b0 = (wt % b_groups) * 16 + lane_b;
            float acc[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
            const float* dr = Ds + r0 * CWp;
            const float* pb = Ps + b0 * CWp;
#pragma unroll 2
            for (int q = 0; q < CW / 4; ++q) {
                float4 d[4], p[4];
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    d[i] = *reinterpret_cast<const float4*>(
                        dr + 8 * i * CWp + q * 4);
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    p[j] = *reinterpret_cast<const float4*>(
                        pb + 4 * j * CWp + q * 4);
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        acc[i][j] = dot4(acc[i][j], d[i], p[j]);
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    Acc[(r0 + 8 * i) * Bp16 + b0 + 4 * j] += acc[i][j];
        }
    }
    __syncthreads();
    float* mine = partial + (long long)blockIdx.x * R * B;
    for (int i = tid; i < R * B; i += kGradThreads)
        mine[i] = Acc[(i / B) * Bp16 + i % B];
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

template <int CW>
__global__ void __launch_bounds__(kTableThreads)
compose_table_kernel(const float* __restrict__ comp,
                     const float* __restrict__ pk, float* __restrict__ out,
                     int R, int B, long long K, long long n_chunks) {
    constexpr int CWp = CW + kPad;
    const int tid = threadIdx.x;
    const int Rp4 = (R + 3) / 4 * 4;
    extern __shared__ float4 smem4[];
    float* Ct = reinterpret_cast<float*>(smem4);   // (B, Rp4): comp^T
    float* Ps = Ct + B * Rp4;                      // (B, CWp)
    for (int i = tid; i < B * Rp4; i += kTableThreads) {
        const int b = i / Rp4, r = i % Rp4;
        Ct[i] = r < R ? __ldg(comp + r * B + b) : 0.f;
    }
    for (long long chunk = blockIdx.x; chunk < n_chunks;
         chunk += gridDim.x) {
        const long long c0 = chunk * CW;
        __syncthreads();
        load_chunk<CW>(Ps, pk, B, K, c0, tid, kTableThreads);
        __syncthreads();
        left_product<CW>(Ct, Rp4, Ps, B, R, out, K, c0, tid, kTableThreads);
    }
}

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

int sm_count() {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return 1;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev)
            != cudaSuccess)
        return 1;
    return n > 0 ? n : 1;
}

size_t grad_smem(int R, int B, int CW) {
    return GradLayout(R, B).floats(R, CW) * sizeof(float);
}

size_t table_smem(int R, int B, int CW) {
    return ((size_t)B * round_up(R, 4) + (size_t)B * (CW + kPad))
         * sizeof(float);
}

// The widest chunk whose tiles fit a thread block's shared memory; 0 if
// none does.
template <typename Smem>
int widest_chunk(Smem smem, int R, int B) {
    for (int cw : {128, 64, 32})
        if (smem(R, B, cw) <= kSmemLimit) return cw;
    return 0;
}

template <int CW>
cudaError_t launch_grad(const float* d_t, const float* packed,
                        const float* comp, float* d_packed, float* partial,
                        int R, int B, long long K, int ctas,
                        cudaStream_t stream) {
    const size_t smem = grad_smem(R, B, CW);
    cudaError_t err = cudaFuncSetAttribute(
        compose_grad_kernel<CW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const long long n_chunks = (K + CW - 1) / CW;
    compose_grad_kernel<CW><<<ctas, kGradThreads, smem, stream>>>(
        d_t, packed, comp, d_packed, partial, R, B, K, n_chunks);
    return cudaGetLastError();
}

template <int CW>
cudaError_t launch_table(const float* comp, const float* pk, float* out,
                         int R, int B, long long K, cudaStream_t stream) {
    const size_t smem = table_smem(R, B, CW);
    cudaError_t err = cudaFuncSetAttribute(
        compose_table_kernel<CW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const long long n_chunks = (K + CW - 1) / CW;
    long long ctas = 2LL * sm_count();
    if (ctas > n_chunks) ctas = n_chunks;
    compose_table_kernel<CW><<<(unsigned)ctas, kTableThreads, smem, stream>>>(
        comp, pk, out, R, B, K, n_chunks);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* mrgcn_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// Columns per chunk for these R and B (0: they fit no chunk width), and
// the thread blocks a launch over K columns uses: the Python wrapper sizes
// the `partial` workspace of compose_grad from the latter.
int mrgcn_compose_grad_chunk(int R, int B) {
    return widest_chunk(grad_smem, R, B);
}

int mrgcn_compose_table_chunk(int R, int B) {
    return widest_chunk(table_smem, R, B);
}

int mrgcn_compose_grad_ctas(int R, int B, long long K) {
    const int cw = mrgcn_compose_grad_chunk(R, B);
    if (cw == 0 || K <= 0) return 0;
    const long long n_chunks = (K + cw - 1) / cw;
    const int sms = sm_count();
    return n_chunks < sms ? (int)n_chunks : sms;
}

// d_comp (R, B) = D P^T and d_packed (B, K) = C^T D for D = d_t (R, K),
// P = packed (B, K), C = comp (R, B); K a positive multiple of 4, all
// pointers 16-byte aligned. `partial` is scratch of
// mrgcn_compose_grad_ctas(R, B, K) * R * B floats. Launches on `stream`
// and returns cudaGetLastError() (0 on success).
int mrgcn_compose_grad_f32(const float* d_t, const float* packed,
                           const float* comp, float* d_packed, float* d_comp,
                           float* partial, int R, int B, long long K,
                           void* stream) {
    const int cw = mrgcn_compose_grad_chunk(R, B);
    const int ctas = mrgcn_compose_grad_ctas(R, B, K);
    if (cw == 0 || ctas == 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err;
    if (cw == 128)
        err = launch_grad<128>(d_t, packed, comp, d_packed, partial, R, B, K,
                               ctas, s);
    else if (cw == 64)
        err = launch_grad<64>(d_t, packed, comp, d_packed, partial, R, B, K,
                              ctas, s);
    else
        err = launch_grad<32>(d_t, packed, comp, d_packed, partial, R, B, K,
                              ctas, s);
    if (err != cudaSuccess) return (int)err;
    const int n = R * B;
    sum_partials_kernel<<<(n + 255) / 256, 256, 0, s>>>(partial, d_comp, n,
                                                        ctas);
    return (int)cudaGetLastError();
}

// out (R, K) = comp (R, B) @ pk (B, K); K a positive multiple of 4, all
// pointers 16-byte aligned.
int mrgcn_compose_table_f32(const float* comp, const float* pk, float* out,
                            int R, int B, long long K, void* stream) {
    const int cw = mrgcn_compose_table_chunk(R, B);
    if (cw == 0 || K <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err;
    if (cw == 128)
        err = launch_table<128>(comp, pk, out, R, B, K, s);
    else if (cw == 64)
        err = launch_table<64>(comp, pk, out, R, B, K, s);
    else
        err = launch_table<32>(comp, pk, out, R, B, K, s);
    return (int)err;
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

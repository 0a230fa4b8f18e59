// The Hopper (sm_90a) plumbing the tensor-core kernels share
// (fused_attention.cu, fused_mlp.cu): mbarriers, TMA tile loads into the
// 128-byte swizzle, wgmma shared-memory descriptors and products, the
// accumulator -> A-fragment repack and ldmatrix A-fragment loads, and on
// the host the tensor maps and the shared-memory opt-in.
//
// The tile layout every descriptor here assumes: a box of 64 rows x 64
// bf16 columns (128 bytes a row) as TMA writes it with the 128-byte
// swizzle, the 16-byte chunk c of row r at chunk c ^ (r % 8), eight rows
// (1 KB) a swizzle atom. A 1 KB-aligned box is what the descriptors read.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int kBoxRows = 64;                 // rows of a TMA box
constexpr int kBoxBytes = kBoxRows * 128;    // 64 rows x 64 bf16 columns
constexpr int kRowGroup = 8 * 128;           // a swizzle atom: 8 rows

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t shared_address(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers and TMA loads ----------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(shared_address(bar)), "r"(count) : "memory");
}

// makes the initialised barriers visible to the copy engine
__device__ __forceinline__ void mbar_init_fence() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival, and `bytes` more to wait for in the barrier's current phase
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(shared_address(bar)), "r"(bytes) : "memory");
}

// one arrival
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(shared_address(bar)) : "memory");
}

// until the barrier's phase of the given parity is complete
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
    asm volatile(
        "{\n.reg .pred P1;\nLAB_WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
        "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n"
        :: "r"(shared_address(bar)), "r"(parity) : "memory");
}

// One box of a 3-d tensor map, at coordinates (c0 innermost, c1, c2), into
// shared memory at dst (1 KB aligned); the bytes count on `bar`. Zeros
// where the box reaches past the tensor. One thread calls it.
__device__ __forceinline__ void tma_load_box(char* dst, const CUtensorMap* map,
                                             uint64_t* bar, int c0, int c1,
                                             int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier"
        "::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
        :: "r"(shared_address(dst)), "l"((uint64_t)map),
           "r"(shared_address(bar)), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
}

// Rows row.. (64) x all 128 columns of sequence n of a mapped (N, L, d)
// tensor into a shared tile (two boxes); the bytes count on `bar`. Zeros
// outside (L, d). One thread calls it.
__device__ __forceinline__ void load_tile(char* dst, const CUtensorMap* map,
                                          uint64_t* bar, int row, int n) {
#pragma unroll
    for (int box = 0; box < 2; ++box)
        tma_load_box(dst + box * kBoxBytes, map, bar, box * 64, row, n);
}

// One box of a 4-d tensor map, at coordinates (c0 innermost, .., c3).
__device__ __forceinline__ void tma_load_box_4d(char* dst,
                                                const CUtensorMap* map,
                                                uint64_t* bar, int c0, int c1,
                                                int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier"
        "::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
        :: "r"(shared_address(dst)), "l"((uint64_t)map),
           "r"(shared_address(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}

// Rows row.. (64) x all 128 columns of head h of sequence n of a mapped
// (N, L, H, d) tensor (make_map_heads) into a shared tile (two boxes);
// zeros outside (L, d). One thread calls it.
__device__ __forceinline__ void load_tile_head(char* dst,
                                               const CUtensorMap* map,
                                               uint64_t* bar, int row, int n,
                                               int h) {
#pragma unroll
    for (int box = 0; box < 2; ++box)
        tma_load_box_4d(dst + box * kBoxBytes, map, bar, box * 64, h, row, n);
}

// orders this thread's generic-proxy accesses of shared memory before
// later async-proxy ones (wgmma operand reads, TMA writes)
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- wgmma -----------------------------------------------------------------

// Shared-memory matrix descriptors (128-byte swizzle). An operand whose k
// index runs along the tile's columns (K-major: q, k, v, do in the score
// products): rows row0.. (a multiple of 8), columns 16 kk.. .
__device__ __forceinline__ uint64_t desc_k_major(const char* tile, int row0,
                                                 int kk) {
    const uint32_t at = shared_address(tile) + (kk >> 2) * kBoxBytes
                      + (row0 >> 3) * kRowGroup + (kk & 3) * 32;
    return (uint64_t)((at & 0x3FFFF) >> 4) | ((uint64_t)1 << 16)
         | ((uint64_t)(kRowGroup >> 4) << 32)     // next 8 of m / n
         | ((uint64_t)1 << 62);
}

// The B operand of the second products, whose k index runs along the
// tile's rows k0.. and whose n index along all its columns (MN-major).
__device__ __forceinline__ uint64_t desc_mn_major(const char* tile, int k0) {
    const uint32_t at = shared_address(tile) + (k0 >> 3) * kRowGroup;
    return (uint64_t)((at & 0x3FFFF) >> 4)
         | ((uint64_t)(kBoxBytes >> 4) << 16)     // next 64 of n
         | ((uint64_t)(kRowGroup >> 4) << 32)     // next 8 of k
         | ((uint64_t)1 << 62);
}

// d (+)= a b over one k step of 16, for the warpgroup's 64 rows. Thread
// (warp w, g = lane / 4, t = lane % 4) holds rows 16 w + g (d[nt][0..1])
// and 16 w + g + 8 (d[nt][2..3]) at columns 8 nt + 2 t + {0, 1}: the layout
// of mma.sync's accumulator, a warp at a time. TransA / TransB = 1 reads
// that operand MN-major (desc_mn_major), 0 K-major (desc_k_major).
template <int TransA = 0, int TransB = 0>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t a,
        uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
        " %16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
        "%32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "l"(a), "l"(b), "r"(accumulate), "n"(TransA), "n"(TransB));
}

__device__ __forceinline__ void wgmma_ss_n32(float (&d)[4][4], uint64_t a,
        uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= a b, 64 columns, A from registers (the accumulator layout, as
// to_a or ldmatrix_a packs it), B from shared memory (MN-major with
// TransB = 1)
template <int TransB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[8][4],
        const uint32_t (&a)[4], uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
        " %16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate),
          "n"(TransB));
}

#define HOPPER_ACC128                                                       \
    "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),            \
    "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),            \
    "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),            \
    "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),            \
    "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),            \
    "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),            \
    "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),            \
    "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),            \
    "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),            \
    "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),            \
    "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),        \
    "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),        \
    "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),        \
    "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),        \
    "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),        \
    "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])

#define HOPPER_ACC128_REGS                                                  \
    "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"               \
    " %16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"     \
    " %32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"     \
    " %48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, "

// d (+)= a b, 128 columns, both operands from shared memory
template <int TransA, int TransB>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[16][4], uint64_t a,
        uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        HOPPER_ACC128_REGS
        "%64, %65, p, 1, 1, %67, %68;\n}\n"
        : HOPPER_ACC128
        : "l"(a), "l"(b), "r"(accumulate), "n"(TransA), "n"(TransB));
}

// d (+)= a b, 128 columns, A from registers (the accumulator layout, as
// to_a packs it), B from shared memory (MN-major with TransB = 1)
template <int TransB = 1>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[16][4],
        const uint32_t (&a)[4], uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        HOPPER_ACC128_REGS
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : HOPPER_ACC128
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate),
          "n"(TransB));
}

#undef HOPPER_ACC128
#undef HOPPER_ACC128_REGS

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait for every product issued, then pin the accumulators so that no
// read of them moves above the wait.
template <int NT>
__device__ __forceinline__ void wgmma_wait(float (&d)[NT][4]) {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
            asm volatile("" : "+f"(d[nt][e]) :: "memory");
}

// accumulator tiles 2 kk and 2 kk + 1 -> the bf16 A fragment over columns
// 16 kk .. 16 kk + 15
template <int NT>
__device__ __forceinline__ void to_a(uint32_t (&a)[4],
                                     const float (&s)[NT][4], int kk) {
    a[0] = pack2(s[2 * kk][0], s[2 * kk][1]);
    a[1] = pack2(s[2 * kk][2], s[2 * kk][3]);
    a[2] = pack2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    a[3] = pack2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
}

// The warpgroup's A fragments (rows 16 warp.. of each warp, as wgmma
// takes A from registers) over k-steps 0..7 of a 64-row tile whose k
// index runs along its 128 columns (two boxes: K-major), by ldmatrix.
__device__ __forceinline__ void ldmatrix_a_k_major(uint32_t (&a)[8][4],
                                                   const char* tile) {
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int r = 16 * warp + (lane & 15);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
        const int q = 2 * (kk & 3) + (lane >> 4);
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
            : "=r"(a[kk][0]), "=r"(a[kk][1]), "=r"(a[kk][2]), "=r"(a[kk][3])
            : "r"(shared_address(tile + (kk >> 2) * kBoxBytes + r * 128
                                 + ((q ^ (r & 7)) << 4))));
    }
}

// The same for A = T^T, T a tile of 128 rows (k) x 64 columns (m) in two
// stacked boxes (MN-major A), by ldmatrix.trans.
__device__ __forceinline__ void ldmatrix_a_mn_major(uint32_t (&a)[8][4],
                                                    const char* tile) {
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int q = 2 * warp + ((lane >> 3) & 1);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
        const int k = 16 * kk + (lane & 7) + ((lane >> 4) << 3);
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
            "{%0,%1,%2,%3}, [%4];\n"
            : "=r"(a[kk][0]), "=r"(a[kk][1]), "=r"(a[kk][2]), "=r"(a[kk][3])
            : "r"(shared_address(tile + k * 128 + ((q ^ (k & 7)) << 4))));
    }
}

// 2^x, the hardware's approximation (2 ulp; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// ---- host side ------------------------------------------------------------

// Lets `kernel` use `smem` bytes of dynamic shared memory on the current
// device; asked for once per kernel and device (`done`). Also binds the
// device's context to the calling thread, which the tensor-map encoder (a
// libcuda call, not a runtime one) needs and a thread that has only
// launched through the runtime may lack (the autograd engine's workers).
inline int allow_smem(const void* kernel, size_t smem, bool (&done)[64]) {
    int device = 0;
    int err = (int)cudaGetDevice(&device);
    if (err) return err;
    err = (int)cudaFree(nullptr);
    if (err) return err;
    if (device < 64 && done[device]) return 0;
    err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err) return err;
    err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
    if (err) return err;
    if (device < 64) done[device] = true;
    return 0;
}

typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// libcuda's tensor-map encoder, taken through the runtime, so nothing links
// against libcuda; nullptr where the driver lacks it
inline EncodeTiled tensor_map_encoder() {
    static EncodeTiled encode = nullptr;
    if (!encode) {
        void* fn = nullptr;
        cudaDriverEntryPointQueryResult found;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                    cudaEnableDefault, &found) != cudaSuccess
            || found != cudaDriverEntryPointSuccess)
            return nullptr;
        encode = (EncodeTiled)fn;
    }
    return encode;
}

// A bf16 tensor map of `rank` dims (sizes innermost first, the element
// strides of the outer ones) read in boxes of sizes `box`, in the 128-byte
// swizzle, zeros outside the tensor.
inline int encode_map(CUtensorMap* map, const void* base, int rank,
                      const cuuint64_t* dims, const long long* strides,
                      const cuuint32_t* box) {
    EncodeTiled encode = tensor_map_encoder();
    if (!encode) return (int)cudaErrorSymbolNotFound;
    cuuint64_t bytes[4];
    for (int i = 0; i + 1 < rank; ++i) bytes[i] = (cuuint64_t)strides[i] * 2;
    const cuuint32_t steps[4] = {1, 1, 1, 1};
    const CUresult rc = encode(
        map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
        const_cast<void*>(base), dims, bytes, box, steps,
        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return rc == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The tensor map of an (N, L, d) bf16 tensor with element strides
// (sn, sl, 1): boxes of 64 rows x 64 columns of one sequence.
inline int make_map(CUtensorMap* map, const void* base, int N, int L, int d,
                    long long sn, long long sl) {
    const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)L, (cuuint64_t)N};
    const long long strides[2] = {sl, sn};
    const cuuint32_t box[3] = {64, kBoxRows, 1};
    return encode_map(map, base, 3, dims, strides, box);
}

// The tensor map of an (N, L, H, d) bf16 tensor with element strides
// (sn, sl, sh, 1): boxes of 64 rows x 64 columns of one head of one
// sequence (the layout of a box in shared memory is make_map's).
inline int make_map_heads(CUtensorMap* map, const void* base, int N, int L,
                          int H, int d, long long sn, long long sl,
                          long long sh) {
    const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)H, (cuuint64_t)L,
                                (cuuint64_t)N};
    const long long strides[3] = {sh, sl, sn};
    const cuuint32_t box[4] = {64, 1, kBoxRows, 1};
    return encode_map(map, base, 4, dims, strides, box);
}

}  // namespace hopper

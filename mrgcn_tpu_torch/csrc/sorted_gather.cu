// Block-sorted row gather for Hopper (sm_90a).
//
// Computes  out[s * EB + j] = table[tbl[s] * RB + local[s, j]]  for every
// slab s of EB edges; a local index outside [0, RB), or a row outside the
// table, gives a zero row. Exact in f32: the rows are copied.
//
// Replaces: mrgcn_tpu/ops/pallas_gather.py::_gather_kernel (the TPU kernel
// behind pallas_gather.sorted_gather, the transpose of sorted_scatter).
// That kernel brings each slab's whole (RB, L) table block into VMEM
// through a ring of asynchronous copies and selects the rows with a one-hot
// matmul. On this card a row is read where it lies: neighbouring threads
// read neighbouring 16-byte pieces of one row, and rows of one table block
// that several edges of a slab name are served from cache.
//
// What bounds it on the card: memory bandwidth (it does no arithmetic): it
// reads at most E_pad rows of L floats and writes E_pad rows.
//
// What the design does about it: one CTA per slab, 256 threads, each moving
// 16 bytes at a time; the slab's local indices are staged in shared memory
// once. Slabs are independent, so the grid fills the card whatever the run
// structure of the stream. Offsets are 64-bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxEdgeBlock = 1024;

__global__ void __launch_bounds__(kThreads)
sorted_gather_kernel(const float* __restrict__ table,
                     const int* __restrict__ local,
                     const int* __restrict__ tbl_idx,
                     float* __restrict__ out, int edge_block, int row_block,
                     long long table_rows, int L) {
    __shared__ int s_local[kMaxEdgeBlock];
    const int s = blockIdx.x;
    const int tid = threadIdx.x;
    const long long e0 = (long long)s * edge_block;
    for (int e = tid; e < edge_block; e += kThreads)
        s_local[e] = __ldg(local + e0 + e);
    __syncthreads();

    const long long base = (long long)__ldg(tbl_idx + s) * row_block;
    const int n_vec = L / 4;
    for (int c = tid; c < edge_block * n_vec; c += kThreads) {
        const int e = c / n_vec;
        const int q = c % n_vec;
        const int loc = s_local[e];
        const long long row = base + loc;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if ((unsigned)loc < (unsigned)row_block && row >= 0
                && row < table_rows)
            v = __ldg(reinterpret_cast<const float4*>(
                table + row * L + q * 4));
        *reinterpret_cast<float4*>(out + (e0 + e) * L + q * 4) = v;
    }
}

}  // namespace

extern "C" {

// Largest edge block the kernel takes; the Python wrapper checks against it.
int mrgcn_sorted_gather_max_edge_block() { return kMaxEdgeBlock; }

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// `table` is (table_rows, L) and `out` (nslab * edge_block, L), both
// contiguous and 16-byte aligned, L a multiple of 4; nslab > 0.
int mrgcn_sorted_gather_f32(const float* table, const int* local,
                            const int* tbl_idx, float* out, int nslab,
                            int edge_block, int row_block,
                            long long table_rows, int L, void* stream) {
    sorted_gather_kernel<<<(unsigned)nslab, kThreads, 0,
                           (cudaStream_t)stream>>>(
        table, local, tbl_idx, out, edge_block, row_block, table_rows, L);
    return (int)cudaGetLastError();
}

const char* mrgcn_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

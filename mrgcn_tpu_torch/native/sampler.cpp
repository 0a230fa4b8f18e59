// Native BFS neighbourhood expansion for mini-batch sampling.
//
// The reference expands L-hop neighbourhoods by slicing scipy CSR rows in
// Python per batch (reference: mrgcn/data/batch.py:185-197, 228-243). Here
// the per-hop expansion — gather all out-edges of the frontier, dedup the
// neighbour set — is a single C pass over the CSR arrays, called via ctypes
// from mrgcn_tpu_torch/data/batching.py. One visited-marks buffer is reused
// across calls; only the entries touched in a hop are cleared, so a hop
// costs O(edges + neighbours), never O(num_nodes).
//
// Build (done at first use by mrgcn_tpu_torch/data/native.py):
//   g++ -O3 -shared -fPIC -std=c++17 sampler.cpp -o _sampler.so

#include <algorithm>
#include <cstdint>

extern "C" {

// Expand one BFS hop.
//   indptr       : int64[num_nodes + 1]  CSR row pointers (src-sorted edges)
//   dst          : int32[E]              edge targets
//   frontier     : int32[num_frontier]   nodes to expand
//   eids_out     : int64[sum degrees]    all out-edge ids of the frontier
//   neigh_out    : int32[num_nodes]      unique neighbour ids (sorted)
//   num_neigh_out: receives the neighbour count
//   mark         : uint8[num_nodes]      scratch, all-zero on entry and exit
// Returns the number of edge ids written, or -1 on a bad frontier id.
int64_t mg_bfs_hop(const int64_t* indptr, const int32_t* dst,
                   int64_t num_nodes,
                   const int32_t* frontier, int64_t num_frontier,
                   int64_t* eids_out, int32_t* neigh_out,
                   int64_t* num_neigh_out, uint8_t* mark) {
    int64_t n_eids = 0;
    int64_t n_neigh = 0;
    for (int64_t i = 0; i < num_frontier; ++i) {
        const int64_t v = frontier[i];
        if (v < 0 || v >= num_nodes) {
            for (int64_t j = 0; j < n_neigh; ++j) mark[neigh_out[j]] = 0;
            return -1;
        }
        const int64_t lo = indptr[v], hi = indptr[v + 1];
        for (int64_t e = lo; e < hi; ++e) {
            eids_out[n_eids++] = e;
            const int32_t u = dst[e];
            if (!mark[u]) {
                mark[u] = 1;
                neigh_out[n_neigh++] = u;
            }
        }
    }
    std::sort(neigh_out, neigh_out + n_neigh);
    for (int64_t j = 0; j < n_neigh; ++j) mark[neigh_out[j]] = 0;
    *num_neigh_out = n_neigh;
    return n_eids;
}

}  // extern "C"

// Native levelizer: longest-path topological levels over the combinational
// edge set (the compiled-ahead-of-time replacement for the reference's
// runtime scheduler, cf. reference src/iyokan.cpp:100-161 doTopologicalSort).
//
// The Python levelizer is fine for the reference-sized CPUs (~10k nodes);
// production netlists run to millions of gates, where the O(V+E) C++ pass
// with flat arrays is ~100x faster and allocation-free.
//
// C ABI (ctypes):
//   levelize(n_nodes, n_edges, src[], dst[], out_level[]) -> int
//     returns 0 on success, -1 if a combinational cycle exists.
//   gate_census(n_nodes, kinds[], n_kinds, out_counts[])

#include <cstddef>
#include <cstdint>
#include <vector>

extern "C" {

int levelize(int64_t n_nodes, int64_t n_edges, const int32_t* src,
             const int32_t* dst, int32_t* out_level) {
    std::vector<int32_t> indeg(n_nodes, 0);
    std::vector<int64_t> head(n_nodes, -1), next(n_edges, -1);
    std::vector<int32_t> to(n_edges);

    for (int64_t e = 0; e < n_edges; ++e) {
        int32_t s = src[e], d = dst[e];
        to[e] = d;
        next[e] = head[s];
        head[s] = e;
        indeg[d]++;
    }

    std::vector<int32_t> queue;
    queue.reserve(n_nodes);
    for (int64_t i = 0; i < n_nodes; ++i) {
        out_level[i] = 0;
        if (indeg[i] == 0) queue.push_back((int32_t)i);
    }

    std::size_t qhead = 0;
    while (qhead < queue.size()) {
        int32_t u = queue[qhead++];
        for (int64_t e = head[u]; e != -1; e = next[e]) {
            int32_t v = to[e];
            if (out_level[u] + 1 > out_level[v]) out_level[v] = out_level[u] + 1;
            if (--indeg[v] == 0) queue.push_back(v);
        }
    }
    return (int64_t)queue.size() == n_nodes ? 0 : -1;
}

void gate_census(int64_t n_nodes, const uint8_t* kinds, int32_t n_kinds,
                 int64_t* out_counts) {
    for (int32_t k = 0; k < n_kinds; ++k) out_counts[k] = 0;
    for (int64_t i = 0; i < n_nodes; ++i) {
        if (kinds[i] < n_kinds) out_counts[kinds[i]]++;
    }
}

}  // extern "C"

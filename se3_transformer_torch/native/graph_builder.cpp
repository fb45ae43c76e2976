// Host-side graph/data pipeline functions (C, exported for ctypes): the
// port's own copy of se3_transformer_tpu/native/graph_builder.cpp.
//
// Chain adjacency, N-hop adjacency expansion with ring labels, exact kNN
// and padded batch assembly for the input pipeline, so that the card does
// not wait on host-side batch preparation. Built by native/loader.py at
// first use into native/build/; every entry point has a NumPy fallback
// there.
//
// Build: g++ -O3 -shared -fPIC graph_builder.cpp -o libse3graph.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Chain adjacency: nodes i, i+1 bonded. out is [n*n] row-major uint8.
void chain_adjacency(int32_t n, uint8_t* out) {
    std::memset(out, 0, (size_t)n * n);
    for (int32_t i = 0; i + 1 < n; ++i) {
        out[(size_t)i * n + i + 1] = 1;
        out[(size_t)(i + 1) * n + i] = 1;
    }
}

// N-hop expansion with ring labels (reference se3_transformer_pytorch.py
// :1177-1190 semantics): labels[i,j] = smallest hop count <= num_degrees
// reachable via repeated boolean squaring, 0 if unreachable. adj and
// labels are [n*n]; adj is modified in place to the expanded matrix.
void expand_adjacency(int32_t n, int32_t num_degrees, uint8_t* adj,
                      int32_t* labels) {
    std::vector<uint8_t> cur(adj, adj + (size_t)n * n);
    for (size_t ij = 0; ij < (size_t)n * n; ++ij)
        labels[ij] = adj[ij] ? 1 : 0;
    std::vector<uint8_t> next((size_t)n * n);
    for (int32_t d = 2; d <= num_degrees; ++d) {
        // next = (cur @ cur) > 0
        for (int32_t i = 0; i < n; ++i) {
            const uint8_t* row = &cur[(size_t)i * n];
            uint8_t* nrow = &next[(size_t)i * n];
            std::memset(nrow, 0, n);
            for (int32_t k = 0; k < n; ++k) {
                if (!row[k]) continue;
                const uint8_t* krow = &cur[(size_t)k * n];
                for (int32_t j = 0; j < n; ++j) nrow[j] |= krow[j];
            }
        }
        for (size_t ij = 0; ij < (size_t)n * n; ++ij) {
            if (next[ij] && !cur[ij] && labels[ij] == 0) labels[ij] = d;
        }
        cur = next;
    }
    std::memcpy(adj, cur.data(), (size_t)n * n);
}

// Exact kNN (excluding self) per batch of point clouds.
// coords [b, n, 3] float32. Outputs idx [b, n, k] int32, dist [b, n, k]
// float32, mask [b, n, k] uint8 (dist <= radius). Selection by partial
// sort; ties broken by index (stable), matching fixed-K top-k semantics.
void knn_graph(const float* coords, int32_t b, int32_t n, int32_t k,
               float radius, int32_t* idx, float* dist, uint8_t* mask) {
    std::vector<std::pair<float, int32_t>> cand;
    for (int32_t bi = 0; bi < b; ++bi) {
        const float* C = coords + (size_t)bi * n * 3;
        for (int32_t i = 0; i < n; ++i) {
            cand.clear();
            cand.reserve(n - 1);
            const float xi = C[i * 3], yi = C[i * 3 + 1], zi = C[i * 3 + 2];
            for (int32_t j = 0; j < n; ++j) {
                if (j == i) continue;
                const float dx = xi - C[j * 3], dy = yi - C[j * 3 + 1],
                            dz = zi - C[j * 3 + 2];
                cand.emplace_back(dx * dx + dy * dy + dz * dz, j);
            }
            const int32_t kk = std::min<int32_t>(k, (int32_t)cand.size());
            std::partial_sort(cand.begin(), cand.begin() + kk, cand.end());
            size_t base = ((size_t)bi * n + i) * k;
            for (int32_t t = 0; t < k; ++t) {
                if (t < kk) {
                    float d = std::sqrt(cand[t].first);
                    idx[base + t] = cand[t].second;
                    dist[base + t] = d;
                    mask[base + t] = d <= radius ? 1 : 0;
                } else {
                    idx[base + t] = 0;
                    dist[base + t] = 0.f;
                    mask[base + t] = 0;
                }
            }
        }
    }
}

// Pad a ragged set of sequences into one [b, max_len] int32 batch plus
// mask. lengths [b], flat concatenated tokens.
void pad_token_batch(const int32_t* flat, const int32_t* lengths, int32_t b,
                     int32_t max_len, int32_t pad_value, int32_t* out,
                     uint8_t* mask) {
    size_t off = 0;
    for (int32_t bi = 0; bi < b; ++bi) {
        int32_t L = lengths[bi];
        for (int32_t t = 0; t < max_len; ++t) {
            out[(size_t)bi * max_len + t] = t < L ? flat[off + t] : pad_value;
            mask[(size_t)bi * max_len + t] = t < L ? 1 : 0;
        }
        off += L;
    }
}

// Same for float coordinate triples.
void pad_coord_batch(const float* flat, const int32_t* lengths, int32_t b,
                     int32_t max_len, float* out) {
    size_t off = 0;
    for (int32_t bi = 0; bi < b; ++bi) {
        int32_t L = lengths[bi];
        for (int32_t t = 0; t < max_len; ++t) {
            for (int32_t c = 0; c < 3; ++c)
                out[((size_t)bi * max_len + t) * 3 + c] =
                    t < L ? flat[(off + t) * 3 + c] : 0.f;
        }
        off += L;
    }
}

}  // extern "C"

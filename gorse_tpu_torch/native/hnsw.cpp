// Native HNSW index (host-side ANN), a copy of gorse_tpu/native/hnsw.cpp:
// the same source and flags give the same graph for the same insertion
// order. Compiled C++ behind a C ABI, bound by ctypes from
// gorse_tpu_torch/native/hnsw.py; the store ``hnsw://`` serves from it.
//
// Spaces: 0 = squared L2, 1 = inner product (distance = -dot),
//         2 = cosine (vectors L2-normalized on add; distance = -cos).
// Supports incremental add, soft delete, save/load, batched search.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <random>
#include <shared_mutex>
#include <unordered_map>
#include <vector>

namespace {

struct Index {
    int dim = 0;
    int space = 1;           // 0 l2, 1 ip, 2 cosine
    int M = 16;              // max links per node, levels > 0
    int maxM0 = 32;          // max links at level 0
    int efC = 200;           // ef at construction
    double level_mult = 1.0; // 1/ln(M)

    std::vector<float> data;              // n * dim
    std::vector<int64_t> labels;          // internal id -> label
    std::vector<uint8_t> deleted;         // soft-delete flags
    int64_t n_deleted = 0;                // live count of set flags
    std::vector<int> levels;              // node level
    // links[l][i] = neighbor list of node i at level l (flat with counts)
    std::vector<std::vector<int>> links;  // per node: concatenated per-level
    std::vector<std::vector<int>> offsets; // per node: level -> (start, count handled via vectors below)

    // simpler: per node, per level adjacency
    std::vector<std::vector<std::vector<int>>> adj; // adj[node][level] -> neighbors

    std::unordered_map<int64_t, int> label_to_id;
    int entry = -1;
    int max_level = -1;
    std::mt19937_64 rng;
    mutable std::shared_mutex mu;

    const float* vec(int i) const { return data.data() + (size_t)i * dim; }

    float dist(const float* a, const float* b) const {
        float acc = 0.f;
        if (space == 0) {
            for (int d = 0; d < dim; ++d) {
                float t = a[d] - b[d];
                acc += t * t;
            }
            return acc;
        }
        for (int d = 0; d < dim; ++d) acc += a[d] * b[d];
        return -acc; // ip / cosine (normalized)
    }
};

using HeapItem = std::pair<float, int>; // (distance, node)

// search one layer: returns up to ef closest candidates to q
void search_layer(const Index& ix, const float* q, int ep, int level, int ef,
                  std::priority_queue<HeapItem>& result /* max-heap by dist */) {
    std::vector<uint8_t> visited(ix.labels.size(), 0);
    std::priority_queue<HeapItem, std::vector<HeapItem>, std::greater<>> cand;
    float d0 = ix.dist(q, ix.vec(ep));
    cand.emplace(d0, ep);
    result.emplace(d0, ep);
    visited[ep] = 1;
    while (!cand.empty()) {
        auto [dc, c] = cand.top();
        if (dc > result.top().first && (int)result.size() >= ef) break;
        cand.pop();
        if (level < (int)ix.adj[c].size()) {
            for (int nb : ix.adj[c][level]) {
                if (visited[nb]) continue;
                visited[nb] = 1;
                float d = ix.dist(q, ix.vec(nb));
                if ((int)result.size() < ef || d < result.top().first) {
                    cand.emplace(d, nb);
                    result.emplace(d, nb);
                    if ((int)result.size() > ef) result.pop();
                }
            }
        }
    }
}

// heuristic neighbor selection (Malkov & Yashunin Algorithm 4,
// mirrors common/ann/hnsw.go:271-276)
std::vector<int> select_neighbors(const Index& ix, const float* q,
                                  std::vector<HeapItem> cands, int m) {
    std::sort(cands.begin(), cands.end());
    std::vector<int> out;
    for (auto& [d, e] : cands) {
        if ((int)out.size() >= m) break;
        bool good = true;
        for (int sel : out) {
            if (ix.dist(ix.vec(e), ix.vec(sel)) < d) { good = false; break; }
        }
        if (good) out.push_back(e);
    }
    // backfill with pruned candidates if underfull
    if ((int)out.size() < m) {
        for (auto& [d, e] : cands) {
            if ((int)out.size() >= m) break;
            if (std::find(out.begin(), out.end(), e) == out.end()) out.push_back(e);
        }
    }
    return out;
}

void add_one(Index& ix, int64_t label, const float* v_in) {
    std::vector<float> norm;
    const float* v = v_in;
    if (ix.space == 2) {
        norm.assign(v_in, v_in + ix.dim);
        float n2 = 0.f;
        for (float x : norm) n2 += x * x;
        float inv = n2 > 0.f ? 1.0f / std::sqrt(n2) : 0.f;
        for (float& x : norm) x *= inv;
        v = norm.data();
    }
    auto it = ix.label_to_id.find(label);
    if (it != ix.label_to_id.end()) {
        // overwrite vector in place; graph links stay (approximation is fine
        // for upserts of slowly-moving embeddings), undelete
        std::memcpy(ix.data.data() + (size_t)it->second * ix.dim, v,
                    sizeof(float) * ix.dim);
        if (ix.deleted[it->second]) ix.n_deleted--;
        ix.deleted[it->second] = 0;
        return;
    }
    int id = (int)ix.labels.size();
    ix.labels.push_back(label);
    ix.deleted.push_back(0);
    ix.data.insert(ix.data.end(), v, v + ix.dim);
    std::uniform_real_distribution<double> unif(0.0, 1.0);
    int level = (int)(-std::log(std::max(unif(ix.rng), 1e-12)) * ix.level_mult);
    ix.levels.push_back(level);
    ix.adj.emplace_back(level + 1);
    ix.label_to_id[label] = id;

    if (ix.entry < 0) {
        ix.entry = id;
        ix.max_level = level;
        return;
    }
    int ep = ix.entry;
    // greedy descent through upper levels
    for (int l = ix.max_level; l > level; --l) {
        bool improved = true;
        float de = ix.dist(v, ix.vec(ep));
        while (improved) {
            improved = false;
            if (l < (int)ix.adj[ep].size()) {
                for (int nb : ix.adj[ep][l]) {
                    float d = ix.dist(v, ix.vec(nb));
                    if (d < de) { de = d; ep = nb; improved = true; }
                }
            }
        }
    }
    for (int l = std::min(level, ix.max_level); l >= 0; --l) {
        std::priority_queue<HeapItem> res;
        search_layer(ix, v, ep, l, ix.efC, res);
        std::vector<HeapItem> cands;
        while (!res.empty()) { cands.push_back(res.top()); res.pop(); }
        int m = l == 0 ? ix.maxM0 : ix.M;
        auto nbs = select_neighbors(ix, v, cands, ix.M);
        ix.adj[id][l] = nbs;
        for (int nb : nbs) {
            auto& lst = ix.adj[nb][l];
            lst.push_back(id);
            if ((int)lst.size() > m) {
                // shrink: keep the m heuristic-best neighbors of nb
                std::vector<HeapItem> c2;
                c2.reserve(lst.size());
                for (int x : lst) c2.emplace_back(ix.dist(ix.vec(nb), ix.vec(x)), x);
                lst = select_neighbors(ix, ix.vec(nb), std::move(c2), m);
            }
        }
        if (!cands.empty()) {
            ep = std::min_element(cands.begin(), cands.end())->second;
        }
    }
    if (level > ix.max_level) {
        ix.max_level = level;
        ix.entry = id;
    }
}

} // namespace

extern "C" {

void* hnsw_new(int dim, int space, int M, int ef_construction, uint64_t seed) {
    auto* ix = new Index();
    ix->dim = dim;
    ix->space = space;
    ix->M = M;
    ix->maxM0 = 2 * M;
    ix->efC = ef_construction;
    ix->level_mult = 1.0 / std::log(std::max(2.0, (double)M));
    ix->rng.seed(seed);
    return ix;
}

void hnsw_free(void* h) { delete (Index*)h; }

int64_t hnsw_size(void* h) {
    auto* ix = (Index*)h;
    std::shared_lock lk(ix->mu);
    int64_t n = 0;
    for (uint8_t d : ix->deleted) n += !d;
    return n;
}

void hnsw_add(void* h, int64_t n, const int64_t* labels, const float* vecs) {
    auto* ix = (Index*)h;
    std::unique_lock lk(ix->mu);
    for (int64_t i = 0; i < n; ++i)
        add_one(*ix, labels[i], vecs + (size_t)i * ix->dim);
}

int hnsw_mark_deleted(void* h, int64_t label) {
    auto* ix = (Index*)h;
    std::unique_lock lk(ix->mu);
    auto it = ix->label_to_id.find(label);
    if (it == ix->label_to_id.end()) return 0;
    if (!ix->deleted[it->second]) ix->n_deleted++;
    ix->deleted[it->second] = 1;
    return 1;
}

// out_labels/out_dists are nq*k, padded with -1 / +inf
void hnsw_search(void* h, int64_t nq, const float* queries, int k, int ef,
                 int64_t* out_labels, float* out_dists) {
    auto* ix = (Index*)h;
    std::shared_lock lk(ix->mu);
    ef = std::max(ef, k);
    for (int64_t qi = 0; qi < nq; ++qi) {
        const float* q0 = queries + (size_t)qi * ix->dim;
        std::vector<float> norm;
        const float* q = q0;
        if (ix->space == 2) {
            norm.assign(q0, q0 + ix->dim);
            float n2 = 0.f;
            for (float x : norm) n2 += x * x;
            float inv = n2 > 0.f ? 1.0f / std::sqrt(n2) : 0.f;
            for (float& x : norm) x *= inv;
            q = norm.data();
        }
        int64_t* ol = out_labels + qi * k;
        float* od = out_dists + qi * k;
        for (int j = 0; j < k; ++j) { ol[j] = -1; od[j] = INFINITY; }
        if (ix->entry < 0) continue;
        int ep = ix->entry;
        float de = ix->dist(q, ix->vec(ep));
        for (int l = ix->max_level; l > 0; --l) {
            bool improved = true;
            while (improved) {
                improved = false;
                if (l < (int)ix->adj[ep].size()) {
                    for (int nb : ix->adj[ep][l]) {
                        float d = ix->dist(q, ix->vec(nb));
                        if (d < de) { de = d; ep = nb; improved = true; }
                    }
                }
            }
        }
        std::priority_queue<HeapItem> res;
        // oversample ef by the number of soft-deleted nodes so k live
        // survivors remain after filtering (bounded by the index size)
        int64_t ef_eff = (int64_t)ef;
        if (ix->n_deleted > 0) {
            ef_eff = std::min<int64_t>(ef_eff + ix->n_deleted,
                                       (int64_t)ix->labels.size());
        }
        search_layer(*ix, q, ep, 0, (int)ef_eff, res);
        std::vector<HeapItem> hits;
        while (!res.empty()) { hits.push_back(res.top()); res.pop(); }
        std::sort(hits.begin(), hits.end());
        int j = 0;
        for (auto& [d, e] : hits) {
            if (j >= k) break;
            if (ix->deleted[e]) continue;
            ol[j] = ix->labels[e];
            od[j] = d;
            ++j;
        }
    }
}

int hnsw_save(void* h, const char* path) {
    auto* ix = (Index*)h;
    std::shared_lock lk(ix->mu);
    FILE* f = std::fopen(path, "wb");
    if (!f) return -1;
    int32_t header[5] = {ix->dim, ix->space, ix->M, ix->efC,
                         (int32_t)ix->labels.size()};
    std::fwrite(header, sizeof(header), 1, f);
    int32_t meta[2] = {ix->entry, ix->max_level};
    std::fwrite(meta, sizeof(meta), 1, f);
    size_t n = ix->labels.size();
    std::fwrite(ix->labels.data(), sizeof(int64_t), n, f);
    std::fwrite(ix->deleted.data(), sizeof(uint8_t), n, f);
    std::fwrite(ix->levels.data(), sizeof(int), n, f);
    std::fwrite(ix->data.data(), sizeof(float), n * ix->dim, f);
    for (size_t i = 0; i < n; ++i) {
        int32_t nl = (int32_t)ix->adj[i].size();
        std::fwrite(&nl, sizeof(nl), 1, f);
        for (auto& lst : ix->adj[i]) {
            int32_t c = (int32_t)lst.size();
            std::fwrite(&c, sizeof(c), 1, f);
            std::fwrite(lst.data(), sizeof(int), c, f);
        }
    }
    std::fclose(f);
    return 0;
}

void* hnsw_load(const char* path) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return nullptr;
    int32_t header[5];
    if (std::fread(header, sizeof(header), 1, f) != 1) { std::fclose(f); return nullptr; }
    auto* ix = (Index*)hnsw_new(header[0], header[1], header[2], header[3], 0);
    int32_t meta[2];
    if (std::fread(meta, sizeof(meta), 1, f) != 1) { std::fclose(f); hnsw_free(ix); return nullptr; }
    ix->entry = meta[0];
    ix->max_level = meta[1];
    size_t n = (size_t)header[4];
    ix->labels.resize(n);
    ix->deleted.resize(n);
    ix->levels.resize(n);
    ix->data.resize(n * ix->dim);
    bool ok = std::fread(ix->labels.data(), sizeof(int64_t), n, f) == n
        && std::fread(ix->deleted.data(), sizeof(uint8_t), n, f) == n
        && std::fread(ix->levels.data(), sizeof(int), n, f) == n
        && std::fread(ix->data.data(), sizeof(float), n * ix->dim, f) == n * ix->dim;
    ix->adj.resize(n);
    for (size_t i = 0; ok && i < n; ++i) {
        int32_t nl = 0;
        ok = std::fread(&nl, sizeof(nl), 1, f) == 1;
        if (!ok) break;
        ix->adj[i].resize(nl);
        for (int32_t l = 0; ok && l < nl; ++l) {
            int32_t c = 0;
            ok = std::fread(&c, sizeof(c), 1, f) == 1;
            if (!ok) break;
            ix->adj[i][l].resize(c);
            ok = std::fread(ix->adj[i][l].data(), sizeof(int), c, f) == (size_t)c;
        }
        ix->label_to_id[ix->labels[i]] = (int)i;
    }
    std::fclose(f);
    if (!ok) { hnsw_free(ix); return nullptr; }
    for (uint8_t d : ix->deleted) ix->n_deleted += (d != 0);
    return ix;
}

} // extern "C"

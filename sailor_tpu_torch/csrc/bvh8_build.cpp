// Host BVH8 builder of the port: the binned-SAH binary build with 7-triangle
// leaves and its collapse into packed 72-float rows (raytracing/bvh8.py's
// layout).
//
// A copy of the BVH section of the JAX package's native/sailor_native.cpp
// (sailor_bvh_build, Collapse, sailor_bvh8_build), with the same arithmetic
// in the same order and the same compiler flags (-O3 -march=native
// -std=c++17 -fPIC), so that both build the same table bit for bit. The
// port keeps its own copy: it loads no library of the JAX package.
// kernels/host_lib.py compiles it at first use with the system C++ compiler
// and loads it with ctypes; it is host code only and needs no CUDA toolkit.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Binned-SAH BVH build (Runtime/Raytracing/BVH.cpp counterpart).
// Flat output layout of raytracing/bvh.py.
// ---------------------------------------------------------------------------

namespace {

struct V3 {
    float x, y, z;
    V3 min(const V3& o) const { return {std::min(x, o.x), std::min(y, o.y), std::min(z, o.z)}; }
    V3 max(const V3& o) const { return {std::max(x, o.x), std::max(y, o.y), std::max(z, o.z)}; }
};

constexpr int kSahBins = 16;
constexpr int kLeafSize = 7;  // bvh8.MAX_LEAF

struct BuildCtx {
    const float *v0, *v1, *v2;
    std::vector<V3> cent, tmin, tmax;
    int32_t* order;
    float* nmin;
    float* nmax;
    int32_t* nleft;
    int32_t* nstart;
    int32_t* ncount;
    int n_nodes = 0;
    int cap;
    int leaf_size;
};

float half_area(const V3& lo, const V3& hi) {
    float dx = std::max(hi.x - lo.x, 0.f);
    float dy = std::max(hi.y - lo.y, 0.f);
    float dz = std::max(hi.z - lo.z, 0.f);
    return dx * dy + dy * dz + dz * dx;
}

void build_range(BuildCtx& c, int node, int start, int end) {
    V3 lo{1e30f, 1e30f, 1e30f}, hi{-1e30f, -1e30f, -1e30f};
    for (int i = start; i < end; ++i) {
        lo = lo.min(c.tmin[c.order[i]]);
        hi = hi.max(c.tmax[c.order[i]]);
    }
    c.nmin[node * 3 + 0] = lo.x;
    c.nmin[node * 3 + 1] = lo.y;
    c.nmin[node * 3 + 2] = lo.z;
    c.nmax[node * 3 + 0] = hi.x;
    c.nmax[node * 3 + 1] = hi.y;
    c.nmax[node * 3 + 2] = hi.z;
    int count = end - start;
    if (count <= c.leaf_size) {
        c.nstart[node] = start;
        c.ncount[node] = count;
        c.nleft[node] = 0;
        return;
    }
    // centroid bounds + largest axis
    V3 clo{1e30f, 1e30f, 1e30f}, chi{-1e30f, -1e30f, -1e30f};
    for (int i = start; i < end; ++i) {
        clo = clo.min(c.cent[c.order[i]]);
        chi = chi.max(c.cent[c.order[i]]);
    }
    float ext[3] = {chi.x - clo.x, chi.y - clo.y, chi.z - clo.z};
    int axis = ext[1] > ext[0] ? 1 : 0;
    if (ext[2] > ext[axis]) axis = 2;
    int mid;
    if (ext[axis] < 1e-12f) {
        mid = start + count / 2;
    } else {
        float base = axis == 0 ? clo.x : (axis == 1 ? clo.y : clo.z);
        float scale = kSahBins * (1.f - 1e-6f) / ext[axis];
        int bin_count[kSahBins] = {0};
        V3 bin_lo[kSahBins], bin_hi[kSahBins];
        for (int b = 0; b < kSahBins; ++b) {
            bin_lo[b] = {1e30f, 1e30f, 1e30f};
            bin_hi[b] = {-1e30f, -1e30f, -1e30f};
        }
        auto bin_of = [&](int tri) {
            const V3& ce = c.cent[tri];
            float v = axis == 0 ? ce.x : (axis == 1 ? ce.y : ce.z);
            int b = (int)((v - base) * scale);
            return std::min(std::max(b, 0), kSahBins - 1);
        };
        for (int i = start; i < end; ++i) {
            int tri = c.order[i];
            int b = bin_of(tri);
            bin_count[b]++;
            bin_lo[b] = bin_lo[b].min(c.tmin[tri]);
            bin_hi[b] = bin_hi[b].max(c.tmax[tri]);
        }
        // prefix/suffix areas
        float lcost[kSahBins], rcost[kSahBins];
        {
            V3 alo{1e30f, 1e30f, 1e30f}, ahi{-1e30f, -1e30f, -1e30f};
            int n = 0;
            for (int b = 0; b < kSahBins; ++b) {
                alo = alo.min(bin_lo[b]);
                ahi = ahi.max(bin_hi[b]);
                n += bin_count[b];
                lcost[b] = n ? half_area(alo, ahi) * n : 0.f;
            }
            alo = {1e30f, 1e30f, 1e30f};
            ahi = {-1e30f, -1e30f, -1e30f};
            n = 0;
            for (int b = kSahBins - 1; b >= 0; --b) {
                alo = alo.min(bin_lo[b]);
                ahi = ahi.max(bin_hi[b]);
                n += bin_count[b];
                rcost[b] = n ? half_area(alo, ahi) * n : 0.f;
            }
        }
        int best = -1;
        float best_cost = 1e30f;
        int nl = 0;
        for (int b = 0; b < kSahBins - 1; ++b) {
            nl += bin_count[b];
            if (nl == 0 || nl == count) continue;
            float cost = lcost[b] + rcost[b + 1];
            if (cost < best_cost) {
                best_cost = cost;
                best = b;
            }
        }
        if (best < 0) {
            mid = start + count / 2;
        } else {
            // partition by bin
            int i = start, j = end - 1;
            while (i <= j) {
                if (bin_of(c.order[i]) <= best) {
                    ++i;
                } else {
                    std::swap(c.order[i], c.order[j]);
                    --j;
                }
            }
            mid = i;
            if (mid == start || mid == end) mid = start + count / 2;
        }
    }
    if (mid == start || mid == end) {
        // median fallback: nth_element on axis
        mid = start + count / 2;
        std::nth_element(
            c.order + start, c.order + mid, c.order + end,
            [&](int a, int b) {
                const V3 &ca = c.cent[a], &cb = c.cent[b];
                float va = axis == 0 ? ca.x : (axis == 1 ? ca.y : ca.z);
                float vb = axis == 0 ? cb.x : (axis == 1 ? cb.y : cb.z);
                return va < vb;
            });
    }
    int left = c.n_nodes;
    c.n_nodes += 2;
    c.nleft[node] = left;
    c.nstart[node] = 0;
    c.ncount[node] = 0;
    build_range(c, left, start, mid);
    build_range(c, left + 1, mid, end);
}

}  // namespace

// Builds the flat binary BVH. Arrays must be preallocated with capacity
// 2*num_tris nodes (num_tris for `order`). Returns the node count.
int sailor_torch_bvh_build(const float* v0, const float* v1, const float* v2,
                     int num_tris, int leaf_size, float* node_min,
                     float* node_max, int32_t* node_left, int32_t* node_start,
                     int32_t* node_count, int32_t* order) {
    BuildCtx c;
    c.v0 = v0;
    c.v1 = v1;
    c.v2 = v2;
    c.order = order;
    c.nmin = node_min;
    c.nmax = node_max;
    c.nleft = node_left;
    c.nstart = node_start;
    c.ncount = node_count;
    c.cap = 2 * std::max(num_tris, 1);
    c.leaf_size = leaf_size > 0 ? leaf_size : kLeafSize;
    c.cent.resize(num_tris);
    c.tmin.resize(num_tris);
    c.tmax.resize(num_tris);
    for (int i = 0; i < num_tris; ++i) {
        V3 a{v0[i * 3], v0[i * 3 + 1], v0[i * 3 + 2]};
        V3 b{v1[i * 3], v1[i * 3 + 1], v1[i * 3 + 2]};
        V3 d{v2[i * 3], v2[i * 3 + 1], v2[i * 3 + 2]};
        c.tmin[i] = a.min(b).min(d);
        c.tmax[i] = a.max(b).max(d);
        c.cent[i] = {(a.x + b.x + d.x) / 3.f, (a.y + b.y + d.y) / 3.f,
                     (a.z + b.z + d.z) / 3.f};
        order[i] = i;
    }
    c.n_nodes = 1;
    build_range(c, 0, 0, num_tris);
    return c.n_nodes;
}

// ---------------------------------------------------------------------------
// BVH8 packed-row collapse (the layout of raytracing/bvh8.py:
// ROW=72 floats; internal: 8xAABB SoA + child ids + flag; leaf: 7 triangles
// in Moller-Trumbore form + ids + flag).
// ---------------------------------------------------------------------------

namespace {

constexpr int kRow = 72;
constexpr int kIMin = 0, kIMax = 24, kIChild = 48, kFlag = 71;
constexpr int kLV0 = 0, kLE1 = 21, kLE2 = 42, kLId = 63;

struct Collapse {
    const float *nmin, *nmax;
    const int32_t *nleft, *nstart, *ncount;
    const float *v0, *v1, *v2;  // ORIGINAL (unordered) triangle arrays
    const int32_t* order;
    std::vector<float> rows;
    int n_rows = 0;

    int new_row() {
        rows.resize(rows.size() + kRow, 0.f);
        return n_rows++;
    }

    void pack_leaf(int row_id, int start, int count) {
        float* row = &rows[(size_t)row_id * kRow];
        int32_t ids[7];
        for (int k = 0; k < 7; ++k) ids[k] = -1;
        for (int k = 0; k < count && k < 7; ++k) {
            int t = order[start + k];
            const float* a = &v0[t * 3];
            const float* b = &v1[t * 3];
            const float* d = &v2[t * 3];
            row[kLV0 + k] = a[0];
            row[kLV0 + 7 + k] = a[1];
            row[kLV0 + 14 + k] = a[2];
            row[kLE1 + k] = b[0] - a[0];
            row[kLE1 + 7 + k] = b[1] - a[1];
            row[kLE1 + 14 + k] = b[2] - a[2];
            row[kLE2 + k] = d[0] - a[0];
            row[kLE2 + 7 + k] = d[1] - a[1];
            row[kLE2 + 14 + k] = d[2] - a[2];
            ids[k] = t;
        }
        std::memcpy(&row[kLId], ids, sizeof(ids));
        row[kFlag] = 1.0f;
    }

    float area_of(int n) const {
        V3 lo{nmin[n * 3], nmin[n * 3 + 1], nmin[n * 3 + 2]};
        V3 hi{nmax[n * 3], nmax[n * 3 + 1], nmax[n * 3 + 2]};
        return half_area(lo, hi);
    }

    void gather_children(int node, int* slots, int* n_slots) {
        slots[0] = node;
        *n_slots = 1;
        for (;;) {
            int best = -1;
            float best_area = -1.f;
            for (int i = 0; i < *n_slots; ++i) {
                int s = slots[i];
                if (ncount[s] == 0 && area_of(s) > best_area) {
                    best = i;
                    best_area = area_of(s);
                }
            }
            if (best < 0 || *n_slots + 1 > 8) break;
            int s = slots[best];
            slots[best] = nleft[s];
            slots[(*n_slots)++] = nleft[s] + 1;
        }
    }

    void fill(int row_id, int node) {
        if (ncount[node] > 0) {
            pack_leaf(row_id, nstart[node], ncount[node]);
            return;
        }
        int slots[8], n_slots;
        gather_children(node, slots, &n_slots);
        int child_rows[8];
        for (int k = 0; k < n_slots; ++k) child_rows[k] = new_row();
        int32_t child_ids[8];
        for (int k = 0; k < 8; ++k) child_ids[k] = -1;
        float* row = &rows[(size_t)row_id * kRow];
        for (int k = 0; k < n_slots; ++k) {
            fill(child_rows[k], slots[k]);
            row = &rows[(size_t)row_id * kRow];  // rows may have reallocated
            child_ids[k] = child_rows[k];
            int s = slots[k];
            row[kIMin + k] = nmin[s * 3];
            row[kIMin + 8 + k] = nmin[s * 3 + 1];
            row[kIMin + 16 + k] = nmin[s * 3 + 2];
            row[kIMax + k] = nmax[s * 3];
            row[kIMax + 8 + k] = nmax[s * 3 + 1];
            row[kIMax + 16 + k] = nmax[s * 3 + 2];
        }
        for (int k = n_slots; k < 8; ++k) {
            row[kIMin + k] = 1.f;
            row[kIMin + 8 + k] = 1.f;
            row[kIMin + 16 + k] = 1.f;
            row[kIMax + k] = -1.f;
            row[kIMax + 8 + k] = -1.f;
            row[kIMax + 16 + k] = -1.f;
        }
        std::memcpy(&row[kIChild], child_ids, sizeof(child_ids));
        row[kFlag] = 0.0f;
    }
};

}  // namespace

// Builds the packed 8-wide table directly from a triangle soup. Writes up to
// max_rows rows into `table` (kRow floats each); returns the row count, or
// -needed if max_rows was too small.
int sailor_torch_bvh8_build(const float* v0, const float* v1, const float* v2,
                      int num_tris, float* table, int max_rows) {
    int cap = 2 * std::max(num_tris, 1);
    std::vector<float> nmin(cap * 3), nmax(cap * 3);
    std::vector<int32_t> nleft(cap), nstart(cap), ncount(cap), order(std::max(num_tris, 1));
    sailor_torch_bvh_build(v0, v1, v2, num_tris, kLeafSize, nmin.data(), nmax.data(),
                     nleft.data(), nstart.data(), ncount.data(), order.data());
    Collapse c;
    c.nmin = nmin.data();
    c.nmax = nmax.data();
    c.nleft = nleft.data();
    c.nstart = nstart.data();
    c.ncount = ncount.data();
    c.v0 = v0;
    c.v1 = v1;
    c.v2 = v2;
    c.order = order.data();
    int root = c.new_row();
    c.fill(root, 0);
    if (c.n_rows > max_rows) return -c.n_rows;
    std::memcpy(table, c.rows.data(), (size_t)c.n_rows * kRow * sizeof(float));
    return c.n_rows;
}

}  // extern "C"

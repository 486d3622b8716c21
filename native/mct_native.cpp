// Native runtime components for mitsuba_customization_tpu.
//
// Counterpart of the reference's C++ core runtime (SURVEY.md
// §2.3: src/core Stream/Bitmap loaders; §2.3 L3: accel build). The JAX/XLA
// side owns all device compute; this library owns the host-side hot paths:
//
//   * mct_read_merl     — MERL .binary reader (33 MB of f64 -> scaled f32),
//                         ~10x the numpy reader on large material sets
//   * mct_build_bvh     — iterative binned-SAH BVH builder emitting the
//                         depth-first skip-link layout consumed by
//                         render/bvh.py (identical array contract)
//   * mct_parse_obj     — Wavefront OBJ triangle parser (two-pass C API)
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this environment).
// Build: native/build.sh  ->  native/libmct_native.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// MERL reader
// ---------------------------------------------------------------------------

// Standard MERL semantics (SURVEY.md §2.1): header int32 dims {90,90,180},
// then double[3*n] channel-major planes; scales 1/1500, 1.15/1500,
// 1.66/1500; negatives (unmeasured) clamp to 0. Output layout matches
// models/merl.py: (th, td, pd, 3) float32.
// Returns 0 on success, negative error codes otherwise.
int mct_read_merl(const char* path, float* out, int n_th, int n_td,
                  int n_pd) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    int32_t dims[3];
    if (fread(dims, sizeof(int32_t), 3, f) != 3) {
        fclose(f);
        return -2;
    }
    if (dims[0] != n_th || dims[1] != n_td || dims[2] != n_pd) {
        fclose(f);
        return -3;
    }
    const size_t n = (size_t)n_th * n_td * n_pd;
    std::vector<double> plane(n);
    const double scales[3] = {1.0 / 1500.0, 1.15 / 1500.0, 1.66 / 1500.0};
    for (int c = 0; c < 3; ++c) {
        if (fread(plane.data(), sizeof(double), n, f) != n) {
            fclose(f);
            return -4;
        }
        const double s = scales[c];
        for (size_t i = 0; i < n; ++i) {
            double v = plane[i] * s;
            out[i * 3 + c] = v > 0.0 ? (float)v : 0.0f;
        }
    }
    fclose(f);
    return 0;
}

// ---------------------------------------------------------------------------
// BVH builder (binned SAH, iterative, skip-link DFS layout)
// ---------------------------------------------------------------------------

namespace {

struct BuildTask {
    int first, count;  // range in the index array
};

inline float surface_area(const float lo[3], const float hi[3]) {
    float e0 = hi[0] - lo[0], e1 = hi[1] - lo[1], e2 = hi[2] - lo[2];
    if (e0 < 0 || e1 < 0 || e2 < 0) return 0.f;
    return 2.f * (e0 * e1 + e1 * e2 + e0 * e2);
}

}  // namespace

// bb_min/bb_max: (n_prims, 3) row-major. Outputs sized for 2*n_prims nodes
// (a safe upper bound for leaf_size >= 1 trees... we emit leaves of up to
// leaf_size prims, so node count <= 2*ceil(n/1) is ample).
// Returns number of nodes, or negative on error.
int mct_build_bvh(const float* bb_min, const float* bb_max, int n_prims,
                  int leaf_size, int n_bins, float* nodes_min,
                  float* nodes_max, int32_t* skip, int32_t* leaf_prims,
                  int max_nodes) {
    if (n_prims <= 0 || leaf_size < 1) return -1;
    std::vector<int> order(n_prims);
    for (int i = 0; i < n_prims; ++i) order[i] = i;
    std::vector<float> centroid(3 * (size_t)n_prims);
    for (int i = 0; i < n_prims; ++i)
        for (int k = 0; k < 3; ++k)
            centroid[3 * (size_t)i + k] =
                0.5f * (bb_min[3 * (size_t)i + k] + bb_max[3 * (size_t)i + k]);

    // Emit nodes in DFS order (left subtree immediately after its
    // parent): push right, then left, so left pops first. Skip links are
    // recomputed from the DFS structure in a final pass.
    int n_nodes = 0;
    std::vector<BuildTask> stack;
    stack.push_back({0, n_prims});
    while (!stack.empty()) {
        BuildTask task = stack.back();
        stack.pop_back();
        if (n_nodes >= max_nodes) return -2;
        const int node = n_nodes++;

        // node bounds
        float lo[3] = {1e30f, 1e30f, 1e30f};
        float hi[3] = {-1e30f, -1e30f, -1e30f};
        for (int i = 0; i < task.count; ++i) {
            const int p = order[task.first + i];
            for (int k = 0; k < 3; ++k) {
                lo[k] = std::min(lo[k], bb_min[3 * (size_t)p + k]);
                hi[k] = std::max(hi[k], bb_max[3 * (size_t)p + k]);
            }
        }
        std::memcpy(nodes_min + 3 * (size_t)node, lo, sizeof lo);
        std::memcpy(nodes_max + 3 * (size_t)node, hi, sizeof hi);
        skip[node] = n_nodes;  // placeholder; final pass recomputes
        for (int s = 0; s < leaf_size; ++s)
            leaf_prims[(size_t)node * leaf_size + s] = -1;

        if (task.count <= leaf_size) {
            for (int i = 0; i < task.count; ++i)
                leaf_prims[(size_t)node * leaf_size + i] =
                    order[task.first + i];
            continue;
        }

        // centroid extent -> split axis
        float clo[3] = {1e30f, 1e30f, 1e30f};
        float chi[3] = {-1e30f, -1e30f, -1e30f};
        for (int i = 0; i < task.count; ++i) {
            const float* c = &centroid[3 * (size_t)order[task.first + i]];
            for (int k = 0; k < 3; ++k) {
                clo[k] = std::min(clo[k], c[k]);
                chi[k] = std::max(chi[k], c[k]);
            }
        }
        int axis = 0;
        float ext = chi[0] - clo[0];
        for (int k = 1; k < 3; ++k)
            if (chi[k] - clo[k] > ext) ext = chi[k] - clo[k], axis = k;

        int mid;
        if (ext <= 1e-12f) {
            mid = task.first + task.count / 2;  // degenerate: median
        } else {
            // binned SAH
            std::vector<int> bin_count(n_bins, 0);
            std::vector<float> bin_lo(3 * (size_t)n_bins, 1e30f);
            std::vector<float> bin_hi(3 * (size_t)n_bins, -1e30f);
            const float inv_ext = (float)n_bins / ext;
            auto bin_of = [&](int p) {
                int b = (int)((centroid[3 * (size_t)p + axis] - clo[axis]) *
                              inv_ext);
                return std::min(b, n_bins - 1);
            };
            for (int i = 0; i < task.count; ++i) {
                const int p = order[task.first + i];
                const int b = bin_of(p);
                bin_count[b]++;
                for (int k = 0; k < 3; ++k) {
                    bin_lo[3 * (size_t)b + k] =
                        std::min(bin_lo[3 * (size_t)b + k],
                                 bb_min[3 * (size_t)p + k]);
                    bin_hi[3 * (size_t)b + k] =
                        std::max(bin_hi[3 * (size_t)b + k],
                                 bb_max[3 * (size_t)p + k]);
                }
            }
            // sweep areas
            std::vector<float> right_area(n_bins, 0.f);
            {
                float rlo[3] = {1e30f, 1e30f, 1e30f};
                float rhi[3] = {-1e30f, -1e30f, -1e30f};
                for (int b = n_bins - 1; b >= 0; --b) {
                    if (bin_count[b]) {
                        for (int k = 0; k < 3; ++k) {
                            rlo[k] = std::min(rlo[k], bin_lo[3 * (size_t)b + k]);
                            rhi[k] = std::max(rhi[k], bin_hi[3 * (size_t)b + k]);
                        }
                    }
                    right_area[b] =
                        bin_count[b] || b < n_bins - 1
                            ? surface_area(rlo, rhi)
                            : 0.f;
                }
            }
            float best_cost = 1e30f;
            int best_split = -1;
            {
                float llo[3] = {1e30f, 1e30f, 1e30f};
                float lhi[3] = {-1e30f, -1e30f, -1e30f};
                int lcount = 0;
                for (int b = 0; b < n_bins - 1; ++b) {
                    if (bin_count[b]) {
                        for (int k = 0; k < 3; ++k) {
                            llo[k] = std::min(llo[k], bin_lo[3 * (size_t)b + k]);
                            lhi[k] = std::max(lhi[k], bin_hi[3 * (size_t)b + k]);
                        }
                        lcount += bin_count[b];
                    }
                    const int rcount = task.count - lcount;
                    if (!lcount || !rcount) continue;
                    const float cost = surface_area(llo, lhi) * lcount +
                                       right_area[b + 1] * rcount;
                    if (cost < best_cost) best_cost = cost, best_split = b;
                }
            }
            if (best_split < 0) {
                mid = task.first + task.count / 2;
                std::nth_element(
                    order.begin() + task.first, order.begin() + mid,
                    order.begin() + task.first + task.count,
                    [&](int a, int b) {
                        return centroid[3 * (size_t)a + axis] <
                               centroid[3 * (size_t)b + axis];
                    });
            } else {
                auto it = std::partition(
                    order.begin() + task.first,
                    order.begin() + task.first + task.count,
                    [&](int p) { return bin_of(p) <= best_split; });
                mid = (int)(it - order.begin());
                if (mid == task.first || mid == task.first + task.count)
                    mid = task.first + task.count / 2;
            }
        }

        stack.push_back({mid, task.first + task.count - mid});  // right
        stack.push_back({task.first, mid - task.first});        // left
    }

    // Skip links from the DFS structure (leaf flags + subtree sizes) —
    // identical algorithm to the numpy builder in render/bvh.py:
    // skip[i] = first node outside i's subtree; a missed internal node
    // skips its whole subtree, a finished leaf continues there.
    {
        std::vector<int> size(n_nodes, 1);
        // subtree sizes via reverse DFS: a node's subtree is itself plus
        // the two following subtrees when internal.
        for (int i = n_nodes - 1; i >= 0; --i) {
            const bool is_leaf = leaf_prims[(size_t)i * leaf_size] >= 0;
            if (!is_leaf) {
                const int left = i + 1;
                const int right = left + size[left];
                size[i] = 1 + size[left] + (right < n_nodes ? size[right] : 0);
            }
        }
        // assign skips iteratively: (node, skip_to) pairs
        std::vector<std::pair<int, int>> st;
        st.push_back({0, n_nodes});
        while (!st.empty()) {
            auto [i, sk] = st.back();
            st.pop_back();
            skip[i] = sk;
            const bool is_leaf = leaf_prims[(size_t)i * leaf_size] >= 0;
            if (!is_leaf) {
                const int left = i + 1;
                const int right = left + size[left];
                st.push_back({left, right});
                if (right < n_nodes) st.push_back({right, sk});
            }
        }
    }
    return n_nodes;
}

// ---------------------------------------------------------------------------
// OBJ parser (triangles; positions + optional normals/uvs, fan-triangulated)
// ---------------------------------------------------------------------------

// Two-pass API. Pass 1 (out_* null): returns counts via pointers.
// Pass 2: fills caller-allocated buffers.
// Corner re-indexing (v/vt/vn welding) is left to the Python layer for
// meshes with split attributes; this fast path handles the common
// "positions + faces" case (f v v v / f v//vn ...) indexing positions only.
int mct_parse_obj(const char* path, float* out_verts, int32_t* out_faces,
                  int32_t* n_verts, int32_t* n_faces) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    const bool counting = (out_verts == nullptr);
    int nv = 0, nf = 0;
    char line[8192];
    while (fgets(line, sizeof line, f)) {
        if (line[0] == 'v' && (line[1] == ' ' || line[1] == '\t')) {
            if (!counting) {
                float x = 0, y = 0, z = 0;
                sscanf(line + 2, "%f %f %f", &x, &y, &z);
                out_verts[3 * (size_t)nv] = x;
                out_verts[3 * (size_t)nv + 1] = y;
                out_verts[3 * (size_t)nv + 2] = z;
            }
            nv++;
        } else if (line[0] == 'f' && (line[1] == ' ' || line[1] == '\t')) {
            // parse up to 64 corners, take position index before any '/'
            int idx[64];
            int cnt = 0;
            char* p = line + 2;
            while (*p && cnt < 64) {
                while (*p == ' ' || *p == '\t') p++;
                if (*p == '\0' || *p == '\n' || *p == '\r') break;
                long v = strtol(p, &p, 10);
                if (v == 0) break;
                idx[cnt++] = (int)(v > 0 ? v - 1 : nv + v);
                while (*p && *p != ' ' && *p != '\t' && *p != '\n') p++;
            }
            for (int i = 1; i + 1 < cnt; ++i) {
                if (!counting) {
                    out_faces[3 * (size_t)nf] = idx[0];
                    out_faces[3 * (size_t)nf + 1] = idx[i];
                    out_faces[3 * (size_t)nf + 2] = idx[i + 1];
                }
                nf++;
            }
        }
    }
    fclose(f);
    *n_verts = nv;
    *n_faces = nf;
    return 0;
}

}  // extern "C"

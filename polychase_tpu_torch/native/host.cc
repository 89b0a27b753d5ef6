// Host C++ of the port: the BVH triangle-mesh ray caster, GFTT's fused
// quality sort + greedy min-distance suppression and its quality order.
//
// The port's own copy of the parts of polychase_tpu/native/bvh.cc that it
// calls (bvh_build, bvh_free, bvh_raycast, gftt_sort_suppress,
// gftt_quality_order), built at
// first use by polychase_tpu_torch/native/__init__.py and loaded with ctypes.
//
// BVH design: binned-SAH (16 bins), max 4 triangles per leaf, iterative
// stack traversal, Möller–Trumbore intersection, closest-hit semantics
// with the reference's masked-triangle rule — the nearest hit is found
// over all triangles and *then* discarded if masked, so masked geometry
// still occludes (cpp/ray_casting.cc:100-120).  Refine's prim refresh takes
// it from polychase_tpu_torch.engine.refiner.BVH_TRIANGLE_THRESHOLD
// triangles.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

struct Vec3 {
    float x, y, z;
    Vec3() : x(0), y(0), z(0) {}
    Vec3(float a, float b, float c) : x(a), y(b), z(c) {}
    Vec3 operator+(const Vec3& o) const { return {x + o.x, y + o.y, z + o.z}; }
    Vec3 operator-(const Vec3& o) const { return {x - o.x, y - o.y, z - o.z}; }
    Vec3 operator*(float s) const { return {x * s, y * s, z * s}; }
};

inline Vec3 cross(const Vec3& a, const Vec3& b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x};
}
inline float dot(const Vec3& a, const Vec3& b) {
    return a.x * b.x + a.y * b.y + a.z * b.z;
}
inline Vec3 vmin(const Vec3& a, const Vec3& b) {
    return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3& a, const Vec3& b) {
    return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct Aabb {
    Vec3 lo{+std::numeric_limits<float>::infinity(),
            +std::numeric_limits<float>::infinity(),
            +std::numeric_limits<float>::infinity()};
    Vec3 hi{-std::numeric_limits<float>::infinity(),
            -std::numeric_limits<float>::infinity(),
            -std::numeric_limits<float>::infinity()};
    void grow(const Vec3& p) { lo = vmin(lo, p); hi = vmax(hi, p); }
    void grow(const Aabb& b) { lo = vmin(lo, b.lo); hi = vmax(hi, b.hi); }
    float area() const {
        Vec3 d = hi - lo;
        if (d.x < 0 || d.y < 0 || d.z < 0) return 0.0f;
        return 2.0f * (d.x * d.y + d.y * d.z + d.z * d.x);
    }
};

struct Node {
    Aabb bounds;
    int32_t left = -1;      // internal: left child (right = left + 1)
    int32_t first = 0;      // leaf: first triangle index
    int32_t count = 0;      // leaf: triangle count (0 → internal)
};

struct Bvh {
    std::vector<Vec3> p1, e1, e2;   // pretransformed triangle data
    std::vector<uint32_t> prim_id;  // BVH order → original triangle id
    std::vector<Node> nodes;
    uint32_t num_tris = 0;
};

struct BuildPrim {
    Aabb bounds;
    Vec3 centroid;
    uint32_t id;
};

constexpr int kBins = 16;
constexpr int kLeafSize = 4;

int build_recursive(Bvh& bvh, std::vector<BuildPrim>& prims, int first,
                    int count) {
    const int node_idx = static_cast<int>(bvh.nodes.size());
    bvh.nodes.emplace_back();

    Aabb bounds, cbounds;
    for (int i = first; i < first + count; i++) {
        bounds.grow(prims[i].bounds);
        cbounds.grow(prims[i].centroid);
    }
    bvh.nodes[node_idx].bounds = bounds;

    if (count <= kLeafSize) {
        bvh.nodes[node_idx].first = first;
        bvh.nodes[node_idx].count = count;
        return node_idx;
    }

    // Binned SAH over the widest centroid axis
    Vec3 ext = cbounds.hi - cbounds.lo;
    int axis = 0;
    if (ext.y > ext.x) axis = 1;
    if (ext.z == std::max({ext.x, ext.y, ext.z})) axis = 2;
    const float lo = (&cbounds.lo.x)[axis];
    const float extent = (&ext.x)[axis];

    int split = -1;
    if (extent > 1e-12f) {
        Aabb bin_bounds[kBins];
        int bin_count[kBins] = {0};
        const float scale = kBins / extent;
        for (int i = first; i < first + count; i++) {
            int b = std::min(
                kBins - 1,
                static_cast<int>(((&prims[i].centroid.x)[axis] - lo) * scale));
            bin_count[b]++;
            bin_bounds[b].grow(prims[i].bounds);
        }
        // Sweep for the best split plane
        float right_area[kBins];
        Aabb acc;
        int total_right = 0;
        for (int b = kBins - 1; b > 0; b--) {
            acc.grow(bin_bounds[b]);
            total_right += bin_count[b];
            right_area[b] = acc.area() * total_right;
        }
        acc = Aabb();
        int left_n = 0;
        float best_cost = std::numeric_limits<float>::infinity();
        for (int b = 0; b < kBins - 1; b++) {
            acc.grow(bin_bounds[b]);
            left_n += bin_count[b];
            if (left_n == 0 || left_n == count) continue;
            const float cost = acc.area() * left_n + right_area[b + 1];
            if (cost < best_cost) {
                best_cost = cost;
                split = b;
            }
        }
        if (split >= 0) {
            const float plane = lo + (split + 1) * (extent / kBins);
            auto mid_it = std::partition(
                prims.begin() + first, prims.begin() + first + count,
                [&](const BuildPrim& p) {
                    return (&p.centroid.x)[axis] < plane;
                });
            int mid = static_cast<int>(mid_it - prims.begin());
            if (mid == first || mid == first + count) split = -1;
            else {
                const int left =
                    build_recursive(bvh, prims, first, mid - first);
                const int right =
                    build_recursive(bvh, prims, mid, first + count - mid);
                (void)right;  // right == left+? not guaranteed; store both
                bvh.nodes[node_idx].left = left;
                bvh.nodes[node_idx].first = right;  // reuse: right child idx
                bvh.nodes[node_idx].count = 0;
                return node_idx;
            }
        }
    }
    // Fallback: median split by index
    if (split < 0) {
        const int mid = first + count / 2;
        std::nth_element(
            prims.begin() + first, prims.begin() + mid,
            prims.begin() + first + count,
            [&](const BuildPrim& a, const BuildPrim& b) {
                return (&a.centroid.x)[axis] < (&b.centroid.x)[axis];
            });
        const int left = build_recursive(bvh, prims, first, count / 2);
        const int right =
            build_recursive(bvh, prims, mid, count - count / 2);
        bvh.nodes[node_idx].left = left;
        bvh.nodes[node_idx].first = right;
        bvh.nodes[node_idx].count = 0;
    }
    return node_idx;
}

inline bool intersect_aabb(const Aabb& b, const Vec3& o, const Vec3& inv_d,
                           float t_max) {
    float tx1 = (b.lo.x - o.x) * inv_d.x, tx2 = (b.hi.x - o.x) * inv_d.x;
    float tmin = std::min(tx1, tx2), tmax = std::max(tx1, tx2);
    float ty1 = (b.lo.y - o.y) * inv_d.y, ty2 = (b.hi.y - o.y) * inv_d.y;
    tmin = std::max(tmin, std::min(ty1, ty2));
    tmax = std::min(tmax, std::max(ty1, ty2));
    float tz1 = (b.lo.z - o.z) * inv_d.z, tz2 = (b.hi.z - o.z) * inv_d.z;
    tmin = std::max(tmin, std::min(tz1, tz2));
    tmax = std::min(tmax, std::max(tz1, tz2));
    return tmax >= std::max(tmin, 0.0f) && tmin < t_max;
}

}  // namespace

extern "C" {

void* bvh_build(const float* vertices, uint32_t num_vertices,
                const uint32_t* triangles, uint32_t num_triangles) {
    (void)num_vertices;
    Bvh* bvh = new Bvh();
    bvh->num_tris = num_triangles;
    if (num_triangles == 0) {
        bvh->nodes.emplace_back();
        return bvh;
    }

    std::vector<BuildPrim> prims(num_triangles);
    bvh->p1.resize(num_triangles);
    bvh->e1.resize(num_triangles);
    bvh->e2.resize(num_triangles);
    std::vector<Vec3> p1_orig(num_triangles), e1_orig(num_triangles),
        e2_orig(num_triangles);
    for (uint32_t i = 0; i < num_triangles; i++) {
        const uint32_t* t = triangles + 3 * i;
        const Vec3 a{vertices[3 * t[0]], vertices[3 * t[0] + 1],
                     vertices[3 * t[0] + 2]};
        const Vec3 b{vertices[3 * t[1]], vertices[3 * t[1] + 1],
                     vertices[3 * t[1] + 2]};
        const Vec3 c{vertices[3 * t[2]], vertices[3 * t[2] + 1],
                     vertices[3 * t[2] + 2]};
        p1_orig[i] = a;
        e1_orig[i] = b - a;
        e2_orig[i] = c - a;
        prims[i].bounds.grow(a);
        prims[i].bounds.grow(b);
        prims[i].bounds.grow(c);
        prims[i].centroid = (a + b + c) * (1.0f / 3.0f);
        prims[i].id = i;
    }
    bvh->nodes.reserve(2 * num_triangles);
    build_recursive(*bvh, prims, 0, static_cast<int>(num_triangles));

    // Store triangles in BVH order for cache-friendly leaves
    bvh->prim_id.resize(num_triangles);
    for (uint32_t i = 0; i < num_triangles; i++) {
        bvh->prim_id[i] = prims[i].id;
        bvh->p1[i] = p1_orig[prims[i].id];
        bvh->e1[i] = e1_orig[prims[i].id];
        bvh->e2[i] = e2_orig[prims[i].id];
    }
    return bvh;
}

void bvh_free(void* handle) { delete static_cast<Bvh*>(handle); }

// Cast `n` rays; for each, write hit position/normal/barycentric/t/prim.
// masked: packed u32 bitmask (may be null).  prim_out = 0xFFFFFFFF on miss.
void bvh_raycast(const void* handle, const float* origins, const float* dirs,
                 uint32_t n, const uint32_t* masked, float* pos_out,
                 float* normal_out, float* bary_out, float* t_out,
                 uint32_t* prim_out) {
    const Bvh& bvh = *static_cast<const Bvh*>(handle);
    constexpr uint32_t kInvalid = 0xFFFFFFFFu;
    constexpr float kEps = 1e-10f;

    for (uint32_t r = 0; r < n; r++) {
        const Vec3 o{origins[3 * r], origins[3 * r + 1], origins[3 * r + 2]};
        const Vec3 d{dirs[3 * r], dirs[3 * r + 1], dirs[3 * r + 2]};
        const Vec3 inv_d{1.0f / d.x, 1.0f / d.y, 1.0f / d.z};

        float best_t = std::numeric_limits<float>::infinity();
        float best_u = 0, best_v = 0;
        uint32_t best_local = kInvalid;

        if (!bvh.nodes.empty() && bvh.num_tris) {
            int stack[64];
            int sp = 0;
            stack[sp++] = 0;
            while (sp) {
                const Node& node = bvh.nodes[stack[--sp]];
                if (!intersect_aabb(node.bounds, o, inv_d, best_t)) continue;
                if (node.count) {  // leaf
                    for (int i = node.first; i < node.first + node.count;
                         i++) {
                        const Vec3& p1 = bvh.p1[i];
                        const Vec3& e1 = bvh.e1[i];
                        const Vec3& e2 = bvh.e2[i];
                        const Vec3 pv = cross(d, e2);
                        const float det = dot(e1, pv);
                        if (std::fabs(det) < kEps) continue;
                        const float inv_det = 1.0f / det;
                        const Vec3 s = o - p1;
                        const float u = dot(s, pv) * inv_det;
                        if (u < 0.0f || u > 1.0f) continue;
                        const Vec3 qv = cross(s, e1);
                        const float v = dot(d, qv) * inv_det;
                        if (v < 0.0f || u + v > 1.0f) continue;
                        const float t = dot(e2, qv) * inv_det;
                        if (t > 0.0f && t < best_t) {
                            best_t = t;
                            best_u = u;
                            best_v = v;
                            best_local = static_cast<uint32_t>(i);
                        }
                    }
                } else {
                    stack[sp++] = node.left;
                    stack[sp++] = node.first;  // right child
                }
            }
        }

        uint32_t prim = kInvalid;
        if (best_local != kInvalid) {
            prim = bvh.prim_id[best_local];
            // Masked triangles occlude but do not produce hits
            // (cpp/ray_casting.cc:100-120).
            if (masked && ((masked[prim >> 5] >> (prim & 31)) & 1u)) {
                prim = kInvalid;
            }
        }

        if (prim != kInvalid) {
            const Vec3 p = o + d * best_t;
            Vec3 ng = cross(bvh.e1[best_local], bvh.e2[best_local]);
            const float len =
                std::sqrt(std::max(dot(ng, ng), 1e-30f));
            ng = ng * (1.0f / len);
            pos_out[3 * r] = p.x;
            pos_out[3 * r + 1] = p.y;
            pos_out[3 * r + 2] = p.z;
            normal_out[3 * r] = ng.x;
            normal_out[3 * r + 1] = ng.y;
            normal_out[3 * r + 2] = ng.z;
            bary_out[2 * r] = best_u;
            bary_out[2 * r + 1] = best_v;
            t_out[r] = best_t;
            prim_out[r] = prim;
        } else {
            std::memset(pos_out + 3 * r, 0, 3 * sizeof(float));
            std::memset(normal_out + 3 * r, 0, 3 * sizeof(float));
            bary_out[2 * r] = bary_out[2 * r + 1] = 0.0f;
            t_out[r] = std::numeric_limits<float>::infinity();
            prim_out[r] = kInvalid;
        }
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Fused quality sort + greedy suppression for GFTT candidates.
//
// The Python path (engine/gftt.py::_sort_suppress_numpy: np.lexsort
// followed by a grid pass) spends ~10 ms/frame at 16k candidates on a
// 1-core host; here one std::sort plus a flat fixed-capacity grid does
// the same work in <1 ms.
// Candidates are integer pixel positions given as linear indices
// (lin = y * width + x); ordering matches the reference's deterministic
// sort exactly: quality descending, ties broken by LATER row-major
// position first (cpp/feature_detection/gftt.cc:7-12, the pointer-address
// tie-break).  Accepted original-candidate indices are written to
// accepted_out in acceptance (quality-desc) order.
//
// Grid capacity: any d x d cell holds at most 4 points that are pairwise
// >= d apart (split the cell into quadrants; a quadrant's diagonal is
// < d for every d >= 1 with cell = round(d)), so kCap = 6 never
// overflows; the guard falls back to rejecting the candidate against an
// overflow list to stay exact regardless.
// ---------------------------------------------------------------------------

// Totally-ordered sortable encoding of an IEEE float (sign-magnitude to
// biased-unsigned): preserves < exactly for every non-NaN value.
static inline uint32_t float_key(float v) {
    if (v == 0.0f) v = 0.0f;  // collapse -0.0 to +0.0 (compare equal)
    uint32_t b;
    std::memcpy(&b, &v, sizeof(b));
    return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// Keyed candidate: one 8-byte comparison gives (quality desc, row-major
// position desc) when sorted descending — an indirect two-array
// comparator costs ~3x more wall time at 16k candidates.
struct KeyedIdx {
    uint64_t key;
    uint32_t idx;
};

static void quality_sort(const float* vals, const int64_t* lin, uint32_t n,
                         std::vector<KeyedIdx>& keyed) {
    keyed.resize(n);
    for (uint32_t i = 0; i < n; i++) {
        // lin fits 32 bits for any real frame (2^31 pixels); clamp
        // defensively so huge synthetic inputs stay ordered by quality.
        const uint64_t l = static_cast<uint64_t>(
            lin[i] < 0 ? 0 : (lin[i] > 0x7FFFFFFFll ? 0x7FFFFFFFll
                                                    : lin[i]));
        keyed[i].key = (static_cast<uint64_t>(float_key(vals[i])) << 32) | l;
        keyed[i].idx = i;
    }
    std::sort(keyed.begin(), keyed.end(),
              [](const KeyedIdx& a, const KeyedIdx& b) {
                  return a.key > b.key;
              });
}

extern "C" uint32_t gftt_sort_suppress(
    const float* vals, const int64_t* lin, uint32_t n, int32_t width,
    int32_t height, float min_distance, int32_t max_corners,
    uint32_t* accepted_out) {
    if (n == 0) return 0;

    std::vector<KeyedIdx> keyed;
    quality_sort(vals, lin, n, keyed);

    if (min_distance < 1.0f) {
        uint32_t count = n;
        if (max_corners > 0 && static_cast<uint32_t>(max_corners) < count)
            count = static_cast<uint32_t>(max_corners);
        for (uint32_t oi = 0; oi < count; oi++)
            accepted_out[oi] = keyed[oi].idx;
        return count;
    }

    const int cell = static_cast<int>(min_distance + 0.5f);
    const int gw = (width + cell - 1) / cell;
    const int gh = (height + cell - 1) / cell;
    const float md2 = min_distance * min_distance;

    constexpr int kCap = 6;
    std::vector<float> slots(static_cast<size_t>(gw) * gh * kCap * 2);
    std::vector<uint8_t> counts(static_cast<size_t>(gw) * gh, 0);
    std::vector<std::pair<float, float>> overflow;

    uint32_t count = 0;
    for (uint32_t oi = 0; oi < n; oi++) {
        const uint32_t i = keyed[oi].idx;
        const int64_t l = lin[i];
        const float x = static_cast<float>(l % width);
        const float y = static_cast<float>(l / width);
        const int xc = static_cast<int>(x) / cell;
        const int yc = static_cast<int>(y) / cell;
        const int x1 = std::max(xc - 1, 0);
        const int y1 = std::max(yc - 1, 0);
        const int x2 = std::min(xc + 1, gw - 1);
        const int y2 = std::min(yc + 1, gh - 1);

        bool good = true;
        for (int yy = y1; yy <= y2 && good; yy++) {
            for (int xx = x1; xx <= x2 && good; xx++) {
                const size_t c = static_cast<size_t>(yy) * gw + xx;
                const float* s = &slots[c * kCap * 2];
                const int m = counts[c];
                for (int j = 0; j < m; j++) {
                    const float dx = x - s[2 * j];
                    const float dy = y - s[2 * j + 1];
                    if (dx * dx + dy * dy < md2) {
                        good = false;
                        break;
                    }
                }
            }
        }
        if (good && !overflow.empty()) {
            for (const auto& p : overflow) {
                const float dx = x - p.first;
                const float dy = y - p.second;
                if (dx * dx + dy * dy < md2) {
                    good = false;
                    break;
                }
            }
        }
        if (good) {
            const size_t c = static_cast<size_t>(yc) * gw + xc;
            if (counts[c] < kCap) {
                float* s = &slots[c * kCap * 2];
                s[2 * counts[c]] = x;
                s[2 * counts[c] + 1] = y;
                counts[c]++;
            } else {
                overflow.emplace_back(x, y);
            }
            accepted_out[count++] = i;
            if (max_corners > 0 &&
                static_cast<int32_t>(count) == max_corners) {
                break;
            }
        }
    }
    return count;
}

// Quality-descending order (ties: later row-major position first) without
// the suppression pass: the device-suppressed GFTT route only orders its
// survivors (polychase_tpu/native/bvh.cc:552).
extern "C" void gftt_quality_order(
    const float* vals, const int64_t* lin, uint32_t n, uint32_t* order_out) {
    std::vector<KeyedIdx> keyed;
    quality_sort(vals, lin, n, keyed);
    for (uint32_t i = 0; i < n; i++) order_out[i] = keyed[i].idx;
}

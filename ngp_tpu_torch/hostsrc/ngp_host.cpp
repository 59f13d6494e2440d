// ngp_host — the host-side geometry builders of ngp_tpu_torch, the port's
// own copy of native/ngp_host.cpp.
//
// The reference keeps its acceleration-structure builders in native code
// (TriangleBvh4's CPU build, src/triangle_bvh.cu:541; the triangle octree
// refinement, triangle_octree.cuh:46-382). This library builds them in C++
// with the same algorithms and order as the numpy builders of
// ngp_tpu_torch/geometry/ (triangle_bvh.build_bvh_arrays,
// triangle_octree.TriangleOctree.build), so that both give the same arrays.
// Work is split over threads; the output does not depend on the split.
// Against native/ngp_host.cpp, the two builds take the number of threads
// (0: one a hardware thread), so that a test can vary the split.
//
// Built by ngp_tpu_torch/ops/host_build.py with g++ at first use and
// called through a plain C ABI with ctypes. Handle-based two-phase API:
// build → query sizes → copy out → free.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <numeric>
#include <thread>
#include <vector>

namespace {

// ------------------------------------------------------------------
// Triangle BVH (mirrors ngp_tpu/geometry/triangle_bvh.py::build_bvh)
// ------------------------------------------------------------------

struct BvhHandle {
  std::vector<float> node_min, node_max;   // (M, 3)
  std::vector<int32_t> node_a, node_b;     // (M,)
  std::vector<uint8_t> node_leaf;          // (M,)
  std::vector<float> tris;                 // (Tp, 9) reordered, leaf-padded
  std::vector<float> normals;              // (Tp, 3)
  std::vector<int32_t> tri_index;          // (Tp,)
};

struct BvhBuilder {
  const float* in_tris;  // (T, 9)
  int leaf_size;
  std::vector<float> cent;      // (T, 3) — (a+b+c)/3 in fp32, numpy order
  std::vector<float> tmin, tmax;  // (T, 3)
  BvhHandle* out;

  int new_node() {
    out->node_min.insert(out->node_min.end(), 3, 0.f);
    out->node_max.insert(out->node_max.end(), 3, 0.f);
    out->node_a.push_back(0);
    out->node_b.push_back(0);
    out->node_leaf.push_back(0);
    return (int)out->node_leaf.size() - 1;
  }

  int build(std::vector<int64_t>& ids) {
    int ni = new_node();
    float bmin[3] = {1e30f, 1e30f, 1e30f}, bmax[3] = {-1e30f, -1e30f, -1e30f};
    for (int64_t id : ids)
      for (int a = 0; a < 3; ++a) {
        bmin[a] = std::min(bmin[a], tmin[id * 3 + a]);
        bmax[a] = std::max(bmax[a], tmax[id * 3 + a]);
      }
    std::memcpy(&out->node_min[ni * 3], bmin, 12);
    std::memcpy(&out->node_max[ni * 3], bmax, 12);

    if ((int)ids.size() <= leaf_size) {
      int64_t start = (int64_t)(out->tri_index.size());
      for (int64_t id : ids) {
        const float* t = in_tris + id * 9;
        out->tris.insert(out->tris.end(), t, t + 9);
        out->tri_index.push_back((int32_t)id);
      }
      for (int p = (int)ids.size(); p < leaf_size; ++p) {
        out->tris.insert(out->tris.end(), 9, 1e10f);
        out->tri_index.push_back(-1);
      }
      out->node_leaf[ni] = 1;
      out->node_a[ni] = (int32_t)start;
      return ni;
    }

    // longest centroid-extent axis; ties -> first (numpy argmax)
    float cmin[3] = {1e30f, 1e30f, 1e30f}, cmax[3] = {-1e30f, -1e30f, -1e30f};
    for (int64_t id : ids)
      for (int a = 0; a < 3; ++a) {
        cmin[a] = std::min(cmin[a], cent[id * 3 + a]);
        cmax[a] = std::max(cmax[a], cent[id * 3 + a]);
      }
    int axis = 0;
    float best = cmax[0] - cmin[0];
    for (int a = 1; a < 3; ++a) {
      float e = cmax[a] - cmin[a];
      if (e > best) { best = e; axis = a; }
    }
    std::stable_sort(ids.begin(), ids.end(), [&](int64_t x, int64_t y) {
      return cent[x * 3 + axis] < cent[y * 3 + axis];
    });
    size_t half = ids.size() / 2;
    std::vector<int64_t> left_ids(ids.begin(), ids.begin() + half);
    std::vector<int64_t> right_ids(ids.begin() + half, ids.end());
    ids.clear();
    ids.shrink_to_fit();
    int left = build(left_ids);
    int right = build(right_ids);
    out->node_a[ni] = left;
    out->node_b[ni] = right;
    return ni;
  }
};

// ------------------------------------------------------------------
// Triangle octree (mirrors geometry/triangle_octree.py::TriangleOctree.build)
// ------------------------------------------------------------------

struct OctreeHandle {
  int max_depth = 0;
  std::vector<std::vector<int32_t>> codes;          // per depth, sorted
  std::vector<std::vector<int32_t>> verts;          // per depth, (n, 8)
  int64_t n_vertices = 0;
};

// Akenine-Möller triangle/AABB SAT in double, matching the numpy test.
bool tri_box_overlap(const double c[3], double half, const double tri[9]) {
  double v[3][3], e[3][3];
  for (int i = 0; i < 3; ++i)
    for (int a = 0; a < 3; ++a) v[i][a] = tri[i * 3 + a] - c[a];
  for (int i = 0; i < 3; ++i)
    for (int a = 0; a < 3; ++a) e[i][a] = v[(i + 1) % 3][a] - v[i][a];

  for (int a = 0; a < 3; ++a) {
    double mn = std::min({v[0][a], v[1][a], v[2][a]});
    double mx = std::max({v[0][a], v[1][a], v[2][a]});
    if (mn > half || mx < -half) return false;
  }
  double n[3] = {e[0][1] * e[1][2] - e[0][2] * e[1][1],
                 e[0][2] * e[1][0] - e[0][0] * e[1][2],
                 e[0][0] * e[1][1] - e[0][1] * e[1][0]};
  double d = n[0] * v[0][0] + n[1] * v[0][1] + n[2] * v[0][2];
  double r = half * (std::fabs(n[0]) + std::fabs(n[1]) + std::fabs(n[2]));
  if (std::fabs(d) > r) return false;

  for (int i = 0; i < 3; ++i) {
    double ex = e[i][0], ey = e[i][1], ez = e[i][2];
    double fex = std::fabs(ex), fey = std::fabs(ey), fez = std::fabs(ez);
    // axis (0, -ez, ey)
    {
      double p0 = -ez * v[0][1] + ey * v[0][2];
      double p1 = -ez * v[1][1] + ey * v[1][2];
      double p2 = -ez * v[2][1] + ey * v[2][2];
      double rad = half * (fez + fey);
      if (std::min({p0, p1, p2}) > rad || std::max({p0, p1, p2}) < -rad)
        return false;
    }
    // axis (ez, 0, -ex)
    {
      double p0 = ez * v[0][0] - ex * v[0][2];
      double p1 = ez * v[1][0] - ex * v[1][2];
      double p2 = ez * v[2][0] - ex * v[2][2];
      double rad = half * (fez + fex);
      if (std::min({p0, p1, p2}) > rad || std::max({p0, p1, p2}) < -rad)
        return false;
    }
    // axis (-ey, ex, 0)
    {
      double p0 = -ey * v[0][0] + ex * v[0][1];
      double p1 = -ey * v[1][0] + ex * v[1][1];
      double p2 = -ey * v[2][0] + ex * v[2][1];
      double rad = half * (fey + fex);
      if (std::min({p0, p1, p2}) > rad || std::max({p0, p1, p2}) < -rad)
        return false;
    }
  }
  return true;
}

// threads a build may use: ``requested`` where positive, else one a
// hardware thread
int64_t thread_budget(int requested) {
  if (requested > 0) return requested;
  return std::max(1u, std::thread::hardware_concurrency());
}

void parallel_for(int64_t n, int64_t budget,
                  const std::function<void(int64_t, int64_t)>& fn) {
  int64_t n_threads = std::min<int64_t>(budget, std::max<int64_t>(1, n / 1024));
  if (n_threads <= 1) { fn(0, n); return; }
  std::vector<std::thread> ts;
  int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int64_t t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back(fn, lo, hi);
  }
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// ---------------- BVH ----------------

void* ngp_bvh_build(const float* tris, int64_t T, int leaf_size, int n_threads) {
  int64_t budget = thread_budget(n_threads);
  auto* h = new BvhHandle();
  BvhBuilder b;
  b.in_tris = tris;
  b.leaf_size = leaf_size;
  b.out = h;
  b.cent.resize(T * 3);
  b.tmin.resize(T * 3);
  b.tmax.resize(T * 3);
  parallel_for(T, budget, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i)
      for (int a = 0; a < 3; ++a) {
        float x0 = tris[i * 9 + 0 + a], x1 = tris[i * 9 + 3 + a],
              x2 = tris[i * 9 + 6 + a];
        b.cent[i * 3 + a] = (x0 + x1 + x2) / 3.0f;
        b.tmin[i * 3 + a] = std::min({x0, x1, x2});
        b.tmax[i * 3 + a] = std::max({x0, x1, x2});
      }
  });
  std::vector<int64_t> ids(T);
  std::iota(ids.begin(), ids.end(), 0);
  b.build(ids);
  // leaf-padded normals (padding rows are degenerate FAR triangles; their
  // cross product is 0 -> normalized against the 1e-12 floor like numpy)
  int64_t Tp = (int64_t)h->tri_index.size();
  h->normals.resize(Tp * 3);
  parallel_for(Tp, budget, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const float* t = &h->tris[i * 9];
      float u[3] = {t[3] - t[0], t[4] - t[1], t[5] - t[2]};
      float w[3] = {t[6] - t[0], t[7] - t[1], t[8] - t[2]};
      float n[3] = {u[1] * w[2] - u[2] * w[1], u[2] * w[0] - u[0] * w[2],
                    u[0] * w[1] - u[1] * w[0]};
      float len = std::sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
      len = std::max(len, 1e-12f);
      for (int a = 0; a < 3; ++a) h->normals[i * 3 + a] = n[a] / len;
    }
  });
  return h;
}

int64_t ngp_bvh_n_nodes(void* hp) {
  return (int64_t)((BvhHandle*)hp)->node_leaf.size();
}
int64_t ngp_bvh_n_padded(void* hp) {
  return (int64_t)((BvhHandle*)hp)->tri_index.size();
}
void ngp_bvh_copy(void* hp, float* node_min, float* node_max, int32_t* node_a,
                  int32_t* node_b, uint8_t* node_leaf, float* tris,
                  float* normals, int32_t* tri_index) {
  auto* h = (BvhHandle*)hp;
  std::memcpy(node_min, h->node_min.data(), h->node_min.size() * 4);
  std::memcpy(node_max, h->node_max.data(), h->node_max.size() * 4);
  std::memcpy(node_a, h->node_a.data(), h->node_a.size() * 4);
  std::memcpy(node_b, h->node_b.data(), h->node_b.size() * 4);
  std::memcpy(node_leaf, h->node_leaf.data(), h->node_leaf.size());
  std::memcpy(tris, h->tris.data(), h->tris.size() * 4);
  std::memcpy(normals, h->normals.data(), h->normals.size() * 4);
  std::memcpy(tri_index, h->tri_index.data(), h->tri_index.size() * 4);
}
void ngp_bvh_free(void* hp) { delete (BvhHandle*)hp; }

// ---------------- Triangle octree ----------------

void* ngp_octree_build(const double* tris, int64_t T, int max_depth,
                       int n_threads) {
  int64_t budget = thread_budget(n_threads);
  auto* h = new OctreeHandle();
  h->max_depth = max_depth;
  h->codes.resize(max_depth);
  h->codes[0] = {0};  // root

  std::vector<double> tmin(T * 3), tmax(T * 3);
  parallel_for(T, budget, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i)
      for (int a = 0; a < 3; ++a) {
        double x0 = tris[i * 9 + 0 + a], x1 = tris[i * 9 + 3 + a],
               x2 = tris[i * 9 + 6 + a];
        tmin[i * 3 + a] = std::min({x0, x1, x2});
        tmax[i * 3 + a] = std::max({x0, x1, x2});
      }
  });

  for (int d = 1; d < max_depth; ++d) {
    int64_t R = 1ll << d;
    double size = 1.0 / (double)R;
    const auto& pc = h->codes[d - 1];

    int nthreads = (int)std::min<int64_t>(budget, std::max<int64_t>(1, T / 256));
    std::vector<std::vector<int64_t>> partial(nthreads);
    std::vector<std::thread> ts;
    int64_t chunk = (T + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; ++t) {
      int64_t lo = t * chunk, hi = std::min<int64_t>(T, lo + chunk);
      if (lo >= hi) break;
      ts.emplace_back([&, t, lo, hi]() {
        auto& mine = partial[t];
        for (int64_t i = lo; i < hi; ++i) {
          int64_t vlo[3], vhi[3];
          for (int a = 0; a < 3; ++a) {
            vlo[a] = std::clamp(
                (int64_t)std::floor(tmin[i * 3 + a] / size), (int64_t)0, R - 1);
            vhi[a] = std::clamp(
                (int64_t)std::floor(tmax[i * 3 + a] / size), (int64_t)0, R - 1);
          }
          for (int64_t z = vlo[2]; z <= vhi[2]; ++z)
            for (int64_t y = vlo[1]; y <= vhi[1]; ++y)
              for (int64_t x = vlo[0]; x <= vhi[0]; ++x) {
                int64_t parent = (x >> 1) + ((y >> 1) << (d - 1)) +
                                 ((z >> 1) << (2 * (d - 1)));
                if (!std::binary_search(pc.begin(), pc.end(),
                                        (int32_t)parent))
                  continue;
                double c[3] = {(x + 0.5) * size, (y + 0.5) * size,
                               (z + 0.5) * size};
                if (tri_box_overlap(c, 0.5 * size, tris + i * 9))
                  mine.push_back(x + (y << d) + (z << (2 * d)));
              }
        }
      });
    }
    for (auto& t : ts) t.join();
    std::vector<int64_t> all;
    for (auto& p : partial) {
      all.insert(all.end(), p.begin(), p.end());
      p.clear();
    }
    std::sort(all.begin(), all.end());
    all.erase(std::unique(all.begin(), all.end()), all.end());
    h->codes[d].assign(all.begin(), all.end());
  }

  // dual vertices: dedup (corner key) per depth; level-major global ids
  h->verts.resize(max_depth);
  for (int d = 0; d < max_depth; ++d) {
    int64_t R = 1ll << d;
    const auto& codes = h->codes[d];
    int64_t n = (int64_t)codes.size();
    std::vector<int64_t> keys(n * 8);
    for (int64_t i = 0; i < n; ++i) {
      int64_t c = codes[i];
      int64_t x = c & (R - 1), y = (c >> d) & (R - 1), z = c >> (2 * d);
      for (int k = 0; k < 8; ++k) {
        int64_t cx = x + (k & 1), cy = y + ((k >> 1) & 1), cz = z + ((k >> 2) & 1);
        keys[i * 8 + k] = cx + cy * (R + 1) + cz * (R + 1) * (R + 1);
      }
    }
    std::vector<int64_t> uniq(keys);
    std::sort(uniq.begin(), uniq.end());
    uniq.erase(std::unique(uniq.begin(), uniq.end()), uniq.end());
    auto& v = h->verts[d];
    v.resize(n * 8);
    parallel_for(n * 8, budget, [&](int64_t lo, int64_t hi) {
      for (int64_t i = lo; i < hi; ++i) {
        int64_t j =
            std::lower_bound(uniq.begin(), uniq.end(), keys[i]) - uniq.begin();
        v[i] = (int32_t)(j + h->n_vertices);
      }
    });
    h->n_vertices += (int64_t)uniq.size();
  }
  return h;
}

int64_t ngp_octree_level_size(void* hp, int d) {
  return (int64_t)((OctreeHandle*)hp)->codes[d].size();
}
void ngp_octree_copy_level(void* hp, int d, int32_t* codes, int32_t* verts) {
  auto* h = (OctreeHandle*)hp;
  std::memcpy(codes, h->codes[d].data(), h->codes[d].size() * 4);
  std::memcpy(verts, h->verts[d].data(), h->verts[d].size() * 4);
}
int64_t ngp_octree_n_vertices(void* hp) {
  return ((OctreeHandle*)hp)->n_vertices;
}
void ngp_octree_free(void* hp) { delete (OctreeHandle*)hp; }

// ---------------- chessboard distance transform ----------------
// Exact L-inf DT via two chamfer sweeps over the 26-neighborhood.
void ngp_chessboard_dt(const uint8_t* occ, int G, int32_t* out) {
  const int32_t INF = 3 * G;
  int64_t n = (int64_t)G * G * G;
  for (int64_t i = 0; i < n; ++i) out[i] = occ[i] ? 0 : INF;
  auto at = [&](int z, int y, int x) -> int32_t& {
    return out[((int64_t)z * G + y) * G + x];
  };
  // forward: neighbors with (dz,dy,dx) lexicographically before (0,0,0)
  for (int z = 0; z < G; ++z)
    for (int y = 0; y < G; ++y)
      for (int x = 0; x < G; ++x) {
        int32_t best = at(z, y, x);
        for (int dz = -1; dz <= 0; ++dz)
          for (int dy = -1; dy <= 1; ++dy)
            for (int dx = -1; dx <= 1; ++dx) {
              if (dz == 0 && (dy > 0 || (dy == 0 && dx >= 0))) continue;
              int zz = z + dz, yy = y + dy, xx = x + dx;
              if (zz < 0 || yy < 0 || yy >= G || xx < 0 || xx >= G) continue;
              best = std::min(best, at(zz, yy, xx) + 1);
            }
        at(z, y, x) = best;
      }
  // backward
  for (int z = G - 1; z >= 0; --z)
    for (int y = G - 1; y >= 0; --y)
      for (int x = G - 1; x >= 0; --x) {
        int32_t best = at(z, y, x);
        for (int dz = 0; dz <= 1; ++dz)
          for (int dy = -1; dy <= 1; ++dy)
            for (int dx = -1; dx <= 1; ++dx) {
              if (dz == 0 && (dy < 0 || (dy == 0 && dx <= 0))) continue;
              int zz = z + dz, yy = y + dy, xx = x + dx;
              if (zz >= G || yy < 0 || yy >= G || xx < 0 || xx >= G) continue;
              best = std::min(best, at(zz, yy, xx) + 1);
            }
        at(z, y, x) = best;
      }
}

}  // extern "C"

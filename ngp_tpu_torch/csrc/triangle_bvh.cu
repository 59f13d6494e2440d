// Triangle-BVH traversal for Hopper (sm_90a): the closest point on a mesh
// and the nearest ray hit, one thread a query.
//
// No TPU kernel is replaced: the JAX package runs these queries as
// lax.while_loop traversals over per-query stacks
// (ngp_tpu/geometry/triangle_bvh.py, closest_point and ray_intersect). These
// kernels compute what those loops compute, query by query:
//
//   closest point: pop a node; a leaf tests its 4 triangles (Ericson's
//     closest point, slot order, a strict '<' against the best squared
//     distance); an internal node pushes its farther child, then its nearer
//     one (left when the two box distances tie), each only if its box's
//     squared distance is strictly below the best. Out: sqrt of the best,
//     the point, the leaf slot.
//   ray hit: pop a node; a leaf tests its 4 triangles (Moller-Trumbore,
//     t > 1e-6, slot order, strict '<' against the best t); an internal
//     node pushes its right child, then its left one, each only if the ray
//     meets its box before the best t. Out: t (inf on a miss), the slot.
//
// The tree (geometry/triangle_bvh.py:build_bvh): node_min/node_max (M, 3)
// float32, node_a (left child, or a leaf's first slot) and node_b (right
// child) (M,) int32, node_leaf (M,) bool (one byte), triangles (Tp, 3, 3)
// float32 in leaf order, each leaf 4 slots, padding slots at 1e10 (their
// squared distances reach ~3e20, finite in float32; nothing divides by
// them). The stack holds 64 node indices; the build refuses a deeper
// tree, and a push past the top overwrites the top, as the JAX loop's
// clamped index does.
//
// Bound on the H100: the work depends on the data. Each query reads its 12
// (or 24) bytes and writes 20 (or 8); the tree's bytes are read by many
// queries, so the DRAM floor is the distinct nodes and leaves the queries
// touch, read once, plus the queries' own bytes; the operation floor is the
// box and triangle tests at the float32 rate. chip_smoke.py counts both from
// the twin's visits (phase sdf_kernels). What sets the pace in practice is
// neither: a thread walks a data-dependent path of dependent loads (node,
// then its children's boxes, then triangles) with divergent control flow
// between the lanes of a warp, and its stack lives in local memory.
//
// Design, simple first: one thread a query, 128 threads a block, the node
// arrays and triangles read through the read-only path (__ldg), the stack in
// a per-thread array. Neighbouring queries (a frame's neighbouring pixels, a
// refresh's samples near one another on the surface) walk similar paths, so
// the warp shares lines in L1/L2. A wider tree (the reference's
// TriangleBvh4), packed nodes and a shorter stack are for a later redesign.
//
// Every dot and cross product is written left to right, ((x + y) + z), and
// this source is compiled with -fmad=false: no product is fused into an
// add, so the plain PyTorch twin in ngp_tpu_torch/ops/bvh.py, which rounds
// each operation, gives the same bits. Divisions and sqrt are IEEE (no
// fast-math flags).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kStackDepth = 64;
constexpr int kLeafSize = 4;
constexpr int kThreads = 128;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 operator*(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ float safe(float x, float eps, float fill) {
  return fabsf(x) > eps ? x : fill;
}
__device__ __forceinline__ float clamp01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

__device__ __forceinline__ V3 load3(const float* p) {
  return {__ldg(p), __ldg(p + 1), __ldg(p + 2)};
}

struct Tree {
  const float* node_min;
  const float* node_max;
  const int* node_a;
  const int* node_b;
  const unsigned char* node_leaf;
  const float* tris;
};

// Ericson's closest point on triangle abc. The JAX function evaluates every
// region and keeps, by a chain of selects, the last whose test holds:
// vertex c over b over a over edge bc over ac over ab over the face. The
// tests here run in that order of precedence.
__device__ V3 closest_on_triangle(V3 p, V3 a, V3 b, V3 c) {
  const V3 ab = b - a, ac = c - a, ap = p - a;
  const float d1 = dot(ab, ap), d2 = dot(ac, ap);
  const V3 bp = p - b;
  const float d3 = dot(ab, bp), d4 = dot(ac, bp);
  const V3 cp = p - c;
  const float d5 = dot(ab, cp), d6 = dot(ac, cp);
  if (d6 >= 0.0f && d5 <= d6) return c;
  if (d3 >= 0.0f && d4 <= d3) return b;
  if (d1 <= 0.0f && d2 <= 0.0f) return a;
  const float va = d3 * d6 - d5 * d4;
  const float vb = d5 * d2 - d1 * d6;
  const float vc = d1 * d4 - d3 * d2;
  const float d43 = d4 - d3, d56 = d5 - d6;
  if (va <= 0.0f && d43 >= 0.0f && d56 >= 0.0f) {
    return b + (c - b) * clamp01(d43 / safe(d43 + d56, 1e-20f, 1.0f));
  }
  if (vb <= 0.0f && d2 >= 0.0f && d6 <= 0.0f) {
    return a + ac * clamp01(d2 / safe(d2 - d6, 1e-20f, 1.0f));
  }
  if (vc <= 0.0f && d1 >= 0.0f && d3 <= 0.0f) {
    return a + ab * clamp01(d1 / safe(d1 - d3, 1e-20f, 1.0f));
  }
  const float denom = safe(va + vb + vc, 1e-20f, 1.0f);
  return a + ab * (vb / denom) + ac * (vc / denom);
}

__device__ __forceinline__ float box_sq_dist(const Tree& t, int node, V3 p) {
  const V3 mn = load3(t.node_min + 3 * node), mx = load3(t.node_max + 3 * node);
  const V3 d = {fmaxf(fmaxf(mn.x - p.x, 0.0f), p.x - mx.x),
                fmaxf(fmaxf(mn.y - p.y, 0.0f), p.y - mx.y),
                fmaxf(fmaxf(mn.z - p.z, 0.0f), p.z - mx.z)};
  return dot(d, d);
}

// Moller-Trumbore: t, or inf on a miss.
__device__ __forceinline__ float ray_triangle(V3 o, V3 d, V3 a, V3 b, V3 c) {
  const V3 e1 = b - a, e2 = c - a;
  const V3 pv = cross(d, e2);
  const float det = dot(e1, pv);
  const float inv = 1.0f / safe(det, 1e-12f, 1.0f);
  const V3 tv = o - a;
  const float u = dot(tv, pv) * inv;
  const V3 qv = cross(tv, e1);
  const float v = dot(d, qv) * inv;
  const float t = dot(e2, qv) * inv;
  const bool hit = fabsf(det) > 1e-12f && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > 1e-6f;
  return hit ? t : CUDART_INF_F;
}

__device__ __forceinline__ bool box_hit(const Tree& t, int node, V3 o, V3 inv_d, float tmax) {
  const V3 mn = load3(t.node_min + 3 * node), mx = load3(t.node_max + 3 * node);
  const float ax = (mn.x - o.x) * inv_d.x, bx = (mx.x - o.x) * inv_d.x;
  const float ay = (mn.y - o.y) * inv_d.y, by = (mx.y - o.y) * inv_d.y;
  const float az = (mn.z - o.z) * inv_d.z, bz = (mx.z - o.z) * inv_d.z;
  const float tn = fmaxf(fmaxf(fminf(ax, bx), fminf(ay, by)), fminf(az, bz));
  const float tf = fminf(fminf(fmaxf(ax, bx), fmaxf(ay, by)), fmaxf(az, bz));
  return tf >= fmaxf(tn, 0.0f) && tn < tmax;
}

__device__ __forceinline__ void push(int* stack, int& sp, int node) {
  stack[sp < kStackDepth - 1 ? sp : kStackDepth - 1] = node;
  sp += 1;
}

__device__ __forceinline__ void tri_at(const Tree& t, int slot, V3& a, V3& b, V3& c) {
  const float* q = t.tris + 9 * static_cast<int64_t>(slot);
  a = load3(q);
  b = load3(q + 3);
  c = load3(q + 6);
}

__global__ void __launch_bounds__(kThreads)
closest_point_kernel(Tree t, const float* __restrict__ points, int64_t n,
                     float* __restrict__ dist, float* __restrict__ cp_out,
                     int* __restrict__ tri_out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const V3 p = {points[3 * i], points[3 * i + 1], points[3 * i + 2]};
  int stack[kStackDepth];
  stack[0] = 0;
  int sp = 1;
  float best_d2 = CUDART_INF_F;
  V3 best_cp = {0.0f, 0.0f, 0.0f};
  int best_tri = -1;
  while (sp > 0) {
    sp -= 1;
    const int node = stack[sp];
    const int a_idx = __ldg(t.node_a + node);
    if (__ldg(t.node_leaf + node)) {
      for (int j = 0; j < kLeafSize; ++j) {
        V3 a, b, c;
        tri_at(t, a_idx + j, a, b, c);
        const V3 cp = closest_on_triangle(p, a, b, c);
        const V3 e = cp - p;
        const float d2 = dot(e, e);
        if (d2 < best_d2) {
          best_d2 = d2;
          best_cp = cp;
          best_tri = a_idx + j;
        }
      }
    } else {
      const int left = a_idx, right = __ldg(t.node_b + node);
      const float dl = box_sq_dist(t, left, p), dr = box_sq_dist(t, right, p);
      const bool left_near = dl <= dr;
      const int near_child = left_near ? left : right;
      const int far_child = left_near ? right : left;
      if (fmaxf(dl, dr) < best_d2) push(stack, sp, far_child);
      if (fminf(dl, dr) < best_d2) push(stack, sp, near_child);
    }
  }
  dist[i] = sqrtf(best_d2);
  cp_out[3 * i] = best_cp.x;
  cp_out[3 * i + 1] = best_cp.y;
  cp_out[3 * i + 2] = best_cp.z;
  tri_out[i] = best_tri;
}

__global__ void __launch_bounds__(kThreads)
ray_intersect_kernel(Tree t, const float* __restrict__ origins,
                     const float* __restrict__ dirs, int64_t n,
                     float* __restrict__ t_out, int* __restrict__ tri_out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const V3 o = {origins[3 * i], origins[3 * i + 1], origins[3 * i + 2]};
  const V3 d = {dirs[3 * i], dirs[3 * i + 1], dirs[3 * i + 2]};
  const V3 inv_d = {1.0f / safe(d.x, 1e-12f, 1e-12f), 1.0f / safe(d.y, 1e-12f, 1e-12f),
                    1.0f / safe(d.z, 1e-12f, 1e-12f)};
  int stack[kStackDepth];
  stack[0] = 0;
  int sp = 1;
  float best_t = CUDART_INF_F;
  int best_tri = -1;
  while (sp > 0) {
    sp -= 1;
    const int node = stack[sp];
    const int a_idx = __ldg(t.node_a + node);
    if (__ldg(t.node_leaf + node)) {
      for (int j = 0; j < kLeafSize; ++j) {
        V3 a, b, c;
        tri_at(t, a_idx + j, a, b, c);
        const float tj = ray_triangle(o, d, a, b, c);
        if (tj < best_t) {
          best_t = tj;
          best_tri = a_idx + j;
        }
      }
    } else {
      const int left = a_idx, right = __ldg(t.node_b + node);
      const bool hl = box_hit(t, left, o, inv_d, best_t);
      const bool hr = box_hit(t, right, o, inv_d, best_t);
      if (hr) push(stack, sp, right);
      if (hl) push(stack, sp, left);
    }
  }
  t_out[i] = best_t;
  tri_out[i] = best_tri;
}

Tree make_tree(const void* node_min, const void* node_max, const void* node_a,
               const void* node_b, const void* node_leaf, const void* tris) {
  return Tree{static_cast<const float*>(node_min), static_cast<const float*>(node_max),
              static_cast<const int*>(node_a), static_cast<const int*>(node_b),
              static_cast<const unsigned char*>(node_leaf), static_cast<const float*>(tris)};
}

unsigned blocks_for(long long n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int bvh_closest_point(const void* node_min, const void* node_max,
                                 const void* node_a, const void* node_b,
                                 const void* node_leaf, const void* tris,
                                 const void* points, long long n, void* dist,
                                 void* cp, void* tri, void* stream) {
  if (n <= 0) return 0;
  closest_point_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      make_tree(node_min, node_max, node_a, node_b, node_leaf, tris),
      static_cast<const float*>(points), static_cast<int64_t>(n), static_cast<float*>(dist),
      static_cast<float*>(cp), static_cast<int*>(tri));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bvh_ray_intersect(const void* node_min, const void* node_max,
                                 const void* node_a, const void* node_b,
                                 const void* node_leaf, const void* tris,
                                 const void* origins, const void* dirs, long long n,
                                 void* t, void* tri, void* stream) {
  if (n <= 0) return 0;
  ray_intersect_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      make_tree(node_min, node_max, node_a, node_b, node_leaf, tris),
      static_cast<const float*>(origins), static_cast<const float*>(dirs),
      static_cast<int64_t>(n), static_cast<float*>(t), static_cast<int*>(tri));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* triangle_bvh_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

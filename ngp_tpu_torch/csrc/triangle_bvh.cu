// Triangle-BVH traversal for Hopper (sm_90a): the closest point on a mesh
// and the nearest ray hit, one thread a query.
//
// No TPU kernel is replaced: the JAX package runs these queries as
// lax.while_loop traversals over per-query stacks
// (ngp_tpu/geometry/triangle_bvh.py, closest_point and ray_intersect). These
// kernels compute what those loops compute, query by query, bit for bit:
//
//   closest point: pop a node; a leaf tests its triangles (Ericson's
//     closest point, slot order, a strict '<' against the best squared
//     distance); an internal node pushes its farther child, then its nearer
//     one (left when the two box distances tie), each only if its box's
//     squared distance is strictly below the best. Out: sqrt of the best,
//     the point, the leaf slot.
//   ray hit: pop a node; a leaf tests its triangles (Moller-Trumbore,
//     t > 1e-6, slot order, strict '<' against the best t); an internal
//     node pushes its right child, then its left one, each only if the ray
//     meets its box before the best t. Out: t (inf on a miss), the slot.
//
// What must not change, so that the outputs stay the loop's bits:
//   - each query visits the loop's nodes in the loop's order: the initial
//     best is +inf; the push tests use the best at the parent; a popped
//     node is processed without a second test; leaf slots are taken in
//     order with a strict '<';
//   - no pruning the loop does not make: no re-test at pop, no tighter
//     first bound, no other child order, no wider tree (a rounded closest
//     point can land a few ulps outside its leaf's box, so such a cull can
//     drop the triangle the loop keeps);
//   - every dot and cross product is written left to right, ((x + y) + z),
//     and this source is compiled with -fmad=false: no product is fused
//     into an add, so the plain PyTorch twin in ngp_tpu_torch/ops/bvh.py,
//     which rounds each operation, gives the same bits. Divisions and sqrt
//     are IEEE (no fast-math flags).
//
// The tree (geometry/triangle_bvh.py): `records`, one 64-byte record an
// internal node, numbered level by level from the root (pack_bvh_records):
// both children's boxes (12 floats) and both children's references (an
// internal child's record number, or ~(leaf << 3 | real) for a leaf whose
// 4 slots start at 4 * leaf and whose first `real` slots hold triangles);
// `tris` (Tp, 3, 3) float32 in leaf order, padding slots at 1e10.
//
// Bound on the H100: the work depends on the data. The DRAM floor is the
// distinct records and leaves the queries touch, read once, plus the
// queries' own bytes; the operation floor is the box and real-triangle
// tests at the float32 rate (chip_smoke.py counts both from the twin's
// visits, phase sdf_kernels). Neither sets the pace. A refresh's 2^17
// closest-point queries fit on the card at once, and a query near the
// middle of the closed mesh prunes little (2,500 nodes against a mean of
// 115), so the launch lasts as long as that one query's chain of dependent
// node reads; the ray kernel's half-million rays run in many waves, where
// the instructions and bytes of each node count as well.
//
// Design, each step aimed at the cost of one iteration:
//   - a packed record: an internal node costs one round of four 16-byte
//     read-only loads (both children's boxes and references together),
//     where the arrays' layout cost three dependent rounds of scalar loads;
//   - one fetch an iteration for either kind of node, before the branch:
//     the lanes of a warp at internal nodes and those at leaves wait for
//     one round of loads, not one after the other;
//   - the next node in a register: the child the loop would pop next (the
//     near one; the left one for a ray) is taken directly and only the other
//     is pushed, the loop's "push both, pop" with half the stack traffic;
//   - the stack in shared memory, [entry][thread] (no bank conflicts),
//     sized to the tree: depth - 1 entries hold every walk, so the loop's
//     clamped overwrite at 64 never triggers (the build refuses depth >= 64);
//   - only a leaf's real triangles, read as 16-byte loads issued together.
//     A padding slot's three vertices are equal: the ray test's det is 0,
//     a miss, so the ray kernel skips them; Ericson's path returns its
//     vertex c (ab = ac = 0, the first test holds), so the closest-point
//     kernel computes the padding's squared distance once per query, in the
//     loop's order, and keeps it under the same strict '<' after a leaf's
//     real triangles: the loop's answer without its divisions.
// Measured on the card and left out (PERF.md): the top records in shared
// memory (the top levels sit in L1; the block's copy and the lower
// occupancy cost more), a prefetch of each pushed node into L1, Ericson by
// selects, a while-while loop, a 64-register cap (spills) and walking a
// launch's queries in Morton order: each was slower.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kLeafSize = 4;
constexpr int kThreads = 128;
constexpr float kPad = 1e10f;  // the padding slots' coordinate
constexpr int kDone = INT32_MIN;  // no node: the walk is over (never a leaf's reference)

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

// Ericson's closest point on triangle abc. The JAX function evaluates every
// region and keeps, by a chain of selects, the last whose test holds:
// vertex c over b over a over edge bc over ac over ab over the face. The
// tests here run in that order of precedence and return at the first that
// holds (computing every region and selecting, as the JAX function does,
// gives the same bits and was slower on the card).
__device__ __forceinline__ V3 closest_on_triangle(V3 p, V3 a, V3 b, V3 c) {
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

__device__ __forceinline__ float box_sq_dist(V3 mn, V3 mx, V3 p) {
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

__device__ __forceinline__ bool box_hit(V3 mn, V3 mx, V3 o, V3 inv_d, float tmax) {
  const float ax = (mn.x - o.x) * inv_d.x, bx = (mx.x - o.x) * inv_d.x;
  const float ay = (mn.y - o.y) * inv_d.y, by = (mx.y - o.y) * inv_d.y;
  const float az = (mn.z - o.z) * inv_d.z, bz = (mx.z - o.z) * inv_d.z;
  const float tn = fmaxf(fmaxf(fminf(ax, bx), fminf(ay, by)), fminf(az, bz));
  const float tf = fminf(fminf(fmaxf(ax, bx), fmaxf(ay, by)), fmaxf(az, bz));
  return tf >= fmaxf(tn, 0.0f) && tn < tmax;
}

struct Tree {
  const float4* records;  // 4 float4 a record; the 4th holds int32 words
  const float4* tris;     // 9 float4 a leaf (its 4 slots' 36 floats)
  int root;
  int stack_entries;
};

// A node's bytes: an internal node's record (4 float4), or a leaf's real
// triangles (floats [0, 9 * real) of its 36: 3, 5, 7 or 9 float4).
struct Fetched {
  float4 q[9];
};

__device__ __forceinline__ int leaf_index(int ref) { return ~ref >> 3; }
__device__ __forceinline__ int leaf_real(int ref) { return ~ref & 7; }

// One round of 16-byte read-only loads for whichever kind the node is, so
// that the lanes of a warp at internal nodes and at leaves wait for their
// loads together (a load in each branch was slower on the card).
__device__ __forceinline__ void fetch(const Tree& t, int node, Fetched& f) {
  const bool inner = node >= 0;
  const float4* src = inner ? t.records + 4 * static_cast<int64_t>(node)
                            : t.tris + 9 * static_cast<int64_t>(leaf_index(node));
  const int n_q = inner ? 4 : (9 * leaf_real(node) + 3) / 4;
#pragma unroll
  for (int k = 0; k < 9; ++k) f.q[k] = k < n_q ? __ldg(src + k) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// One internal node: its children's boxes and references.
struct Node {
  V3 lmin, lmax, rmin, rmax;
  int left, right;
  __device__ __forceinline__ explicit Node(const Fetched& f)
      : lmin{f.q[0].x, f.q[0].y, f.q[0].z}, lmax{f.q[0].w, f.q[1].x, f.q[1].y},
        rmin{f.q[1].z, f.q[1].w, f.q[2].x}, rmax{f.q[2].y, f.q[2].z, f.q[2].w} {
    left = __float_as_int(f.q[3].x);  // (an intrinsic: not in the initializer list,
    right = __float_as_int(f.q[3].y);  // which the host pass also reads)
  }
};

// A leaf: its first slot, its real triangles, their vertices.
struct Leaf {
  int first, real;
  const Fetched& f;
  __device__ __forceinline__ Leaf(int ref, const Fetched& f_)
      : first(leaf_index(ref) * kLeafSize), real(leaf_real(ref)), f(f_) {}
  __device__ __forceinline__ float at(int k) const {
    const float4 v = f.q[k / 4];
    return k % 4 == 0 ? v.x : k % 4 == 1 ? v.y : k % 4 == 2 ? v.z : v.w;
  }
  __device__ __forceinline__ V3 vertex(int k) const { return {at(3 * k), at(3 * k + 1), at(3 * k + 2)}; }
};

// The thread's stack in dynamic shared memory, one int every kThreads
// (entry e at stack[e * kThreads]: no bank conflicts). `stack_entries`
// holds every walk of a tree of that depth + 1; a push past the top would
// overwrite the top, as the JAX loop's clamped index does.
struct Stack {
  int* s;
  int sp, cap;
  __device__ __forceinline__ void push(int ref) {
    s[(sp < cap - 1 ? sp : cap - 1) * kThreads] = ref;
    sp += 1;
  }
  __device__ __forceinline__ int pop() {
    if (sp == 0) return kDone;
    sp -= 1;
    return s[sp * kThreads];
  }
};

// The closest-point walk of one query, as the loop pops it: a leaf's real
// triangles, then its first padding slot at the padding's squared distance;
// an internal node goes to the near child, pushing the far one, when their
// boxes can beat the best.
struct ClosestPoint {
  V3 p, pad;
  float pad_d2, best_d2;
  V3 best_cp;
  int best_tri;

  __device__ __forceinline__ explicit ClosestPoint(V3 q) : p(q), pad{kPad, kPad, kPad} {
    const V3 e = pad - p;  // a padding slot's closest point is its vertex c
    pad_d2 = dot(e, e);
    best_d2 = CUDART_INF_F;
    best_cp = {0.0f, 0.0f, 0.0f};
    best_tri = -1;
  }
  __device__ __forceinline__ int internal(const Node& nd, Stack& stack) {
    const float dl = box_sq_dist(nd.lmin, nd.lmax, p), dr = box_sq_dist(nd.rmin, nd.rmax, p);
    const bool left_near = dl <= dr;
    if (!(fminf(dl, dr) < best_d2)) return stack.pop();
    if (fmaxf(dl, dr) < best_d2) stack.push(left_near ? nd.right : nd.left);
    return left_near ? nd.left : nd.right;
  }
  __device__ __forceinline__ void leaf(const Leaf& lf) {
#pragma unroll
    for (int j = 0; j < kLeafSize; ++j) {
      if (j < lf.real) {
        const V3 cp = closest_on_triangle(p, lf.vertex(3 * j), lf.vertex(3 * j + 1),
                                          lf.vertex(3 * j + 2));
        const V3 e = cp - p;
        const float d2 = dot(e, e);
        if (d2 < best_d2) {
          best_d2 = d2;
          best_cp = cp;
          best_tri = lf.first + j;
        }
      }
    }
    if (lf.real < kLeafSize && pad_d2 < best_d2) {
      best_d2 = pad_d2;
      best_cp = pad;
      best_tri = lf.first + lf.real;
    }
  }
};

// The ray-hit walk of one ray: a leaf's real triangles (a padding slot's
// det is 0: it always misses); an internal node goes to the left child,
// pushing the right one, when the ray meets both boxes before the best t,
// else to the one it meets.
struct RayHit {
  V3 o, d, inv_d;
  float best_t;
  int best_tri;

  __device__ __forceinline__ RayHit(V3 o_, V3 d_)
      : o(o_), d(d_), inv_d{1.0f / safe(d_.x, 1e-12f, 1e-12f), 1.0f / safe(d_.y, 1e-12f, 1e-12f),
                            1.0f / safe(d_.z, 1e-12f, 1e-12f)} {
    best_t = CUDART_INF_F;
    best_tri = -1;
  }
  __device__ __forceinline__ int internal(const Node& nd, Stack& stack) {
    const bool hl = box_hit(nd.lmin, nd.lmax, o, inv_d, best_t);
    const bool hr = box_hit(nd.rmin, nd.rmax, o, inv_d, best_t);
    if (hl && hr) stack.push(nd.right);
    return hl ? nd.left : hr ? nd.right : stack.pop();
  }
  __device__ __forceinline__ void leaf(const Leaf& lf) {
#pragma unroll
    for (int j = 0; j < kLeafSize; ++j) {
      if (j < lf.real) {
        const float tj = ray_triangle(o, d, lf.vertex(3 * j), lf.vertex(3 * j + 1),
                                      lf.vertex(3 * j + 2));
        if (tj < best_t) {
          best_t = tj;
          best_tri = lf.first + j;
        }
      }
    }
  }
};

// One query's walk from the root until its stack is empty; returns the
// nodes processed.
template <typename Query>
__device__ __forceinline__ int walk(const Tree& t, Query& q, Stack& stack) {
  int visits = 0;
  int node = t.root;
  do {
    visits += 1;
    Fetched f;
    fetch(t, node, f);
    if (node >= 0) {
      node = q.internal(Node(f), stack);
    } else {
      q.leaf(Leaf(node, f));
      node = stack.pop();
    }
  } while (node != kDone);
  return visits;
}

__device__ __forceinline__ Stack thread_stack(const Tree& t) {
  extern __shared__ int stacks[];
  return Stack{stacks + threadIdx.x, 0, t.stack_entries};
}

__global__ void __launch_bounds__(kThreads)
closest_point_kernel(Tree t, const float* __restrict__ points, int64_t n,
                     float* __restrict__ dist, float* __restrict__ cp_out,
                     int* __restrict__ tri_out, int* __restrict__ visits_out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  Stack stack = thread_stack(t);
  ClosestPoint q({points[3 * i], points[3 * i + 1], points[3 * i + 2]});
  const int visits = walk(t, q, stack);
  dist[i] = sqrtf(q.best_d2);
  cp_out[3 * i] = q.best_cp.x;
  cp_out[3 * i + 1] = q.best_cp.y;
  cp_out[3 * i + 2] = q.best_cp.z;
  tri_out[i] = q.best_tri;
  if (visits_out) visits_out[i] = visits;
}

__global__ void __launch_bounds__(kThreads)
ray_intersect_kernel(Tree t, const float* __restrict__ origins,
                     const float* __restrict__ dirs, int64_t n,
                     float* __restrict__ t_out, int* __restrict__ tri_out,
                     int* __restrict__ visits_out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  Stack stack = thread_stack(t);
  RayHit q({origins[3 * i], origins[3 * i + 1], origins[3 * i + 2]},
           {dirs[3 * i], dirs[3 * i + 1], dirs[3 * i + 2]});
  const int visits = walk(t, q, stack);
  t_out[i] = q.best_t;
  tri_out[i] = q.best_tri;
  if (visits_out) visits_out[i] = visits;
}

unsigned blocks_for(long long n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

// A block's stacks: at most 62 entries (depth < 64) of kThreads ints, under
// the 48 KB of dynamic shared memory a launch may take without opting in.
size_t stack_bytes(int entries) { return static_cast<size_t>(entries) * kThreads * sizeof(int); }

}  // namespace

extern "C" int bvh_closest_point(const void* records, int root, int stack_entries,
                                 const void* tris, const void* points, long long n, void* dist,
                                 void* cp, void* tri, void* visits, void* stream) {
  if (n <= 0) return 0;
  const Tree t{static_cast<const float4*>(records), static_cast<const float4*>(tris), root,
               stack_entries};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  closest_point_kernel<<<blocks_for(n), kThreads, stack_bytes(stack_entries), s>>>(
      t, static_cast<const float*>(points), static_cast<int64_t>(n), static_cast<float*>(dist),
      static_cast<float*>(cp), static_cast<int*>(tri), static_cast<int*>(visits));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bvh_ray_intersect(const void* records, int root, int stack_entries,
                                 const void* tris, const void* origins, const void* dirs,
                                 long long n, void* t_out, void* tri, void* visits,
                                 void* stream) {
  if (n <= 0) return 0;
  const Tree t{static_cast<const float4*>(records), static_cast<const float4*>(tris), root,
               stack_entries};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  ray_intersect_kernel<<<blocks_for(n), kThreads, stack_bytes(stack_entries), s>>>(
      t, static_cast<const float*>(origins), static_cast<const float*>(dirs),
      static_cast<int64_t>(n), static_cast<float*>(t_out), static_cast<int*>(tri),
      static_cast<int*>(visits));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* triangle_bvh_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

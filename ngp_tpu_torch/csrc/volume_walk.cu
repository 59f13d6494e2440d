// Delta tracking through a density volume for Hopper (sm_90a): the volume
// engine's training-data walk and its frame walk, one thread an episode or
// a ray.
//
// No TPU kernel is replaced: the JAX package runs these walks as
// lax.fori_loops of 512 lockstep iterations (ngp_tpu/engines/volume.py,
// generate_training_data :128-205 and _render_rays :259-298), which in
// eager PyTorch would be some 40 small launches an iteration. The reference
// runs each as one CUDA kernel (volume_generate_training_data_kernel and
// volume_render_kernel_gt / _step, src/testbed_volume.cu). These kernels
// compute what the lockstep loops compute, lane by lane, bit for bit with
// the plain PyTorch twins of ngp_tpu_torch/ops/volume_walk.py:
//
//   jump (one iteration): where the bit cell (128^3, centred on integers)
//     of the position is occupied, a free flight of
//     -log(max(1 - u, 1e-12)) * distance_scale / majorant; else a skip to
//     the next bit-cell boundary (a direction component with |d| <= 1e-12
//     taken as +1e-12, clipped to [1e-3, 128] cells, /128, + 1e-5). A ray
//     that leaves the AABB dies; an event is a landing in an occupied cell
//     from an occupied cell.
//   volume_train_walk: at an event, the jittered nearest-voxel density is
//     recorded in the next of 4 slots while one is free; the collision is
//     real with probability density/majorant, a scatter with albedo of
//     that (a new direction from a normal draw, mixed with the old one by
//     `scattering`), else an absorption (throughput 0, the episode ends).
//     An episode walks until it dies or 512 iterations pass; it does not
//     stop at 4 vertices, since later scatters turn its final direction,
//     along which the engine reads the sky.
//   volume_render_walk, ground truth: at an event
//     a = clip(density/majorant, 0, 1) * (1 - opa) adds to col (rgb 1) and
//     opa; a ray stops once opa > 0.99. Learned: one round of the event
//     wavefront, each live ray advanced until its next event, its death or
//     iteration 512, with its own iteration counter; the engine evaluates
//     the network at the events, composites and calls again. A non-event
//     iteration of the lockstep loop adds rgb*0 and 0, so the rounds give
//     its result.
//
// Random draws: a counter-based stream, lowbias32 of
// key(seed, step) ^ row, then of that ^ (16 * iteration + stream) * golden;
// a uniform is the top 24 bits * 2^-24 (exact in float32). The logarithm
// and the Box-Muller sine and cosine are polynomials in +, -, *, / (vlog,
// sincos_2pi), in the twin's order; this source is compiled with
// -fmad=false and IEEE division and sqrt, so that no product is fused and
// each operation rounds as the twin's tensor operation does.
//
// Bound on the H100: the work depends on the data. The DRAM floor is the
// rays' own bytes and the density voxels read at events (the bitgrid is
// 2 MB and stays in L2); the operation floor is the iterations walked
// times the float operations of one, at the float32 rate (chip_smoke.py
// counts both from the kernels' per-ray iteration counts, phase
// volume_kernels). Neither sets the pace: a step's 16,384 episodes are 4
// warps an SM, each iteration is a chain of dependent bitgrid and density
// loads (L2 and DRAM latency), and a warp runs as long as its longest
// walk. Design: a thread holds its walk in registers (position, direction,
// 4 vertex slots) and writes each output once at the end; the read-only
// volume goes through the non-coherent cache (__ldg); the draws are
// computed where they are used (an iteration without an event draws one
// uniform), not stored.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kMaxIters = 512;
constexpr int kVertices = 4;
constexpr int kRes = 128;
constexpr uint32_t kGolden = 0x9e3779b9u;

struct Volume {
  const uint8_t* bits;
  const float* density;
  long long nx, ny, nz;
  float mn[3], mx[3], off[3];
  float w2i, majorant, flight, albedo, scattering;
  uint32_t key;
};

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t draw_bits(uint32_t key, int it, int stream) {
  return fmix32(key ^ (static_cast<uint32_t>(it * 16 + stream) * kGolden));
}

__device__ __forceinline__ float uniform(uint32_t key, int it, int stream) {
  return static_cast<float>(draw_bits(key, it, stream) >> 8) * 0x1p-24f;
}

__device__ __forceinline__ float uniform_open(uint32_t key, int it, int stream) {
  return static_cast<float>((draw_bits(key, it, stream) >> 8) + 1u) * 0x1p-24f;
}

// log of a positive normal float: x = 2^e m, m in [sqrt(1/2), sqrt(2)),
// log m = 2 atanh(s), s = (m - 1) / (m + 1), odd series to s^11
__device__ __forceinline__ float vlog(float x) {
  const int bits = __float_as_int(x);
  int e = (bits >> 23) - 127;
  float m = __int_as_float((bits & 0x7fffff) | 0x3f800000);
  if (m > 1.41421354f) {
    m = m * 0.5f;
    e += 1;
  }
  const float fe = static_cast<float>(e);
  const float f = m - 1.0f;
  const float s = f / (f + 2.0f);
  const float s2 = s * s;
  float p = 0.181818187f;
  p = s2 * p + 0.222222224f;
  p = s2 * p + 0.285714298f;
  p = s2 * p + 0.400000006f;
  p = s2 * p + 0.666666687f;
  const float lm = (s + s) + s * (s2 * p);
  return fe * 0.693145752f + (fe * 1.42860677e-06f + lm);
}

// cos and sin of 2 pi u, u in [0, 1): the octant of 8u, Taylor polynomials
// on [0, pi/4]
__device__ __forceinline__ void sincos_2pi(float u, float& cos_out, float& sin_out) {
  const float t = u * 8.0f;
  const float q = floorf(t);
  const float f = t - q;
  const int qi = static_cast<int>(q);
  const float y = (qi & 1) ? 1.0f - f : f;
  const float x = y * 0.785398185f;
  const float x2 = x * x;
  float ps = -2.50521079e-08f;
  ps = x2 * ps + 2.75573188e-06f;
  ps = x2 * ps + -0.000198412701f;
  ps = x2 * ps + 0.00833333377f;
  ps = x2 * ps + -0.166666672f;
  const float s = x + x * (x2 * ps);
  float pc = -2.755732e-07f;
  pc = x2 * pc + 2.48015876e-05f;
  pc = x2 * pc + -0.00138888892f;
  pc = x2 * pc + 0.0416666679f;
  pc = x2 * pc + -0.5f;
  const float c = 1.0f + x2 * pc;
  const bool swap = ((qi + 1) & 2) != 0;
  const float a = swap ? s : c;
  const float b = swap ? c : s;
  cos_out = ((qi + 2) & 4) ? -a : a;
  sin_out = qi >= 4 ? -b : b;
}

// Box-Muller from streams stream .. stream + 3
__device__ __forceinline__ float3 normal3(uint32_t key, int it, int stream) {
  const float r1 = sqrtf(-2.0f * vlog(uniform_open(key, it, stream)));
  float c1, s1, c2, s2;
  sincos_2pi(uniform(key, it, stream + 1), c1, s1);
  const float r2 = sqrtf(-2.0f * vlog(uniform_open(key, it, stream + 2)));
  sincos_2pi(uniform(key, it, stream + 3), c2, s2);
  return make_float3(r1 * c1, r1 * s1, r2 * c2);
}

__device__ __forceinline__ float3 normalize3(float3 v) {
  const float len = sqrtf(v.x * v.x + v.y * v.y + v.z * v.z);
  return make_float3(v.x / len, v.y / len, v.z / len);
}

__device__ __forceinline__ bool bit_occupied(const Volume& v, float3 p) {
  const float fx = floorf(p.x * 128.0f + 0.5f);
  const float fy = floorf(p.y * 128.0f + 0.5f);
  const float fz = floorf(p.z * 128.0f + 0.5f);
  if (!(fx >= 0.0f && fx < 128.0f && fy >= 0.0f && fy < 128.0f && fz >= 0.0f &&
        fz < 128.0f))
    return false;
  const int i = (static_cast<int>(fx) * kRes + static_cast<int>(fy)) * kRes +
                static_cast<int>(fz);
  return __ldg(v.bits + i) != 0;
}

__device__ __forceinline__ float density_at(const Volume& v, float3 p, float jx, float jy,
                                            float jz) {
  const float fx = floorf((p.x * v.w2i + v.off[0]) + jx);
  const float fy = floorf((p.y * v.w2i + v.off[1]) + jy);
  const float fz = floorf((p.z * v.w2i + v.off[2]) + jz);
  if (!(fx >= 0.0f && fx < static_cast<float>(v.nx) && fy >= 0.0f &&
        fy < static_cast<float>(v.ny) && fz >= 0.0f && fz < static_cast<float>(v.nz)))
    return 0.0f;
  const long long i = (static_cast<long long>(fx) * v.ny + static_cast<long long>(fy)) * v.nz +
                      static_cast<long long>(fz);
  return __ldg(v.density + i);
}

// time to the next bit-cell boundary along one axis, +inf where not ahead
__device__ __forceinline__ float axis_t(float pc, float dc) {
  const float step = static_cast<float>((dc > 0.0f) - (dc < 0.0f));
  const float boundary = floorf(pc + 0.5f) + 0.5f * step;
  const float t = (boundary - pc) / (fabsf(dc) > 1e-12f ? dc : 1e-12f);
  return t > 0.0f ? t : CUDART_INF_F;
}

// one advance of a live ray; returns whether it is at an event, clears
// `alive` if it left the box
__device__ __forceinline__ bool jump(const Volume& v, float3& p, float3 d, float u,
                                     bool& alive) {
  const bool occ = bit_occupied(v, p);
  float dt;
  if (occ) {
    dt = -vlog(fmaxf(1.0f - u, 1e-12f)) * v.flight;
  } else {
    const float tm = fminf(fminf(axis_t(p.x * 128.0f, d.x), axis_t(p.y * 128.0f, d.y)),
                           axis_t(p.z * 128.0f, d.z));
    dt = fminf(fmaxf(tm, 1e-3f), 128.0f) / 128.0f + 1e-5f;
  }
  p = make_float3(p.x + d.x * dt, p.y + d.y * dt, p.z + d.z * dt);
  alive = p.x >= v.mn[0] && p.x <= v.mx[0] && p.y >= v.mn[1] && p.y <= v.mx[1] &&
          p.z >= v.mn[2] && p.z <= v.mx[2];
  return alive && occ && bit_occupied(v, p);
}

__device__ __forceinline__ uint32_t row_key(const Volume& v, long long row) {
  return fmix32(static_cast<uint32_t>(row) ^ v.key);
}

__global__ void __launch_bounds__(kThreads)
train_walk_kernel(const Volume v, const float* __restrict__ pos_in,
                  const float* __restrict__ dirs_in, const uint8_t* __restrict__ alive_in,
                  int64_t n, float* __restrict__ out_pos, float* __restrict__ out_den,
                  int* __restrict__ cursor_out, float* __restrict__ dirs_out,
                  float* __restrict__ thr_out, int* __restrict__ steps_out) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= n) return;
  const uint32_t key = row_key(v, e);
  float3 p = make_float3(pos_in[3 * e], pos_in[3 * e + 1], pos_in[3 * e + 2]);
  float3 d = make_float3(dirs_in[3 * e], dirs_in[3 * e + 1], dirs_in[3 * e + 2]);
  bool alive = alive_in[e] != 0;
  float vp[kVertices][3] = {};
  float vd[kVertices] = {};
  int cursor = 0;
  float thr = 1.0f;
  int it = 0;
  for (; it < kMaxIters && alive; ++it) {
    if (!jump(v, p, d, uniform(key, it, 0), alive)) continue;
    const float den = density_at(v, p, uniform(key, it, 1), uniform(key, it, 2),
                                 uniform(key, it, 3));
    // register slots: unrolled so that the cursor does not index local memory
#pragma unroll
    for (int k = 0; k < kVertices; ++k) {
      if (k == cursor) {
        vp[k][0] = p.x;
        vp[k][1] = p.y;
        vp[k][2] = p.z;
        vd[k] = den;
      }
    }
    cursor += cursor < kVertices;
    const float ext = den / v.majorant;
    const float scatter_p = ext * v.albedo;
    const float z = uniform(key, it, 4);
    if (!(z < ext)) continue;
    if (z < scatter_p) {
      const float3 nd = normalize3(normal3(key, it, 5));
      d = normalize3(make_float3(d.x * v.scattering + nd.x, d.y * v.scattering + nd.y,
                                 d.z * v.scattering + nd.z));
    } else {
      thr = 0.0f;
      alive = false;
    }
  }
#pragma unroll
  for (int k = 0; k < kVertices; ++k) {
    out_pos[(e * kVertices + k) * 3] = vp[k][0];
    out_pos[(e * kVertices + k) * 3 + 1] = vp[k][1];
    out_pos[(e * kVertices + k) * 3 + 2] = vp[k][2];
    out_den[e * kVertices + k] = vd[k];
  }
  cursor_out[e] = cursor;
  dirs_out[3 * e] = d.x;
  dirs_out[3 * e + 1] = d.y;
  dirs_out[3 * e + 2] = d.z;
  thr_out[e] = thr;
  if (steps_out) steps_out[e] = it;
}

__global__ void __launch_bounds__(kThreads)
render_gt_kernel(const Volume v, const float* __restrict__ pos_in,
                 const float* __restrict__ dirs_in, const uint8_t* __restrict__ alive_in,
                 int64_t n, float* __restrict__ col_out, float* __restrict__ opa_out,
                 int* __restrict__ steps_out) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= n) return;
  const uint32_t key = row_key(v, r);
  float3 p = make_float3(pos_in[3 * r], pos_in[3 * r + 1], pos_in[3 * r + 2]);
  const float3 d = make_float3(dirs_in[3 * r], dirs_in[3 * r + 1], dirs_in[3 * r + 2]);
  bool alive = alive_in[r] != 0;
  float col = 0.0f, opa = 0.0f;
  int it = 0;
  for (; it < kMaxIters && alive; ++it) {
    if (!jump(v, p, d, uniform(key, it, 0), alive)) continue;
    const float den = density_at(v, p, uniform(key, it, 1), uniform(key, it, 2),
                                 uniform(key, it, 3));
    const float ext = fminf(fmaxf(den / v.majorant, 0.0f), 1.0f);
    const float a = ext * (1.0f - opa);
    col = col + a;
    opa = opa + a;
    alive = opa <= 0.99000001f;
  }
  col_out[3 * r] = col;
  col_out[3 * r + 1] = col;
  col_out[3 * r + 2] = col;
  opa_out[r] = opa;
  if (steps_out) steps_out[r] = it;
}

__global__ void __launch_bounds__(kThreads)
render_round_kernel(const Volume v, const int64_t* __restrict__ ids, float* __restrict__ pos,
                    const float* __restrict__ dirs, uint8_t* __restrict__ alive_io,
                    int* __restrict__ iters, int64_t n, uint8_t* __restrict__ event_out) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= n) return;
  if (!alive_io[r]) {
    event_out[r] = 0;
    return;
  }
  const uint32_t key = row_key(v, ids[r]);
  float3 p = make_float3(pos[3 * r], pos[3 * r + 1], pos[3 * r + 2]);
  const float3 d = make_float3(dirs[3 * r], dirs[3 * r + 1], dirs[3 * r + 2]);
  bool alive = true, event = false;
  int it = iters[r];
  while (it < kMaxIters) {
    event = jump(v, p, d, uniform(key, it, 0), alive);
    ++it;
    if (!alive || event) break;
  }
  pos[3 * r] = p.x;
  pos[3 * r + 1] = p.y;
  pos[3 * r + 2] = p.z;
  alive_io[r] = event;
  iters[r] = it;
  event_out[r] = event;
}

Volume make_volume(const void* bits, const void* density, long long nx, long long ny,
                   long long nz, const float* params, unsigned key) {
  Volume v;
  v.bits = static_cast<const uint8_t*>(bits);
  v.density = static_cast<const float*>(density);
  v.nx = nx;
  v.ny = ny;
  v.nz = nz;
  for (int a = 0; a < 3; ++a) {
    v.mn[a] = params[a];
    v.mx[a] = params[3 + a];
    v.off[a] = params[6 + a];
  }
  v.w2i = params[9];
  v.majorant = params[10];
  v.flight = params[11];
  v.albedo = params[12];
  v.scattering = params[13];
  v.key = key;
  return v;
}

unsigned blocks_for(long long n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int volume_train_walk(const void* bits, const void* density, long long nx,
                                 long long ny, long long nz, const float* params, unsigned key,
                                 const void* pos, const void* dirs, const void* alive,
                                 long long n, void* out_pos, void* out_den, void* cursor,
                                 void* dirs_out, void* thr, void* steps, void* stream) {
  if (n <= 0) return 0;
  const Volume v = make_volume(bits, density, nx, ny, nz, params, key);
  train_walk_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      v, static_cast<const float*>(pos), static_cast<const float*>(dirs),
      static_cast<const uint8_t*>(alive), static_cast<int64_t>(n), static_cast<float*>(out_pos),
      static_cast<float*>(out_den), static_cast<int*>(cursor), static_cast<float*>(dirs_out),
      static_cast<float*>(thr), static_cast<int*>(steps));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int volume_render_walk(const void* bits, const void* density, long long nx,
                                  long long ny, long long nz, const float* params,
                                  unsigned key, int gt, const void* ids, void* pos,
                                  const void* dirs, void* alive, void* iters, long long n,
                                  void* col, void* opa, void* event, void* steps,
                                  void* stream) {
  if (n <= 0) return 0;
  const Volume v = make_volume(bits, density, nx, ny, nz, params, key);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gt) {
    render_gt_kernel<<<blocks_for(n), kThreads, 0, s>>>(
        v, static_cast<const float*>(pos), static_cast<const float*>(dirs),
        static_cast<const uint8_t*>(alive), static_cast<int64_t>(n), static_cast<float*>(col),
        static_cast<float*>(opa), static_cast<int*>(steps));
  } else {
    render_round_kernel<<<blocks_for(n), kThreads, 0, s>>>(
        v, static_cast<const int64_t*>(ids), static_cast<float*>(pos),
        static_cast<const float*>(dirs), static_cast<uint8_t*>(alive), static_cast<int*>(iters),
        static_cast<int64_t>(n), static_cast<uint8_t*>(event));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* volume_walk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

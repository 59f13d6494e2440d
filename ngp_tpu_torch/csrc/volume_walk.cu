// Delta tracking through a density volume for Hopper (sm_90a): the volume
// engine's training data (the episodes' starts, their walks and the sky
// targets, in one launch) and its frame walk, one thread an episode or a
// ray.
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
//   volume_train_walk (training_data): an episode starts on the sphere of
//     radius 2 about the box's centre (a normal draw, normalised) toward a
//     uniform point of the box, and enters the box 1e-6 past the slab
//     test's entry. At an event, the jittered nearest-voxel density is
//     recorded in the next of 4 slots while one is free; the collision is
//     real with probability density/majorant, a scatter with albedo of
//     that (a new direction from a normal draw, mixed with the old one by
//     `scattering`), else an absorption (throughput 0, the episode ends).
//     An episode walks until it dies or 512 iterations pass; it does not
//     stop at 4 vertices, since later scatters turn its final direction,
//     along which the procedural sky is read. Each slot's target is that
//     sky times the throughput, then the slot's density.
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
// each operation rounds as the twin's tensor operation does. Where PyTorch
// propagates NaN (minimum, maximum, amax, clamp), so do these kernels.
//
// Bound on the H100: the work depends on the data. The DRAM floor is the
// outputs and rays, the bitgrid and the density voxels read at events; the
// operation floor is the iterations walked times the float operations of
// one, at the float32 rate (chip_smoke.py counts both from the kernels'
// per-ray iteration counts, phase volume_kernels). Neither sets the pace:
// a step's 16,384 episodes are 4 warps an SM, a warp runs as long as its
// longest walk, and an iteration is a chain of dependent operations and
// loads. Design elements, each measured in turns on every kernel
// (chip_kernel_ab.py walk --walk-variants; PERF.md §6) and kept by the
// kernels where it won:
//   (a) carry: one bitgrid read an iteration; the landing cell's bit
//       decides the event and, carried in a register, the next
//       iteration's flight or skip (a loop that read the cell at the
//       start of each iteration read it twice). Training and ground-truth
//       walks.
//   (b) packed: the bitgrid at one bit a cell (256 KB), tiled so that one
//       128-byte line covers an 8 x 8 x 16 block of cells
//       (ops/volume_walk.py pack_bitgrid builds it; packed_bit reads it as
//       bit_word does here). Training walk; the render walks, thousands of
//       warps that hide their loads, lose to its address arithmetic and
//       read the 2 MB byte grid.
//   (c) overlap: where the ray stands in an occupied cell, the density at
//       the landing point (its address depends on the position and the
//       jitter draws, not on the bit) is loaded together with the landing
//       bit and used only at an event. Training and ground-truth walks
//       (the learned round reads no density).
//   (d) bricks: the density in bricks of 4^3 voxels (ops/volume_walk.py
//       brick_density; brick_index addresses it as density_at does here),
//       so that a walk's successive reads, ~1.4 voxels apart, share
//       sectors. Training walk (a second copy of the density on the card).
// Measured and dropped: issuing the next iteration's landing and loads
// before the current event's density is used (a software pipeline on the
// guess of a null collision). -D WALK_<ELEMENT>=0 or 1 forces an element
// on every kernel and -D WALK_THREADS sets the block size (chip_kernel_ab.py
// builds such copies); every variant gives the same bits.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#ifndef WALK_THREADS
#define WALK_THREADS 128
#endif
#ifndef WALK_CARRY
#define WALK_CARRY -1
#endif
#ifndef WALK_PACKED
#define WALK_PACKED -1
#endif
#ifndef WALK_OVERLAP
#define WALK_OVERLAP -1
#endif
#ifndef WALK_BRICKS
#define WALK_BRICKS -1
#endif

namespace {

constexpr int kThreads = WALK_THREADS;
constexpr int kMaxIters = 512;
constexpr int kStartIteration = kMaxIters;  // the draws of an episode's start
constexpr int kVertices = 4;
constexpr uint32_t kGolden = 0x9e3779b9u;

constexpr int kBrick = 4;  // voxels a side of a density brick

// an element as a kernel keeps it, unless a WALK_* macro forces it
constexpr bool pick(int forced, bool kept) { return forced < 0 ? kept : forced != 0; }
// (a)-(d) of the training walk, the ground-truth walk and the learned round
constexpr bool kTrainCarry = pick(WALK_CARRY, true), kTrainPacked = pick(WALK_PACKED, true),
               kTrainOverlap = pick(WALK_OVERLAP, true), kTrainBricks = pick(WALK_BRICKS, true);
constexpr bool kGtCarry = pick(WALK_CARRY, true), kGtPacked = pick(WALK_PACKED, false),
               kGtOverlap = pick(WALK_OVERLAP, true), kGtBricks = pick(WALK_BRICKS, false);
constexpr bool kRoundCarry = pick(WALK_CARRY, false), kRoundPacked = pick(WALK_PACKED, false);

struct Volume {
  const uint8_t* bits;     // 128^3 bytes
  const uint32_t* packed;  // 128^3 bits in 8 x 8 x 16 tiles of 32 words
  const float* density;    // X x Y x Z
  const float* bricks;     // the density in 4^3 bricks, each axis padded to a multiple of 4
  long long nx, ny, nz;
  float mn[3], mx[3], off[3];
  float w2i, majorant, flight, albedo, scattering;
  uint32_t key;
};

// the procedural sky: up, sun direction, sky colour, sun colour (float32)
struct Envmap {
  float up[3], sun[3], sky[3], sun_col[3];
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

__device__ __forceinline__ float dot3(float3 a, float3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

__device__ __forceinline__ float3 normalize3(float3 v) {
  const float len = sqrtf(dot3(v, v));
  return make_float3(v.x / len, v.y / len, v.z / len);
}

// torch.minimum / torch.maximum: NaN if either is NaN
__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// the bit cell of p, or false outside the grid
__device__ __forceinline__ bool bit_cell(float3 p, int& ix, int& iy, int& iz) {
  const float fx = floorf(p.x * 128.0f + 0.5f);
  const float fy = floorf(p.y * 128.0f + 0.5f);
  const float fz = floorf(p.z * 128.0f + 0.5f);
  if (!(fx >= 0.0f && fx < 128.0f && fy >= 0.0f && fy < 128.0f && fz >= 0.0f &&
        fz < 128.0f))
    return false;
  ix = static_cast<int>(fx);
  iy = static_cast<int>(fy);
  iz = static_cast<int>(fz);
  return true;
}

// the bitgrid word of p's bit cell and its bit (a byte and bit 0 where
// not kPacked); 0 outside the grid
template <bool kPacked>
__device__ __forceinline__ uint32_t bit_word(const Volume& v, float3 p, int& bit) {
  int ix, iy, iz;
  bit = 0;
  if (!bit_cell(p, ix, iy, iz)) return 0u;
  if (!kPacked) return __ldg(v.bits + (ix * 128 + iy) * 128 + iz) != 0;
  // tile (x / 8, y / 8, z / 16) of 32 words; in it, bit (x % 8 * 8 + y % 8) * 16 + z % 16
  const int tile = ((ix >> 3) * 16 + (iy >> 3)) * 8 + (iz >> 4);
  const int b = ((ix & 7) * 8 + (iy & 7)) * 16 + (iz & 15);
  bit = b & 31;
  return __ldg(v.packed + tile * 32 + (b >> 5));
}

template <bool kPacked>
__device__ __forceinline__ bool bit_occupied(const Volume& v, float3 p) {
  int bit;
  const uint32_t word = bit_word<kPacked>(v, p, bit);
  return (word >> bit) & 1u;
}

template <bool kBricks>
__device__ __forceinline__ float density_at(const Volume& v, float3 p, float jx, float jy,
                                            float jz) {
  const float fx = floorf((p.x * v.w2i + v.off[0]) + jx);
  const float fy = floorf((p.y * v.w2i + v.off[1]) + jy);
  const float fz = floorf((p.z * v.w2i + v.off[2]) + jz);
  if (!(fx >= 0.0f && fx < static_cast<float>(v.nx) && fy >= 0.0f &&
        fy < static_cast<float>(v.ny) && fz >= 0.0f && fz < static_cast<float>(v.nz)))
    return 0.0f;
  const long long x = static_cast<long long>(fx), y = static_cast<long long>(fy),
                  z = static_cast<long long>(fz);
  if (!kBricks) return __ldg(v.density + (x * v.ny + y) * v.nz + z);
  const long long by = (v.ny + kBrick - 1) / kBrick, bz = (v.nz + kBrick - 1) / kBrick;
  const long long brick = ((x / kBrick) * by + y / kBrick) * bz + z / kBrick;
  return __ldg(v.bricks + ((brick * kBrick + x % kBrick) * kBrick + y % kBrick) * kBrick +
               z % kBrick);
}

template <bool kBricks>
__device__ __forceinline__ float density_jittered(const Volume& v, float3 p, uint32_t key,
                                                  int it) {
  return density_at<kBricks>(v, p, uniform(key, it, 1), uniform(key, it, 2),
                             uniform(key, it, 3));
}

// time to the next bit-cell boundary along one axis, +inf where not ahead
__device__ __forceinline__ float axis_t(float pc, float dc) {
  const float step = static_cast<float>((dc > 0.0f) - (dc < 0.0f));
  const float boundary = floorf(pc + 0.5f) + 0.5f * step;
  const float t = (boundary - pc) / (fabsf(dc) > 1e-12f ? dc : 1e-12f);
  return t > 0.0f ? t : CUDART_INF_F;
}

// Where iteration `it` of a live ray at p along d lands: a free flight
// where p's bit cell is occupied (`occ`), else a skip; whether it is still
// in the box; the landing cell's bitgrid word (read where `read`) and,
// with kDensity and kOverlap where the ray flew, the density there. The
// loads are issued here and waited for where their values are first used.
struct Landing {
  float3 p;
  bool alive;
  uint32_t word;
  int bit;
  float den;
};

template <bool kPacked, bool kDensity, bool kOverlap, bool kBricks>
__device__ __forceinline__ Landing land(const Volume& v, uint32_t key, int it, float3 p,
                                        float3 d, bool occ, bool read) {
  const float u = uniform(key, it, 0);
  float dt;
  if (occ) {
    dt = -vlog(fmaxf(1.0f - u, 1e-12f)) * v.flight;
  } else {
    const float tm = fminf(fminf(axis_t(p.x * 128.0f, d.x), axis_t(p.y * 128.0f, d.y)),
                           axis_t(p.z * 128.0f, d.z));
    dt = fminf(fmaxf(tm, 1e-3f), 128.0f) / 128.0f + 1e-5f;
  }
  Landing l;
  l.p = make_float3(p.x + d.x * dt, p.y + d.y * dt, p.z + d.z * dt);
  l.alive = l.p.x >= v.mn[0] && l.p.x <= v.mx[0] && l.p.y >= v.mn[1] && l.p.y <= v.mx[1] &&
            l.p.z >= v.mn[2] && l.p.z <= v.mx[2];
  l.word = 0u;
  l.bit = 0;
  l.den = 0.0f;
  if (l.alive) {
    if (kDensity && kOverlap && occ) l.den = density_jittered<kBricks>(v, l.p, key, it);
    if (read) l.word = bit_word<kPacked>(v, l.p, l.bit);
  }
  return l;
}

// One advance of a live ray at iteration `it`: p moves to its landing,
// `alive` clears where it left the box, `occ` becomes whether the landing
// cell is occupied (kCarry; without it, read again from p first). Returns
// whether it is at an event; with kDensity, `den` is then the jittered
// density there.
template <bool kCarry, bool kPacked, bool kDensity, bool kOverlap, bool kBricks>
__device__ __forceinline__ bool advance(const Volume& v, uint32_t key, int it, float3& p,
                                        float3 d, bool& occ, bool& alive, float& den) {
  if (!kCarry) occ = bit_occupied<kPacked>(v, p);
  const Landing l =
      land<kPacked, kDensity, kOverlap, kBricks>(v, key, it, p, d, occ, kCarry || occ);
  p = l.p;
  alive = l.alive;
  const bool landed = (l.word >> l.bit) & 1u;
  const bool event = alive && occ && landed;
  occ = landed;
  den = l.den;
  if (kDensity && !kOverlap && event) den = density_jittered<kBricks>(v, p, key, it);
  return event;
}

__device__ __forceinline__ uint32_t row_key(const Volume& v, long long row) {
  return fmix32(static_cast<uint32_t>(row) ^ v.key);
}

// the procedural sun and sky along unit d (proc_envmap, testbed_volume.cu:46-60)
__device__ __forceinline__ float3 envmap(const Envmap& env, float3 d) {
  const float skyam = dot3(d, make_float3(env.up[0], env.up[1], env.up[2])) * 0.5f + 0.5f;
  float sunam = dot3(d, make_float3(env.sun[0], env.sun[1], env.sun[2]));
  sunam = sunam < 0.0f ? 0.0f : sunam;  // clamp_min: NaN stays NaN
#pragma unroll
  for (int k = 0; k < 6; ++k) sunam = sunam * sunam;
  const float sun = 20.0f * sunam;
  return make_float3(env.sky[0] * skyam + env.sun_col[0] * sun,
                     env.sky[1] * skyam + env.sun_col[1] * sun,
                     env.sky[2] * skyam + env.sun_col[2] * sun);
}

// A walk of up to kMaxIters iterations from p along d. At each event,
// on_event(it, p, d, den, alive) may turn d and clear alive; returns the
// iterations walked.
template <bool kCarry, bool kPacked, bool kOverlap, bool kBricks, typename OnEvent>
__device__ __forceinline__ int walk(const Volume& v, uint32_t key, float3& p, float3& d,
                                   bool& alive, OnEvent on_event) {
  bool occ = kCarry && alive && bit_occupied<kPacked>(v, p);
  int it = 0;
  for (; it < kMaxIters && alive; ++it) {
    float den;
    if (advance<kCarry, kPacked, true, kOverlap, kBricks>(v, key, it, p, d, occ, alive, den))
      on_event(it, p, d, den, alive);
  }
  return it;
}

__global__ void __launch_bounds__(kThreads)
train_walk_kernel(const Volume v, const Envmap env, int64_t n, float* __restrict__ positions,
                  float* __restrict__ targets, uint8_t* __restrict__ valid,
                  int* __restrict__ steps_out) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= n) return;
  const uint32_t key = row_key(v, e);
  // the start (start_draws, then the engine's rays and slab test)
  const float3 nrm = normalize3(normal3(key, kStartIteration, 0));
  const float3 o = make_float3(nrm.x * 2.0f + 0.5f, nrm.y * 2.0f + 0.5f, nrm.z * 2.0f + 0.5f);
  float tgt[3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
    tgt[a] = v.mn[a] + uniform(key, kStartIteration, 4 + a) * (v.mx[a] - v.mn[a]);
  float3 d = normalize3(make_float3(tgt[0] - o.x, tgt[1] - o.y, tgt[2] - o.z));
  const float oa[3] = {o.x, o.y, o.z}, da[3] = {d.x, d.y, d.z};
  float tmin = 0.0f, tmax = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float inv = 1.0f / da[a];
    const float t0 = (v.mn[a] - oa[a]) * inv;
    const float t1 = (v.mx[a] - oa[a]) * inv;
    const float lo = nan_min(t0, t1), hi = nan_max(t0, t1);
    tmin = a == 0 ? lo : nan_max(tmin, lo);
    tmax = a == 0 ? hi : nan_min(tmax, hi);
  }
  tmin = tmin != tmin ? tmin : fmaxf(tmin, 0.0f);
  bool alive = tmin <= tmax;
  const float entry = tmin + 1e-6f;
  float3 p = make_float3(o.x + d.x * entry, o.y + d.y * entry, o.z + d.z * entry);

  float vp[kVertices][3] = {};
  float vd[kVertices] = {};
  int cursor = 0;
  float thr = 1.0f;
  const int it = walk<kTrainCarry, kTrainPacked, kTrainOverlap, kTrainBricks>(
      v, key, p, d, alive, [&](int it, float3 q, float3& dir, float den, bool& live) {
        // register slots: unrolled so that the cursor does not index local memory
#pragma unroll
        for (int k = 0; k < kVertices; ++k) {
          if (k == cursor) {
            vp[k][0] = q.x;
            vp[k][1] = q.y;
            vp[k][2] = q.z;
            vd[k] = den;
          }
        }
        cursor += cursor < kVertices;
        const float ext = den / v.majorant;
        const float scatter_p = ext * v.albedo;
        const float z = uniform(key, it, 4);
        if (!(z < ext)) return;
        if (z < scatter_p) {
          const float3 nd = normalize3(normal3(key, it, 5));
          dir = normalize3(make_float3(dir.x * v.scattering + nd.x, dir.y * v.scattering + nd.y,
                                       dir.z * v.scattering + nd.z));
        } else {
          thr = 0.0f;
          live = false;
        }
      });
  const float3 sky = envmap(env, d);
  const float rgb[3] = {sky.x * thr, sky.y * thr, sky.z * thr};
#pragma unroll
  for (int k = 0; k < kVertices; ++k) {
    const int64_t s = e * kVertices + k;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      positions[s * 3 + c] = vp[k][c];
      targets[s * 4 + c] = rgb[c];
    }
    targets[s * 4 + 3] = vd[k];
    valid[s] = k < cursor;
  }
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
  float3 d = make_float3(dirs_in[3 * r], dirs_in[3 * r + 1], dirs_in[3 * r + 2]);
  bool alive = alive_in[r] != 0;
  float col = 0.0f, opa = 0.0f;
  const int it = walk<kGtCarry, kGtPacked, kGtOverlap, kGtBricks>(
      v, key, p, d, alive, [&](int, float3, float3&, float den, bool& live) {
        const float ext = fminf(fmaxf(den / v.majorant, 0.0f), 1.0f);
        const float a = ext * (1.0f - opa);
        col = col + a;
        opa = opa + a;
        live = opa <= 0.99000001f;
      });
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
  bool occ = kRoundCarry && it < kMaxIters && bit_occupied<kRoundPacked>(v, p);
  while (it < kMaxIters) {
    float den;
    event = advance<kRoundCarry, kRoundPacked, false, false, false>(v, key, it, p, d, occ,
                                                                    alive, den);
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

Volume make_volume(const void* bits, const void* packed, const void* density,
                   const void* bricks, long long nx, long long ny, long long nz,
                   const float* params, unsigned key) {
  Volume v;
  v.bits = static_cast<const uint8_t*>(bits);
  v.packed = static_cast<const uint32_t*>(packed);
  v.density = static_cast<const float*>(density);
  v.bricks = static_cast<const float*>(bricks);
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

extern "C" int volume_train_walk(const void* bits, const void* packed, const void* density,
                                 const void* bricks, long long nx, long long ny, long long nz,
                                 const float* params, unsigned key, const float* env,
                                 long long n, void* positions, void* targets, void* valid,
                                 void* steps, void* stream) {
  if (n <= 0) return 0;
  const Volume v = make_volume(bits, packed, density, bricks, nx, ny, nz, params, key);
  Envmap m;
  for (int a = 0; a < 3; ++a) {
    m.up[a] = env[a];
    m.sun[a] = env[3 + a];
    m.sky[a] = env[6 + a];
    m.sun_col[a] = env[9 + a];
  }
  train_walk_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      v, m, static_cast<int64_t>(n), static_cast<float*>(positions),
      static_cast<float*>(targets), static_cast<uint8_t*>(valid), static_cast<int*>(steps));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int volume_render_walk(const void* bits, const void* packed, const void* density,
                                  const void* bricks, long long nx, long long ny, long long nz,
                                  const float* params, unsigned key, int gt, const void* ids,
                                  void* pos, const void* dirs, void* alive, void* iters,
                                  long long n, void* col, void* opa, void* event, void* steps,
                                  void* stream) {
  if (n <= 0) return 0;
  const Volume v = make_volume(bits, packed, density, bricks, nx, ny, nz, params, key);
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

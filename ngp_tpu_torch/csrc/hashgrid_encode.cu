// Multiresolution hash/dense grid encoding for Hopper (sm_90a): the forward,
// its table gradient and its position gradient.
//
// Replaces the TPU kernel ngp_tpu/ops/pallas/hashgrid.py:_encode_kernel
// (hashgrid_encode_pallas). That kernel computes the XOR hash only; this one
// also computes the additive hash, which the JAX package evaluates with the
// XLA gather grid_dup_gather_blend (ngp_tpu/models/encodings.py). For each
// sample n and level l <= max_level:
//
//   p = x[n] * scale[l] + 0.5,  p0 = floor(p),  f = p - p0
//   out[n, l, :] = sum over the 2^D cell corners c of w_c * table[l, idx_c]
//
// with w_c the multilinear weight (product over d of f_d or 1 - f_d), and
//   hashed levels: idx_c = (c0 * 1 (^|+) c1 * 2654435761 (^|+) c2 * 805459861)
//                          & (size - 1), in uint32 arithmetic (negative
//                          corner coordinates wrap as int32 -> uint32);
//   dense levels:  idx_c = sum_d clip(c_d, 0, res - 1) * res^d, stride and
//                          sum in uint32, then & (size - 1) on a Tiled
//                          level whose res^D exceeds its size (it wraps
//                          modulo the size, a power of two, as the JAX
//                          package's `lin % size` does after the clip).
// With Simplex interpolation (the JAX package's _simplex_corners_weights,
// not tcnn's) a sample reads the D + 1 corners of the simplex of the cell's
// Kuhn triangulation that holds it, with barycentric weights (cell_corners);
// the JAX package computes it with the XLA gather grid_gather_blend, and
// the port with these kernels as a compile-time variant: a Simplex sample
// reads D + 1 rows where a Linear one reads 2^D.
// Levels above max_level are written as zeros. The output is (N, L, F)
// float32, i.e. (N, L*F) level-major. The table is (L, T, F), float32 or
// bf16; bf16 entries are widened to float32 before the blend. (Rounding a
// float32 table to bf16 inside the kernel, instead of the caller's cast,
// was measured slower than cast and kernel together: PERF.md.)
//
// Bound on the H100: per sample the kernel must read 4*D bytes of
// positions and write 4*L*F bytes of features, and each table row once. At
// the "tpu" tier (L=8, F=2, T=2^18) the table is 16 MB in float32 (8 MB in
// bf16) and stays in the 50 MB L2, so the DRAM floor is about
// (12 + 64) B/sample / 3.35 TB/s. What sets the pace are the 2^D * L table
// reads per sample, each a request to L1 and, where it misses, to L2 for
// one 32-byte sector. On uniform positions every lane of a load touches
// its own sector; on the positions a rendered frame gives (k-major
// compaction puts the k-th samples of neighbouring pixels side by side)
// the lanes of a warp share lines, above all on the coarse levels.
//
// Design, for that:
//   - Level-uniform warps. A warp encodes 32 consecutive samples, one a
//     lane, level after level, so each load instruction's lanes read one
//     level: neighbouring samples share its lines, the hashed/dense branch
//     is uniform, and no thread divides to find its (sample, level). A
//     warp takes at most 8 levels: with 16 (the "upstream" tier) a warp
//     walking all of them kept too few loads in flight (PERF.md).
//   - Geometry off the memory path: the per-level scale, resolution, mask
//     and hashed flag are a __grid_constant__ struct among the kernel's
//     arguments, read at the warp's (uniform) level from the constant bank.
//   - Outputs staged per warp: each warp gathers its (32, levels, F)
//     outputs in its own shared memory and writes each sample's run of
//     them with 16-byte stores. Warps never wait for one another: a
//     block-wide barrier made every warp wait for the block's slowest
//     level.
//   - One row per load. Fetching corners c and c + 1 (rows h and h + 1, or
//     h ^ 1) with one 16-byte load was measured (PERF.md): it cut the
//     requests on uniform positions but cost more than it saved where lanes
//     share lines, since a 16-byte load takes four L1 data cycles a warp
//     where a 4-byte one takes one.
// Products and sums are rounded one at a time (no FMA contraction) in the
// corner order, so the plain PyTorch twin in ngp_tpu_torch/ops/hashgrid.py
// reproduces the result bit for bit. Nothing of the TPU kernel's block
// layout (pack_table, 8192-row VMEM tiles, lane select) is carried over.
//
// Backward (hashgrid_backward), the port of the JAX package's _pge_bwd
// (ngp_tpu/models/encodings.py), the VJP that pairs with the TPU kernel,
// whose sum is segment_sum_sorted_blocks on the TPU:
//
//   d(table)[l, idx_c(x[n]), :] += bf16(w_c(x[n]) * g[n, l, :])
//
// summed in float32 over samples n and corners c, for levels l <=
// max_level; every other row stays +0.0. The corner rows and weights come
// from cell_corners, shared with the forward. Depositing corner by corner
// gives the JAX package's gradient on the dense top plane too: its
// additive path shifts the cell base down and pushes the fraction to 1
// there, the per-corner clamp puts the same total weight on the same row.
// Each addend is rounded to bf16 (round to nearest even) before it is
// added, the precision of the JAX package's default payload; the sum is
// float32, in an order atomics decide.
//
// Bound on the H100: the kernel must read x and g once and write d(table)
// once, N * (4D + 4LF) + 4LTF bytes (22.7 MB, 0.0068 ms at 3.35 TB/s for
// the training step's mean of 78,416 samples at the "tpu" tier). What sets
// its pace is the count of atomic reductions into L2: L * 2^D per sample,
// about 5.0 M a step. Design, for that:
//   - One kernel, no buffer: each corner's addend goes straight to its
//     row with a vector atomic (csrc/atomic_rows.cuh, shared with the
//     segment sum), where the kernel it replaces wrote (L, N * 2^D) keys
//     and (L, N * 2^D, F) addends, 768 B a sample at the "tpu" tier, for
//     csrc/segment_sum.cu to read back.
//   - Corners c and c + 1 (the x bit) paired inside the thread for F <= 2:
//     the same row (a dense level's clamp) is one atomic of their sum, rows
//     2r and 2r + 1 (the additive hash, the XOR hash at even x, a dense
//     level) one float2 / float4 atomic, on levels whose rows start on a
//     vector boundary (l * T even). All-zero vectors are skipped.
//   - Level-uniform warps: a warp takes 32 consecutive samples, one a lane,
//     at one level; consecutive warps take consecutive levels of the same
//     samples, so a block's warps share the lines of x and g, and the
//     card works on every level at once instead of crowding the coarse
//     levels' few rows one level after another. The geometry is the
//     forward's __grid_constant__ struct, read at the warp's level.
//   - One vector load of g[n, l, :] per (sample, level).
// Warp aggregation (lanes whose corners share a row summed by shuffles,
// one atomic for them, on warps whose samples share a cell) was measured
// and dropped: 20% slower on a training step's own positions, where the
// coarse levels crowd (PERF.md).
// With round_addends off (payload "float32") the backward sums each w_c * g
// unrounded: the d(table) of the JAX package's differentiable_inputs path,
// whose float32 take_along_axis gather autodiff transposes into a float32
// scatter-add (ngp_tpu/models/encodings.py:824-834). The training path keeps
// the bf16 rounding; the two are separate instantiations.
//
// Input gradient (hashgrid_input_grad): d(out)/dx contracted with the
// output cotangent g, the VJP with respect to positions that JAX autodiff
// computes through GridEncoding.__call__(..., differentiable_inputs=True)
// (ngp_tpu/models/encodings.py:785-834). It has no TPU kernel: the JAX
// package differentiates plain XLA gathers. For each sample n:
//
//   dx[n, d] = sum over l <= max_level of scale_l * sum over corners c of
//              s_cd * (sum_f g[n, l, f] * table[l, idx_c, f])
//                   * prod over d' != d of (bit_d'(c) ? f_d' : 1 - f_d')
//
// with s_cd = +1 where corner c takes the upper cell along d, else -1; the
// floor has no gradient. Corner rows come from cell_corners, so the hash,
// the dense clamp of each corner (two clamped corners on one row cancel)
// and the twice-rounded x * scale + 0.5 are the forward's. The table is
// read in float32, as the JAX package's differentiable path reads it.
//
// Bound on the H100: per sample it must read x (4D bytes) and g (4LF
// bytes) and write dx (4D bytes), and read each table row it reaches once:
// about (24 + 64) B a sample plus the rows at the "tpu" tier. Like the
// forward it is paced by its 2^D * L row loads a sample, each a 32-byte
// sector where the lanes of a load do not share lines; on tables larger
// than the L2 (base.json: 16 levels of up to 2^19 rows, 50-57 MB of level
// rows) a row that misses costs a DRAM sector. Design (each part measured
// against its alternatives on the card, PERF.md):
//   - One launch; a thread a sample walks its levels in order, so one
//     thread sums a sample's terms and no level order is left to atomics;
//     neighbouring samples are neighbouring lanes, so on a rendered frame's
//     positions a warp's loads share lines on the coarse levels.
//   - The block's cotangents are staged in shared memory with 16-byte
//     loads, kGradStageFloats a sample at a time (8 levels at F = 2), in
//     place of a strided load a lane a level. A stage of 32 floats (16
//     levels at once) ran up to 1.5x slower, and one of 8, 12 or 24 slower
//     on at least three of the four inputs PERF.md measures; 512 threads a
//     block beat 128, 192 and 256 on the three of them at D = 3.
//   - No branch in the corner loop: a level's hashed or dense indexing and
//     the hash variant are compile-time in the level's code (both bodies are
//     in the loop; a warp takes one at its level).
// Measured and dropped: level-parallel warps (a warp a level, or a pair of
// levels, of 32 samples, the terms summed in level order in shared memory)
// lost on a rendered frame's positions at 8 levels, where the coarse
// levels' warps wait at the barrier for the fine ones; level passes sized
// to the L2 (one launch a run of levels, dx carried) won on uniform
// positions but lost on the rendered positions the paths send.
// The sum is the twin's: per level, per corner a = sum_f g_f * row_f in
// feature order; a times the other dimensions' weight factors in dimension
// order, added to dfrac[d] for the upper corner and subtracted for the
// lower; then acc = acc + t_l level after level from acc = +0.0 (not from
// t_0: 0.0 + -0.0 is +0.0). Products and sums are rounded one at a time, so
// the twin in ngp_tpu_torch/ops/hashgrid.py gives the kernel's bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "atomic_rows.cuh"

namespace {

constexpr uint32_t kPrime1 = 2654435761u;
constexpr uint32_t kPrime2 = 805459861u;
constexpr int kThreads = 256;       // the backward's block
constexpr int kMaxLevels = 32;      // levels the geometry holds
constexpr int kWarpSamples = 32;    // samples a warp takes, one a lane
constexpr int kWarpLevels = 8;      // levels a forward warp encodes, at most
constexpr int kMaxBlockWarps = 8;   // warps a forward block has at most
constexpr int kMaxBlockSmem = 48 * 1024;
constexpr int kGradThreads = 512;      // an input-gradient block's threads (samples)
constexpr int kGradStageFloats = 16;   // a sample's cotangents a stage of its g tile holds

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Per-level geometry, passed by value among the kernels' arguments
// (mirrored by ctypes in ngp_tpu_torch/ops/hashgrid.py). The kernel takes it
// as a __grid_constant__ parameter, so that indexing it by the warp's level
// reads the parameter's constant bank instead of a local copy.
struct Geometry {
  float scale[kMaxLevels];
  int32_t res[kMaxLevels];
  uint32_t mask[kMaxLevels];  // ends every row index of the level (corner_row)
  int32_t hashed[kMaxLevels];
};

// Corners a sample reads at a level: the 2^D of its cell (Linear), or the
// D + 1 of the simplex of the cell's Kuhn triangulation that holds it
// (Simplex).
template <int D, bool Simplex>
constexpr int kCorners = Simplex ? D + 1 : 1 << D;

// Cell base and fractions of one sample at a level: p = x * scale + 0.5,
// rounded after the product and after the sum, p0 = floor(p), frac = p - p0.
template <int D>
__device__ __forceinline__ void cell_fraction(const float* __restrict__ xs, float scale,
                                              int (&p0)[D], float (&frac)[D]) {
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float p = __fadd_rn(__fmul_rn(xs[d], scale), 0.5f);
    const float fl = floorf(p);
    frac[d] = __fsub_rn(p, fl);
    p0[d] = static_cast<int>(fl);
  }
}

// Table row of one corner at a level, in uint32 arithmetic: the spatial
// hash of its coordinates on hashed levels (negative coordinates wrap as
// int32 -> uint32), else the linear index sum_d clip(c_d, 0, res - 1) *
// res^d with the stride and the sum wrapping modulo 2^32. Either ends in &
// mask: size - 1 where the level's size is a power of two (every hashed
// level, and a Tiled level whose res^D exceeds its rows, which wraps), all
// ones elsewhere (a dense index never reaches such a level's size).
template <int D>
__device__ __forceinline__ uint32_t corner_row(const int (&cc)[D], bool hashed, int res,
                                               uint32_t mask, int additive) {
  uint32_t h;
  if (hashed) {
    h = static_cast<uint32_t>(cc[0]);
    const uint32_t t1 = static_cast<uint32_t>(cc[1]) * kPrime1;
    h = additive ? h + t1 : h ^ t1;
    if (D == 3) {
      const uint32_t t2 = static_cast<uint32_t>(cc[D - 1]) * kPrime2;
      h = additive ? h + t2 : h ^ t2;
    }
  } else {
    h = 0;
    uint32_t stride = 1;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int v = min(max(cc[d], 0), res - 1);
      h += static_cast<uint32_t>(v) * stride;
      stride *= static_cast<uint32_t>(res);
    }
  }
  return h & mask;
}

// Ranks of the fractions, 0 for the largest; a tie ranks the lower
// dimension first: rank_d = #{e < d : f_e >= f_d} + #{e > d : f_e > f_d},
// the order of the JAX package's stable descending sort.
template <int D>
__device__ __forceinline__ void simplex_ranks(const float (&frac)[D], int (&rank)[D]) {
#pragma unroll
  for (int d = 0; d < D; ++d) {
    int r = 0;
#pragma unroll
    for (int e = 0; e < D; ++e) {
      if (e < d) r += frac[e] >= frac[d];
      if (e > d) r += frac[e] > frac[d];
    }
    rank[d] = r;
  }
}

// Table rows and weights of the corners of one sample at level l, and the
// cell fractions: the index math shared by the forward, the backward and
// the input gradient, so they cannot drift apart.
//   Linear: the 2^D cell corners in bit order (bit d of c: +1 along d),
//     w_c the product over d of f_d or 1 - f_d, in dimension order.
//   Simplex (the JAX package's _simplex_corners_weights): corner k
//     (k = 0..D) is p0 plus e_d for every d with rank_d < k; with g the
//     fractions sorted in descending order (g_j = f_d of rank j), the
//     weights are [1 - g_0, g_0 - g_1, ..., g_{D-2} - g_{D-1}, g_{D-1}].
template <int D, bool Simplex>
__device__ __forceinline__ void cell_corners(
    const float* __restrict__ xs, float scale, int res, bool hashed,
    uint32_t mask, int additive, uint32_t (&idx)[kCorners<D, Simplex>],
    float (&w)[kCorners<D, Simplex>], float (&frac)[D]) {
  int p0[D];
  cell_fraction<D>(xs, scale, p0, frac);
  if constexpr (Simplex) {
    int rank[D];
    simplex_ranks<D>(frac, rank);
    float g[D];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      g[j] = frac[D - 1];
#pragma unroll
      for (int d = D - 2; d >= 0; --d) g[j] = rank[d] == j ? frac[d] : g[j];
    }
    w[0] = __fsub_rn(1.0f, g[0]);
#pragma unroll
    for (int k = 1; k < D; ++k) w[k] = __fsub_rn(g[k - 1], g[k]);
    w[D] = g[D - 1];
#pragma unroll
    for (int k = 0; k <= D; ++k) {
      int cc[D];
#pragma unroll
      for (int d = 0; d < D; ++d) cc[d] = p0[d] + (rank[d] < k ? 1 : 0);
      idx[k] = corner_row<D>(cc, hashed, res, mask, additive);
    }
  } else {
#pragma unroll
    for (int c = 0; c < (1 << D); ++c) {
      float wc = 1.0f;
      int cc[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const int bit = (c >> d) & 1;
        wc = __fmul_rn(wc, bit ? frac[d] : __fsub_rn(1.0f, frac[d]));
        cc[d] = p0[d] + bit;
      }
      idx[c] = corner_row<D>(cc, hashed, res, mask, additive);
      w[c] = wc;
    }
  }
}

// acc += sum over the C corners of w_c * table[level + idx_c], corner by
// corner, each row one vector load.
template <int C, int F, typename T>
__device__ __forceinline__ void blend(const T* __restrict__ table, int64_t level,
                                      const uint32_t (&idx)[C],
                                      const float (&w)[C], float (&acc)[F]) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const Row<T, F> row =
        *reinterpret_cast<const Row<T, F>*>(table + (level + idx[c]) * F);
#pragma unroll
    for (int f = 0; f < F; ++f) {
      acc[f] = __fadd_rn(acc[f], __fmul_rn(w[c], to_float(row.v[f])));
    }
  }
}

// Shared memory a warp stages its outputs in: (levels, 32 * F + 1) floats,
// the padding word keeping the store phase's reads off one bank.
template <int F>
__host__ __device__ constexpr int warp_stage_floats(int levels) {
  return levels * (kWarpSamples * F + 1);
}

// Each warp encodes 32 samples, one a lane, over a run of at most
// kWarpLevels levels (run blockIdx.y), level after level. A warp stages its
// (32, levels, F) outputs in its own shared memory and writes each
// sample's run of levels with 16-byte stores. Warps never wait for one
// another.
template <int D, int F, typename T, bool Simplex>
__global__ void __launch_bounds__(kMaxBlockWarps * 32)
hashgrid_encode_kernel(const float* __restrict__ x, const T* __restrict__ table,
                       const __grid_constant__ Geometry geo,
                       float* __restrict__ out, int64_t n, int n_levels,
                       int64_t table_rows, int additive, int max_level) {
  extern __shared__ float smem[];
  constexpr int kLevelStride = kWarpSamples * F + 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t s0 =
      (static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp) * kWarpSamples;
  if (s0 >= n) return;
  const int l0 = static_cast<int>(blockIdx.y) * kWarpLevels;
  const int l1 = min(l0 + kWarpLevels, n_levels);
  const int here = static_cast<int>(n - s0 < kWarpSamples ? n - s0 : kWarpSamples);
  const bool live = lane < here;
  float xs[D];
#pragma unroll
  for (int d = 0; d < D; ++d) xs[d] = live ? x[(s0 + lane) * D + d] : 0.0f;
  float* os = smem + warp * warp_stage_floats<F>(min(n_levels, kWarpLevels));

  for (int l = l0; l < l1; ++l) {
    float acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = 0.0f;
    if (live && l <= max_level) {
      constexpr int C = kCorners<D, Simplex>;
      uint32_t idx[C];
      float w[C], frac[D];
      cell_corners<D, Simplex>(xs, geo.scale[l], geo.res[l], geo.hashed[l] != 0,
                               geo.mask[l], additive, idx, w, frac);
      blend<C, F, T>(table, l * table_rows, idx, w, acc);
    }
#pragma unroll
    for (int f = 0; f < F; ++f) os[(l - l0) * kLevelStride + lane * F + f] = acc[f];
  }
  __syncwarp();

  // sample s's levels l0 .. l1 - 1 are the run out[s0 + s, l0 * F ...] of
  // (l1 - l0) * F floats
  const int row = n_levels * F;
  const int run = (l1 - l0) * F;
  float* dst = out + s0 * row + l0 * F;
  auto at = [&](int s, int r) {
    const int l = r / F;
    return os[l * kLevelStride + s * F + (r - l * F)];
  };
  if ((run & 3) == 0 && (row & 3) == 0) {
    for (int q = lane; q < here * run / 4; q += 32) {
      const int s = 4 * q / run;
      const int r = 4 * q - s * run;
      *reinterpret_cast<float4*>(dst + s * row + r) =
          make_float4(at(s, r), at(s, r + 1), at(s, r + 2), at(s, r + 3));
    }
  } else {
    for (int i = lane; i < here * run; i += 32) {
      const int s = i / run;
      const int r = i - s * run;
      dst[s * row + r] = at(s, r);
    }
  }
}

// Backward: warp w of the grid takes samples 32 * (w / levels) onwards at
// level w % levels (levels = min(L, max_level + 1)), one sample a lane, and
// adds each corner's w_c * g[s, l, :], bf16-rounded where Round, to its row
// of out. Simplex corners go one atomic each: their count D + 1 is odd at
// D = 2, and corners k and k + 1 differ along the dimension of rank k, not
// along x, so the pairing below (corners c and c + 1, rows 2r and 2r + 1)
// does not apply.
template <int D, int F, bool Round, bool Simplex>
__global__ void __launch_bounds__(kThreads)
hashgrid_backward_kernel(const float* __restrict__ x, const float* __restrict__ g,
                         const __grid_constant__ Geometry geo,
                         float* __restrict__ out, int64_t n, int n_levels,
                         int levels, int64_t table_rows, int additive) {
  constexpr int C = kCorners<D, Simplex>;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int l = static_cast<int>(warp % levels);
  const int64_t s = (warp / levels) * kWarpSamples + (threadIdx.x & 31);
  if (s >= n) return;

  uint32_t idx[C];
  float w[C], frac[D];
  cell_corners<D, Simplex>(x + s * D, geo.scale[l], geo.res[l], geo.hashed[l] != 0,
                           geo.mask[l], additive, idx, w, frac);
  const Row<float, F> gl =
      *reinterpret_cast<const Row<float, F>*>(g + (s * n_levels + l) * F);
  float* o = out + l * table_rows * F;
  if constexpr (Simplex) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      Row<float, F> a;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        a.v[f] = __fmul_rn(w[c], gl.v[f]);
        if constexpr (Round) a.v[f] = round_bf16(a.v[f]);
      }
      add_to_device<F>(o + static_cast<int64_t>(idx[c]) * F, a);
    }
  } else {
    const bool pair = (l * table_rows) % 2 == 0;  // o on a vector boundary
#pragma unroll
    for (int c = 0; c < C; c += 2) {
      Row<float, F> a0, a1;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        a0.v[f] = __fmul_rn(w[c], gl.v[f]);
        a1.v[f] = __fmul_rn(w[c + 1], gl.v[f]);
        if constexpr (Round) {
          a0.v[f] = round_bf16(a0.v[f]);
          a1.v[f] = round_bf16(a1.v[f]);
        }
      }
      const int32_t k0 = static_cast<int32_t>(idx[c]);
      const int32_t k1 = static_cast<int32_t>(idx[c + 1]);
      if constexpr (F <= 2) {
        if (pair && rows_pair(k0, k1)) {
          add_pair<F>(o, k0, a0, k1, a1);
          continue;
        }
      }
      add_to_device<F>(o + static_cast<int64_t>(k0) * F, a0);
      add_to_device<F>(o + static_cast<int64_t>(k1) * F, a1);
    }
  }
}

// One level's term of the input gradient for one sample: t[d] = dfrac[d] *
// scale_l, dfrac the gradient of the level's blend with respect to the cell
// fractions. `Hashed` and `Add` (the hash variant) are compile-time, so the
// corner loop carries no branch. a = sum_f g_f * row_f starts from
// g_0 * row_0 where the twin starts from 0.0 + g_0 * row_0: the two differ at
// most in the sign of a zero, which no dfrac keeps (dfrac starts at +0.0,
// and +0.0 plus or minus a zero is +0.0), so the bits are the twin's.
//
// Simplex: out = sum_k w_k a_k with a_k = sum_f g_f * row_k,f and w the
// differences of the sorted fractions g, so d(out)/d(g_j) = a_{j+1} - a_j,
// and the fraction of rank j takes it: dfrac[d] = a_{rank_d + 1} -
// a_{rank_d} (the JAX package's autodiff through its sort). There a zero's
// sign can reach dfrac (-0.0 - +0.0), but not dx: the level sum starts at
// +0.0 and adding a zero of either sign to it, or to any nonzero sum,
// leaves it as it is.
template <int D, int F, int Add, bool Hashed, bool Simplex>
__device__ __forceinline__ void input_grad_level_as(const float (&xs)[D], const float (&gl)[F],
                                                    const float* __restrict__ table,
                                                    const Geometry& geo, int l,
                                                    int64_t table_rows, float (&t)[D]) {
  constexpr int C = kCorners<D, Simplex>;
  uint32_t idx[C];
  float w[C], frac[D];
  cell_corners<D, Simplex>(xs, geo.scale[l], geo.res[l], Hashed, geo.mask[l], Add, idx, w,
                           frac);
  const float* rows = table + l * table_rows * F;
  if constexpr (Simplex) {
    float a[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const Row<float, F> r = *reinterpret_cast<const Row<float, F>*>(
          rows + static_cast<size_t>(idx[c]) * F);
      a[c] = __fmul_rn(gl[0], r.v[0]);
#pragma unroll
      for (int f = 1; f < F; ++f) a[c] = __fadd_rn(a[c], __fmul_rn(gl[f], r.v[f]));
    }
    int rank[D];
    simplex_ranks<D>(frac, rank);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      float dg = __fsub_rn(a[D], a[D - 1]);
#pragma unroll
      for (int j = D - 2; j >= 0; --j) dg = rank[d] == j ? __fsub_rn(a[j + 1], a[j]) : dg;
      t[d] = __fmul_rn(dg, geo.scale[l]);
    }
    return;
  }
  float dfrac[D];
#pragma unroll
  for (int d = 0; d < D; ++d) dfrac[d] = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const Row<float, F> r = *reinterpret_cast<const Row<float, F>*>(
        rows + static_cast<size_t>(idx[c]) * F);
    float a = __fmul_rn(gl[0], r.v[0]);  // d(out)/d(w_c)
#pragma unroll
    for (int f = 1; f < F; ++f) a = __fadd_rn(a, __fmul_rn(gl[f], r.v[f]));
#pragma unroll
    for (int d = 0; d < D; ++d) {
      float p = a;
#pragma unroll
      for (int e = 0; e < D; ++e) {
        if (e == d) continue;
        p = __fmul_rn(p, ((c >> e) & 1) ? frac[e] : __fsub_rn(1.0f, frac[e]));
      }
      dfrac[d] = ((c >> d) & 1) ? __fadd_rn(dfrac[d], p) : __fsub_rn(dfrac[d], p);
    }
  }
#pragma unroll
  for (int d = 0; d < D; ++d) t[d] = __fmul_rn(dfrac[d], geo.scale[l]);
}

template <int D, int F, int Add, bool Simplex>
__device__ __forceinline__ void input_grad_level(const float (&xs)[D], const float (&gl)[F],
                                                 const float* __restrict__ table,
                                                 const Geometry& geo, int l,
                                                 int64_t table_rows, float (&t)[D]) {
  if (geo.hashed[l]) {
    input_grad_level_as<D, F, Add, true, Simplex>(xs, gl, table, geo, l, table_rows, t);
  } else {
    input_grad_level_as<D, F, Add, false, Simplex>(xs, gl, table, geo, l, table_rows, t);
  }
}

// Input gradient: a thread a sample, kGradThreads samples a block (a
// compile-time count: the same code with blockDim.x, or with the level's
// row pointer taken outside the level's code, compiled to markedly slower
// code for the card), levels 0 .. levels - 1 in order from dx = +0.0. The
// levels go in stages of kGradStageFloats / F: the block copies its
// samples' cotangents of a stage's levels (contiguous runs of g) into
// shared memory with 16-byte loads where the layout allows, behind a
// barrier, in place of a strided load a lane a level; the tile of one
// stage keeps the block's shared memory small enough not to cut the
// number of blocks an SM holds.
template <int D, int F, int Add, bool Simplex>
__global__ void __launch_bounds__(kGradThreads)
hashgrid_input_grad_kernel(const float* __restrict__ x, const float* __restrict__ g,
                           const float* __restrict__ table,
                           const __grid_constant__ Geometry geo,
                           float* __restrict__ dx, int64_t n, int n_levels,
                           int levels, int64_t table_rows) {
  constexpr int kStageLevels = kGradStageFloats / F;
  constexpr int kStride = (kStageLevels * F) | 1;  // odd: a warp's reads of a level hit 32 banks
  __shared__ float tile[kGradThreads * kStride];
  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * kGradThreads;
  const int here = static_cast<int>(n - s0 < kGradThreads ? n - s0 : kGradThreads);
  const bool live = static_cast<int>(threadIdx.x) < here;
  const int64_t s = s0 + threadIdx.x;
  const int64_t row = static_cast<int64_t>(n_levels) * F;
  const bool quads = ((row & 3) == 0) && (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  const float* gs = tile + threadIdx.x * kStride;
  float xs[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    xs[d] = live ? x[s * D + d] : 0.0f;
    acc[d] = 0.0f;
  }
  for (int l0 = 0; l0 < levels; l0 += kStageLevels) {
    const int stage = levels - l0 < kStageLevels ? levels - l0 : kStageLevels;
    const int run = stage * F;
    const float* gb = g + s0 * row + l0 * F;
    if (l0 > 0) __syncthreads();  // every thread is done with the last stage
    if (quads && (run & 3) == 0) {
      const int q4 = run >> 2;
      for (int q = threadIdx.x; q < here * q4; q += kGradThreads) {
        const int i = q / q4;
        const int r = (q - i * q4) << 2;
        const float4 v = *reinterpret_cast<const float4*>(gb + i * row + r);
        float* dst = tile + i * kStride + r;
        dst[0] = v.x;
        dst[1] = v.y;
        dst[2] = v.z;
        dst[3] = v.w;
      }
    } else {
      for (int q = threadIdx.x; q < here * run; q += kGradThreads) {
        const int i = q / run;
        tile[i * kStride + (q - i * run)] = gb[i * row + (q - i * run)];
      }
    }
    __syncthreads();
    if (!live) continue;
    for (int l = l0; l < l0 + stage; ++l) {
      float gl[F], t[D];
#pragma unroll
      for (int f = 0; f < F; ++f) gl[f] = gs[(l - l0) * F + f];
      input_grad_level<D, F, Add, Simplex>(xs, gl, table, geo, l, table_rows, t);
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = __fadd_rn(acc[d], t[d]);
    }
  }
  if (!live) return;
#pragma unroll
  for (int d = 0; d < D; ++d) dx[s * D + d] = acc[d];
}

struct Forward {
  const float* x;
  const void* table;
  const Geometry* geo;
  float* out;
  int64_t n;
  int n_levels;
  int64_t table_rows;
  int additive;
  int max_level;
};

template <int D, int F, typename T, bool Simplex>
int launch(const Forward& a, cudaStream_t stream) {
  // as many warps a block as keep its staging within 48 KB
  const int warp_bytes =
      warp_stage_floats<F>(a.n_levels < kWarpLevels ? a.n_levels : kWarpLevels) *
      static_cast<int>(sizeof(float));
  int warps = kMaxBlockSmem / warp_bytes;
  warps = warps < 1 ? 1 : (warps > kMaxBlockWarps ? kMaxBlockWarps : warps);
  const int64_t groups = (a.n + kWarpSamples - 1) / kWarpSamples;
  const dim3 blocks(static_cast<unsigned>((groups + warps - 1) / warps),
                    (a.n_levels + kWarpLevels - 1) / kWarpLevels);
  hashgrid_encode_kernel<D, F, T, Simplex>
      <<<blocks, warps * 32,
         static_cast<size_t>(warps) * warp_bytes, stream>>>(
          a.x, static_cast<const T*>(a.table), *a.geo, a.out, a.n, a.n_levels,
          a.table_rows, a.additive, a.max_level);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int F, bool Simplex>
int dispatch_table(int table_bf16, const Forward& a, cudaStream_t stream) {
  return table_bf16 ? launch<D, F, __nv_bfloat16, Simplex>(a, stream)
                    : launch<D, F, float, Simplex>(a, stream);
}

template <int D, bool Simplex>
int dispatch_features(int n_features, int table_bf16, const Forward& a,
                      cudaStream_t stream) {
  switch (n_features) {
    case 1: return dispatch_table<D, 1, Simplex>(table_bf16, a, stream);
    case 2: return dispatch_table<D, 2, Simplex>(table_bf16, a, stream);
    case 4: return dispatch_table<D, 4, Simplex>(table_bf16, a, stream);
    case 8: return dispatch_table<D, 8, Simplex>(table_bf16, a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

struct Backward {
  const float* x;
  const float* g;
  const Geometry* geo;
  float* out;
  int64_t n;
  int n_levels;
  int levels;
  int64_t table_rows;
  int additive;
};

template <int D, int F, bool Simplex>
int launch_backward(const Backward& a, int round_addends, cudaStream_t stream) {
  const int64_t warps = (a.n + kWarpSamples - 1) / kWarpSamples * a.levels;
  const unsigned blocks =
      static_cast<unsigned>((warps * 32 + kThreads - 1) / kThreads);
  if (round_addends) {
    hashgrid_backward_kernel<D, F, true, Simplex><<<blocks, kThreads, 0, stream>>>(
        a.x, a.g, *a.geo, a.out, a.n, a.n_levels, a.levels, a.table_rows, a.additive);
  } else {
    hashgrid_backward_kernel<D, F, false, Simplex><<<blocks, kThreads, 0, stream>>>(
        a.x, a.g, *a.geo, a.out, a.n, a.n_levels, a.levels, a.table_rows, a.additive);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool Simplex>
int dispatch_backward(int n_features, const Backward& a, int round_addends,
                      cudaStream_t stream) {
  switch (n_features) {
    case 1: return launch_backward<D, 1, Simplex>(a, round_addends, stream);
    case 2: return launch_backward<D, 2, Simplex>(a, round_addends, stream);
    case 4: return launch_backward<D, 4, Simplex>(a, round_addends, stream);
    case 8: return launch_backward<D, 8, Simplex>(a, round_addends, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The input gradient's launch: Backward's fields, `out` being dx and
// `table` the float32 table.
template <int D, int F, int Add, bool Simplex>
int launch_input_grad(const Backward& a, const float* table, cudaStream_t stream) {
  const unsigned blocks =
      static_cast<unsigned>((a.n + kGradThreads - 1) / kGradThreads);
  hashgrid_input_grad_kernel<D, F, Add, Simplex><<<blocks, kGradThreads, 0, stream>>>(
      a.x, a.g, table, *a.geo, a.out, a.n, a.n_levels, a.levels, a.table_rows);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int F, bool Simplex>
int dispatch_hash(const Backward& a, const float* table, cudaStream_t stream) {
  return a.additive ? launch_input_grad<D, F, 1, Simplex>(a, table, stream)
                    : launch_input_grad<D, F, 0, Simplex>(a, table, stream);
}

template <int D, bool Simplex>
int dispatch_input_grad(int n_features, const Backward& a, const float* table,
                        cudaStream_t stream) {
  switch (n_features) {
    case 1: return dispatch_hash<D, 1, Simplex>(a, table, stream);
    case 2: return dispatch_hash<D, 2, Simplex>(a, table, stream);
    case 4: return dispatch_hash<D, 4, Simplex>(a, table, stream);
    case 8: return dispatch_hash<D, 8, Simplex>(a, table, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The instantiation of (n_dims, simplex): fn<D, Simplex>(args...), or
// cudaErrorInvalidValue for a D the kernels do not take.
template <template <int, bool> class Fn, typename... Args>
int dispatch_dims(int n_dims, int simplex, Args... args) {
  switch (n_dims * 2 + (simplex ? 1 : 0)) {
    case 4: return Fn<2, false>::run(args...);
    case 5: return Fn<2, true>::run(args...);
    case 6: return Fn<3, false>::run(args...);
    case 7: return Fn<3, true>::run(args...);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int D, bool Simplex>
struct ForwardFn {
  static int run(int n_features, int table_bf16, Forward a, cudaStream_t s) {
    return dispatch_features<D, Simplex>(n_features, table_bf16, a, s);
  }
};

template <int D, bool Simplex>
struct BackwardFn {
  static int run(int n_features, Backward a, int round_addends, cudaStream_t s) {
    return dispatch_backward<D, Simplex>(n_features, a, round_addends, s);
  }
};

template <int D, bool Simplex>
struct InputGradFn {
  static int run(int n_features, Backward a, const float* table, cudaStream_t s) {
    return dispatch_input_grad<D, Simplex>(n_features, a, table, s);
  }
};

}  // namespace

// C interface, bound with ctypes by ngp_tpu_torch/ops/hashgrid.py. Pointers
// are device pointers of contiguous tensors, except `geometry`, a host
// pointer to the per-level Geometry (copied into the launch's arguments).
// `simplex` picks the interpolation: 0 Linear (2^D cell corners), 1 Simplex
// (D + 1 corners). Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int hashgrid_encode(const void* x, const void* table,
                               const void* geometry, void* out, long long n,
                               int n_levels, long long table_rows,
                               int n_features, int n_dims, int table_bf16,
                               int additive, int max_level, int simplex, void* stream) {
  if (n <= 0) return 0;
  if (n_levels < 1 || n_levels > kMaxLevels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Forward a{static_cast<const float*>(x), table,
                  static_cast<const Geometry*>(geometry), static_cast<float*>(out),
                  static_cast<int64_t>(n), n_levels,
                  static_cast<int64_t>(table_rows), additive, max_level};
  return dispatch_dims<ForwardFn>(n_dims, simplex, n_features, table_bf16, a,
                                  static_cast<cudaStream_t>(stream));
}

// d(table) (L, table_rows, F) float32 of hashgrid_encode with respect to its
// table, given positions x (N, D) and the output cotangent g (N, L * F),
// added into `out`, which the caller zeroes; each addend rounded to bf16
// where round_addends is not 0. Same conventions as above.
extern "C" int hashgrid_backward(const void* x, const void* g,
                                 const void* geometry, void* out, long long n,
                                 int n_levels, long long table_rows,
                                 int n_features, int n_dims, int additive,
                                 int max_level, int round_addends, int simplex,
                                 void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int levels = max_level + 1 < n_levels ? max_level + 1 : n_levels;
  if (n <= 0 || levels <= 0) return 0;
  const Backward a{static_cast<const float*>(x), static_cast<const float*>(g),
                   static_cast<const Geometry*>(geometry), static_cast<float*>(out),
                   static_cast<int64_t>(n), n_levels, levels,
                   static_cast<int64_t>(table_rows), additive};
  return dispatch_dims<BackwardFn>(n_dims, simplex, n_features, a, round_addends,
                                   static_cast<cudaStream_t>(stream));
}

// dx (N, D) float32, the gradient of sum(g * hashgrid_encode(x, table)) with
// respect to x, for a float32 table (L, table_rows, F); written whole (levels
// above max_level add nothing). Same conventions as above.
extern "C" int hashgrid_input_grad(const void* x, const void* g, const void* table,
                                   const void* geometry, void* dx, long long n,
                                   int n_levels, long long table_rows,
                                   int n_features, int n_dims, int additive,
                                   int max_level, int simplex, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return 0;
  const int levels = max_level + 1 < n_levels ? max_level + 1 : n_levels;
  const Backward a{static_cast<const float*>(x), static_cast<const float*>(g),
                   static_cast<const Geometry*>(geometry), static_cast<float*>(dx),
                   static_cast<int64_t>(n), n_levels, levels < 0 ? 0 : levels,
                   static_cast<int64_t>(table_rows), additive};
  return dispatch_dims<InputGradFn>(n_dims, simplex, n_features, a,
                                    static_cast<const float*>(table),
                                    static_cast<cudaStream_t>(stream));
}

extern "C" const char* hashgrid_encode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

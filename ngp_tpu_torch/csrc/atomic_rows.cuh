// Rows of F float32 features added atomically to a dense (rows, F) table in
// device memory: the deposit step shared by the segment sum
// (csrc/segment_sum.cu) and the fused grid backward
// (csrc/hashgrid_encode.cu), so that both pair and skip addends by one rule.
//
//   - Vector atomics: sm_90 adds a float2 or a float4 in one reduction
//     (RED.E.ADD.F32x2 / F32x4), so a row of F = 2 or 4 is one atomic and
//     F = 8 two.
//   - Pairs: two addends for the same row go as one atomic of their sum;
//     two for rows 2r and 2r + 1 as one vector atomic of 2F floats, for
//     F <= 2. The vector needs rows 2r and 2r + 1 to start on a 2F-float
//     boundary, which holds on a level whose first row l * T is even; the
//     caller says so.
//   - A vector whose components are all zero is skipped, so a row that no
//     nonzero addend touches stays +0.0.
//   - Addends are rounded to bf16 (round to nearest even) before they are
//     added where the JAX package's default payload asks for it; the sum
//     itself is float32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// F features of one row, loaded, stored or added as a single aligned vector.
template <typename T, int F>
struct alignas(sizeof(T) * F) Row {
  T v[F];
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Adds a row to device memory: one float2 or float4 atomic per vector of
// the row, skipping a vector whose components are all zero.
template <int F>
__device__ __forceinline__ void add_to_device(float* dst, const Row<float, F>& a) {
  if constexpr (F == 1) {
    if (a.v[0] != 0.0f) atomicAdd(dst, a.v[0]);
  } else if constexpr (F == 2) {
    if (a.v[0] != 0.0f || a.v[1] != 0.0f)
      atomicAdd(reinterpret_cast<float2*>(dst), make_float2(a.v[0], a.v[1]));
  } else {
#pragma unroll
    for (int q = 0; q < F; q += 4) {
      if (a.v[q] != 0.0f || a.v[q + 1] != 0.0f || a.v[q + 2] != 0.0f ||
          a.v[q + 3] != 0.0f)
        atomicAdd(reinterpret_cast<float4*>(dst + q),
                  make_float4(a.v[q], a.v[q + 1], a.v[q + 2], a.v[q + 3]));
    }
  }
}

// Whether addends for rows k0 and k1 (both >= 0) go as one atomic: the
// same row, or rows 2r and 2r + 1 in either order.
__device__ __forceinline__ bool rows_pair(int32_t k0, int32_t k1) {
  return k0 == k1 || (k0 ^ k1) == 1;
}

// One atomic for addends a0, a1 of rows k0, k1 that pair (rows_pair; F <= 2,
// on a level whose rows start on a vector boundary): their sum on a shared
// row, or rows 2r and 2r + 1 as one vector of 2F floats.
template <int F>
__device__ __forceinline__ void add_pair(float* out, int32_t k0,
                                         const Row<float, F>& a0, int32_t k1,
                                         const Row<float, F>& a1) {
  static_assert(F <= 2, "pairs are one vector atomic for F <= 2 only");
  if (k0 == k1) {
    Row<float, F> s;
#pragma unroll
    for (int f = 0; f < F; ++f) s.v[f] = a0.v[f] + a1.v[f];
    add_to_device<F>(out + static_cast<int64_t>(k0) * F, s);
    return;
  }
  Row<float, 2 * F> w;
#pragma unroll
  for (int f = 0; f < F; ++f) {
    w.v[f] = k0 < k1 ? a0.v[f] : a1.v[f];
    w.v[F + f] = k0 < k1 ? a1.v[f] : a0.v[f];
  }
  add_to_device<2 * F>(out + static_cast<int64_t>(k0 & ~1) * F, w);
}

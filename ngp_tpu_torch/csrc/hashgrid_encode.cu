// Multiresolution hash/dense grid encoding, forward, for Hopper (sm_90a).
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
//   dense levels:  idx_c = sum_d clip(c_d, 0, res - 1) * res^d.
// Levels above max_level are written as zeros. The output is (N, L, F)
// float32, i.e. (N, L*F) level-major. The table is (L, T, F), float32 or
// bf16; bf16 entries are widened to float32 before the blend.
//
// Bound on the H100: per sample the kernel must read 4*D bytes of
// positions and write 4*L*F bytes of features. The table is small: at the
// "tpu" tier (L=8, F=2, T=2^18) it is 16 MB in float32 (8 MB in bf16) and
// stays in the 50 MB L2, so the DRAM floor is about (12 + 64) B/sample /
// 3.35 TB/s. What will more likely hold it back are the 2^D * L random
// table reads per sample, served from L2 at one sector each.
//
// Design (a first, simple one): one thread per (sample, level), threads
// sample-major so that a warp's output stores are contiguous; the 2^D
// corners are unrolled and each corner's F features are one vector load
// (up to 16 bytes; F = 8 in float32 is two). Products and sums are rounded
// one at a time (no FMA contraction) so that the plain PyTorch twin in
// ngp_tpu_torch/ops/hashgrid.py reproduces the arithmetic. Nothing of the
// TPU kernel's block layout (pack_table, 8192-row VMEM tiles, lane select)
// is carried over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kPrime1 = 2654435761u;
constexpr uint32_t kPrime2 = 805459861u;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// F features of one table row (or one output row), loaded or stored as a
// single aligned vector.
template <typename T, int F>
struct alignas(sizeof(T) * F) Row {
  T v[F];
};

struct Args {
  const float* x;
  const void* table;
  const float* level_scale;
  const int32_t* level_res;
  const int32_t* level_size;
  const int32_t* level_hashed;
  float* out;
  int64_t n;
  int n_levels;
  int64_t table_rows;
  int additive;
  int max_level;
};

template <int D, int F, typename T>
__global__ void __launch_bounds__(kThreads)
hashgrid_encode_kernel(const float* __restrict__ x, const T* __restrict__ table,
                       const float* __restrict__ level_scale,
                       const int32_t* __restrict__ level_res,
                       const int32_t* __restrict__ level_size,
                       const int32_t* __restrict__ level_hashed,
                       float* __restrict__ out, int64_t n, int n_levels,
                       int64_t table_rows, int additive, int max_level) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n * n_levels) return;
  const int64_t s = i / n_levels;
  const int l = static_cast<int>(i - s * n_levels);

  Row<float, F> acc;
#pragma unroll
  for (int f = 0; f < F; ++f) acc.v[f] = 0.0f;

  if (l <= max_level) {
    const float scale = level_scale[l];
    const int res = level_res[l];
    const bool hashed = level_hashed[l] != 0;
    const uint32_t mask = static_cast<uint32_t>(level_size[l]) - 1u;

    float frac[D];
    int p0[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float p = __fadd_rn(__fmul_rn(x[s * D + d], scale), 0.5f);
      const float fl = floorf(p);
      frac[d] = __fsub_rn(p, fl);
      p0[d] = static_cast<int>(fl);
    }

    const T* tl = table + static_cast<int64_t>(l) * table_rows * F;
#pragma unroll
    for (int c = 0; c < (1 << D); ++c) {
      float w = 1.0f;
      int cc[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const int bit = (c >> d) & 1;
        w = __fmul_rn(w, bit ? frac[d] : __fsub_rn(1.0f, frac[d]));
        cc[d] = p0[d] + bit;
      }
      uint32_t idx;
      if (hashed) {
        idx = static_cast<uint32_t>(cc[0]);
        const uint32_t t1 = static_cast<uint32_t>(cc[1]) * kPrime1;
        idx = additive ? idx + t1 : idx ^ t1;
        if (D == 3) {
          const uint32_t t2 = static_cast<uint32_t>(cc[D - 1]) * kPrime2;
          idx = additive ? idx + t2 : idx ^ t2;
        }
        idx &= mask;
      } else {
        idx = 0;
        uint32_t stride = 1;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const int v = min(max(cc[d], 0), res - 1);
          idx += static_cast<uint32_t>(v) * stride;
          stride *= static_cast<uint32_t>(res);
        }
      }
      const Row<T, F> row =
          *reinterpret_cast<const Row<T, F>*>(tl + static_cast<int64_t>(idx) * F);
#pragma unroll
      for (int f = 0; f < F; ++f) {
        acc.v[f] = __fadd_rn(acc.v[f], __fmul_rn(w, to_float(row.v[f])));
      }
    }
  }
  *reinterpret_cast<Row<float, F>*>(out + i * F) = acc;
}

template <int D, int F, typename T>
int launch(const Args& a, cudaStream_t stream) {
  const int64_t total = a.n * a.n_levels;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  hashgrid_encode_kernel<D, F, T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      a.x, static_cast<const T*>(a.table), a.level_scale, a.level_res,
      a.level_size, a.level_hashed, a.out, a.n, a.n_levels, a.table_rows,
      a.additive, a.max_level);
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename T>
int dispatch_features(int n_features, const Args& a, cudaStream_t stream) {
  switch (n_features) {
    case 1: return launch<D, 1, T>(a, stream);
    case 2: return launch<D, 2, T>(a, stream);
    case 4: return launch<D, 4, T>(a, stream);
    case 8: return launch<D, 8, T>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_dims(int n_dims, int n_features, const Args& a, cudaStream_t stream) {
  switch (n_dims) {
    case 2: return dispatch_features<2, T>(n_features, a, stream);
    case 3: return dispatch_features<3, T>(n_features, a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C interface, bound with ctypes by ngp_tpu_torch/ops/hashgrid.py. Pointers
// are device pointers of contiguous tensors; returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int hashgrid_encode(const void* x, const void* table,
                               const void* level_scale, const void* level_res,
                               const void* level_size, const void* level_hashed,
                               void* out, long long n, int n_levels,
                               long long table_rows, int n_features, int n_dims,
                               int table_bf16, int additive, int max_level,
                               void* stream) {
  if (n <= 0) return 0;
  const Args a{static_cast<const float*>(x), table,
               static_cast<const float*>(level_scale),
               static_cast<const int32_t*>(level_res),
               static_cast<const int32_t*>(level_size),
               static_cast<const int32_t*>(level_hashed),
               static_cast<float*>(out), static_cast<int64_t>(n), n_levels,
               static_cast<int64_t>(table_rows), additive, max_level};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return table_bf16 ? dispatch_dims<__nv_bfloat16>(n_dims, n_features, a, s)
                    : dispatch_dims<float>(n_dims, n_features, a, s);
}

extern "C" const char* hashgrid_encode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

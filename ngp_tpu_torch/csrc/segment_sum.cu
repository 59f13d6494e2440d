// Dense segment sum and key histogram of unsorted keys, for Hopper (sm_90a).
//
// segment_sum replaces the TPU kernels
//   ngp_tpu/ops/pallas/segsum_sorted.py:_segsum_sorted_kernel
//     (segment_sum_sorted_blocks: keys sorted per level, block_starts windows,
//      kron-factored one-hot matmuls), and
//   ngp_tpu/ops/pallas/segsum.py:_kernel with F >= 1 (segment_sum_onehot);
// segment_count replaces
//   ngp_tpu/ops/pallas/segsum.py:_kernel_count_batched
//     (segment_count_onehot_batched, int8 one-hot matmuls), and
//   ngp_tpu/ops/pallas/segsum.py:_kernel with F = 0 (segment_count_onehot).
//
//   segment_sum:   out[l, t, f] = sum_j vals[l, j, f] * [keys[l, j] == t]
//   segment_count: out[l, t]    = sum_j [keys[l, j] == t]
//
// keys (L, M) int32 in [0, T), in any order; vals (L, M, F) float32,
// F in {1, 2, 4, 8}; out (L, T, F) float32 / (L, T) int32, zeroed by the
// caller. Keys outside [0, T) are skipped. With bf16 payloads each addend is
// first rounded to bf16 (round to nearest even), the precision of the JAX
// package's default payload_dtype; the sum itself is float32.
//
// The TPU needed the sort, the windows and the one-hot matmuls because XLA's
// scatter serializes there. Hopper has float and integer atomics in L2, so
// the design is one thread per (level, element) with one atomicAdd per
// nonzero addend: no sort, no windows. Zero addends (levels above
// max_level, samples whose cotangent is zero) skip the atomic.
//
// Bound on the H100: the kernel must read M * (4 + 4F) bytes per level and
// write the dense table once, 4 * L * T * F bytes; at the "tpu" tier that is
// about 126 MB + 16 MB, some 0.04 ms at 3.35 TB/s. The atomics cost more:
// on an H100 the kernel runs at about 5x that bound at the training step's
// shapes (chip_smoke.py, phase kernel_train), though the coarse dense levels
// (level 0 has 16^3 = 4096 rows for a million addends) take no more than
// their share. Privatizing small levels in shared memory and packed bf16x2
// atomics are the later levers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int F>
struct alignas(4 * F) Row {
  float v[F];
};

template <int F, bool kBf16>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const int32_t* __restrict__ keys,
                   const float* __restrict__ vals, float* __restrict__ out,
                   int64_t m, int n_levels, int64_t n_segments) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= m * n_levels) return;
  const int32_t key = keys[i];
  if (key < 0 || key >= n_segments) return;
  const int64_t l = i / m;
  const Row<F> row = *reinterpret_cast<const Row<F>*>(vals + i * F);
  float* dst = out + (l * n_segments + key) * F;
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const float a =
        kBf16 ? __bfloat162float(__float2bfloat16_rn(row.v[f])) : row.v[f];
    if (a != 0.0f) atomicAdd(dst + f, a);
  }
}

__global__ void __launch_bounds__(kThreads)
segment_count_kernel(const int32_t* __restrict__ keys, int32_t* __restrict__ out,
                     int64_t m, int n_levels, int64_t n_segments) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= m * n_levels) return;
  const int32_t key = keys[i];
  if (key < 0 || key >= n_segments) return;
  atomicAdd(out + (i / m) * n_segments + key, 1);
}

int64_t n_blocks(int64_t n) { return (n + kThreads - 1) / kThreads; }

template <int F>
int launch_sum(const int32_t* keys, const float* vals, float* out, int64_t m,
               int n_levels, int64_t n_segments, int bf16, cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>(n_blocks(m * n_levels));
  if (bf16) {
    segment_sum_kernel<F, true><<<blocks, kThreads, 0, s>>>(
        keys, vals, out, m, n_levels, n_segments);
  } else {
    segment_sum_kernel<F, false><<<blocks, kThreads, 0, s>>>(
        keys, vals, out, m, n_levels, n_segments);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, bound with ctypes by ngp_tpu_torch/ops/segsum.py. Pointers are
// device pointers of contiguous tensors; each function returns
// cudaGetLastError() after its launch (0 on success).
extern "C" int segment_sum(const void* keys, const void* vals, void* out,
                           long long m, int n_levels, long long n_segments,
                           int n_features, int bf16_payload, void* stream) {
  if (m <= 0 || n_levels <= 0) return 0;
  const auto* k = static_cast<const int32_t*>(keys);
  const auto* v = static_cast<const float*>(vals);
  auto* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_features) {
    case 1: return launch_sum<1>(k, v, o, m, n_levels, n_segments, bf16_payload, s);
    case 2: return launch_sum<2>(k, v, o, m, n_levels, n_segments, bf16_payload, s);
    case 4: return launch_sum<4>(k, v, o, m, n_levels, n_segments, bf16_payload, s);
    case 8: return launch_sum<8>(k, v, o, m, n_levels, n_segments, bf16_payload, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int segment_count(const void* keys, void* out, long long m,
                             int n_levels, long long n_segments, void* stream) {
  if (m <= 0 || n_levels <= 0) return 0;
  segment_count_kernel<<<static_cast<unsigned>(n_blocks(m * n_levels)), kThreads,
                         0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<int32_t*>(out), m,
      n_levels, n_segments);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* segment_sum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

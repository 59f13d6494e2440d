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
// scatter serializes there. Hopper adds floats atomically in L2, so there
// is no sort and no window: each addend goes to its row with an atomic
// reduction (RED), and what costs is the number of them.
//
// Bound on the H100: the kernel must read M * (4 + 4F) bytes per level and
// write the dense table once, 4 * L * T * F bytes (77 MB, 0.023 ms at
// 3.35 TB/s for the training step's 8 levels of 644,280 addends, F = 2,
// T = 2^18). The design cuts the atomics two ways:
//   - vector atomics: sm_90 adds a float2 or a float4 in one operation
//     (RED.E.ADD.F32x2 / F32x4), so a row of F = 2 or 4 is one atomic and
//     F = 8 two, where one per feature was issued before;
//   - neighbouring pairs: the grid backward writes a sample's corners x and
//     x + 1 as neighbouring addends, and with the additive hash, the XOR
//     hash at even x, or a dense level, their rows are 2r and 2r + 1 half
//     the time (or the same row, where a dense level clamps). For F <= 2,
//     lanes 2w and 2w + 1 of a warp hold neighbouring addends; where their
//     rows are one such pair (or the same row), the even lane adds both
//     with one vector atomic and the odd lane adds nothing. Any keys are
//     summed right; this only saves atomics where the pairs occur. A level
//     pairs only where its rows start on a vector boundary (l * T even):
//     with T odd, every odd level's row 2r lies off the float2 / float4
//     alignment that the vector atomic needs, and is added row by row.
// A vector whose components are all zero is skipped, so a row that no
// nonzero addend touches stays +0.0. One launch covers every level, sized
// to fill the card once (SMs times the blocks an SM holds), each thread
// striding over each level with kUnroll loads in flight.
//
// Summing levels with few rows in shared memory first (privatisation) was
// measured and dropped: Hopper has no shared-memory float add (it becomes
// a compare-and-swap loop), and on the training step's level 0 (4,096
// rows) it was 6.8x slower than these atomics in L2 (PERF.md).
//
// The float32 sums run in another order than the twin's; a float32 sum of n
// addends in any order is within (n - 1) * 2^-24 * sum |addend| of the
// exact one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // addends a thread loads before it adds them

template <int F>
struct alignas(4 * F) Row {
  float v[F];
};

template <int F, bool kBf16>
__device__ __forceinline__ Row<F> load_addend(const float* __restrict__ vals,
                                              int64_t i) {
  Row<F> r = *reinterpret_cast<const Row<F>*>(vals + i * F);
  if (kBf16) {
#pragma unroll
    for (int f = 0; f < F; ++f)
      r.v[f] = __bfloat162float(__float2bfloat16_rn(r.v[f]));
  }
  return r;
}

// Adds a row to device memory: one float2 or float4 atomic per vector of
// the row, skipping a vector whose components are all zero.
template <int F>
__device__ __forceinline__ void add_to_device(float* dst, const Row<F>& a) {
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

// Adds addend a to row key of out (key < 0: nothing), pairing it with the
// neighbouring lane's (lane ^ 1) as the header says where `pair` (the same
// for the whole warp) allows it. Every lane of the warp must call it
// together.
template <int F>
__device__ __forceinline__ void add_pairwise(float* out, int32_t key,
                                             Row<F> a, bool pair) {
  if constexpr (F <= 2) {
    if (pair) {
      const int32_t pk = __shfl_xor_sync(0xffffffffu, key, 1);
      Row<F> pa;
#pragma unroll
      for (int f = 0; f < F; ++f) pa.v[f] = __shfl_xor_sync(0xffffffffu, a.v[f], 1);
      if (key < 0) return;
      const bool odd = threadIdx.x & 1;
      if (pk == key) {  // the same row: one atomic of the two addends' sum
        if (odd) return;
#pragma unroll
        for (int f = 0; f < F; ++f) a.v[f] += pa.v[f];
      } else if (pk >= 0 && (key ^ pk) == 1) {  // rows 2r and 2r + 1
        if (odd) return;
        Row<2 * F> w;
#pragma unroll
        for (int f = 0; f < F; ++f) {
          w.v[f] = key < pk ? a.v[f] : pa.v[f];
          w.v[F + f] = key < pk ? pa.v[f] : a.v[f];
        }
        add_to_device<2 * F>(out + static_cast<int64_t>(key & ~1) * F, w);
        return;
      }
    }
  }
  if (key >= 0) add_to_device<F>(out + static_cast<int64_t>(key) * F, a);
}

template <int F, bool kBf16>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const int32_t* __restrict__ keys,
                   const float* __restrict__ vals, float* __restrict__ out,
                   int64_t m, int n_levels, int64_t n_segments) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  // the warp's first element: it keeps the loop the same for every lane
  const int64_t warp_first = first - (threadIdx.x & 31);
  for (int l = 0; l < n_levels; ++l) {
    const int32_t* k = keys + l * m;
    const float* v = vals + l * m * F;
    float* o = out + l * n_segments * F;
    const bool pair = (l * n_segments) % 2 == 0;  // o on a vector boundary
    for (int64_t i = 0; warp_first + i < m; i += kUnroll * step) {
      int32_t key[kUnroll];
      Row<F> a[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t iu = first + i + u * step;
        key[u] = iu < m ? k[iu] : -1;
        if (key[u] >= n_segments) key[u] = -1;
        a[u] = iu < m ? load_addend<F, kBf16>(v, iu) : Row<F>{};
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) add_pairwise<F>(o, key[u], a[u], pair);
    }
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

// The blocks of segment_sum_kernel<F, kBf16> that fill the current device
// once (SMs times the blocks an SM holds), asked of the runtime on each
// device's first launch only.
template <int F, bool kBf16>
cudaError_t card_blocks(int64_t* blocks) {
  constexpr int kDevices = 64;
  static int known[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && known[dev] > 0) {
    *blocks = known[dev];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, segment_sum_kernel<F, kBf16>, kThreads, 0);
  if (err != cudaSuccess) return err;
  *blocks = sms * per_sm > 0 ? sms * per_sm : 1;
  if (dev < kDevices) known[dev] = static_cast<int>(*blocks);
  return cudaSuccess;
}

template <int F, bool kBf16>
int launch_sum(const int32_t* keys, const float* vals, float* out, int64_t m,
               int n_levels, int64_t n_segments, cudaStream_t s) {
  int64_t card = 0;
  const cudaError_t err = card_blocks<F, kBf16>(&card);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = card < n_blocks(m) ? card : n_blocks(m);
  segment_sum_kernel<F, kBf16><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      keys, vals, out, m, n_levels, n_segments);
  return static_cast<int>(cudaGetLastError());
}

template <int F>
int launch_sum(const int32_t* keys, const float* vals, float* out, int64_t m,
               int n_levels, int64_t n_segments, int bf16, cudaStream_t s) {
  return bf16 ? launch_sum<F, true>(keys, vals, out, m, n_levels, n_segments, s)
              : launch_sum<F, false>(keys, vals, out, m, n_levels, n_segments, s);
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

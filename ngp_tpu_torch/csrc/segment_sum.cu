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
// Bound on the H100: segment_sum must read M * (4 + 4F) bytes per level and
// write the dense table once, 4 * L * T * F bytes (77 MB, 0.023 ms at
// 3.35 TB/s for the training step's 8 levels of 644,280 addends, F = 2,
// T = 2^18). What costs is the number of atomics, and the design cuts them
// two ways, with the deposit rule of csrc/atomic_rows.cuh (shared with the
// fused grid backward):
//   - vector atomics: a row of F = 2 or 4 is one atomic and F = 8 two;
//   - neighbouring pairs: the grid backward's corners x and x + 1 come as
//     neighbouring addends, and with the additive hash, the XOR hash at
//     even x, or a dense level, their rows are 2r and 2r + 1 half the time
//     (or the same row, where a dense level clamps). For F <= 2, lanes 2w
//     and 2w + 1 of a warp hold neighbouring addends; where their rows
//     pair, the even lane adds both with one atomic and the odd lane adds
//     nothing. Any keys are summed right; this only saves atomics where
//     the pairs occur. A level pairs only where its rows start on a vector
//     boundary (l * T even): with T odd, every odd level's row 2r lies off
//     the float2 / float4 alignment that the vector atomic needs, and is
//     added row by row.
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
//
// segment_count is bound the same way: it reads L * M * 4 bytes of keys
// and writes L * T * 4 bytes of counts (28.5 MB, 0.0085 ms at the training
// step's shape), and issues one integer atomic per key. Its design:
//   - one launch sized to the card, grid-stride loops over each level with
//     kUnroll keys a thread in flight, one key a lane, so that a warp's
//     atomic instruction covers 32 consecutive keys: the corners of four
//     samples, whose rows often share 32-byte sectors;
//   - neighbouring keys paired across lanes 2w and 2w + 1, as segment_sum
//     pairs addends: equal keys add 2 from the even lane with one atomic;
//     rows 2r and 2r + 1 (on a level whose counters start on an 8-byte
//     boundary, l * T even) add 1 to both from the even lane with one
//     64-bit atomic of 1 + 2^32 on the aligned pair of counters, row 2r
//     the low word. Counts stay below 2^31, so the low word never carries
//     into the high.
// Measured and dropped (PERF.md): four keys a thread from one 16-byte load,
// paired inside the thread, whose instructions each cover every fourth key
// (12% slower than one thread a key, unpaired; slower still without the
// pairs), two keys a thread from one 8-byte load, and warp aggregation
// with __match_any_sync. A level's histogram is T * 4 bytes (1 MB at
// T = 2^18), above a block's shared memory, and the contract gives no
// level's live size, so the counts are not privatised in shared memory.
// Counts are exact.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "atomic_rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // keys (and addends) a thread loads before it adds them

template <int F, bool kBf16>
__device__ __forceinline__ Row<float, F> load_addend(const float* __restrict__ vals,
                                                     int64_t i) {
  Row<float, F> r = *reinterpret_cast<const Row<float, F>*>(vals + i * F);
  if (kBf16) {
#pragma unroll
    for (int f = 0; f < F; ++f) r.v[f] = round_bf16(r.v[f]);
  }
  return r;
}

// Adds addend a to row key of out (key < 0: nothing), pairing it with the
// neighbouring lane's (lane ^ 1) as the header says where `pair` (the same
// for the whole warp) allows it. Every lane of the warp must call it
// together.
template <int F>
__device__ __forceinline__ void add_pairwise(float* out, int32_t key,
                                             const Row<float, F>& a, bool pair) {
  if constexpr (F <= 2) {
    if (pair) {
      const int32_t pk = __shfl_xor_sync(0xffffffffu, key, 1);
      Row<float, F> pa;
#pragma unroll
      for (int f = 0; f < F; ++f) pa.v[f] = __shfl_xor_sync(0xffffffffu, a.v[f], 1);
      if (key < 0) return;
      if (pk >= 0 && rows_pair(key, pk)) {
        if ((threadIdx.x & 1) == 0) add_pair<F>(out, key, a, pk, pa);
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
      Row<float, F> a[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t iu = first + i + u * step;
        key[u] = iu < m ? k[iu] : -1;
        if (key[u] >= n_segments) key[u] = -1;
        a[u] = iu < m ? load_addend<F, kBf16>(v, iu) : Row<float, F>{};
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) add_pairwise<F>(o, key[u], a[u], pair);
    }
  }
}

// Counts key in o (one level's counters; key < 0: nothing), pairing it
// with the neighbouring lane's (lane ^ 1) as the header says. Every lane of
// the warp must call it together.
__device__ __forceinline__ void count_pairwise(int32_t* o, int32_t key, bool pair) {
  const int32_t pk = __shfl_xor_sync(0xffffffffu, key, 1);
  if (key < 0) return;
  const bool odd = threadIdx.x & 1;
  if (pk == key) {  // the same row: 2 from the even lane
    if (!odd) atomicAdd(o + key, 2);
  } else if (pair && pk >= 0 && (key ^ pk) == 1) {  // rows 2r and 2r + 1
    if (!odd)
      atomicAdd(reinterpret_cast<unsigned long long*>(o + (key & ~1)),
                1ull + (1ull << 32));
  } else {
    atomicAdd(o + key, 1);
  }
}

__global__ void __launch_bounds__(kThreads)
segment_count_kernel(const int32_t* __restrict__ keys, int32_t* __restrict__ out,
                     int64_t m, int n_levels, int64_t n_segments) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  // the warp's first key: it keeps the loop the same for every lane
  const int64_t warp_first = first - (threadIdx.x & 31);
  for (int l = 0; l < n_levels; ++l) {
    const int32_t* k = keys + l * m;
    int32_t* o = out + l * n_segments;
    const bool pair = (l * n_segments) % 2 == 0;  // o + 2r on an 8-byte boundary
    for (int64_t i = 0; warp_first + i < m; i += kUnroll * step) {
      int32_t key[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t iu = first + i + u * step;
        key[u] = iu < m ? k[iu] : -1;
        if (key[u] >= n_segments) key[u] = -1;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) count_pairwise(o, key[u], pair);
    }
  }
}

int64_t n_blocks(int64_t n) { return (n + kThreads - 1) / kThreads; }

// The blocks of `kernel` (kThreads each) that fill the current device once
// (SMs times the blocks an SM holds), asked of the runtime on each device's
// first launch only.
template <auto kernel>
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
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  *blocks = sms * per_sm > 0 ? sms * per_sm : 1;
  if (dev < kDevices) known[dev] = static_cast<int>(*blocks);
  return cudaSuccess;
}

template <int F, bool kBf16>
int launch_sum(const int32_t* keys, const float* vals, float* out, int64_t m,
               int n_levels, int64_t n_segments, cudaStream_t s) {
  int64_t card = 0;
  const cudaError_t err = card_blocks<segment_sum_kernel<F, kBf16>>(&card);
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
  int64_t card = 0;
  const cudaError_t err = card_blocks<segment_count_kernel>(&card);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = card < n_blocks(m) ? card : n_blocks(m);
  segment_count_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<int32_t*>(out), m,
      n_levels, n_segments);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* segment_sum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

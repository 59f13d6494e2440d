// Batched bitonic sort with its argsort, for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   ngp_tpu/ops/pallas/sort.py:_sort_kernel (bitonic_sort_pos),
// which holds a whole row in VMEM and runs every stage of the network there.
//
//   sorted[b, i] = keys[b, perm[b, i]], each row ascending.
//
// keys (B, n) int32, n a power of two >= 128; sorted and perm (B, n) int32,
// written by the kernels (keys is only read). The network is the TPU
// kernel's, stage for stage, so the permutation is the same, ties included:
// stages k = 1 .. log2 n, inside each k strides j = 2^(k-1) .. 1; element i
// pairs with i ^ j; the pair is ascending where bit k of i (the index within
// the row) is 0; the two exchange only where they are strictly out of order,
// so equal keys never swap.
//
// A block's shared memory holds 2^12 keys and positions (32 KB), not a
// row of 2^20, so the network is cut at strides of 2^12:
//   1. one launch sorts every tile of 2^12 elements in shared memory: all
//      stages with k <= 12;
//   2. for each k > 12: one pass over device memory per stride j >= 2^12,
//      one thread per pair, then one shared-memory launch that runs the
//      strides j < 2^12 of that k.
// At n = 2^20 that is 1 + sum_{k=13..20} (k - 11) = 45 launches, all from
// bitonic_sort_pos on the caller's stream.
//
// Bound on the H100: the keys read once and the keys and perm written once,
// 12 bytes an element (50.3 MB at (4, 2^20), 0.015 ms at 3.35 TB/s). This
// design moves the keys and positions through device memory once per
// global pass and once per shared-memory launch (45 times at n = 2^20), so
// it runs far above that bound; keeping more of a row on chip (a cluster's
// distributed shared memory, or fewer, wider global passes) is the lever.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileLog = 12;
constexpr int kTile = 1 << kTileLog;  // elements a block sorts in shared memory
constexpr int kTileThreads = 1024;
constexpr int kPassThreads = 256;
constexpr int kMaxLogN = 30;

// Lower element of pair q at stride j: q with a 0 bit inserted at log2(j).
__device__ __forceinline__ int64_t pair_low(int64_t q, int64_t j) {
  return ((q & ~(j - 1)) << 1) | (q & (j - 1));
}

// Whether (a at the lower index, b at the upper) must exchange.
__device__ __forceinline__ bool exchange(int32_t a, int32_t b, bool ascending) {
  return ascending ? b < a : b > a;
}

// Stages k = k_lo .. k_hi, each from stride min(2^(k-1), tile/2) down to 1,
// on one tile of `tile` elements of a row. Stages k <= log2(tile) are the
// whole of that k; for larger k the strides >= tile ran before in device
// memory. row_base is the tile's first index within its row: the direction
// bit is bit k of the index within the row.
__global__ void __launch_bounds__(kTileThreads)
sort_tiles_kernel(const int32_t* src_keys, const int32_t* src_perm,
                  int32_t* keys, int32_t* perm, int n, int tile, int k_lo,
                  int k_hi) {
  __shared__ int32_t sk[kTile];
  __shared__ int32_t sp[kTile];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * tile;
  const int row_base = static_cast<int>(base & (n - 1));
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    sk[i] = src_keys[base + i];
    sp[i] = src_perm != nullptr ? src_perm[base + i] : row_base + i;
  }
  __syncthreads();
  for (int k = k_lo; k <= k_hi; ++k) {
    const int j_top = min(1 << (k - 1), tile >> 1);
    for (int j = j_top; j >= 1; j >>= 1) {
      for (int q = threadIdx.x; q < (tile >> 1); q += blockDim.x) {
        const int lo = static_cast<int>(pair_low(q, j));
        const int hi = lo + j;
        const bool ascending = (((row_base + lo) >> k) & 1) == 0;
        const int32_t a = sk[lo];
        const int32_t b = sk[hi];
        if (exchange(a, b, ascending)) {
          sk[lo] = b;
          sk[hi] = a;
          const int32_t t = sp[lo];
          sp[lo] = sp[hi];
          sp[hi] = t;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    keys[base + i] = sk[i];
    perm[base + i] = sp[i];
  }
}

// One stage (k, j) with j >= the tile, in place in device memory: one
// thread per pair of the B * n / 2 pairs.
__global__ void __launch_bounds__(kPassThreads)
merge_pass_kernel(int32_t* keys, int32_t* perm, int64_t n_pairs, int log_n,
                  int k, int j) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * kPassThreads + threadIdx.x;
  if (q >= n_pairs) return;
  const int64_t row = q >> (log_n - 1);
  const int64_t lo = pair_low(q & ((int64_t{1} << (log_n - 1)) - 1), j);
  const bool ascending = ((lo >> k) & 1) == 0;
  const int64_t a_i = (row << log_n) + lo;
  const int64_t b_i = a_i + j;
  const int32_t a = keys[a_i];
  const int32_t b = keys[b_i];
  if (exchange(a, b, ascending)) {
    keys[a_i] = b;
    keys[b_i] = a;
    const int32_t t = perm[a_i];
    perm[a_i] = perm[b_i];
    perm[b_i] = t;
  }
}

}  // namespace

// C interface, bound with ctypes by ngp_tpu_torch/ops/sort.py. keys, sorted
// and perm are device pointers of contiguous (batch, n) int32 tensors; the
// stream is the caller's. Returns cudaGetLastError() after the first launch
// that fails, else 0.
extern "C" int bitonic_sort_pos(const void* keys, void* sorted, void* perm,
                                long long batch, int n, void* stream) {
  if (batch <= 0) return 0;
  int log_n = 0;
  while ((1 << log_n) < n && log_n < kMaxLogN) ++log_n;
  if (n < 2 || (1 << log_n) != n) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* out_k = static_cast<int32_t*>(sorted);
  auto* out_p = static_cast<int32_t*>(perm);
  const int tile = n < kTile ? n : kTile;
  const int tile_log = log_n < kTileLog ? log_n : kTileLog;
  const int threads = tile / 2 < kTileThreads ? tile / 2 : kTileThreads;
  const unsigned tiles = static_cast<unsigned>(batch * (n / tile));
  const int64_t n_pairs = batch * static_cast<int64_t>(n) / 2;
  const unsigned pass_blocks =
      static_cast<unsigned>((n_pairs + kPassThreads - 1) / kPassThreads);

  sort_tiles_kernel<<<tiles, threads, 0, s>>>(
      static_cast<const int32_t*>(keys), nullptr, out_k, out_p, n, tile, 1,
      tile_log);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int k = tile_log + 1; k <= log_n; ++k) {
    for (int j = 1 << (k - 1); j >= tile; j >>= 1) {
      merge_pass_kernel<<<pass_blocks, kPassThreads, 0, s>>>(
          out_k, out_p, n_pairs, log_n, k, j);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    sort_tiles_kernel<<<tiles, threads, 0, s>>>(out_k, out_p, out_k, out_p, n,
                                                tile, k, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

extern "C" const char* bitonic_sort_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

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
// Bound on the H100: the keys read once and the keys and perm written once,
// 12 bytes an element (50.3 MB at (4, 2^20), 0.015 ms at 3.35 TB/s). Above
// that bound a bitonic network pays for its comparisons, log2 n (log2 n + 1)
// / 4 per element (210 stages of 2^21 pairs at (4, 2^20)), and for every
// launch after the first, each of which moves the keys and positions
// through device memory again.
//
// Design. A key and its position travel as one 64-bit word (key in the high
// half); only the key half is compared, so ties keep the network's order.
//   1. Tiles of 2^14 elements (132 KB of dynamic shared memory, padded one
//      word in 32 against bank conflicts) run every stage with k <= 14 in
//      one launch. Each of the tile's 512 threads holds 32 elements in
//      registers. Which 5 bits of the tile index are a thread's register
//      bits is the "layout": a stride whose bit is a register bit runs in
//      registers with no barrier; the tile changes layout through shared
//      memory (one barrier) only when the next stride is not one. Strides
//      1..16 run in layout 0, strides 32..512 in layout 5, larger ones in
//      the layout whose top register bit is the stride's, so a stage k
//      costs at most three trips through shared memory.
//   2. Each exchange's direction is a compile-time constant (the stride and
//      the direction bit's place are dispatched once a stride), so an
//      exchange is one comparison and four selects.
//   3. For each k > 14, the strides j >= 2^14 run as passes over device
//      memory that fuse up to 5 strides each: a thread loads the 2^r
//      elements that those r strides pair among themselves, runs the r
//      strides in registers and stores them back (neighbouring threads on
//      neighbouring addresses). Then one tile launch runs the strides
//      j < 2^14 of that k; it loads its tile straight into the registers of
//      its first layout, which puts neighbouring elements in neighbouring
//      lanes.
// At n = 2^20 that is 1 + 7 fused passes + 6 tile launches = 14 launches
// (bitonic_sort_launches), all from bitonic_sort_pos on the caller's
// stream; the earlier design (tiles of 2^12, one pass per stride) took 45.
// The first launch, with 105 of the 210 stages, takes the largest share
// (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kRegLog = 5;  // a thread holds 2^5 elements in registers
constexpr int kReg = 1 << kRegLog;
constexpr int kTileLog = 14;  // elements a block sorts in shared memory
constexpr int kTileThreads = (1 << kTileLog) / kReg;
constexpr int kMaxGroup = kRegLog;  // strides a pass over device memory fuses
constexpr int kPassThreads = 128;
constexpr int kMaxLogN = 30;

// Shared-memory slot of tile element i: one padding word per 32, so that
// the 32 lanes of layout 0 (element 32t + e) fall on distinct banks.
__host__ __device__ constexpr int padded(int i) { return i + (i >> 5); }

__device__ __forceinline__ uint64_t pack(int32_t key, int32_t pos) {
  return (static_cast<uint64_t>(static_cast<uint32_t>(key)) << 32) |
         static_cast<uint32_t>(pos);
}
__device__ __forceinline__ int32_t key_of(uint64_t v) {
  return static_cast<int32_t>(v >> 32);
}
__device__ __forceinline__ int32_t pos_of(uint64_t v) {
  return static_cast<int32_t>(static_cast<uint32_t>(v));
}

// The network's exchange: a at the lower index, b at the upper; they swap
// only where strictly out of order for the pair's direction (a constant
// wherever the caller can make it one: one comparison and four selects).
__device__ __forceinline__ void exchange(uint64_t& a, uint64_t& b, bool descending) {
  const int32_t ka = key_of(a);
  const int32_t kb = key_of(b);
  const bool swap = descending ? kb > ka : kb < ka;
  const uint64_t lo = swap ? b : a;
  b = swap ? a : b;
  a = lo;
}

// Layout r0: register e of thread t holds tile element
//   ((t >> r0) << (r0 + 5)) | (e << r0) | (t & (2^r0 - 1)),
// i.e. tile bits r0 .. r0 + 4 are the register bits. The layout for stride
// bit b: 0 for b < 5, else the one whose register bits end at b (never
// starting below bit 5, never reaching past the tile).
__device__ __forceinline__ int layout_for(int b, int tile_log) {
  if (b < kRegLog) return 0;
  return min(max(kRegLog, b - (kRegLog - 1)), tile_log - kRegLog);
}

__device__ __forceinline__ int layout_base(int t, int r0) {
  return ((t >> r0) << (r0 + kRegLog)) | (t & ((1 << r0) - 1));
}

// A stride's direction for a thread's registers: all ascending, all
// descending, or (0 <= mode < 5) given by bit `mode` of the register index,
// where bit k of the row index is one of the layout's register bits.
constexpr int kAscending = -1;
constexpr int kDescending = -2;

// One stride (register bit RB of the layout) on a thread's registers, the
// direction of every exchange a constant.
template <int RB, int MODE>
__device__ __forceinline__ void stride_in_registers(uint64_t (&v)[kReg]) {
#pragma unroll
  for (int e = 0; e < kReg; ++e) {
    if (e & (1 << RB)) continue;
    const bool descending =
        MODE == kDescending || (MODE >= 0 && ((e >> (MODE & 31)) & 1));
    exchange(v[e], v[e | (1 << RB)], descending);
  }
}

// Bit k lies above the stride's bit, so a register bit `mode` is > RB.
template <int RB>
__device__ __forceinline__ void stride_with_mode(uint64_t (&v)[kReg], int mode) {
  switch (mode) {
    case kDescending: stride_in_registers<RB, kDescending>(v); break;
    case kAscending: stride_in_registers<RB, kAscending>(v); break;
    case 1: if constexpr (RB < 1) stride_in_registers<RB, 1>(v); break;
    case 2: if constexpr (RB < 2) stride_in_registers<RB, 2>(v); break;
    case 3: if constexpr (RB < 3) stride_in_registers<RB, 3>(v); break;
    default: if constexpr (RB < 4) stride_in_registers<RB, 4>(v); break;
  }
}

// Stages k = k_lo .. k_hi on one tile of 2^tile_log elements of a row, each
// from stride min(2^(k-1), tile/2) down to 1: stages k <= tile_log whole,
// larger k after their strides >= the tile ran in device memory. src_perm
// null means positions are the row indices (the first launch).
//
// The tile enters registers in the layout of its first stride: straight
// from device memory where that layout puts neighbouring elements in
// neighbouring lanes (layouts from bit 5 up: every launch after the first),
// else through shared memory; it leaves from layout 0 (stride 1) through
// shared memory. Each copy issues all of a thread's loads before it uses
// one.
__global__ void __launch_bounds__(kTileThreads, 1)
sort_tiles_kernel(const int32_t* src_keys, const int32_t* src_perm,
                  int32_t* keys, int32_t* perm, int n, int tile_log, int k_lo,
                  int k_hi) {
  extern __shared__ uint64_t sm[];
  const int tile = 1 << tile_log;
  const int threads = tile / kReg;
  const int64_t base = static_cast<int64_t>(blockIdx.x) << tile_log;
  const int row_base = static_cast<int>(base & (n - 1));
  const int t = threadIdx.x;
  auto load = [&](int i) {
    return pack(src_keys[base + i],
                src_perm != nullptr ? src_perm[base + i] : row_base + i);
  };

  uint64_t v[kReg];
  int r0 = layout_for(min(k_lo, tile_log) - 1, tile_log);
  int ibase = row_base | layout_base(t, r0);
  if (r0 >= kRegLog) {
#pragma unroll
    for (int e = 0; e < kReg; ++e) v[e] = load((ibase & (tile - 1)) | (e << r0));
  } else {
#pragma unroll
    for (int m = 0; m < kReg; ++m) v[m] = load(t + m * threads);
#pragma unroll
    for (int m = 0; m < kReg; ++m) sm[padded(t + m * threads)] = v[m];
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kReg; ++e) v[e] = sm[padded((ibase & (tile - 1)) | (e << r0))];
  }

  for (int k = k_lo; k <= k_hi; ++k) {
    for (int b = min(k, tile_log) - 1; b >= 0; --b) {
      if (b < r0 || b >= r0 + kRegLog) {
        // each thread writes back the slots it read, so one barrier
        // before the next layout's reads is enough
#pragma unroll
        for (int e = 0; e < kReg; ++e) sm[padded((ibase & (tile - 1)) | (e << r0))] = v[e];
        __syncthreads();
        r0 = layout_for(b, tile_log);
        ibase = row_base | layout_base(t, r0);
#pragma unroll
        for (int e = 0; e < kReg; ++e) v[e] = sm[padded((ibase & (tile - 1)) | (e << r0))];
      }
      // ibase is 0 in the register bits: bit k is either one of them or
      // the thread's own
      const int kb = k - r0;
      const int mode = (kb >= 0 && kb < kRegLog) ? kb
                       : ((ibase >> k) & 1) ? kDescending : kAscending;
      switch (b - r0) {
        case 0: stride_with_mode<0>(v, mode); break;
        case 1: stride_with_mode<1>(v, mode); break;
        case 2: stride_with_mode<2>(v, mode); break;
        case 3: stride_with_mode<3>(v, mode); break;
        default: stride_with_mode<4>(v, mode); break;
      }
    }
  }
  // the last stride is 1, in layout 0
#pragma unroll
  for (int e = 0; e < kReg; ++e) sm[padded((ibase & (tile - 1)) | (e << r0))] = v[e];
  __syncthreads();
#pragma unroll
  for (int m = 0; m < kReg; ++m) v[m] = sm[padded(t + m * threads)];
#pragma unroll
  for (int m = 0; m < kReg; ++m) {
    keys[base + t + m * threads] = key_of(v[m]);
    perm[base + t + m * threads] = pos_of(v[m]);
  }
}

// Strides b_lo + R - 1 .. b_lo of stage k (all >= the tile), in place in
// device memory: thread q holds the 2^R elements i0 + m * 2^b_lo, i0 being
// q with R zero bits inserted at b_lo. Bit k lies above them all, so the
// direction is the thread's.
template <int R>
__global__ void __launch_bounds__(kPassThreads)
merge_pass_kernel(int32_t* keys, int32_t* perm, int64_t n_threads, int n,
                  int k, int b_lo) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * kPassThreads + threadIdx.x;
  if (q >= n_threads) return;
  const int64_t low = q & ((int64_t{1} << b_lo) - 1);
  const int64_t i0 = ((q >> b_lo) << (b_lo + R)) | low;
  const bool descending = (((i0 & (n - 1)) >> k) & 1) != 0;
  uint64_t v[1 << R];
#pragma unroll
  for (int m = 0; m < (1 << R); ++m) {
    const int64_t i = i0 + (static_cast<int64_t>(m) << b_lo);
    v[m] = pack(keys[i], perm[i]);
  }
  auto strides = [&](auto desc) {
#pragma unroll
    for (int s = R - 1; s >= 0; --s) {
#pragma unroll
      for (int m = 0; m < (1 << R); ++m) {
        if (!(m & (1 << s))) exchange(v[m], v[m | (1 << s)], desc.value);
      }
    }
  };
  if (descending) {
    strides(std::true_type{});
  } else {
    strides(std::false_type{});
  }
#pragma unroll
  for (int m = 0; m < (1 << R); ++m) {
    const int64_t i = i0 + (static_cast<int64_t>(m) << b_lo);
    keys[i] = key_of(v[m]);
    perm[i] = pos_of(v[m]);
  }
}

template <int R>
cudaError_t launch_pass(int32_t* keys, int32_t* perm, long long batch, int n,
                        int k, int b_lo, cudaStream_t s) {
  const int64_t n_threads = (batch * static_cast<int64_t>(n)) >> R;
  const unsigned blocks =
      static_cast<unsigned>((n_threads + kPassThreads - 1) / kPassThreads);
  merge_pass_kernel<R><<<blocks, kPassThreads, 0, s>>>(keys, perm, n_threads, n, k, b_lo);
  return cudaGetLastError();
}

int log2_exact(int n) {
  int log_n = 0;
  while ((1 << log_n) < n && log_n < kMaxLogN) ++log_n;
  // a tile needs at least one thread's registers' worth of elements
  return (n >= kReg && (1 << log_n) == n) ? log_n : -1;
}

// The launches of one sort: the first tile launch, then for each stage k
// above the tile its passes over device memory (the k - tile_log strides
// >= the tile cut into near-equal groups of at most kMaxGroup, highest
// first) and one tile launch. `tile(k_lo, k_hi)` and `pass(r, k, b_lo)`
// issue them; each returns a cudaError_t, and the first failure ends the
// walk and is returned.
template <typename Tile, typename Pass>
cudaError_t for_each_launch(int log_n, Tile tile, Pass pass) {
  const int tile_log = log_n < kTileLog ? log_n : kTileLog;
  cudaError_t err = tile(1, tile_log);
  for (int k = tile_log + 1; k <= log_n && err == cudaSuccess; ++k) {
    const int strides = k - tile_log;
    const int groups = (strides + kMaxGroup - 1) / kMaxGroup;
    int b_hi = k - 1;
    for (int g = 0; g < groups && err == cudaSuccess; ++g) {
      const int r = strides / groups + (g < strides % groups ? 1 : 0);
      err = pass(r, k, b_hi - r + 1);
      b_hi -= r;
    }
    if (err == cudaSuccess) err = tile(k, k);
  }
  return err;
}

}  // namespace

// C interface, bound with ctypes by ngp_tpu_torch/ops/sort.py. keys, sorted
// and perm are device pointers of contiguous (batch, n) int32 tensors; the
// stream is the caller's. Returns cudaGetLastError() after the first launch
// that fails, else 0.
extern "C" int bitonic_sort_pos(const void* keys, void* sorted, void* perm,
                                long long batch, int n, void* stream) {
  if (batch <= 0) return 0;
  const int log_n = log2_exact(n);
  if (log_n < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* out_k = static_cast<int32_t*>(sorted);
  auto* out_p = static_cast<int32_t*>(perm);
  const int tile_log = log_n < kTileLog ? log_n : kTileLog;
  const size_t smem = padded(1 << tile_log) * sizeof(uint64_t);
  const unsigned tiles = static_cast<unsigned>((batch * n) >> tile_log);
  const int threads = (1 << tile_log) / kReg;
  cudaError_t err = cudaFuncSetAttribute(
      sort_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(padded(1 << kTileLog) * sizeof(uint64_t)));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = for_each_launch(
      log_n,
      [&](int k_lo, int k_hi) {
        const bool first = k_lo == 1;
        sort_tiles_kernel<<<tiles, threads, smem, s>>>(
            first ? static_cast<const int32_t*>(keys) : out_k,
            first ? nullptr : out_p, out_k, out_p, n, tile_log, k_lo, k_hi);
        return cudaGetLastError();
      },
      [&](int r, int k, int b_lo) {
        switch (r) {
          case 1: return launch_pass<1>(out_k, out_p, batch, n, k, b_lo, s);
          case 2: return launch_pass<2>(out_k, out_p, batch, n, k, b_lo, s);
          case 3: return launch_pass<3>(out_k, out_p, batch, n, k, b_lo, s);
          case 4: return launch_pass<4>(out_k, out_p, batch, n, k, b_lo, s);
          default: return launch_pass<5>(out_k, out_p, batch, n, k, b_lo, s);
        }
      });
  return static_cast<int>(err);
}

// Kernel launches one bitonic_sort_pos call makes for rows of n (a power
// of two), or -1 for any other n.
extern "C" int bitonic_sort_launches(int n) {
  const int log_n = log2_exact(n);
  if (log_n < 0) return -1;
  int launches = 0;
  for_each_launch(
      log_n, [&](int, int) { ++launches; return cudaSuccess; },
      [&](int, int, int) { ++launches; return cudaSuccess; });
  return launches;
}

extern "C" const char* bitonic_sort_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

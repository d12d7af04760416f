// Windowed-group merge kernels of the windowed quantile: the row sort, the
// dyadic level build and the window fold.
//
// Replaces xsdba_tpu/ops/pallas/merge_kernel.py:
//   sort_rows_alternating        (K3, _sort_rows_kernel / _bitonic_sort_lastaxis)
//     -> sort_rows_warp_kernel (rows of up to 1024 values), else the long-row
//        sort_rows_alt_kernel
//   _merged_window_rows_shared_impl, _build_levels_kernel (K5)
//     -> build_levels_kernel, every level in one launch
//   _merged_window_rows_shared_impl, _shared_fold_fused_kernel /
//   _shared_fold_kernel / _fold_class_body (K6), and merged_window_rows (K4)
//     -> fold_windows_kernel (K4 is the fold with every segment one base row)
// Their plain twins live beside the wrappers in xsdba_tpu_torch/ops/merge.py.
//
// Layout.  The slab is [B, dp, m]: row r of batch b is one pre-group list of
// m values, +inf past its data (NaN is not allowed: the caller maps it to
// +inf).  The row sort leaves even rows ascending and odd rows descending,
// the layout the TPU kernels exchange; the kernels below read an odd row
// from its end, so they see every run ascending.  Levels are [B, L, dp, m]:
// level k holds every aligned run of 2^(k+1) slab rows (row offset a
// multiple of 2^(k+1)) as one ascending run of 2^(k+1)·m values, stored
// ascending (the TPU kernel stores some runs negated; this one does not).
// The fold writes [B, G, window·ymax]: group g's window rows [g, g + window)
// merged ascending, +inf past the data.
//
// Order.  Every kernel orders by IEEE totalOrder, -0.0 below +0.0 (no NaN
// reaches them), as the Pallas kernels' min/max networks do, so equal values
// are equal bit patterns and no order among ties can show in an output.  The
// warp sort gets it from FMNMX in f32 and from order_zeros in f64; the
// long-row sort and the merges compare keys (order_key): a value's bit
// pattern as a signed integer with a negative value's magnitude bits
// inverted, whose integer order is totalOrder.  The
// merges (K4, K5, K6) see only bit patterns (templated on int or long long):
// they turn a value into its key once where they stage it and back once
// where they store it, and merge keys with integer compares, no more
// instructions than a float compare.
//
// Bound.  The Pallas kernels are compare-exchange networks sized for VMEM
// and the VPU's roll/iota lanes.  On Hopper the scarce things are a block's
// shared memory and its synchronisations, and all three kernels here are
// bound by bytes at the heavy path's shapes.
//
// The row sort of a row of up to 1024 values is a bitonic network in one
// warp's registers: each lane holds m/32 consecutive values (VPT, a template
// argument, so every index into the lane's values is a constant), the
// stages with a stride below VPT are compare-exchanges inside a lane and the
// others __shfl_xor_sync exchanges; no shared memory, no __syncthreads().
// Rows of m < 32 values take m lanes each, several rows to a warp.  Every
// compare-exchange is ascending (each merge opens with a flip, not with a
// direction computed per pair), and an odd row is stored reversed, so the
// alternating layout costs nothing.  What bounds it is instruction issue
// (36 stages at m = 256), not its bytes (0.125 ms at [512, 400, 256] f32),
// so in float a compare-exchange is one min and one max instruction, and
// the row index takes no 64-bit division.  Longer rows keep
// the long-row variant, one block a row sorting in shared memory (bound by
// its log2(m)^2/2 block-wide synchronisations; off every path the port runs
// at production shapes).
//
// The level build takes one block per (batch row, aligned run of 2^L slab
// rows) and builds all L levels of it in one launch: the 2^L rows are
// staged as keys (cp.async, odd rows read from their end, then a pass that
// keys what each thread staged), then level k merges
// each aligned pair of 2^k·m-value runs by merge path (each thread a
// contiguous range of outputs, placed by one co-rank search, ties to the
// left run), ping-ponging between two shared buffers, and each level leaves
// shared memory in 16-byte stores, as bit patterns again.  So the slab is
// read once and each level written once, the bytes its bound counts.  When the two buffers do not fit
// in shared memory (f64 with m = 1024), the block merges in device memory:
// level 0 reads the slab, level k the level k - 1 the same block has just
// written (through a plain pointer, never the read-only path; the block's
// __syncthreads() makes its own writes visible to it).
//
// The window fold is bound by bytes: its [B, G, window·ymax] output (3.47 GB
// at the heavy path's [512, 365, 4650] f32, 1.351 ms at 3.35 TB/s with its
// inputs).  A rank merge there would cost every value a binary search in
// every other segment (about 5 x 11 dependent shared loads a value) and a
// store to a scattered slot.  So the fold merges by merge path: the
// segments, staged as keys (cp.async and a keying pass), are folded
// smallest first (4 steps at window 31, moving 56 rows of values in all for
// the window's 31), each
// thread taking a contiguous range of a step's outputs, placed by one
// co-rank search, then one comparison and one shared load per output with
// no branch on the data; the finished row leaves shared memory in 16-byte
// stores, so every store is coalesced.  What is left is instruction issue
// in the steps (about 18 instructions an output a step): comparing keys
// with integer compares adds none there, and order_key adds two
// instructions a value where it is staged and two where it is stored.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSegments = 64;
// the warp row sort: warps a block, and the longest row (32 values a lane)
constexpr int kSortWarps = 8;
constexpr int kWarpSortMax = 32 * 32;

// The bit patterns of a float type as a signed integer type.
template <typename T>
struct BitsOf;
template <>
struct BitsOf<float> {
  using type = int;
};
template <>
struct BitsOf<double> {
  using type = long long;
};

// A bit pattern's totalOrder key, and a key's bit pattern (its own inverse).
__device__ __forceinline__ int order_key(int b) { return b ^ ((b >> 31) & 0x7fffffff); }
__device__ __forceinline__ long long order_key(long long b) { return b ^ ((b >> 63) & 0x7fffffffffffffffLL); }

template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
  static constexpr int n = 4;
  __device__ static float4 make(const float* v) { return make_float4(v[0], v[1], v[2], v[3]); }
  __device__ static void split(const float4& q, float* v) { v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w; }
};
template <>
struct Vec16<double> {
  using type = double2;
  static constexpr int n = 2;
  __device__ static double2 make(const double* v) { return make_double2(v[0], v[1]); }
  __device__ static void split(const double2& q, double* v) { v[0] = q.x, v[1] = q.y; }
};
template <>
struct Vec16<int> {
  using type = int4;
  static constexpr int n = 4;
  __device__ static int4 make(const int* v) { return make_int4(v[0], v[1], v[2], v[3]); }
  __device__ static void split(const int4& q, int* v) { v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w; }
};
template <>
struct Vec16<long long> {
  using type = longlong2;
  static constexpr int n = 2;
  __device__ static longlong2 make(const long long* v) { return make_longlong2(v[0], v[1]); }
  __device__ static void split(const longlong2& q, long long* v) { v[0] = q.x, v[1] = q.y; }
};

// ------------------------------------------------------------------ K3
// The compare-exchange of the warp sort: a and b in ascending order, a
// permutation for any values (compared with < only, so +-0.0 stay apart).
template <typename T>
__device__ __forceinline__ void order(T& a, T& b) {
  const bool swap = b < a;
  const T lo = swap ? b : a;
  b = swap ? a : b;
  a = lo;
}

// Of a pair split across two lanes, the value this lane keeps: the smaller
// when it holds the pair's lower position.  Both lanes compare the same two
// values the same way, so exactly one takes each.
template <typename T>
__device__ __forceinline__ T keep(T mine, T theirs, bool lower) {
  return (lower ? theirs < mine : mine < theirs) ? theirs : mine;
}

// In float both are min/max instructions (FMNMX, the min or max picked by
// a predicate): half the instructions of the compare and selects, and
// Hopper's FMNMX orders -0.0 below +0.0, which is totalOrder on values
// that are never NaN (chip_smoke.py phase 3 and tests/test_torch_cuda.py
// hold the output's bit patterns to the totalOrder twin's).  Double has no
// such instruction (fmin costs more than the compare and selects), and its
// < ties +-0.0, so a double row leaves the network with its zeros one run
// in no order of sign, which order_zeros then puts in order.
template <>
__device__ __forceinline__ void order<float>(float& a, float& b) {
  const float lo = fminf(a, b);
  b = fmaxf(a, b);
  a = lo;
}
template <>
__device__ __forceinline__ float keep<float>(float mine, float theirs, bool lower) {
  return lower ? fminf(mine, theirs) : fmaxf(mine, theirs);
}

// The bitonic half-cleaner stages of strides J, J/2, ..., 1 inside a lane's
// VPT values: pair (v, v + J) ascending.
template <int J, int VPT, typename T>
__device__ __forceinline__ void lane_half_cleaners(T (&r)[VPT]) {
  if constexpr (J >= 1) {
#pragma unroll
    for (int v = 0; v < VPT; ++v)
      if ((v & J) == 0) order(r[v], r[v | J]);
    lane_half_cleaners<J / 2>(r);
  }
}

// A row sorted as doubles, its +-0.0 tied: the zeros are one run, at
// ascending positions [below, below + zeros) where below counts the
// negative values; the run's first n_neg (the row's -0.0s) take -0.0 and
// the rest +0.0, which is totalOrder.  Lane sub of a row's lanes holds
// positions [sub·VPT, (sub + 1)·VPT); the two counts ride one warp sum over
// the row's lanes (xor offsets below lanes stay inside them).  Some 4
// instructions a value and log2(lanes) shuffles: comparing int64 keys in
// every stage instead took 1.51x the double network's time on an H100
// ([512, 400, 256]).
template <int VPT>
__device__ __forceinline__ void order_zeros(double (&r)[VPT], int sub, int lanes) {
  int counts = 0;  // negative values, plus -0.0s << 16 (a row holds at most 1024)
#pragma unroll
  for (int v = 0; v < VPT; ++v)
    counts += (r[v] < 0.0) + (r[v] == 0.0 && __double_as_longlong(r[v]) < 0 ? 1 << 16 : 0);
  for (int d = 1; d < lanes; d <<= 1) counts += __shfl_xor_sync(0xffffffffu, counts, d);
  const int split = (counts & 0xffff) + (counts >> 16);  // positions below it that are zero take -0.0
#pragma unroll
  for (int v = 0; v < VPT; ++v)
    if (r[v] == 0.0) r[v] = sub * VPT + v < split ? -0.0 : 0.0;
}

// The merges of size K, 2K, ..., VPT inside a lane: each first pairs v with
// its mirror v ^ (K - 1) (the flip that makes every merge ascending), then
// half-cleans.  After it each lane's values are sorted.
template <int K, int VPT, typename T>
__device__ __forceinline__ void lane_sort(T (&r)[VPT]) {
  if constexpr (K <= VPT) {
#pragma unroll
    for (int v = 0; v < VPT; ++v)
      if ((v & (K / 2)) == 0) order(r[v], r[v ^ (K - 1)]);
    lane_half_cleaners<K / 4>(r);
    lane_sort<2 * K>(r);
  }
}

// One warp per slab row of m = 32·VPT values (m / VPT = m lanes a row when
// m < 32, VPT = 1, so 32 / m rows a warp), the row in registers: lane l
// holds values [l·VPT, (l + 1)·VPT).  A bitonic network whose every
// compare-exchange is ascending (each merge opens with a flip: value i
// pairs with its mirror in the merged run, i ^ (k - 1)), so a direction is
// never computed; an odd row (row index within dp) is stored reversed,
// each lane's values into the mirror lane's slot.  Stages of stride below
// VPT stay in a lane; the others are __shfl_xor_sync exchanges.  Every lane
// of the warp runs every stage (the shuffles take the full mask); lanes
// past the last row hold zeros and store nothing.  A double row's zeros
// are put in order of sign after the network (order_zeros).
template <typename T, int VPT>
__global__ void __launch_bounds__(kSortWarps * 32)
sort_rows_warp_kernel(const T* __restrict__ in, T* __restrict__ out, int rows, int m, int dp, bool aligned) {
  // rows < 2^31 and lanes a power of two: no 64-bit division
  const int lanes = m / VPT;
  const int log_lanes = __ffs(lanes) - 1;
  const int sub = threadIdx.x & (lanes - 1);
  const long long row64 = static_cast<long long>(blockIdx.x) * (kSortWarps * 32 >> log_lanes) + (threadIdx.x >> log_lanes);
  const bool valid = row64 < rows;
  const int row = static_cast<int>(row64);
  using V = Vec16<T>;
  constexpr bool kVector = VPT % V::n == 0;
  T r[VPT];
  if (!valid) {
#pragma unroll
    for (int v = 0; v < VPT; ++v) r[v] = T(0);
  } else if (kVector && aligned) {
    const auto* q = reinterpret_cast<const typename V::type*>(in + static_cast<long long>(row) * m + sub * VPT);
#pragma unroll
    for (int c = 0; c < VPT / V::n; ++c) V::split(q[c], r + c * V::n);
  } else {
#pragma unroll
    for (int v = 0; v < VPT; ++v) r[v] = in[static_cast<long long>(row) * m + sub * VPT + v];
  }

  lane_sort<2>(r);
  for (int k = 2 * VPT; k <= m; k <<= 1) {
    // the flip: lane sub ^ (k / VPT - 1) holds the mirrors, in reverse order
    const int mirror = k / VPT - 1;
    const bool lower = (sub & (k / (2 * VPT))) == 0;
    if constexpr (VPT == 1) {
      r[0] = keep(r[0], __shfl_xor_sync(0xffffffffu, r[0], mirror), lower);
    } else {
#pragma unroll
      for (int v = 0; v < VPT / 2; ++v) {
        const T theirs_w = __shfl_xor_sync(0xffffffffu, r[VPT - 1 - v], mirror);
        const T theirs_v = __shfl_xor_sync(0xffffffffu, r[v], mirror);
        r[v] = keep(r[v], theirs_w, lower);
        r[VPT - 1 - v] = keep(r[VPT - 1 - v], theirs_v, lower);
      }
    }
    // half-cleaners across lanes: lane sub ^ d holds the same positions
    for (int d = k / (4 * VPT); d >= 1; d >>= 1) {
      const bool low = (sub & d) == 0;
#pragma unroll
      for (int v = 0; v < VPT; ++v) r[v] = keep(r[v], __shfl_xor_sync(0xffffffffu, r[v], d), low);
    }
    lane_half_cleaners<VPT / 2>(r);
  }
  if constexpr (std::is_same_v<T, double>) order_zeros(r, sub, lanes);

  if (!valid) return;
  const bool desc = (row % dp) & 1;
  T w[VPT];
#pragma unroll
  for (int v = 0; v < VPT; ++v) w[v] = desc ? r[VPT - 1 - v] : r[v];
  T* dst = out + static_cast<long long>(row) * m + (desc ? lanes - 1 - sub : sub) * VPT;
  if (kVector && aligned) {
    auto* q = reinterpret_cast<typename V::type*>(dst);
#pragma unroll
    for (int c = 0; c < VPT / V::n; ++c) q[c] = V::make(w + c * V::n);
  } else {
#pragma unroll
    for (int v = 0; v < VPT; ++v) dst[v] = w[v];
  }
}

// The long-row variant (rows of more than kWarpSortMax values): one block
// per slab row, bitonic-sorted in shared memory, ascending for even rows
// (row index within dp) and descending for odd ones.  K is the values' bit
// type; the row is sorted as keys (keyed as staged, turned back as stored).
template <typename K>
__global__ void sort_rows_alt_kernel(const K* __restrict__ in, K* __restrict__ out, int m, int dp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  K* s = reinterpret_cast<K*>(smem_raw);
  const long long row = blockIdx.x;
  const K* src = in + row * m;
  for (int i = threadIdx.x; i < m; i += blockDim.x) s[i] = order_key(src[i]);
  __syncthreads();
  const bool desc = (row % dp) & 1;
  const int pairs = m >> 1;
  for (int k = 2; k <= m; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
        const int lo = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const int hi = lo + j;
        const bool up = ((lo & k) == 0) != desc;
        const K a = s[lo];
        const K b = s[hi];
        if (up ? (a > b) : (a < b)) {
          s[lo] = b;
          s[hi] = a;
        }
      }
      __syncthreads();
    }
  }
  K* dst = out + row * m;
  for (int i = threadIdx.x; i < m; i += blockDim.x) dst[i] = order_key(s[i]);
}

// Value at ascending position i of a run of n values stored ascending, or
// descending when rev.
template <typename K>
__device__ __forceinline__ K at(const K* run, int i, int n, bool rev) {
  return rev ? run[n - 1 - i] : run[i];
}

// A run of bit patterns in device memory, read as keys.
template <typename K>
struct Keyed {
  const K* p;
  __device__ __forceinline__ K operator[](int i) const { return order_key(p[i]); }
};

// A run of n values stored descending, read ascending.
template <typename A>
struct Reversed {
  A p;
  int n;
  __device__ __forceinline__ auto operator[](int i) const { return p[n - 1 - i]; }
};

// Merge path of one pair of ascending runs of keys a (na values) and b (nb
// values), ties a first: writes outputs [k, k + count) of merge(a, b) to
// out, as bit patterns again when kBitsOut.  One co-rank search finds
// how many of the first k outputs come from a; then one comparison and one
// load per output, the two heads held in registers, with no branch on the
// data (the lanes of a warp never diverge).  a and b are pointers to keys,
// or Keyed or Reversed runs.
template <bool kBitsOut, typename A, typename B, typename K>
__device__ __forceinline__ void merge_range(A a, int na, B b, int nb, int k, int count, K* out) {
  int lo = k > nb ? k - nb : 0;
  int hi = k < na ? k : na;
  while (lo < hi) {
    const int i = (lo + hi) >> 1;
    if (a[i] > b[k - i - 1]) {
      hi = i;
    } else {
      lo = i + 1;
    }
  }
  int i = lo;
  int j = k - lo;
  K x = i < na ? a[i] : K(0);
  K y = j < nb ? b[j] : K(0);
  for (int c = 0; c < count; ++c) {
    const bool take_a = j >= nb || (i < na && x <= y);
    const K v = take_a ? x : y;
    out[c] = kBitsOut ? order_key(v) : v;
    i += take_a;
    j += !take_a;
    // the side just taken has a value, so its index clamps inside it
    const K next = take_a ? a[min(i, na - 1)] : b[min(j, nb - 1)];
    x = take_a ? next : x;
    y = take_a ? y : next;
  }
}

// Stores the block's n keys of s (shared memory) to run in device memory as
// bit patterns: 16-byte stores once run is aligned, a short head before and
// a tail after.
template <typename K>
__device__ __forceinline__ void store_run(K* run, const K* s, int n) {
  using V = Vec16<K>;
  const int mis = static_cast<int>((reinterpret_cast<unsigned long long>(run) / sizeof(K)) % V::n);
  const int head = min(n, (V::n - mis) % V::n);
  if (static_cast<int>(threadIdx.x) < head) run[threadIdx.x] = order_key(s[threadIdx.x]);
  const int n_vec = (n - head) / V::n;
  auto* vrun = reinterpret_cast<typename V::type*>(run + head);
  const bool vs_aligned = reinterpret_cast<unsigned long long>(s + head) % 16 == 0;
  for (int v = threadIdx.x; v < n_vec; v += blockDim.x) {
    K w[V::n];
    if (vs_aligned) {
      V::split(reinterpret_cast<const typename V::type*>(s + head)[v], w);
    } else {
#pragma unroll
      for (int e = 0; e < V::n; ++e) w[e] = s[head + v * V::n + e];
    }
#pragma unroll
    for (int e = 0; e < V::n; ++e) w[e] = order_key(w[e]);
    vrun[v] = V::make(w);
  }
  for (int i = head + n_vec * V::n + threadIdx.x; i < n; i += blockDim.x) run[i] = order_key(s[i]);
}

// ------------------------------------------------------------------ K5
// Outputs [d, d + count) of one level of a block's run: every aligned pair
// of h-value runs of src merged into one ascending 2h-value run of dst.
// kBits: src and dst hold bit patterns in device memory (keyed as loaded,
// turned back as stored), else keys in shared memory.  When kReversedRight (the
// slab itself, h = m), the right run of each pair is an odd slab row, stored
// descending.
template <bool kBits, bool kReversedRight, typename K>
__device__ __forceinline__ void merge_pairs(const K* src, int h, int d, int count, K* dst) {
  while (count > 0) {
    const int pair = d / (2 * h);
    const int k = d - pair * 2 * h;
    const int c = min(count, 2 * h - k);
    const K* a = src + static_cast<long long>(pair) * 2 * h;
    if constexpr (!kBits) {
      merge_range<false>(a, h, a + h, h, k, c, dst + d);
    } else if constexpr (kReversedRight) {
      merge_range<true>(Keyed<K>{a}, h, Reversed<Keyed<K>>{Keyed<K>{a + h}, h}, h, k, c, dst + d);
    } else {
      merge_range<true>(Keyed<K>{a}, h, Keyed<K>{a + h}, h, k, c, dst + d);
    }
    d += c;
    count -= c;
  }
}

// One block per (batch row b, aligned run of 2^L slab rows): level k of
// those rows, for every k < L, is each aligned pair of 2^k-row runs merged
// (level k - 1's runs; at k = 0 the slab rows, odd ones read from the end).
// Each thread merges a contiguous range of a level's outputs, odd in length
// (distinct shared-memory banks at the start).  kShared: the rows are
// staged in shared memory as keys and the levels ping-pong between two
// shared buffers, each level stored in 16-byte stores once merged.  Else
// every merge runs in device memory, level k reading the level k - 1 the
// block has just written: levels is not __restrict__ and never read through
// the read-only path, and __syncthreads() makes those writes visible.
template <typename K, bool kShared>
__global__ void __launch_bounds__(kThreads)
build_levels_kernel(const K* __restrict__ slab, K* levels, int dp, int m, int n_levels) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int runs = dp >> n_levels;
  const long long b = blockIdx.x / runs;
  const int g = static_cast<int>(blockIdx.x - b * runs);
  const int total = m << n_levels;
  const K* rows = slab + (b * dp + (static_cast<long long>(g) << n_levels)) * m;
  const long long level_stride = static_cast<long long>(dp) * m;
  K* const lv = levels + b * n_levels * level_stride + (static_cast<long long>(g) << n_levels) * m;
  const int step = ((total + blockDim.x - 1) / blockDim.x) | 1;

  if constexpr (kShared) {
    K* const buf0 = reinterpret_cast<K*>(smem_raw);
    K* const buf1 = buf0 + total;
    for (int j = threadIdx.x; j < total; j += blockDim.x) {
      const int r = j / m;
      const int c = j - r * m;
      __pipeline_memcpy_async(buf0 + j, rows + r * m + ((r & 1) ? m - 1 - c : c), sizeof(K));
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    // cp.async lands bit patterns: this thread's own, turned into keys.  On
    // an H100 this pass cost less than keying loads through registers, which
    // took 10 % longer here and 25 % longer in the window-31 fold (5 % less
    // in the window-5 merge)
    for (int j = threadIdx.x; j < total; j += blockDim.x) buf0[j] = order_key(buf0[j]);
    __syncthreads();
    for (int k = 0; k < n_levels; ++k) {
      const K* src = (k & 1) ? buf1 : buf0;
      K* dst = (k & 1) ? buf0 : buf1;
      for (int d = threadIdx.x * step; d < total; d += blockDim.x * step)
        merge_pairs<false, false>(src, m << k, d, min(step, total - d), dst);
      __syncthreads();
      // the next level reads dst and writes the other buffer: no sync here
      store_run(lv + k * level_stride, dst, total);
    }
  } else {
    for (int k = 0; k < n_levels; ++k) {
      K* dst = lv + k * level_stride;
      for (int d = threadIdx.x * step; d < total; d += blockDim.x * step) {
        if (k == 0) {
          merge_pairs<true, true>(rows, m, d, min(step, total - d), dst);
        } else {
          merge_pairs<true, false>(static_cast<const K*>(dst - level_stride), m << k, d, min(step, total - d), dst);
        }
      }
      __syncthreads();
    }
  }
}

// ------------------------------------------------------------------ K6 / K4

// One block per (batch row, group g): the window rows [g, g + window) split
// into aligned dyadic segments of at most 2^n_levels rows (the TPU kernel's
// _dyadic_segments), each an ascending run: a slab row (read from the end
// when odd) or a level run.  The segments are laid out smallest first; each
// one's first rows·ymax values (the rest are +inf by the caller's promise)
// are staged as keys (cp.async into shared memory and a pass keying what
// each thread staged; keying loads into the output row), then folded
// smallest first, as the TPU kernel folds: step k merges
// the run of the first k segments with segment k, by merge path (each
// thread a contiguous range of outputs, odd in length so that the threads'
// ranges start in distinct shared-memory banks), ping-ponging between two
// buffers.  At window 31 the 5 segments (1, 2, 4, 8 and 16 rows) take 4
// steps moving 56 rows of values, where ceil(log2 5) pairwise rounds would
// move the whole row each, 93 rows; and a step is one merge, with no search
// for its pair.
// With many equal segments the steps grow quadratically, but a window has
// few: at most 8 one-row segments below window 9, and levels above.
// Segment k is staged into the buffer step k reads, past the prefix step
// k - 1 writes there.  The second buffer is shared memory when both fit
// (kSharedScratch), else the block's own output row in device memory; the
// last step lands in shared memory, and the finished row is stored with
// coalesced 16-byte stores, as bit patterns again.  The window·ymax
// staged values fill the output row exactly.
template <typename K, bool kSharedScratch>
__global__ void __launch_bounds__(kThreads)
fold_windows_kernel(const K* __restrict__ slab, const K* __restrict__ levels, K* out, int dp, int m, int n_levels,
                    int window, int n_groups, int ymax) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  K* s = reinterpret_cast<K*>(smem_raw);
  __shared__ int seg_off[kMaxSegments + 1];
  __shared__ int seg_rows[kMaxSegments];
  __shared__ const K* seg_src[kMaxSegments];
  __shared__ bool seg_rev[kMaxSegments];
  __shared__ int n_seg;

  const long long bg = blockIdx.x;
  const long long b = bg / n_groups;
  const int g = static_cast<int>(bg - b * n_groups);
  if (threadIdx.x == 0) {
    const int max_rows = 1 << n_levels;
    int p = g;
    int n = 0;
    while (p < g + window && n < kMaxSegments) {
      // the largest power of two that divides p, fits the window's rest and
      // is at most max_rows (dyadic_segments' greedy rule, in O(1))
      const int rest = 1 << (31 - __clz(g + window - p));
      const int align = p == 0 ? max_rows : p & -p;
      const int size = min(min(align, rest), max_rows);
      // insert in ascending order of size (stable)
      int at_n = n;
      for (; at_n > 0 && seg_rows[at_n - 1] > size; --at_n) {
        seg_rows[at_n] = seg_rows[at_n - 1];
        seg_src[at_n] = seg_src[at_n - 1];
        seg_rev[at_n] = seg_rev[at_n - 1];
      }
      seg_rows[at_n] = size;
      if (size == 1) {
        seg_src[at_n] = slab + (b * dp + p) * m;
        seg_rev[at_n] = p & 1;
      } else {
        const int k = __ffs(size) - 2;  // level of a 2^(k+1)-row run
        seg_src[at_n] = levels + ((b * n_levels + k) * dp + p) * static_cast<long long>(m);
        seg_rev[at_n] = false;
      }
      p += size;
      ++n;
    }
    seg_off[0] = 0;
    for (int t = 0; t < n; ++t) seg_off[t + 1] = seg_off[t] + seg_rows[t] * ymax;
    n_seg = n;
  }
  __syncthreads();

  const int ns = n_seg;
  const int total = seg_off[ns];
  K* row = out + bg * total;
  // the two merge buffers: s, and scratch (shared memory or the output row);
  // step k writes s when ns - 1 - k is even, so the last step writes s
  K* const scratch = kSharedScratch ? s + total : row;
  // the buffer segment t's first step reads (s for a lone segment)
  const auto into_s = [&](int t) { return ((ns - 1 - max(t, 1)) & 1) != 0; };

  for (int t = 0; t < ns; ++t) {
    const int len = seg_off[t + 1] - seg_off[t];
    const K* run = seg_src[t];
    const bool rev = seg_rev[t];
    K* to = (into_s(t) ? s : scratch) + seg_off[t];
    if (kSharedScratch || into_s(t)) {
      // into shared memory: every copy in flight at once (cp.async)
      for (int j = threadIdx.x; j < len; j += blockDim.x)
        __pipeline_memcpy_async(to + j, rev ? run + m - 1 - j : run + j, sizeof(K));
    } else {
      for (int j = threadIdx.x; j < len; j += blockDim.x) to[j] = order_key(at(run, j, m, rev));
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  // cp.async lands bit patterns: key the values this thread staged
  for (int t = 0; t < ns; ++t) {
    if (!kSharedScratch && !into_s(t)) continue;
    K* to = (into_s(t) ? s : scratch) + seg_off[t];
    for (int j = threadIdx.x; j < seg_off[t + 1] - seg_off[t]; j += blockDim.x) to[j] = order_key(to[j]);
  }
  __syncthreads();

  for (int k = 1; k < ns; ++k) {
    const bool to_s = !((ns - 1 - k) & 1);
    const K* src = to_s ? scratch : s;
    K* dst = to_s ? s : scratch;
    const int na = seg_off[k];
    const int n_out = seg_off[k + 1];
    const int step = ((n_out + blockDim.x - 1) / blockDim.x) | 1;
    for (int d = threadIdx.x * step; d < n_out; d += blockDim.x * step)
      merge_range<false>(src, na, src + na, n_out - na, d, min(step, n_out - d), dst + d);
    __syncthreads();
  }

  // the merged row is in s
  store_run(row, s, total);
}

template <typename T, int VPT>
int launch_warp_sort(const void* in, void* out, long long rows, int m, int dp, cudaStream_t stream) {
  const long long threads = rows * (m / VPT);
  const long long blocks = (threads + kSortWarps * 32 - 1) / (kSortWarps * 32);
  const bool aligned = ((reinterpret_cast<unsigned long long>(in) | reinterpret_cast<unsigned long long>(out)) % 16) == 0;
  sort_rows_warp_kernel<T, VPT><<<static_cast<unsigned>(blocks), kSortWarps * 32, 0, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), rows, m, dp, aligned);
  return static_cast<int>(cudaGetLastError());
}

// T float or double.  The long-row variant sorts the values' keys.
template <typename T>
int sort_rows_alt(const void* in, void* out, long long rows, int m, int dp, bool in_warp, cudaStream_t stream) {
  using K = typename BitsOf<T>::type;
  if (in_warp) {
    switch (m <= 32 ? 1 : m / 32) {
      case 1: return launch_warp_sort<T, 1>(in, out, rows, m, dp, stream);
      case 2: return launch_warp_sort<T, 2>(in, out, rows, m, dp, stream);
      case 4: return launch_warp_sort<T, 4>(in, out, rows, m, dp, stream);
      case 8: return launch_warp_sort<T, 8>(in, out, rows, m, dp, stream);
      case 16: return launch_warp_sort<T, 16>(in, out, rows, m, dp, stream);
      case 32: return launch_warp_sort<T, 32>(in, out, rows, m, dp, stream);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const int threads = std::min(std::max(m / 2, 32), 512);
  const size_t smem = static_cast<size_t>(m) * sizeof(K);
  sort_rows_alt_kernel<K><<<static_cast<unsigned>(rows), threads, smem, stream>>>(
      static_cast<const K*>(in), static_cast<K*>(out), m, dp);
  return static_cast<int>(cudaGetLastError());
}

// Threads of a merging block (fold or level build): enough for its n
// values at about 9 outputs a thread, at most kThreads.
inline int fold_threads(int total) { return std::min(kThreads, ((total + 8) / 9 + 31) / 32 * 32); }

// The level build and the fold take K, the values' bit type (int for
// float, long long for double).
template <typename K, bool kShared>
int launch_levels(const void* slab, void* levels, int batch, int dp, int m, int n_levels, cudaStream_t stream) {
  const int total = m << n_levels;
  const size_t smem = kShared ? 2 * static_cast<size_t>(total) * sizeof(K) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(build_levels_kernel<K, kShared>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = static_cast<long long>(batch) * (dp >> n_levels);
  build_levels_kernel<K, kShared><<<static_cast<unsigned>(blocks), fold_threads(total), smem, stream>>>(
      static_cast<const K*>(slab), static_cast<K*>(levels), dp, m, n_levels);
  return static_cast<int>(cudaGetLastError());
}

template <typename K>
int build_levels(const void* slab, void* levels, int batch, int dp, int m, int n_levels, bool in_shared,
                 cudaStream_t stream) {
  return in_shared ? launch_levels<K, true>(slab, levels, batch, dp, m, n_levels, stream)
                   : launch_levels<K, false>(slab, levels, batch, dp, m, n_levels, stream);
}

template <typename K, bool kSharedScratch>
int launch_fold(const void* slab, const void* levels, void* out, int batch, int dp, int m, int n_levels, int window,
                int n_groups, int ymax, cudaStream_t stream) {
  const int total = window * ymax;
  const size_t smem = static_cast<size_t>(total) * sizeof(K) * (kSharedScratch ? 2 : 1);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(fold_windows_kernel<K, kSharedScratch>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = fold_threads(total);
  const long long blocks = static_cast<long long>(batch) * n_groups;
  fold_windows_kernel<K, kSharedScratch><<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      static_cast<const K*>(slab), static_cast<const K*>(levels), static_cast<K*>(out), dp, m, n_levels, window,
      n_groups, ymax);
  return static_cast<int>(cudaGetLastError());
}

template <typename K>
int fold_windows(const void* slab, const void* levels, void* out, int batch, int dp, int m, int n_levels,
                 int window, int n_groups, int ymax, bool shared_scratch, cudaStream_t stream) {
  return shared_scratch
             ? launch_fold<K, true>(slab, levels, out, batch, dp, m, n_levels, window, n_groups, ymax, stream)
             : launch_fold<K, false>(slab, levels, out, batch, dp, m, n_levels, window, n_groups, ymax, stream);
}

}  // namespace

// Every entry launches on `stream` of CUDA device `device` (and leaves the
// calling thread's current device as it found it), takes elements
// of elem_size bytes (4: float, 8: double) and returns cudaGetLastError()
// (0 on success).  The caller checks shapes; these check only what would
// make a launch invalid.

// rows = B * dp slab rows of m values (m a power of two, m * elem_size <= 48 KB);
// in_warp: the warp sort (m <= 1024), else the long-row variant.
extern "C" int xsdba_sort_rows_alt(const void* in, void* out, long long rows, int m, int dp, int elem_size,
                                   int in_warp, int device, void* stream) {
  if (rows < 0 || m < 1 || (m & (m - 1)) != 0 || dp < 1 || static_cast<long long>(m) * elem_size > 48 * 1024 ||
      rows >= (1LL << 31) || (in_warp && m > kWarpSortMax))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const xsdba::DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return static_cast<int>(guard.status());
  const auto s = static_cast<cudaStream_t>(stream);
  if (elem_size == 4) return sort_rows_alt<float>(in, out, rows, m, dp, in_warp, s);
  if (elem_size == 8) return sort_rows_alt<double>(in, out, rows, m, dp, in_warp, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// slab [batch, dp, m] (alternating rows) -> levels [batch, n_levels, dp, m];
// dp a multiple of 2^n_levels.  in_shared: the merges in shared memory
// (2 * m * 2^n_levels * elem_size bytes a block), else in device memory.
extern "C" int xsdba_build_levels(const void* slab, void* levels, int batch, int dp, int m, int n_levels,
                                  int elem_size, int in_shared, int device, void* stream) {
  if (batch < 0 || dp < 1 || m < 1 || n_levels < 1 || n_levels > 30 || dp % (1 << n_levels) != 0 ||
      (static_cast<long long>(m) << n_levels) >= (1LL << 30) ||
      static_cast<long long>(batch) * (dp >> n_levels) >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const xsdba::DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return static_cast<int>(guard.status());
  const auto s = static_cast<cudaStream_t>(stream);
  if (elem_size == 4) return build_levels<int>(slab, levels, batch, dp, m, n_levels, in_shared, s);
  if (elem_size == 8) return build_levels<long long>(slab, levels, batch, dp, m, n_levels, in_shared, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// slab [batch, dp, m] and levels [batch, n_levels, dp, m] (n_levels 0: no
// levels, every segment one slab row) -> out [batch, n_groups, window * ymax].
// Needs n_groups - 1 + window <= dp, ymax <= m, at most 64 segments a window
// and window * ymax * elem_size bytes of shared memory, twice that when
// shared_scratch (the merge steps' second buffer in shared memory rather
// than in the output row).
extern "C" int xsdba_fold_windows(const void* slab, const void* levels, void* out, int batch, int dp, int m,
                                  int n_levels, int window, int n_groups, int ymax, int elem_size,
                                  int shared_scratch, int device, void* stream) {
  if (batch < 0 || n_groups < 0 || window < 1 || ymax < 1 || ymax > m || n_levels < 0 ||
      n_groups - 1 + window > dp || static_cast<long long>(batch) * n_groups >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || n_groups == 0) return 0;
  const xsdba::DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return static_cast<int>(guard.status());
  const auto s = static_cast<cudaStream_t>(stream);
  if (elem_size == 4)
    return fold_windows<int>(slab, levels, out, batch, dp, m, n_levels, window, n_groups, ymax, shared_scratch, s);
  if (elem_size == 8)
    return fold_windows<long long>(slab, levels, out, batch, dp, m, n_levels, window, n_groups, ymax, shared_scratch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Bytes of dynamic shared memory a fold block may take on `device` (the
// device's opt-in limit less the kernel's static shared memory), or a
// negative cudaError_t.  The level build, which declares no static shared
// memory, takes the same limit.
extern "C" long long xsdba_fold_smem_limit(int elem_size, int device) {
  const xsdba::DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return -static_cast<long long>(guard.status());
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  cudaFuncAttributes attr;
  // both variants declare the same static shared memory
  err = elem_size == 8 ? cudaFuncGetAttributes(&attr, fold_windows_kernel<long long, false>)
                       : cudaFuncGetAttributes(&attr, fold_windows_kernel<int, false>);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  return static_cast<long long>(optin) - static_cast<long long>(attr.sharedSizeBytes);
}

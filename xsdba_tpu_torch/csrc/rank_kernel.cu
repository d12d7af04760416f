// Grouped percent rank written back to time: for every leading row b and
// group g, the values x[b, gather[g, :]] ranked within the group (ties
// averaged, ranks from 1, NaN and -1 slots left out), optionally divided by
// the group's valid count and rescaled to span [0, max] as the reference
// does (xsdba utils.py:631-634: mx * (r - mn) / (mx - mn)), and each slot j
// written to out[b, t], t = gather[g, j], where t's own group and slot are
// (g, j): every slot of a monthly group, the centre of each window of a
// windowed one.
//
// It replaces no TPU kernel: the JAX package ranks with plain JAX (a gather,
// a sort, cumulative-max scans and a scatter back).  Its plain twin is
// xsdba_tpu_torch/ops/segment.py:grouped_rank_reference (the same chain in
// PyTorch: gather into a NaN-padded [B, G, L] slab, a stable sort with an
// int64 permutation, two cummax scans, a scatter along the permutation,
// nanmin / nanmax, the rescale, a gather back to time), which takes some 25
// launches and, at QDM's headline shape, several [B, G, L] int64
// intermediates.
//
// Bound: bytes.  x is read once and out written once (8 bytes a value in
// float32); the index rows of a group are read by each of its rows and stay
// in L2.  The design keeps the whole group in shared memory:
//   - one block per (row, group), kThreads threads holding kItems values
//     each, in the smallest of four plans whose kThreads * kItems covers the
//     group's length L (1152, 2816, 4864, 11776 slots);
//   - each value becomes the order-preserving unsigned image of its float
//     (sign bit flipped for non-negatives, all bits for negatives), -0.0
//     keyed as +0.0 (one tie run, as the twin's s != prev compares them),
//     NaN and empty slots as all ones, above +inf (ROADMAP trap C1: NaNs
//     never join the +inf run), with its slot j as a 16-bit payload.  A
//     thread issues all its index loads, then all its value loads, at
//     clamped addresses, so that they are in flight together;
//   - one AND / OR reduction finds the bits in which the valid keys differ;
//     the sort is an LSD radix sort of 8-bit digits in shared memory with
//     one pass per digit in which they differ (a pass over a digit they
//     share would leave the order as it is: temperatures in kelvin share
//     their top byte, so a float32 group takes three passes);
//   - the first pass need not be stable (its input order is arbitrary): the
//     valid keys are counted and placed by shared-memory atomics, the empty
//     keys behind them, warp after warp;
//   - every later pass is stable: a per-warp digit histogram (the lanes
//     sharing a digit found by 8 ballots, one leader adding their count),
//     one block-wide exclusive scan of the 256 x warps counts, a scatter;
//   - in sorted order a thread takes kItems consecutive positions; the runs
//     inside its range follow from comparing neighbours, and only a run that
//     crosses into a neighbour's range needs a binary search for its start
//     or end, so rank = (a + b) / 2 + 1 needs no block-wide scan; the least
//     and greatest ranks are those of positions 0 and nvalid - 1;
//   - each result goes to shared memory at its slot, and the block writes
//     out[b, t] slot by slot, so reads and writes follow the index row's
//     runs of consecutive days.
// On an H100 at [4096, 54750] monthly float32 (the benchmark's QDM block)
// the kernel takes about 3.8 ms against a 0.54 ms bound: two thirds of it
// the passes, which wait on shared memory and barriers (PERF.md, section 6).
// The arithmetic is the twin's, operation for operation in T (built with
// -fmad=false): float(a + b) / 2 + 1, / nvalid, and mx * (r - mn) / denom
// with denom = 1 where mx - mn == 0, so the kernel equals the twin bit for
// bit.
//
// Layout: x and out [rows, t_len] row-major; gather [groups, len] int32,
// -1 for an empty slot (an index past t_len reads x[t_len - 1], as the
// twin's clamp does); group_of and slot_of [t_len] int32.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kDigits = 256;

template <typename T>
struct Key;
template <>
struct Key<float> {
  using type = unsigned;
  static constexpr unsigned kEmpty = 0xffffffffu;
  static __device__ __forceinline__ unsigned of(float v) {
    if (isnan(v)) return kEmpty;
    unsigned u = __float_as_uint(v);
    if ((u << 1) == 0) u = 0;  // -0.0 as +0.0
    return u ^ ((u >> 31) ? 0xffffffffu : 0x80000000u);
  }
};
template <>
struct Key<double> {
  using type = unsigned long long;
  static constexpr unsigned long long kEmpty = 0xffffffffffffffffull;
  static __device__ __forceinline__ unsigned long long of(double v) {
    if (isnan(v)) return kEmpty;
    unsigned long long u = static_cast<unsigned long long>(__double_as_longlong(v));
    if ((u << 1) == 0) u = 0;
    return u ^ ((u >> 63) ? 0xffffffffffffffffull : 0x8000000000000000ull);
  }
};

template <typename T>
__device__ __forceinline__ T quiet_nan();
template <>
__device__ __forceinline__ float quiet_nan<float>() { return __int_as_float(0x7fc00000); }
template <>
__device__ __forceinline__ double quiet_nan<double>() { return __longlong_as_double(0x7ff8000000000000ll); }

template <typename K>
__device__ __forceinline__ K warp_and(K v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v &= __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename K>
__device__ __forceinline__ K warp_or(K v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v |= __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Lanes of the warp whose 8-bit digit equals this lane's (8 ballots).
__device__ __forceinline__ unsigned same_digit_lanes(unsigned d) {
  unsigned peers = 0xffffffffu;
#pragma unroll
  for (int bit = 0; bit < 8; ++bit) {
    const bool set = (d >> bit) & 1u;
    const unsigned on = __ballot_sync(0xffffffffu, set);
    peers &= set ? on : ~on;
  }
  return peers;
}

// The plan of a block: kThreads threads of kItems slots each.
template <typename T, int kThreads, int kItems>
struct Plan {
  using K = typename Key<T>::type;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kCap = kThreads * kItems;
  static constexpr int kDigitStride = kWarps + 1;  // a pad word per digit: a warp's lanes spread over the banks
  static constexpr int kCounts = kDigits * kDigitStride;
  static constexpr int kCountsPerThread = kDigits * kWarps / kThreads;  // 8
  // shared memory: keys (then results) | AND, OR of the valid keys |
  // digit counts | warp sums | slots
  static constexpr size_t kRedOff = static_cast<size_t>(kCap) * sizeof(K);
  static constexpr size_t kCountsOff = kRedOff + 2 * sizeof(K);
  static constexpr size_t kWarpSumsOff = kCountsOff + kCounts * sizeof(int);
  static constexpr size_t kSlotsOff = kWarpSumsOff + 32 * sizeof(int);
  static constexpr size_t kSmem = kSlotsOff + static_cast<size_t>(kCap) * sizeof(unsigned short);
  static_assert(kCap < 65536, "slots are 16-bit");
  static_assert(kItems <= 32, "a thread's run ends are bits of one word");
  static_assert(kWarps <= 32 && kThreads % 32 == 0, "one warp scans the warp sums");
  static_assert(sizeof(T) == sizeof(K), "results overwrite the keys");
  static_assert(kRedOff % sizeof(K) == 0, "aligned reductions");
};

// Exclusive scan in place of the digit-major counts (digit d, warp w at
// d * kDigitStride + w), kCountsPerThread consecutive ones a thread.
template <typename P>
__device__ void block_exclusive_scan(int* counts, int* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int f0 = threadIdx.x * P::kCountsPerThread;
  int local[P::kCountsPerThread];
  int sum = 0;
#pragma unroll
  for (int c = 0; c < P::kCountsPerThread; ++c) {
    const int f = f0 + c;
    local[c] = counts[(f / P::kWarps) * P::kDigitStride + f % P::kWarps];
    sum += local[c];
  }
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < P::kWarps ? warp_sums[lane] : 0;
    const int total = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += v;
    }
    if (lane < P::kWarps) warp_sums[lane] = w - total;  // exclusive
  }
  __syncthreads();
  int run = warp_sums[warp] + incl - sum;
#pragma unroll
  for (int c = 0; c < P::kCountsPerThread; ++c) {
    const int f = f0 + c;
    counts[(f / P::kWarps) * P::kDigitStride + f % P::kWarps] = run;
    run += local[c];
  }
}

// First position in [lo, hi) whose key is >= k (> k with kUpper), or hi.
template <bool kUpper, typename K>
__device__ __forceinline__ int search(const K* sk, int lo, int hi, K k) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const K v = sk[mid];
    if (kUpper ? v <= k : v < k) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <typename T, int kThreads, int kItems, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
grouped_rank_kernel(const T* __restrict__ x, const int* __restrict__ gather, const int* __restrict__ group_of,
                    const int* __restrict__ slot_of, T* __restrict__ out, int t_len, int groups, int len, int pct) {
  using P = Plan<T, kThreads, kItems>;
  using K = typename P::K;
  constexpr K kEmpty = Key<T>::kEmpty;
  constexpr int kKeyBits = 8 * sizeof(K);
  extern __shared__ __align__(16) unsigned char smem[];
  K* sk = reinterpret_cast<K*>(smem);
  K* red = reinterpret_cast<K*>(smem + P::kRedOff);
  int* counts = reinterpret_cast<int*>(smem + P::kCountsOff);
  int* warp_sums = reinterpret_cast<int*>(smem + P::kWarpSumsOff);
  unsigned short* ss = reinterpret_cast<unsigned short*>(smem + P::kSlotsOff);

  const long long row = blockIdx.x / groups;
  const int g = static_cast<int>(blockIdx.x - row * groups);
  const T* xrow = x + row * t_len;
  T* orow = out + row * t_len;
  const int* grow = gather + static_cast<long long>(g) * len;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  // the radix passes hold item `it` of a thread at position first + it * 32
  const int first = warp * (kItems * 32) + lane;

  if (threadIdx.x == 0) {
    red[0] = ~K(0);
    red[1] = K(0);
  }
  for (int c = threadIdx.x; c < kDigits; c += kThreads) counts[c] = 0;
  __syncthreads();

  // 1. the group's keys, slot j = first + it * 32 (coalesced along the
  // index row); the AND and OR of the valid ones, and each warp's count
  // (every load is made, at a clamped address, and its value dropped after,
  // so that a thread's loads are all in flight at once)
  K k[kItems];
  unsigned s[kItems];  // slot in the low 16 bits; a pass's local rank in the high 16
  K kand = ~K(0), kor = K(0);
  int warp_valid = 0;
#pragma unroll
  for (int it = 0; it < kItems; ++it) s[it] = static_cast<unsigned>(__ldg(grow + min(first + it * 32, len - 1)));
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int j = first + it * 32;
    const int t = static_cast<int>(s[it]);
    const T v = __ldg(xrow + min(max(t, 0), t_len - 1));
    const K key = j < len && t >= 0 ? Key<T>::of(v) : kEmpty;
    k[it] = key;
    s[it] = static_cast<unsigned>(j);
    if (key != kEmpty) {
      kand &= key;
      kor |= key;
    }
  }
#pragma unroll
  for (int it = 0; it < kItems; ++it) warp_valid += __popc(__ballot_sync(0xffffffffu, k[it] != kEmpty));
  kand = warp_and(kand);
  kor = warp_or(kor);
  if (lane == 0) {
    atomicAnd(red, kand);
    atomicOr(red + 1, kor);
    warp_sums[warp] = warp_valid;
  }
  __syncthreads();
  int nvalid = 0, empty_base = 0;  // the empty keys of this warp go after those of the warps before it
#pragma unroll
  for (int w = 0; w < P::kWarps; ++w) {
    const int n = warp_sums[w];
    nvalid += n;
    if (w < warp) empty_base += kItems * 32 - n;
  }
  const K vary = red[1] & ~red[0];  // bits in which the valid keys differ
  int first_shift = -1, last_shift = -1;
  for (int shift = kKeyBits - 8; shift >= 0; shift -= 8) {
    if ((vary >> shift) & K(0xff)) {
      first_shift = shift;
      if (last_shift < 0) last_shift = shift;
    }
  }

  // 2. the first pass, in any order (an LSD sort's first pass need not be
  // stable): the valid keys counted and placed by their lowest digit that
  // differs (all in one bucket where none does) through shared-memory
  // atomics, the empty keys behind them, warp after warp
  const int shift0 = first_shift < 0 ? 0 : first_shift;
  const K digit_mask = first_shift < 0 ? K(0) : K(0xff);
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    if (k[it] != kEmpty) atomicAdd(counts + static_cast<int>((k[it] >> shift0) & digit_mask), 1);
  }
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the 256 counts, 8 a lane
    int local[kDigits / 32];
    int sum = 0;
#pragma unroll
    for (int c = 0; c < kDigits / 32; ++c) {
      local[c] = counts[lane * (kDigits / 32) + c];
      sum += local[c];
    }
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    int run = incl - sum;
#pragma unroll
    for (int c = 0; c < kDigits / 32; ++c) {
      counts[lane * (kDigits / 32) + c] = run;
      run += local[c];
    }
  }
  __syncthreads();
  int empty_run = nvalid + empty_base;
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const bool valid = k[it] != kEmpty;
    const unsigned eb = __ballot_sync(0xffffffffu, !valid);
    const int pos = valid ? atomicAdd(counts + static_cast<int>((k[it] >> shift0) & digit_mask), 1)
                          : empty_run + __popc(eb & lower);
    empty_run += __popc(eb);
    sk[pos] = k[it];
    ss[pos] = static_cast<unsigned short>(s[it]);
  }
  __syncthreads();

  // 3. stable LSD passes over the other digits in which the valid keys
  // differ; the empty keys, all ones, stay behind the valid ones
  for (int shift = shift0 + 8; shift <= last_shift; shift += 8) {
    if (((vary >> shift) & K(0xff)) == 0) continue;  // the same for the whole block
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      k[it] = sk[first + it * 32];
      s[it] = ss[first + it * 32];
    }
#pragma unroll
    for (int c = threadIdx.x; c < P::kCounts; c += kThreads) counts[c] = 0;
    __syncthreads();
    // per-warp histogram; each item's rank among its warp's items of its digit
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const unsigned d = static_cast<unsigned>((k[it] >> shift) & K(0xff));
      const unsigned peers = same_digit_lanes(d);
      int* c = counts + d * P::kDigitStride + warp;
      const int at = *c;
      __syncwarp();
      s[it] = (s[it] & 0xffffu) | (static_cast<unsigned>(at + __popc(peers & lower)) << 16);
      if (lane == 31 - __clz(peers)) *c = at + __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    block_exclusive_scan<P>(counts, warp_sums);
    __syncthreads();
    // stable scatter
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const unsigned d = static_cast<unsigned>((k[it] >> shift) & K(0xff));
      const int pos = counts[d * P::kDigitStride + warp] + static_cast<int>(s[it] >> 16);
      sk[pos] = k[it];
      ss[pos] = static_cast<unsigned short>(s[it] & 0xffffu);
    }
    __syncthreads();
  }

  // 4. tie-averaged ranks; thread i holds sorted positions [p0, p0 + kItems),
  // its valid ones up to p0 + last.  Bit i of `cut` marks a run ending at
  // p0 + i before the thread's last valid item; the runs of its first and
  // last items may reach past its range: where a neighbour holds the same
  // key, a search finds their start (a0) and end (b1).
  const int p0 = threadIdx.x * kItems;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    k[i] = sk[p0 + i];
    s[i] = ss[p0 + i];
  }
  const int last = min(kItems, nvalid - p0) - 1;  // negative where the thread holds no valid item
  int a0 = 0, b1 = 0;
  unsigned cut = 0;
  if (last >= 0) {
    K k_last = k[0];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (i == last) k_last = k[i];
      if (i + 1 < kItems && i < last && k[i] != k[i + 1]) cut |= 1u << i;
    }
    a0 = p0 == 0 || sk[p0 - 1] != k[0] ? p0 : search<false>(sk, 0, p0, k[0]);
    const int next = p0 + last + 1;
    b1 = (next == nvalid || sk[next] != k_last ? next : search<true>(sk, next, nvalid, k_last)) - 1;
  }
  if (threadIdx.x == 0 && nvalid > 0) {
    // the least and greatest ranks: the runs of positions 0 and nvalid - 1
    warp_sums[0] = search<true>(sk, 1, nvalid, sk[0]) - 1;
    warp_sums[1] = search<false>(sk, 0, nvalid - 1, sk[nvalid - 1]);
  }
  __syncthreads();  // every search is done: the results may take the keys' place
  T* sres = reinterpret_cast<T*>(sk);
  const int b_min = warp_sums[0], a_max = warp_sums[1];
  const T nv = static_cast<T>(nvalid);
  const T r_min = (static_cast<T>(b_min) / T(2) + T(1)) / nv;
  const T r_max = (static_cast<T>(a_max + nvalid - 1) / T(2) + T(1)) / nv;
  const T diff = r_max - r_min;
  const T denom = diff == T(0) ? T(1) : diff;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    T res = quiet_nan<T>();
    if (i <= last) {
      const unsigned before = cut & ((1u << i) - 1u);  // the last run end before item i
      const unsigned from = cut >> i;                   // the first run end at or after it
      const int a = before ? p0 + 32 - __clz(before) : a0;
      const int b = from ? p0 + i + __ffs(from) - 1 : b1;
      const T rnk = static_cast<T>(a + b) / T(2) + T(1);
      res = pct ? r_max * (rnk / nv - r_min) / denom : rnk;
    }
    sres[s[i] & 0xffffu] = res;
  }
  __syncthreads();

  // 5. back to time: slot j lands on t = gather[g, j] where t's own group
  // and slot are (g, j)
  int tj[kItems], own[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) tj[it] = __ldg(grow + min(static_cast<int>(threadIdx.x) + it * kThreads, len - 1));
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int j = threadIdx.x + it * kThreads;
    const int tc = min(max(tj[it], 0), t_len - 1);
    const bool owned = __ldg(group_of + tc) == g && __ldg(slot_of + tc) == j;
    own[it] = j < len && tj[it] >= 0 && tj[it] < t_len && owned;
  }
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    if (own[it]) orow[tj[it]] = sres[threadIdx.x + it * kThreads];
  }
}

template <typename T, int kThreads, int kItems, int kMinBlocks>
int launch_plan(const T* x, const int* gather, const int* group_of, const int* slot_of, T* out, long long rows,
                int t_len, int groups, int len, int pct, cudaStream_t stream) {
  using P = Plan<T, kThreads, kItems>;
  auto kernel = grouped_rank_kernel<T, kThreads, kItems, kMinBlocks>;
  if (P::kSmem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                static_cast<int>(P::kSmem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  kernel<<<static_cast<unsigned>(rows * groups), kThreads, P::kSmem, stream>>>(x, gather, group_of, slot_of, out,
                                                                               t_len, groups, len, pct);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const int* gather, const int* group_of, const int* slot_of, void* out, long long rows,
           int t_len, int groups, int len, int pct, cudaStream_t stream) {
  const auto* px = static_cast<const T*>(x);
  auto* po = static_cast<T*>(out);
  if (len <= 128 * 9) return launch_plan<T, 128, 9, 8>(px, gather, group_of, slot_of, po, rows, t_len, groups, len, pct, stream);
  if (len <= 256 * 11) return launch_plan<T, 256, 11, 4>(px, gather, group_of, slot_of, po, rows, t_len, groups, len, pct, stream);
  if (len <= 256 * 19) return launch_plan<T, 256, 19, sizeof(T) == 4 ? 4 : 3>(px, gather, group_of, slot_of, po, rows, t_len, groups, len, pct, stream);
  return launch_plan<T, 512, 23, 1>(px, gather, group_of, slot_of, po, rows, t_len, groups, len, pct, stream);
}

}  // namespace

// The longest group (gather's row length) a plan covers.
extern "C" int xsdba_grouped_rank_max_len() { return 512 * 23; }

// out [rows, t_len] = the grouped (percent) rank of x [rows, t_len] over
// the groups of gather [groups, len], written back to time through
// group_of / slot_of [t_len] (see the top of this file); `pct` divides by
// the valid count and rescales, `is_double` picks float64 over float32.
// Launches on `stream` of CUDA device `device` (leaving the calling
// thread's current device as it found it) and returns cudaGetLastError()
// (0 on success).  A time step no slot writes is left as it was.
extern "C" int xsdba_grouped_rank(const void* x, const int* gather, const int* group_of, const int* slot_of, void* out,
                                  long long rows, int t_len, int groups, int len, int pct, int is_double, int device,
                                  void* stream) {
  if (rows < 0 || t_len < 0 || groups < 0 || len < 1 || len > xsdba_grouped_rank_max_len()) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0 || t_len == 0 || groups == 0) return 0;
  if (rows * groups > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const xsdba::DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return static_cast<int>(guard.status());
  const auto s = static_cast<cudaStream_t>(stream);
  return is_double ? launch<double>(x, gather, group_of, slot_of, out, rows, t_len, groups, len, pct, s)
                   : launch<float>(x, gather, group_of, slot_of, out, rows, t_len, groups, len, pct, s);
}

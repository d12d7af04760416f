// Windowed-group merge kernels of the windowed quantile: the row sort, the
// dyadic level build and the window fold.
//
// Replaces xsdba_tpu/ops/pallas/merge_kernel.py:
//   sort_rows_alternating        (K3, _sort_rows_kernel / _bitonic_sort_lastaxis)
//     -> sort_rows_alt_kernel
//   _merged_window_rows_shared_impl, _build_levels_kernel (K5)
//     -> build_level_kernel, launched once per level
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
// Bound.  The Pallas kernels are compare-exchange networks sized for VMEM
// and the VPU's roll/iota lanes.  On Hopper the scarce thing is a block's
// shared memory and its synchronisations.  The level build is a rank merge:
// every value finds its output slot on its own, as its index in its run
// plus its binary-search rank in the partner run, read from device memory
// (the L1/L2 caches hold it: a run is at most 2^L·m values), and is written
// once.  A merge of runs A then B (ties: A first) puts a in slot
// i + #{b < a} and b in slot j + #{a <= b}, a permutation for any total
// preorder, so ties and +-0.0 need no care beyond a fixed order of the runs.
// It is bound by those dependent loads, not by bytes.  The row sort is a
// bitonic network in shared memory, one block per row, bound by its
// log2(m)^2/2 block-wide synchronisations.
//
// The window fold is bound by bytes: its [B, G, window·ymax] output (3.47 GB
// at the heavy path's [512, 365, 4650] f32, 1.351 ms at 3.35 TB/s with its
// inputs).  A rank merge there would cost every value a binary search in
// every other segment (about 5 x 11 dependent shared loads a value) and a
// store to a scattered slot.  So the fold merges by merge path: the
// segments, staged with cp.async, are folded smallest first (4 steps at
// window 31, moving 56 rows of values in all for the window's 31), each
// thread taking a contiguous range of a step's outputs, placed by one
// co-rank search, then one comparison and one shared load per output with
// no branch on the data; the finished row leaves shared memory in 16-byte
// stores, so every store is coalesced.  What is left is instruction issue
// in the steps (about 18 instructions an output a step).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSegments = 64;

// ------------------------------------------------------------------ K3
// One block per slab row: load the row, bitonic-sort it in shared memory,
// ascending for even rows (row index within dp) and descending for odd ones.
template <typename T>
__global__ void sort_rows_alt_kernel(const T* __restrict__ in, T* __restrict__ out, int m, int dp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const long long row = blockIdx.x;
  const T* src = in + row * m;
  for (int i = threadIdx.x; i < m; i += blockDim.x) s[i] = src[i];
  __syncthreads();
  const bool desc = (row % dp) & 1;
  const int pairs = m >> 1;
  for (int k = 2; k <= m; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
        const int lo = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const int hi = lo + j;
        const bool up = ((lo & k) == 0) != desc;
        const T a = s[lo];
        const T b = s[hi];
        if (up ? (a > b) : (a < b)) {
          s[lo] = b;
          s[hi] = a;
        }
      }
      __syncthreads();
    }
  }
  T* dst = out + row * m;
  for (int i = threadIdx.x; i < m; i += blockDim.x) dst[i] = s[i];
}

// Value at ascending position i of a run of n values stored ascending, or
// descending when rev.
template <typename T>
__device__ __forceinline__ T at(const T* run, int i, int n, bool rev) {
  return rev ? run[n - 1 - i] : run[i];
}

// Number of values of the run below x (or at most x when inclusive).
template <typename T>
__device__ __forceinline__ int rank_in(const T* run, int n, bool rev, T x, bool inclusive) {
  int lo = 0;
  int hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const T v = at(run, mid, n, rev);
    if (inclusive ? (v <= x) : (v < x)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// ------------------------------------------------------------------ K5
// One level: every aligned pair of h-value runs of src (per batch row,
// stride src_bs) becomes one ascending 2h-value run of dst (stride dst_bs).
// At the base level (src = the slab, h = m) the right run of each pair is
// an odd row, stored descending.  One thread per value.
template <typename T>
__global__ void build_level_kernel(const T* __restrict__ src, long long src_bs, T* __restrict__ dst,
                                   long long dst_bs, long long per_batch, int h, bool base,
                                   long long total) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; e < total; e += stride) {
    const long long b = e / per_batch;
    const long long w = e - b * per_batch;
    const long long pair = w / (2 * h);
    const int pos = static_cast<int>(w - pair * 2 * h);
    const T* left = src + b * src_bs + pair * 2 * h;
    const T* right = left + h;
    T x;
    int slot;
    if (pos < h) {
      x = left[pos];
      slot = pos + rank_in(right, h, base, x, false);
    } else {
      x = at(right, pos - h, h, base);
      slot = pos - h + rank_in(left, h, false, x, true);
    }
    dst[b * dst_bs + pair * 2 * h + slot] = x;
  }
}

// ------------------------------------------------------------------ K6 / K4
// Merge path of one pair of ascending runs a (na values) and b (nb values),
// ties a first: writes outputs [k, k + count) of merge(a, b) to out.  One
// co-rank search finds how many of the first k outputs come from a; then
// one comparison and one load per output, the two heads held in registers,
// with no branch on the data (the lanes of a warp never diverge).
template <typename T>
__device__ __forceinline__ void merge_range(const T* a, int na, const T* b, int nb, int k, int count, T* out) {
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
  T x = i < na ? a[i] : T(0);
  T y = j < nb ? b[j] : T(0);
  for (int c = 0; c < count; ++c) {
    const bool take_a = j >= nb || (i < na && x <= y);
    out[c] = take_a ? x : y;
    i += take_a;
    j += !take_a;
    // the side just taken has a value, so its index clamps inside it
    const T next = take_a ? a[min(i, na - 1)] : b[min(j, nb - 1)];
    x = take_a ? next : x;
    y = take_a ? y : next;
  }
}

template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
  static constexpr int n = 4;
  __device__ static float4 make(const float* v) { return make_float4(v[0], v[1], v[2], v[3]); }
};
template <>
struct Vec16<double> {
  using type = double2;
  static constexpr int n = 2;
  __device__ static double2 make(const double* v) { return make_double2(v[0], v[1]); }
};

// One block per (batch row, group g): the window rows [g, g + window) split
// into aligned dyadic segments of at most 2^n_levels rows (the TPU kernel's
// _dyadic_segments), each an ascending run: a slab row (read from the end
// when odd) or a level run.  The segments are laid out smallest first; each
// one's first rows·ymax values (the rest are +inf by the caller's promise)
// are staged (cp.async into shared memory, plain loads into the output
// row), then folded smallest first, as the TPU kernel folds: step k merges
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
// coalesced 16-byte stores.  The window·ymax staged values fill the output
// row exactly.
template <typename T, bool kSharedScratch>
__global__ void __launch_bounds__(kThreads)
fold_windows_kernel(const T* __restrict__ slab, const T* __restrict__ levels, T* out, int dp, int m, int n_levels,
                    int window, int n_groups, int ymax) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  __shared__ int seg_off[kMaxSegments + 1];
  __shared__ int seg_rows[kMaxSegments];
  __shared__ const T* seg_src[kMaxSegments];
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
  T* row = out + bg * total;
  // the two merge buffers: s, and scratch (shared memory or the output row);
  // step k writes s when ns - 1 - k is even, so the last step writes s
  T* const scratch = kSharedScratch ? s + total : row;

  for (int t = 0; t < ns; ++t) {
    // the buffer the segment's first step reads (s for a lone segment)
    const bool into_s = ((ns - 1 - max(t, 1)) & 1) != 0;
    const int len = seg_off[t + 1] - seg_off[t];
    const T* run = seg_src[t];
    const bool rev = seg_rev[t];
    T* to = (into_s ? s : scratch) + seg_off[t];
    if (kSharedScratch || into_s) {
      // into shared memory: every copy in flight at once (cp.async)
      for (int j = threadIdx.x; j < len; j += blockDim.x)
        __pipeline_memcpy_async(to + j, rev ? run + m - 1 - j : run + j, sizeof(T));
    } else {
      for (int j = threadIdx.x; j < len; j += blockDim.x) to[j] = at(run, j, m, rev);
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  for (int k = 1; k < ns; ++k) {
    const bool into_s = !((ns - 1 - k) & 1);
    const T* src = into_s ? scratch : s;
    T* dst = into_s ? s : scratch;
    const int na = seg_off[k];
    const int n_out = seg_off[k + 1];
    const int step = ((n_out + blockDim.x - 1) / blockDim.x) | 1;
    for (int d = threadIdx.x * step; d < n_out; d += blockDim.x * step)
      merge_range(src, na, src + na, n_out - na, d, min(step, n_out - d), dst + d);
    __syncthreads();
  }

  // the merged row is in s: store it with 16-byte stores once row is aligned
  using V = Vec16<T>;
  const int mis = static_cast<int>((reinterpret_cast<unsigned long long>(row) / sizeof(T)) % V::n);
  const int head = min(total, (V::n - mis) % V::n);
  if (static_cast<int>(threadIdx.x) < head) row[threadIdx.x] = s[threadIdx.x];
  const int n_vec = (total - head) / V::n;
  auto* vrow = reinterpret_cast<typename V::type*>(row + head);
  if (head == 0) {
    const auto* vs = reinterpret_cast<const typename V::type*>(s);
    for (int v = threadIdx.x; v < n_vec; v += blockDim.x) vrow[v] = vs[v];
  } else {
    for (int v = threadIdx.x; v < n_vec; v += blockDim.x) vrow[v] = V::make(s + head + v * V::n);
  }
  for (int i = head + n_vec * V::n + threadIdx.x; i < total; i += blockDim.x) row[i] = s[i];
}

template <typename T>
int sort_rows_alt(const void* in, void* out, long long rows, int m, int dp, cudaStream_t stream) {
  const int threads = std::min(std::max(m / 2, 32), 512);
  const size_t smem = static_cast<size_t>(m) * sizeof(T);
  sort_rows_alt_kernel<T><<<static_cast<unsigned>(rows), threads, smem, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), m, dp);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int build_levels(const void* slab, void* levels, int batch, int dp, int m, int n_levels, cudaStream_t stream) {
  const long long per_batch = static_cast<long long>(dp) * m;
  const long long total = per_batch * batch;
  const long long blocks = std::min((total + kThreads - 1) / kThreads, 1LL << 30);
  for (int k = 0; k < n_levels; ++k) {
    const T* src = k == 0 ? static_cast<const T*>(slab) : static_cast<const T*>(levels) + (k - 1) * per_batch;
    const long long src_bs = k == 0 ? per_batch : n_levels * per_batch;
    T* dst = static_cast<T*>(levels) + k * per_batch;
    build_level_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        src, src_bs, dst, n_levels * per_batch, per_batch, m << k, k == 0, total);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// Threads of a fold block: enough for the row at about 9 outputs a thread
// in the last step, at most kThreads.
inline int fold_threads(int total) { return std::min(kThreads, ((total + 8) / 9 + 31) / 32 * 32); }

template <typename T, bool kSharedScratch>
int launch_fold(const void* slab, const void* levels, void* out, int batch, int dp, int m, int n_levels, int window,
                int n_groups, int ymax, cudaStream_t stream) {
  const int total = window * ymax;
  const size_t smem = static_cast<size_t>(total) * sizeof(T) * (kSharedScratch ? 2 : 1);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(fold_windows_kernel<T, kSharedScratch>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = fold_threads(total);
  const long long blocks = static_cast<long long>(batch) * n_groups;
  fold_windows_kernel<T, kSharedScratch><<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      static_cast<const T*>(slab), static_cast<const T*>(levels), static_cast<T*>(out), dp, m, n_levels, window,
      n_groups, ymax);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int fold_windows(const void* slab, const void* levels, void* out, int batch, int dp, int m, int n_levels,
                 int window, int n_groups, int ymax, bool shared_scratch, cudaStream_t stream) {
  return shared_scratch
             ? launch_fold<T, true>(slab, levels, out, batch, dp, m, n_levels, window, n_groups, ymax, stream)
             : launch_fold<T, false>(slab, levels, out, batch, dp, m, n_levels, window, n_groups, ymax, stream);
}

}  // namespace

// Every entry launches on `stream` of CUDA device `device` (and leaves the
// calling thread's current device as it found it), takes elements
// of elem_size bytes (4: float, 8: double) and returns cudaGetLastError()
// (0 on success).  The caller checks shapes; these check only what would
// make a launch invalid.

// rows = B * dp slab rows of m values (m a power of two, m * elem_size <= 48 KB).
extern "C" int xsdba_sort_rows_alt(const void* in, void* out, long long rows, int m, int dp, int elem_size,
                                   int device, void* stream) {
  if (rows < 0 || m < 1 || (m & (m - 1)) != 0 || dp < 1 || static_cast<long long>(m) * elem_size > 48 * 1024 ||
      rows >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const xsdba::DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return static_cast<int>(guard.status());
  const auto s = static_cast<cudaStream_t>(stream);
  if (elem_size == 4) return sort_rows_alt<float>(in, out, rows, m, dp, s);
  if (elem_size == 8) return sort_rows_alt<double>(in, out, rows, m, dp, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// slab [batch, dp, m] (alternating rows) -> levels [batch, n_levels, dp, m];
// dp a multiple of 2^n_levels.
extern "C" int xsdba_build_levels(const void* slab, void* levels, int batch, int dp, int m, int n_levels,
                                  int elem_size, int device, void* stream) {
  if (batch < 0 || dp < 1 || m < 1 || n_levels < 1 || dp % (1 << n_levels) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const xsdba::DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return static_cast<int>(guard.status());
  const auto s = static_cast<cudaStream_t>(stream);
  if (elem_size == 4) return build_levels<float>(slab, levels, batch, dp, m, n_levels, s);
  if (elem_size == 8) return build_levels<double>(slab, levels, batch, dp, m, n_levels, s);
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
    return fold_windows<float>(slab, levels, out, batch, dp, m, n_levels, window, n_groups, ymax, shared_scratch, s);
  if (elem_size == 8)
    return fold_windows<double>(slab, levels, out, batch, dp, m, n_levels, window, n_groups, ymax, shared_scratch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Bytes of dynamic shared memory a fold block may take on `device` (the
// device's opt-in limit less the kernel's static shared memory), or a
// negative cudaError_t.
extern "C" long long xsdba_fold_smem_limit(int elem_size, int device) {
  const xsdba::DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return -static_cast<long long>(guard.status());
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  cudaFuncAttributes attr;
  // both variants declare the same static shared memory
  err = elem_size == 8 ? cudaFuncGetAttributes(&attr, fold_windows_kernel<double, false>)
                       : cudaFuncGetAttributes(&attr, fold_windows_kernel<float, false>);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  return static_cast<long long>(optin) - static_cast<long long>(attr.sharedSizeBytes);
}

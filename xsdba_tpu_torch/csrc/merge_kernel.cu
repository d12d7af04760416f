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
// shared memory and its synchronisations, so the merges here are rank
// merges: every value finds its output slot on its own, as its index in its
// run plus its binary-search rank in every other run, and is written once.
// A merge of runs A then B (ties: A first) puts a in slot i + #{b < a} and b
// in slot j + #{a <= b}, a permutation for any total preorder, so ties and
// +-0.0 need no care beyond a fixed order of the runs.  The level build
// reads its partner run from device memory (the L1/L2 caches hold it: a
// run is at most 2^L·m values); the fold stages the group's segments in
// shared memory and does window·ymax·log2 searches from there.  Both are
// bound by those dependent loads, not by bytes.  The row sort is a bitonic
// network in shared memory, one block per row, bound by its log2(m)^2/2
// block-wide synchronisations.

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
// One block per (batch row, group g): the window rows [g, g + window) split
// into aligned dyadic segments of at most 2^n_levels rows (the TPU kernel's
// _dyadic_segments), each an ascending run: a slab row (read from the end
// when odd) or a level run.  Each segment's first rows·ymax values (the rest
// are +inf by the caller's promise) are staged in shared memory; each value
// then finds its slot by rank in every other segment, ties ordered by
// segment.  The window·ymax staged values fill the output row exactly.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fold_windows_kernel(const T* __restrict__ slab, const T* __restrict__ levels, T* __restrict__ out, int dp,
                    int m, int n_levels, int window, int n_groups, int ymax) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  __shared__ int seg_off[kMaxSegments + 1];
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
    int off = 0;
    while (p < g + window && n < kMaxSegments) {
      int size = 1;
      while (size * 2 <= max_rows && p % (size * 2) == 0 && p + size * 2 <= g + window) size *= 2;
      seg_off[n] = off;
      if (size == 1) {
        seg_src[n] = slab + (b * dp + p) * m;
        seg_rev[n] = p & 1;
      } else {
        const int k = __ffs(size) - 2;  // level of a 2^(k+1)-row run
        seg_src[n] = levels + ((b * n_levels + k) * dp + p) * static_cast<long long>(m);
        seg_rev[n] = false;
      }
      off += size * ymax;
      p += size;
      ++n;
    }
    seg_off[n] = off;
    n_seg = n;
  }
  __syncthreads();

  const int ns = n_seg;
  for (int t = 0; t < ns; ++t) {
    const int len = seg_off[t + 1] - seg_off[t];
    const T* run = seg_src[t];
    // a slab row holds m values; only its ascending first ymax are data
    const int full = seg_rev[t] ? m : len;
    for (int j = threadIdx.x; j < len; j += blockDim.x) s[seg_off[t] + j] = at(run, j, full, seg_rev[t]);
  }
  __syncthreads();

  T* row = out + bg * seg_off[ns];
  for (int t = 0; t < ns; ++t) {
    const int start = seg_off[t];
    const int len = seg_off[t + 1] - start;
    for (int j = threadIdx.x; j < len; j += blockDim.x) {
      const T x = s[start + j];
      int slot = j;
      for (int u = 0; u < ns; ++u) {
        if (u == t) continue;
        slot += rank_in(s + seg_off[u], seg_off[u + 1] - seg_off[u], false, x, u < t);
      }
      row[slot] = x;
    }
  }
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

template <typename T>
int fold_windows(const void* slab, const void* levels, void* out, int batch, int dp, int m, int n_levels,
                 int window, int n_groups, int ymax, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(window) * ymax * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(fold_windows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = static_cast<long long>(batch) * n_groups;
  fold_windows_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(slab), static_cast<const T*>(levels), static_cast<T*>(out), dp, m, n_levels, window,
      n_groups, ymax);
  return static_cast<int>(cudaGetLastError());
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
// and window * ymax * elem_size bytes of shared memory.
extern "C" int xsdba_fold_windows(const void* slab, const void* levels, void* out, int batch, int dp, int m,
                                  int n_levels, int window, int n_groups, int ymax, int elem_size,
                                  int device, void* stream) {
  if (batch < 0 || n_groups < 0 || window < 1 || ymax < 1 || ymax > m || n_levels < 0 ||
      n_groups - 1 + window > dp || static_cast<long long>(batch) * n_groups >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || n_groups == 0) return 0;
  const xsdba::DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return static_cast<int>(guard.status());
  const auto s = static_cast<cudaStream_t>(stream);
  if (elem_size == 4)
    return fold_windows<float>(slab, levels, out, batch, dp, m, n_levels, window, n_groups, ymax, s);
  if (elem_size == 8)
    return fold_windows<double>(slab, levels, out, batch, dp, m, n_levels, window, n_groups, ymax, s);
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
  err = elem_size == 8 ? cudaFuncGetAttributes(&attr, fold_windows_kernel<double>)
                       : cudaFuncGetAttributes(&attr, fold_windows_kernel<float>);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  return static_cast<long long>(optin) - static_cast<long long>(attr.sharedSizeBytes);
}

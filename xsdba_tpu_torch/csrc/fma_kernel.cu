// Fused multiply-add, out = a * b + c rounded once, elementwise with
// broadcasting: one instruction a value (__fmaf_rn for float32, __fma_rn for
// float64) in place of the exact emulation of
// xsdba_tpu_torch/utils/tensor.py:fma_emulated, its plain twin, which takes
// some eighteen float64 passes.  It has no TPU counterpart: the JAX package
// gets these roundings from XLA, which contracts x * y + z into fused
// multiply-adds in its compiled programs (the type-7 virtual index, the
// quantile lerp, the lookup's interpolation and bracket blend).
//
// Bound: bytes, three reads and one write a value (less where an operand
// broadcasts).  The wrapper (ops/cuda/fma_kernel.py:layout) coalesces the
// broadcast layout on the host first: size-1 dimensions dropped, adjacent
// dimensions merged wherever all three operands' strides allow it.  The
// callers' layouts then have one or two dimensions: contiguous operands
// ([n]), or [R, P] with an operand repeating with period P (the lerp's
// [365, 50] gamma against [512, 365, 50] rows) or constant along a row (a
// per-row count).  Two kernels:
//   - fma_rows_kernel, for any layout of one or two dimensions below 2^31
//     values: the flat output index i in 16-byte vectors (float4 /
//     double2), kItems vectors a thread, so the output and every operand
//     the wrapper marks dense (read at i itself, 16-byte aligned) move in
//     16-byte loads and stores.  Another operand is read a value at a time
//     at row * s0 + col * s1, the row from one multiply-high by a
//     precomputed magic number (no hardware division); a repeating operand
//     stays in L1 / L2.  The n % 4 (f64: n % 2) values past the last vector
//     are done one at a time.  A one-dimensional layout is one row.
//   - fma_strided_kernel, the fallback for every other layout (three or
//     more dimensions after coalescing, a transposed operand, 2^31 values
//     or more): one value a thread, its source offsets from the output index
//     by a division per dimension, up to 8 dimensions.
// Both round with the same intrinsic, so every path equals the twin bit for
// bit.

#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 2;  // 16-byte vectors a thread in fma_rows_kernel
constexpr int kMaxDims = 8;

__device__ __forceinline__ float fused(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fused(double a, double b, double c) { return __fma_rn(a, b, c); }

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static __device__ __forceinline__ void get(const float4 q, float* e) { e[0] = q.x; e[1] = q.y; e[2] = q.z; e[3] = q.w; }
  static __device__ __forceinline__ float4 put(const float* e) { return make_float4(e[0], e[1], e[2], e[3]); }
};
template <>
struct Vec<double> {
  using type = double2;
  static __device__ __forceinline__ void get(const double2 q, double* e) { e[0] = q.x; e[1] = q.y; }
  static __device__ __forceinline__ double2 put(const double* e) { return make_double2(e[0], e[1]); }
};

// [R, P] layout of the rows kernel: operand k reads row * s0[k] + col * s1[k]
// unless bit k of `dense` says it reads the flat index i = row * P + col
struct Rows {
  unsigned P, magic, shift;  // i / P == (__umulhi(i, magic) + i) >> shift for i < 2^31
  long long s0[3], s1[3];
  int dense;
};

__device__ __forceinline__ unsigned row_of(unsigned i, const Rows& L) { return (__umulhi(i, L.magic) + i) >> L.shift; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
fma_rows_kernel(const T* __restrict__ a, const T* __restrict__ b, const T* __restrict__ c, T* __restrict__ out,
                unsigned n, const Rows L) {
  using V = typename Vec<T>::type;
  constexpr int kV = sizeof(V) / sizeof(T);
  const T* const src[3] = {a, b, c};
  const unsigned nvec = n / kV;
  const unsigned first = blockIdx.x * (kThreads * kItems) + threadIdx.x;
  T x[kItems][3][kV];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const unsigned v = first + j * kThreads;
    if (v >= nvec) break;
    const unsigned i = v * kV;
    const unsigned row = row_of(i, L), col = i - row * L.P;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if ((L.dense >> k) & 1) {
        Vec<T>::get(__ldg(reinterpret_cast<const V*>(src[k] + i)), x[j][k]);
      } else {
        unsigned r = row, q = col;
#pragma unroll
        for (int e = 0; e < kV; ++e) {
          x[j][k][e] = __ldg(src[k] + (r * L.s0[k] + q * L.s1[k]));
          if (++q == L.P) {
            q = 0;
            ++r;
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const unsigned v = first + j * kThreads;
    if (v >= nvec) break;
    T y[kV];
#pragma unroll
    for (int e = 0; e < kV; ++e) y[e] = fused(x[j][0][e], x[j][1][e], x[j][2][e]);
    reinterpret_cast<V*>(out)[v] = Vec<T>::put(y);
  }
  // the values past the last whole vector
  if (blockIdx.x == 0 && threadIdx.x < n - nvec * kV) {
    const unsigned i = nvec * kV + threadIdx.x;
    const unsigned row = row_of(i, L), col = i - row * L.P;
    T y[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) y[k] = src[k][row * L.s0[k] + col * L.s1[k]];
    out[i] = fused(y[0], y[1], y[2]);
  }
}

struct Strided {
  int ndim;
  long long shape[kMaxDims];
  long long sa[kMaxDims], sb[kMaxDims], sc[kMaxDims];  // strides in elements
};

template <typename T, typename Index>
__global__ void __launch_bounds__(kThreads)
fma_strided_kernel(const T* __restrict__ a, const T* __restrict__ b, const T* __restrict__ c, T* __restrict__ out,
                   long long n, const Strided lay) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  Index rem = static_cast<Index>(i);
  long long oa = 0, ob = 0, oc = 0;
  for (int d = lay.ndim - 1; d >= 0; --d) {
    const Index size = static_cast<Index>(lay.shape[d]);
    const Index q = rem / size;
    const long long at = static_cast<long long>(rem - q * size);
    rem = q;
    oa += at * lay.sa[d];
    ob += at * lay.sb[d];
    oc += at * lay.sc[d];
  }
  out[i] = fused(a[oa], b[ob], c[oc]);
}

template <typename T>
int launch_rows(const T* a, const T* b, const T* c, T* out, long long n, int ndim, const long long* lay, int dense,
                cudaStream_t stream) {
  constexpr int kV = 16 / sizeof(T);
  if (n >= 0x7fffffffLL || ndim > 2 || (reinterpret_cast<unsigned long long>(out) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Rows L;
  L.P = static_cast<unsigned>(lay[ndim - 1]);
  if (L.P == 0 || n % L.P != 0) return static_cast<int>(cudaErrorInvalidValue);
  unsigned shift = 0;
  while ((1ull << shift) < L.P) ++shift;
  L.shift = shift;
  L.magic = static_cast<unsigned>(((1ull << 32) * ((1ull << shift) - L.P)) / L.P + 1);
  for (int k = 0; k < 3; ++k) {
    const long long* s = lay + (k + 1) * ndim;
    L.s0[k] = ndim == 2 ? s[0] : 0;
    L.s1[k] = s[ndim - 1];
  }
  L.dense = dense;
  const long long nvec = n / kV;
  const long long blocks = (nvec + kThreads * kItems - 1) / (kThreads * kItems);
  fma_rows_kernel<T><<<static_cast<unsigned>(blocks > 0 ? blocks : 1), kThreads, 0, stream>>>(
      a, b, c, out, static_cast<unsigned>(n), L);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_strided(const T* a, const T* b, const T* c, T* out, long long n, int ndim, const long long* lay,
                   cudaStream_t stream) {
  Strided s;
  s.ndim = ndim;
  for (int d = 0; d < kMaxDims; ++d) {
    s.shape[d] = d < ndim ? lay[d] : 1;
    s.sa[d] = d < ndim ? lay[ndim + d] : 0;
    s.sb[d] = d < ndim ? lay[2 * ndim + d] : 0;
    s.sc[d] = d < ndim ? lay[3 * ndim + d] : 0;
  }
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (n < 0x7fffffffLL) {
    fma_strided_kernel<T, unsigned><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(a, b, c, out, n, s);
  } else {
    fma_strided_kernel<T, unsigned long long><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(a, b, c, out, n, s);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* a, const void* b, const void* c, void* out, long long n, int strided, int ndim,
           const long long* lay, int dense, cudaStream_t stream) {
  const auto* pa = static_cast<const T*>(a);
  const auto* pb = static_cast<const T*>(b);
  const auto* pc = static_cast<const T*>(c);
  auto* po = static_cast<T*>(out);
  return strided ? launch_strided<T>(pa, pb, pc, po, n, ndim, lay, stream)
                 : launch_rows<T>(pa, pb, pc, po, n, ndim, lay, dense, stream);
}

}  // namespace

// out[i] = fma(a, b, c) over the n values of a contiguous output whose
// coalesced layout (ops/cuda/fma_kernel.py:layout) has `ndim` dimensions:
// `lay` holds its shape, then a's, b's and c's strides in elements along
// it (0 where an operand broadcasts), ndim values each.  `strided` picks
// fma_strided_kernel (up to 8 dimensions) over fma_rows_kernel (1 or 2
// dimensions, n < 2^31, out 16-byte aligned); bit k of `dense` marks an
// operand the rows kernel reads in vectors at the flat index (a, b, c for
// k = 0, 1, 2).  `is_double` picks float64 over float32.  Launches on
// `stream` of CUDA device `device` (leaving the calling thread's current
// device as it found it) and returns cudaGetLastError() (0 on success).
extern "C" int xsdba_fma(const void* a, const void* b, const void* c, void* out, long long n, int is_double,
                         int strided, int ndim, const long long* lay, int dense, int device, void* stream) {
  if (n < 0 || ndim < 1 || ndim > kMaxDims) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const xsdba::DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return static_cast<int>(guard.status());
  const auto s = static_cast<cudaStream_t>(stream);
  return is_double ? launch<double>(a, b, c, out, n, strided, ndim, lay, dense, s)
                   : launch<float>(a, b, c, out, n, strided, ndim, lay, dense, s);
}

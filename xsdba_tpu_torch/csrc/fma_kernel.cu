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
// broadcasts).  One kernel, fma_strided_kernel: one value a thread, its three
// source offsets from the output index and each operand's strides (0 along a
// broadcast dimension), up to 8 dimensions, 32-bit index arithmetic when the
// output has fewer than 2^31 values.  Its callers broadcast or pass views
// (the virtual index, the lerp against a per-group gamma or on slices), and
// their same-shape calls are a few hundred thousand values, so contiguous
// operands have no kernel of their own.

#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDims = 8;

__device__ __forceinline__ float fused(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fused(double a, double b, double c) { return __fma_rn(a, b, c); }

struct Layout {
  int ndim;
  long long shape[kMaxDims];
  long long sa[kMaxDims], sb[kMaxDims], sc[kMaxDims];  // strides in elements
};

template <typename T, typename Index>
__global__ void __launch_bounds__(kThreads)
fma_strided_kernel(const T* __restrict__ a, const T* __restrict__ b, const T* __restrict__ c, T* __restrict__ out,
                   long long n, const Layout lay) {
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
int launch(const void* a, const void* b, const void* c, void* out, long long n, const Layout& lay, cudaStream_t stream) {
  const auto* pa = static_cast<const T*>(a);
  const auto* pb = static_cast<const T*>(b);
  const auto* pc = static_cast<const T*>(c);
  auto* po = static_cast<T*>(out);
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (n < 0x7fffffffLL) {
    fma_strided_kernel<T, unsigned><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(pa, pb, pc, po, n, lay);
  } else {
    fma_strided_kernel<T, unsigned long long><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(pa, pb, pc, po, n, lay);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out[i] = fma(a, b, c) over the n values of an output of `ndim` dimensions
// `shape` (row-major, contiguous); sa, sb, sc are the operands' strides in
// elements along those dimensions (0 where an operand broadcasts).
// `is_double` picks float64 over float32.  Launches on `stream` of CUDA
// device `device` (leaving the calling thread's current device as it found
// it) and returns cudaGetLastError() (0 on success).
extern "C" int xsdba_fma(const void* a, const void* b, const void* c, void* out, long long n, int is_double,
                         int ndim, const long long* shape, const long long* sa, const long long* sb,
                         const long long* sc, int device, void* stream) {
  if (n < 0 || ndim < 1 || ndim > kMaxDims) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  Layout lay;
  lay.ndim = ndim;
  for (int d = 0; d < kMaxDims; ++d) {
    lay.shape[d] = d < ndim ? shape[d] : 1;
    lay.sa[d] = d < ndim ? sa[d] : 0;
    lay.sb[d] = d < ndim ? sb[d] : 0;
    lay.sc[d] = d < ndim ? sc[d] : 0;
  }
  const xsdba::DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return static_cast<int>(guard.status());
  const auto s = static_cast<cudaStream_t>(stream);
  return is_double ? launch<double>(a, b, c, out, n, lay, s) : launch<float>(a, b, c, out, n, lay, s);
}

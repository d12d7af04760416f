// Per-(batch, group) quantile-table lookup for the partitioned grouped
// adjust: out[r, i] = table_r(v[r, i]), linear interpolation between the
// bracketing nodes, constant extrapolation.
//
// Replaces xsdba_tpu/ops/pallas/interp_kernel.py:interp_table_pallas_3d
// (the _kernel3d/_interp_body Pallas kernel).  Its plain twin is
// xsdba_tpu_torch/ops/interp.py:_interp_unrolled(..., "linear", "constant"),
// and the kernel computes exactly what the twin computes, the single-node
// guard y1 = isnan(y1) ? y0 : y1 included.
//
// Bound: its count loop.  The floor is bytes: each value is read once and
// each result written once (4 + 4 bytes per element, about 2 x 133 MB per
// call at the [512, 14, 4650] headline partition), while a row's table is at
// most 64 + 64 floats.  So one block holds its row's table in shared memory
// and its threads stream the row's values with coalesced loads; no
// intermediate touches device memory.  This version stops short of that
// floor: the locate step counts xs[k] <= v over all nq nodes, nq
// shared-memory loads per value, and on an H100 80GB HBM3 (700 W) that loop
// holds it to 0.451 ms, about 591 GB/s, at the headline shape.
//
// Arithmetic uses the round-to-nearest intrinsics and the build passes
// -fmad=false, so no FMA contraction separates the kernel from the twin:
// both give the same bits.
//
// Layout: v/out [rows, lp] row-major, xs/ys [rows, nq] (compacted: valid
// nodes first, ascending; +inf / NaN tail), nvalid [rows] int32.

#include <cuda_runtime.h>
#include <math.h>

#include "device_guard.cuh"

namespace {

constexpr int kMaxNq = 64;
constexpr int kThreads = 256;
constexpr int kTile = 2048;  // values per block along a row

__global__ void __launch_bounds__(kThreads)
interp_table_3d_kernel(const float* __restrict__ v, const float* __restrict__ xs,
                       const float* __restrict__ ys, const int* __restrict__ nvalid,
                       float* __restrict__ out, int lp, int nq) {
  __shared__ float sx[kMaxNq];
  __shared__ float sy[kMaxNq];
  const long long row = blockIdx.x;
  for (int k = threadIdx.x; k < nq; k += blockDim.x) {
    sx[k] = xs[row * nq + k];
    sy[k] = ys[row * nq + k];
  }
  __syncthreads();

  const int nv = nvalid[row];
  const int kmax = max(nv - 2, 0);               // k0 = clip(cnt - 1, 0, kmax)
  const int last = min(max(nv - 1, 0), nq - 1);  // last valid node
  const float x_first = sx[0];
  const float y_first = sy[0];
  const float x_last = sx[last];
  const float y_last = sy[last];

  const float* vrow = v + row * lp;
  float* orow = out + row * lp;
  const int start = blockIdx.y * kTile;
  const int stop = min(start + kTile, lp);
  for (int i = start + threadIdx.x; i < stop; i += kThreads) {
    const float val = vrow[i];
    int cnt = 0;
#pragma unroll 8
    for (int k = 0; k < nq; ++k) cnt += (sx[k] <= val) ? 1 : 0;
    const int k0 = min(max(cnt - 1, 0), kmax);
    const float x0 = sx[k0];
    const float y0 = sy[k0];
    float x1 = INFINITY;
    float y1 = y0;
    if (k0 < nq - 1) {
      x1 = sx[k0 + 1];
      y1 = sy[k0 + 1];
    }
    if (isnan(y1)) y1 = y0;  // single valid node: its pair is the NaN pad
    const float dx = __fsub_rn(x1, x0);
    float t = 0.0f;
    if (dx > 0.0f) t = __fdiv_rn(__fsub_rn(val, x0), dx);
    if (!isfinite(t)) t = 0.0f;
    float r = __fadd_rn(y0, __fmul_rn(t, __fsub_rn(y1, y0)));
    if (val < x_first) r = y_first;
    if (val > x_last) r = y_last;
    if (nv == 0 || isnan(val)) r = NAN;
    orow[i] = r;
  }
}

}  // namespace

// rows = B * Gp partition rows of lp values each; nq table nodes (<= 64).
// Launches on `stream` of CUDA device `device` (leaving the calling thread's
// current device as it found it) and returns
// cudaGetLastError() (0 on success).
extern "C" int xsdba_interp_table_3d(const void* v, const void* xs, const void* ys,
                                     const void* nvalid, void* out, int rows, int lp,
                                     int nq, int device, void* stream) {
  if (rows < 0 || lp < 0 || nq < 1 || nq > kMaxNq) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || lp == 0) return 0;
  const xsdba::DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return static_cast<int>(guard.status());
  const dim3 grid(static_cast<unsigned>(rows), static_cast<unsigned>((lp + kTile - 1) / kTile));
  interp_table_3d_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<const float*>(xs), static_cast<const float*>(ys),
      static_cast<const int*>(nvalid), static_cast<float*>(out), lp, nq);
  return static_cast<int>(cudaGetLastError());
}

// Quantile-table lookup: out = table(v), linear interpolation between the
// bracketing nodes or the nearer node's value (`method`), constant
// extrapolation.  Three entries:
//   xsdba_interp_table_3d, the per-(batch, group) lookup of the partitioned
//     grouped adjust, replaces xsdba_tpu/ops/pallas/interp_kernel.py:
//     interp_table_pallas_3d (K1, the _kernel3d/_interp_body Pallas kernel);
//   xsdba_interp_table_2d, one table per row of [R, L] values (the ungrouped
//     adjust), replaces interp_kernel.py:interp_table_pallas (K2, _kernel):
//     the same kernel on the same row layout;
//   xsdba_interp_bracketed, the grouped adjust's blended lookup in one pass:
//     every value looked up in the tables of its time step's two bracketing
//     groups and the two results blended.  It stands in for the partition
//     route of xsdba_tpu/ops/interp.py:interp_grouped_partitioned (two
//     partition gathers, two K1 calls, two gathers back and the blend),
//     a layout the TPU needed for want of a cheap per-element gather.
// Their plain twins are
// xsdba_tpu_torch/ops/interp.py:_interp_unrolled(..., method, "constant")
// and ops/cuda/interp_kernel.py:interp_bracketed_reference, and each kernel
// computes exactly what its twin computes, the single-node guard
// y1 = isnan(y1) ? y0 : y1 included.
//
// The row entries take the method as an argument (0 linear, 1 nearest), a
// template parameter of the kernel, so that each method compiles to its own
// straight code.  Nearest shares the search, the staging and every edge,
// NaN and empty-table rule; once the bracket is found it returns
// |v - x0| <= |x1 - v| ? y0 : y1 in place of the division and the fused
// multiply-add (a tie takes the lower node; at the last node x1 is the +inf
// pad).  It is the method of the multivariate schemes (MBCn, NpdfTransform),
// whose every rotation looks ranks in [0, 1] up in a row's own table.  The
// bracketed entry is linear only: nearest never blends two groups.
//
// Bound: bytes.  Each value is read once and each result written once (8
// bytes a value); a table is at most 64 + 64 floats.  What the card spends
// beyond the bytes is instructions (some 60 a lookup: the probes, an IEEE
// division, the extrapolation rules), so the design, for an H100, keeps the
// code straight and every lane busy:
// - Locate by binary search.  The tables are compacted (valid nodes first and
//   ascending, +inf tail), so the count of nodes <= v is an upper bound: seven
//   probes (steps 64, 32, ... 1) of the table in shared memory, unrolled, with
//   no branch and no bound check: the nodes are padded with NaN, which
//   compares false, to 128 entries.  It gives the count loop's number on
//   every input: ties, v = +-inf (the +inf pads count), NaN v (0), nvalid 0,
//   1, 2, nq 1.  The bracketing nodes then come as two 8-byte (x, y) loads.
// - Long rows: one block per 4096-value tile of a row, 16-byte loads and
//   stores, four values a thread a step, two steps in flight.  Row starts
//   are not 16-byte aligned in general (rows of 4650 or 54750 values), so a
//   block's range of the flat array has a scalar head up to the first
//   16-byte boundary, a vector body and a scalar tail.
// - Rows of fewer than kShortRow values take one warp each (8 rows a block,
//   each warp with its own table) and 4-byte accesses, a value a lane a
//   step: on the windowed adjust's 150-value rows four values a lane would
//   leave 4 lanes in 10 idle.
// - The bracketed entry holds all of one site's tables in shared memory
//   (1056 bytes a table: 14.4 KB at the monthly headline) and streams an
//   8192-value tile of the site's time axis through them.  A warp's lanes
//   probe the tables of several groups at the same index, so the tables
//   start an odd number of words (nodes) and of 8-byte pairs apart and one
//   index of several tables falls into several banks.  The group ids and
//   the weight of a time step come from L2 (all sites share them).
// Device times on an NVIDIA H100 80GB HBM3 (700 W limit) are in PERF.md,
// section 6.
//
// Arithmetic uses the round-to-nearest intrinsics and the build passes
// -fmad=false, so the only fused multiply-adds are the explicit
// __fmaf_rn(t, y1 - y0, y0) of the interpolation and
// __fmaf_rn(1 - w, val0, w * val1) of the bracket blend, which the twins
// round once too (ops/cuda/fma_kernel.py fma, as the JAX package's compiled
// adjust fuses them): both give the same bits.
//
// Layout: v/out [rows, lp] row-major, xs/ys [rows, nq] (compacted: valid
// nodes first, ascending; +inf / NaN tail), nvalid [rows] int32.  Bracketed:
// v/out [sites, T], xs/ys [sites, gp, nq], nvalid [sites, gp], g0/g1 [T]
// int32 in [0, gp), w [T].

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kMaxNq = 64;
constexpr int kProbes = 2 * kMaxNq;      // probe nodes a table holds: the probes reach index 126
constexpr int kPairs = kMaxNq + 1;       // (x, y) pairs a table holds: a bracket may start on the last node
constexpr int kThreads = 256;
constexpr int kTile = 4096;              // values a block streams along a long row
constexpr int kShortRow = 4 * kThreads;  // shorter rows take one warp each
constexpr int kWarpRows = kThreads / 32;
constexpr int kBracketTile = 8192;       // time steps a block of the bracketed entry serves
constexpr int kBracketSmem = 48 * 1024;
// a site's tables in the bracketed kernel start an odd number of words
// (probe nodes) and of pairs apart: see the header
constexpr int kProbeStride = kProbes + 1;
constexpr int kPairStride = kPairs;
constexpr int kTableBytes = 16 + 8 * kPairStride + 4 * kProbeStride + 4;  // constants, pairs, nodes, count

// One table in shared memory, evaluated at val: x[0 .. kProbes) its nodes
// for the probes (NaN past nq); xy[0 .. nq] its (x, y) pairs, the last one
// the pair of a bracket that starts on the last node (x = +inf,
// y = y[nq - 1]); edge = (x_first, y_first, x_last, y_last); nv its valid
// count.
template <bool kNearest>
__device__ __forceinline__ float lookup(float val, const float* x, const float2* xy, float4 edge, int nv) {
  int cnt = 0;  // nodes <= val: the largest p with x[p - 1] <= val
#pragma unroll
  for (int step = kMaxNq; step > 0; step >>= 1) cnt += x[cnt + step - 1] <= val ? step : 0;
  const int k0 = min(max(cnt - 1, 0), max(nv - 2, 0));
  const float2 n0 = xy[k0];
  const float2 n1 = xy[k0 + 1];
  const float y0 = n0.y;
  float y1 = n1.y;
  if (isnan(y1)) y1 = y0;  // single valid node: its pair is the NaN pad
  float r;
  if (kNearest) {
    // a NaN val compares false and takes y1, as the twin's select does: the
    // last rule below makes it NaN either way
    r = fabsf(__fsub_rn(val, n0.x)) <= fabsf(__fsub_rn(n1.x, val)) ? y0 : y1;
  } else {
    const float dx = __fsub_rn(n1.x, n0.x);
    float f = 0.0f;
    // a NaN or infinite val gives a NaN or infinite quotient, which counts as
    // 0 below: skipped, so that such a value keeps its warp off the
    // division's slow path
    if (dx > 0.0f && isfinite(val)) f = __fdiv_rn(__fsub_rn(val, n0.x), dx);
    if (!isfinite(f)) f = 0.0f;
    r = __fmaf_rn(f, __fsub_rn(y1, y0), y0);
  }
  if (val < edge.x) r = edge.y;
  if (val > edge.z) r = edge.w;
  if (nv == 0 || isnan(val)) r = NAN;
  return r;
}

// Stage the table (xs, ys)[0 .. nq) into x[0 .. kProbes) and xy[0 .. nq],
// thread `lane` of `width` taking every width-th entry.  The caller
// synchronises before any thread reads them.
__device__ __forceinline__ void stage_table(const float* __restrict__ xs, const float* __restrict__ ys, int nq,
                                            float* x, float2* xy, int lane, int width) {
  for (int k = lane; k < kProbes; k += width) x[k] = k < nq ? xs[k] : NAN;
  for (int k = lane; k <= nq; k += width) {
    xy[k] = k < nq ? make_float2(xs[k], ys[k]) : make_float2(INFINITY, ys[nq - 1]);
  }
}

__device__ __forceinline__ float4 table_edge(const float* __restrict__ xs, const float* __restrict__ ys, int nq, int nv) {
  const int last = min(max(nv - 1, 0), nq - 1);  // last valid node
  return make_float4(xs[0], ys[0], xs[last], ys[last]);
}

// The range [lo, hi) of a flat array split at 16-byte boundaries: scalar
// head [lo, alo), 4-value vectors [alo, ahi), scalar tail [ahi, hi).  With
// vec false (a base pointer off 16 bytes) everything is head.
struct Split {
  long long alo, ahi;
  __device__ Split(long long lo, long long hi, bool vec) {
    alo = vec ? min((lo + 3) & ~3LL, hi) : hi;
    ahi = vec ? max(alo, hi & ~3LL) : hi;
  }
};

// kRows: rows a block serves, 1 (one tile of a long row) or kWarpRows (a warp a row)
template <int kRows, bool kNearest>
__global__ void __launch_bounds__(kThreads)
interp_rows_kernel(const float* __restrict__ v, const float* __restrict__ xs, const float* __restrict__ ys,
                   const int* __restrict__ nvalid, float* __restrict__ out, long long rows, int lp, int nq, bool vec) {
  constexpr int kWidth = kThreads / kRows;  // threads a row
  __shared__ float sx[kRows][kProbes];
  __shared__ float2 sxy[kRows][kPairs];
  const int sub = threadIdx.x / kWidth;
  const int lane = threadIdx.x % kWidth;
  const long long row = static_cast<long long>(blockIdx.x) * kRows + sub;
  const bool live = row < rows;
  if (live) stage_table(xs + row * nq, ys + row * nq, nq, sx[sub], sxy[sub], lane, kWidth);
  __syncthreads();
  if (!live) return;

  const int nv = nvalid[row];
  const float4 edge = table_edge(xs + row * nq, ys + row * nq, nq, nv);
  auto at = [&](float val) { return lookup<kNearest>(val, sx[sub], sxy[sub], edge, nv); };

  const int start = kRows == 1 ? blockIdx.y * kTile : 0;
  const int stop = kRows == 1 ? min(start + kTile, lp) : lp;
  const long long lo = row * lp + start;
  const long long hi = row * lp + stop;
  const Split s(lo, hi, vec && kRows == 1);  // a warp's short row: a value a lane a step
  for (long long i = lo + lane; i < s.alo; i += kWidth) out[i] = at(v[i]);
  for (long long i = s.ahi + lane; i < hi; i += kWidth) out[i] = at(v[i]);
  const float4* v4 = reinterpret_cast<const float4*>(v + s.alo);
  float4* o4 = reinterpret_cast<float4*>(out + s.alo);
  const int n4 = static_cast<int>((s.ahi - s.alo) >> 2);
  for (int j = lane; j < n4; j += 2 * kWidth) {
    const bool two = j + kWidth < n4;
    const float4 a = v4[j];
    const float4 b = two ? v4[j + kWidth] : a;
    o4[j] = make_float4(at(a.x), at(a.y), at(a.z), at(a.w));
    if (two) o4[j + kWidth] = make_float4(at(b.x), at(b.y), at(b.z), at(b.w));
  }
}

__global__ void __launch_bounds__(kThreads)
interp_bracketed_kernel(const float* __restrict__ v, const float* __restrict__ xs, const float* __restrict__ ys,
                        const int* __restrict__ nvalid, const int* __restrict__ g0, const int* __restrict__ g1,
                        const float* __restrict__ w, float* __restrict__ out, int T, int gp, int nq, int tiles,
                        bool vec) {
  extern __shared__ float4 smem[];
  float4* edge = smem;                                            // [gp]
  float2* sxy = reinterpret_cast<float2*>(edge + gp);             // [gp][kPairStride]
  float* sx = reinterpret_cast<float*>(sxy + gp * kPairStride);   // [gp][kProbeStride]
  int* snv = reinterpret_cast<int*>(sx + gp * kProbeStride);      // [gp]
  const long long site = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const float* sxs = xs + site * gp * nq;
  const float* sys = ys + site * gp * nq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int g = warp; g < gp; g += kThreads / 32) {
    stage_table(sxs + g * nq, sys + g * nq, nq, sx + g * kProbeStride, sxy + g * kPairStride, lane, 32);
    if (lane == 0) {
      const int nv = nvalid[site * gp + g];
      snv[g] = nv;
      edge[g] = table_edge(sxs + g * nq, sys + g * nq, nq, nv);
    }
  }
  __syncthreads();

  auto in_group = [&](float val, int grp) {
    const int g = min(max(grp, 0), gp - 1);
    const float r = lookup<false>(val, sx + g * kProbeStride, sxy + g * kPairStride, edge[g], snv[g]);
    return g == grp ? r : NAN;  // no such group: no table
  };
  auto blended = [&](float val, int tstep) {
    const float ww = w[tstep];
    return __fmaf_rn(__fsub_rn(1.0f, ww), in_group(val, g0[tstep]), __fmul_rn(ww, in_group(val, g1[tstep])));
  };

  const int start = tile * kBracketTile;
  const int stop = min(start + kBracketTile, T);
  const long long base = site * T;
  const long long lo = base + start;
  const long long hi = base + stop;
  const Split s(lo, hi, vec);
  for (long long i = lo + threadIdx.x; i < s.alo; i += kThreads) out[i] = blended(v[i], static_cast<int>(i - base));
  for (long long i = s.ahi + threadIdx.x; i < hi; i += kThreads) out[i] = blended(v[i], static_cast<int>(i - base));
  const float4* v4 = reinterpret_cast<const float4*>(v + s.alo);
  float4* o4 = reinterpret_cast<float4*>(out + s.alo);
  const int n4 = static_cast<int>((s.ahi - s.alo) >> 2);
  const int t0 = static_cast<int>(s.alo - base);
  for (int j = threadIdx.x; j < n4; j += kThreads) {
    const float4 a = v4[j];
    const int ts = t0 + 4 * j;
    o4[j] = make_float4(blended(a.x, ts), blended(a.y, ts + 1), blended(a.z, ts + 2), blended(a.w, ts + 3));
  }
}

bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 15) == 0;
}

constexpr int kMethodLinear = 0, kMethodNearest = 1;  // the `method` argument of the row entries

template <bool kNear>
int launch_rows(const void* v, const void* xs, const void* ys, const void* nvalid, void* out, int rows, int lp, int nq,
                int device, void* stream) {
  if (rows < 0 || lp < 0 || nq < 1 || nq > kMaxNq) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || lp == 0) return 0;
  const int tiles = (lp + kTile - 1) / kTile;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const xsdba::DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return static_cast<int>(guard.status());
  const auto* pv = static_cast<const float*>(v);
  const auto* px = static_cast<const float*>(xs);
  const auto* py = static_cast<const float*>(ys);
  const auto* pn = static_cast<const int*>(nvalid);
  auto* po = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(v, out);
  if (lp < kShortRow) {
    const unsigned blocks = static_cast<unsigned>((rows + kWarpRows - 1) / kWarpRows);
    interp_rows_kernel<kWarpRows, kNear><<<blocks, kThreads, 0, s>>>(pv, px, py, pn, po, rows, lp, nq, vec);
  } else {
    const dim3 grid(static_cast<unsigned>(rows), static_cast<unsigned>(tiles));
    interp_rows_kernel<1, kNear><<<grid, kThreads, 0, s>>>(pv, px, py, pn, po, rows, lp, nq, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_rows_by(int method, const void* v, const void* xs, const void* ys, const void* nvalid, void* out, int rows,
                   int lp, int nq, int device, void* stream) {
  if (method == kMethodLinear) return launch_rows<false>(v, xs, ys, nvalid, out, rows, lp, nq, device, stream);
  if (method == kMethodNearest) return launch_rows<true>(v, xs, ys, nvalid, out, rows, lp, nq, device, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Every entry launches on `stream` of CUDA device `device` (leaving the
// calling thread's current device as it found it) and returns
// cudaGetLastError() (0 on success); nq table nodes (<= 64); method 0 is
// linear interpolation, 1 the nearer node's value.

// rows = B * Gp partition rows of lp values each.
extern "C" int xsdba_interp_table_3d(const void* v, const void* xs, const void* ys,
                                     const void* nvalid, void* out, int rows, int lp,
                                     int nq, int method, int device, void* stream) {
  return launch_rows_by(method, v, xs, ys, nvalid, out, rows, lp, nq, device, stream);
}

// v/out [rows, l], xs/ys [rows, nq], nvalid [rows]: one table per row.
extern "C" int xsdba_interp_table_2d(const void* v, const void* xs, const void* ys,
                                     const void* nvalid, void* out, int rows, int l,
                                     int nq, int method, int device, void* stream) {
  return launch_rows_by(method, v, xs, ys, nvalid, out, rows, l, nq, device, stream);
}

// v/out [sites, t], xs/ys [sites, gp, nq], nvalid [sites, gp], g0/g1 [t]
// int32, w [t]: out = fma(1 - w, table_g0(v), w * table_g1(v)).  Refuses
// more tables a site than 48 KB of shared memory hold, 1056 bytes each
// (ops/cuda/interp_kernel.py:bracketed_smem_bytes is the same count).
extern "C" int xsdba_interp_bracketed(const void* v, const void* xs, const void* ys, const void* nvalid,
                                      const void* g0, const void* g1, const void* w, void* out, int sites,
                                      int t, int gp, int nq, int device, void* stream) {
  if (sites < 0 || t < 0 || gp < 1 || nq < 1 || nq > kMaxNq) return static_cast<int>(cudaErrorInvalidValue);
  if (sites == 0 || t == 0) return 0;
  if (gp > kBracketSmem / kTableBytes) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = gp * kTableBytes;
  const int tiles = (t + kBracketTile - 1) / kBracketTile;
  const long long blocks = static_cast<long long>(sites) * tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const xsdba::DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return static_cast<int>(guard.status());
  interp_bracketed_kernel<<<static_cast<unsigned>(blocks), kThreads, static_cast<size_t>(smem),
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<const float*>(xs), static_cast<const float*>(ys),
      static_cast<const int*>(nvalid), static_cast<const int*>(g0), static_cast<const int*>(g1),
      static_cast<const float*>(w), static_cast<float*>(out), t, gp, nq, tiles, aligned16(v, out));
  return static_cast<int>(cudaGetLastError());
}

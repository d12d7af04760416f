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
// - Tables out of order.  The grouped adjust lays a quantile-trained table
//   whose factor is NaN at some quantile (kind="*" on dry days: 0 / 0) out
//   with a +inf hole there, so its nodes are not ascending; the twin's count
//   loop counts nodes by value and takes the segment by position.  The
//   staging notes whether any two neighbouring nodes of a row are out of
//   order (NaN sorting last), a warp vote for a warp's row and a block vote
//   for a block's, and only such a row has its probe nodes ranked by value
//   (stable, NaN last) before the search, by one warp, while its (x, y)
//   pairs and the two extrapolation edges (x[0] and x[nvalid - 1], the
//   twin's) stay by position.  A holey row is ranked with ballots (see
//   `rank_nodes`); any other disorder with nq comparisons a node.  An
//   ordered row takes no further pass.
// - Long rows: one block per 4096-value tile of a row, 16-byte loads and
//   stores, four values a thread a step, two steps in flight.  Row starts
//   are not 16-byte aligned in general (rows of 4650 or 54750 values), so a
//   block's range of the flat array has a scalar head up to the first
//   16-byte boundary, a vector body and a scalar tail.
// - Rows of fewer than kShortRow values take one warp each (8 rows a block,
//   each warp with its own table) and 4-byte accesses, a value a lane a
//   step: on the windowed adjust's 150-value rows four values a lane would
//   leave 4 lanes in 10 idle.
// - The bracketed entry has a layout and a search of its own, below
//   `interp_rows_kernel`.
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
// the bracketed route admits a site's tables while they fit 48 KB at 1056
// bytes a table (46 tables): ops/cuda/interp_kernel.py:bracketed_fits
constexpr int kBracketAdmitSmem = 48 * 1024;
constexpr int kBracketAdmitTable = 1056;

// the nodes' order for the search: by value, NaN after every number
__device__ __forceinline__ bool sorts_before(float a, float b) { return a < b || (!isnan(a) && isnan(b)); }
__device__ __forceinline__ bool same_key(float a, float b) { return a == b || (isnan(a) && isnan(b)); }

// whether node k + 1 of x[0 .. nq) sorts before node k
__device__ __forceinline__ bool out_of_order(const float* x, int k, int nq) {
  return k + 1 < nq && sorts_before(x[k + 1], x[k]);
}

// the stable rank of node k among the nq nodes x[j * stride] by value, NaN
// last: the nodes that sort before it and its equals at lower positions
__device__ __forceinline__ int value_rank(const float* x, int stride, int nq, int k) {
  const float xk = x[k * stride];
  int rank = 0;
  for (int j = 0; j < nq; ++j) {
    const float xj = x[j * stride];
    rank += sorts_before(xj, xk) || (j < k && same_key(xj, xk));
  }
  return rank;
}

// One table in shared memory, evaluated at val: x[0 .. kProbes) its nodes
// for the probes, ascending (by value where the table is out of order; NaN
// past nq); xy[0 .. nq] its (x, y) pairs, the last one
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
// thread `lane` of `width` taking every width-th entry.  Returns whether
// this thread found a node that sorts before the one above it (the nodes'
// order is by value, NaN last).  The caller synchronises before any thread
// reads them.
__device__ __forceinline__ bool stage_table(const float* __restrict__ xs, const float* __restrict__ ys, int nq,
                                            float* x, float2* xy, int lane, int width) {
  bool unsorted = false;
  for (int k = lane; k < kProbes; k += width) {
    const float xk = k < nq ? xs[k] : NAN;
    x[k] = xk;
    unsorted |= out_of_order(xs, k, nq);
  }
  for (int k = lane; k <= nq; k += width) {
    xy[k] = k < nq ? make_float2(xs[k], ys[k]) : make_float2(INFINITY, ys[nq - 1]);
  }
  return unsorted;
}

// A staged table's probe nodes x[0 .. nq) by value (stable, NaN last),
// ranked by one warp (lane 0 .. 31) from its positional pairs xy, which
// stay as they are: the descent in `lookup` then counts the nodes <= val,
// as the twin's count loop does, and the segment is taken by position.
// The grouped adjust's out-of-order rows are ascending numbers with +inf
// holes (ops/interp.py:_compact_sorted_tables).  Where a row's numbers
// (nodes neither +inf nor NaN) do not descend by position, their stable
// order is by position and every +inf node and then every NaN node sorts
// after them, so a node's rank is a count of set bits in the warp's
// ballots of the three classes.  Any other row takes `value_rank`.  A lane
// holds nodes lane and lane + 32 (nq <= 64).  The caller synchronises the
// warp before this, and the row's readers after it.
__device__ void rank_nodes(int nq, float* x, const float2* xy, int lane) {
  const float* px = &xy[0].x;  // node j at px[2 j]
  float key[2];
  unsigned long long num = 0, inf = 0;  // the numbers' and the +inf nodes' positions
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int k = lane + 32 * h;
    key[h] = k < nq ? px[2 * k] : NAN;
    num |= static_cast<unsigned long long>(__ballot_sync(0xffffffffu, key[h] < INFINITY)) << (32 * h);
    inf |= static_cast<unsigned long long>(__ballot_sync(0xffffffffu, key[h] == INFINITY)) << (32 * h);
  }
  bool descends = false;  // a number below the number before it
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const unsigned long long before = num & ((1ull << (lane + 32 * h)) - 1);
    if (key[h] < INFINITY && before != 0) descends |= key[h] < px[2 * (63 - __clzll(before))];
  }
  if (__any_sync(0xffffffffu, descends)) {
    for (int k = lane; k < nq; k += 32) x[value_rank(px, 2, nq, k)] = px[2 * k];
    return;
  }
  const int n_num = __popcll(num), n_inf = __popcll(inf);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int k = lane + 32 * h;
    const unsigned long long below = (1ull << k) - 1;
    const float xk = key[h];
    const int rank = xk < INFINITY    ? __popcll(num & below)
                     : xk == INFINITY ? n_num + __popcll(inf & below)
                                      : n_num + n_inf + __popcll(~(num | inf) & below);
    if (k < nq) x[rank] = xk;
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
  bool unsorted = live && stage_table(xs + row * nq, ys + row * nq, nq, sx[sub], sxy[sub], lane, kWidth);
  // whether the row's nodes are out of order, a block vote for a block's
  // row and a warp vote for a warp's (a warp's lanes share their row), and
  // only then its probe nodes ranked by value, by the row's first warp
  if constexpr (kRows == 1) {
    if (__syncthreads_or(unsorted)) {  // also the staging's barrier
      if (threadIdx.x < 32) rank_nodes(nq, sx[0], sxy[0], threadIdx.x);
      __syncthreads();
    }
  } else {
    if (live && __any_sync(0xffffffffu, unsorted)) {
      __syncwarp();
      rank_nodes(nq, sx[sub], sxy[sub], lane);
    }
    __syncthreads();
  }
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

// ---------------------------------------------------------------------------
// The bracketed entry.  A block serves one site over kBrChunk steps of its
// time axis.  Consecutive lanes take consecutive time steps, so a warp's
// values fall in at most three bracket pairs and its probes mostly in one
// table at a time, and every load and store of v, out and the steps'
// (g0, g1, w) is one coalesced 128-byte access a warp.  A thread looks up
// kSteps values a round, kBrThreads steps apart, in both their tables: 2
// kSteps independent searches, interleaved level by level; the next
// round's operands are loaded before this round's lookups.  The site's
// tables are laid out once, at staging, for a search and one load:
// - the search nodes in breadth-first (Eytzinger) order, 2^kDepth - 1
//   slots: the nq nodes by value, a sentinel, the smallest float above
//   x[last] (the last valid node; none if that is +inf or NaN), inserted
//   after the nodes <= x[last], then NaN.  A descent of kDepth probes (node
//   i's children at 2i + 1 and 2i + 2) ends at 2^kDepth - 1 + c, c the
//   count of those nodes <= v: NaN compares false, so c is `lookup`'s count
//   on every input, plus one where v lies above x[last].  The nodes come
//   ascending (valid first, +inf / NaN tail) but for +inf holes where a
//   quantile-trained table has a NaN factor inside (the grouped adjust
//   lays such tables out uncompacted); a block with such a table ranks its
//   nodes by value first, and the count, as in `lookup`'s count loop, is by
//   value while the segment below is by position.  A level's nodes are
//   adjacent, so the probes of lanes that share a table fall in distinct
//   banks; tables start an odd number of words apart.  kDepth is 6 for
//   nq <= 62 and 7 above.  The descent keeps the probed node's shared-
//   memory address a: the children of a are 2a + k4 and 2a + k4 + 4 with
//   k4 = 4 - (the table's address), so a level is a load, a comparison, a
//   select and a multiply-add;
// - a 16-byte record per count c = 0 .. nq + 1, (x0, y0, dx, dy), found at
//   4 a + a table constant.  Inside the table it is the segment that
//   `lookup` interpolates at that count, k = min(max(c - 1, 0),
//   max(nv - 2, 0)), dx = x[k + 1] - x[k] and dy = y1 - y[k] with the
//   single-node guard, the roundings `lookup` makes at every call.  Below
//   x[0] (at most as many nodes counted as lie below it) and above x[last]
//   (the sentinel counted) it is (0, y[0] or y[last], 0, -0): its
//   interpolation fma(+0, -0, y) is y bit for bit, the constant
//   extrapolation.  An empty table's records carry y0 = NaN, so every value
//   gives NaN.
// A lookup is then kDepth probes, one record load, and `lookup`'s division
// (behind the same condition: dividing 0 / 1 in its place, branch free,
// measured slower on the H100) and fused interpolation; the NaN-value and
// group-outside-[0, gp) rules apply once a value (either gives NaN through
// the blend).  The staging (about 15 KB a site at the monthly headline) is
// repeated once a chunk; the blocks of a wave overlap it with each other's
// lookups.  scripts/probe_bracketed.py splits the kernel's time.
constexpr int kBrThreads = 256;
constexpr int kBrSteps = 2;         // values a thread looks up a round
constexpr int kBrChunk = 8 * 1024;  // steps a block serves

template <int kDepth>
struct Eytzinger {
  static constexpr int kSlots = (1 << kDepth) - 1;
  static constexpr int kStride = kSlots + 2;  // words between tables: odd
};

// nq nodes and the sentinel in 2^kDepth - 1 slots
__host__ __device__ constexpr int bracketed_depth(int nq) { return nq + 1 <= 63 ? 6 : 7; }

// shared memory of one table: nq + 2 records, its thresholds and the nodes
__host__ __device__ inline int bracketed_table_bytes(int nq) {
  return 16 * (nq + 2) + 16 + 4 * (bracketed_depth(nq) == 6 ? Eytzinger<6>::kStride : Eytzinger<7>::kStride);
}

// shared-memory loads at 32-bit shared addresses
__device__ __forceinline__ float lds1(unsigned a) {
  float x;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(x) : "r"(a));
  return x;
}
__device__ __forceinline__ float4 lds4(unsigned a) {
  float4 x;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];" : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w) : "r"(a));
  return x;
}

// the interpolation of `lookup` given the segment record s; `finite` is
// isfinite(val).  The division stays behind its condition, as in `lookup`:
// a branch that most warps take whole measured faster on the H100 than
// dividing 0 / 1 in its place.
__device__ __forceinline__ float seg_value(float val, bool finite, float4 s) {
  float f = 0.0f;
  if (s.z > 0.0f && finite) f = __fdiv_rn(__fsub_rn(val, s.x), s.z);
  if (!isfinite(f)) f = 0.0f;
  return __fmaf_rn(f, s.w, s.y);
}

// the operands of kSteps time steps kBrThreads apart from t: the two
// groups, the weight and the value (zeros past t_hi)
template <int kSteps>
struct StepOperands {
  int a[kSteps], b[kSteps];
  float w[kSteps], v[kSteps];
  __device__ __forceinline__ void load(const int* __restrict__ g0, const int* __restrict__ g1, const float* __restrict__ wt,
                                       const float* __restrict__ vrow, int t, int t_hi) {
#pragma unroll
    for (int r = 0; r < kSteps; ++r) {
      const int tr = t + r * kBrThreads;
      const bool in = tr < t_hi;
      a[r] = in ? g0[tr] : 0;
      b[r] = in ? g1[tr] : 0;
      w[r] = in ? wt[tr] : 0.0f;
      v[r] = in ? vrow[tr] : 0.0f;
    }
  }
};

template <int kDepth, int kSteps>
__global__ void __launch_bounds__(kBrThreads)
interp_bracketed_kernel(const float* __restrict__ v, const float* __restrict__ xs, const float* __restrict__ ys,
                        const int* __restrict__ nvalid, const int* __restrict__ g0, const int* __restrict__ g1,
                        const float* __restrict__ w, float* __restrict__ out, int T, int gp, int nq, int chunks,
                        int chunk_len) {
  using E = Eytzinger<kDepth>;
  constexpr int kChains = 2 * kSteps;
  extern __shared__ float4 smem[];
  const int nrec = nq + 2;
  float4* rec = smem;                                       // [gp][nrec]
  int4* meta = reinterpret_cast<int4*>(rec + gp * nrec);    // [gp]: below, upto, sentinel
  float* ey = reinterpret_cast<float*>(meta + gp);          // [gp][E::kStride]
  const long long site = blockIdx.x / chunks;
  const int t_lo = static_cast<int>(blockIdx.x % chunks) * chunk_len;
  const int t_hi = min(t_lo + chunk_len, T);
  const float* vrow = v + site * T;
  float* orow = out + site * T;
  const float* txs = xs + site * gp * nq;
  const float* tys = ys + site * gp * nq;
  const int* tnv = nvalid + site * gp;

  // a round's operands are loaded a round ahead of its lookups, the first
  // round's while the tables are staged
  StepOperands<kSteps> cur;
  int t = t_lo + threadIdx.x;
  cur.load(g0, g1, w, vrow, t, t_hi);

  // 1. the nodes' raw values and whether any table is out of order (NaN
  //    sorts last): the rows the grouped adjust gets are ascending with a
  //    +inf / NaN tail, but a quantile-trained table with a NaN factor
  //    inside has a +inf hole there, where `lookup`'s count loop counts
  //    nodes by value and takes the segment by position.  With them, the
  //    two extrapolation thresholds as counts of nodes, a warp a table: a
  //    value is below x[0] iff at most `below` nodes are <= it, and above
  //    x[last] iff it is at or above the sentinel, the smallest float above
  //    x[last], which sorts after the `upto` nodes <= x[last]
  bool unsorted = false;
  for (int item = threadIdx.x; item < gp * nq; item += kBrThreads) {
    const int tb = item / nq, k = item - tb * nq;
    const float x = txs[item];
    ey[tb * E::kStride + k] = x;
    unsorted |= out_of_order(txs + tb * nq, k, nq);
  }
  for (int tb = threadIdx.x / 32; tb < gp; tb += kBrThreads / 32) {
    const int lane = threadIdx.x % 32;
    const float* x = txs + tb * nq;
    const float x_first = x[0], x_last = x[min(max(tnv[tb] - 1, 0), nq - 1)];
    int below = 0, upto = 0;
    for (int j = lane; j - lane < nq; j += 32) {  // nq <= 64: two rounds
      const float xj = j < nq ? x[j] : NAN;
      below += __popc(__ballot_sync(0xffffffffu, xj < x_first));
      upto += __popc(__ballot_sync(0xffffffffu, xj <= x_last));
    }
    // no sentinel where nothing lies above x[last] (+inf or NaN)
    if (lane == 0) meta[tb] = make_int4(isnan(x_first) ? -1 : below, upto, x_last < INFINITY, 0);
  }
  const bool permuted = __syncthreads_or(unsorted);
  // 2. where a table is out of order: each table's nodes by value (stable,
  //    NaN last), inv[tb][rank] = position, kept in the records' space
  int* inv = reinterpret_cast<int*>(rec);  // [gp][4 nrec]
  if (permuted) {
    for (int item = threadIdx.x; item < gp * nq; item += kBrThreads) {
      const int tb = item / nq, k = item - tb * nq;
      inv[tb * 4 * nrec + value_rank(ey + tb * E::kStride, 1, nq, k)] = k;
    }
    __syncthreads();
  }
  // 3. the search nodes in breadth-first order: by value, the sentinel
  //    inserted at rank `upto`, NaN past them
  for (int item = threadIdx.x; item < gp * E::kSlots; item += kBrThreads) {
    const int tb = item / E::kSlots, i = item - tb * E::kSlots;
    const int l = 31 - __clz(i + 1);                                        // level of slot i
    int r = ((2 * (i + 1 - (1 << l)) + 1) << (kDepth - 1 - l)) - 1;         // its rank
    const int4 m = meta[tb];
    const float* x = txs + tb * nq;
    float node = NAN;
    if (m.z && r == m.y) {
      node = nextafterf(x[min(max(tnv[tb] - 1, 0), nq - 1)], INFINITY);
    } else {
      if (m.z && r > m.y) --r;
      if (r < nq) node = x[permuted ? inv[tb * 4 * nrec + r] : r];
    }
    ey[tb * E::kStride + i] = node;
  }
  if (permuted) __syncthreads();  // the records overwrite inv
  // 4. the record of each count c of search nodes <= v
  for (int item = threadIdx.x; item < gp * nrec; item += kBrThreads) {
    const int tb = item / nrec, c = item - tb * nrec;
    const float* x = txs + tb * nq;
    const float* y = tys + tb * nq;
    const int nv = tnv[tb];
    const int4 m = meta[tb];
    float4 r;
    if ((m.z && c > m.y) || c <= m.x) {
      // above x[last] (the sentinel counted), else below x[0]: the constant
      // extrapolation, fma(+0, -0, y) = y
      const float y_edge = m.z && c > m.y ? y[min(max(nv - 1, 0), nq - 1)] : y[0];
      r = make_float4(0.0f, nv == 0 ? NAN : y_edge, 0.0f, -0.0f);
    } else {
      const int k = min(max(c - 1, 0), max(nv - 2, 0));
      const float x0 = x[k];
      const float y0 = y[k];
      const float x1 = k + 1 < nq ? x[k + 1] : INFINITY;  // a bracket on the last node: the +inf pad
      float y1 = k + 1 < nq ? y[k + 1] : y[nq - 1];
      if (isnan(y1)) y1 = y0;  // single valid node: its pair is the NaN pad
      r = make_float4(x0, nv == 0 ? NAN : y0, __fsub_rn(x1, x0), __fsub_rn(y1, y0));
    }
    rec[item] = r;
  }
  __syncthreads();

  // shared addresses: table tb's nodes at ey_s + 4 kStride tb; the record of
  // count c at rec_s + 16 (nrec tb + c), which the descent's last address
  // a = ey_s + 4 kStride tb + 4 (kSlots + c) gives as 4 a + rec_c + rec_d tb
  const unsigned ey_s = static_cast<unsigned>(__cvta_generic_to_shared(ey));
  const unsigned rec_c = static_cast<unsigned>(__cvta_generic_to_shared(rec)) - 4u * ey_s - 16u * E::kSlots;
  const unsigned rec_d = 16u * static_cast<unsigned>(nrec) - 16u * E::kStride;
  StepOperands<kSteps> nxt;
  for (; t < t_hi; t += kSteps * kBrThreads) {
    nxt.load(g0, g1, w, vrow, t + kSteps * kBrThreads, t_hi);
    float val[kSteps], wt[kSteps];
    bool bad[kSteps];
    unsigned tb[kChains];
#pragma unroll
    for (int r = 0; r < kSteps; ++r) {
      val[r] = cur.v[r];
      wt[r] = cur.w[r];
      // a group id outside [0, gp) has no table: NaN (table 0 is read)
      bad[r] = static_cast<unsigned>(cur.a[r]) >= static_cast<unsigned>(gp) || static_cast<unsigned>(cur.b[r]) >= static_cast<unsigned>(gp);
      tb[2 * r] = bad[r] ? 0u : static_cast<unsigned>(cur.a[r]);
      tb[2 * r + 1] = bad[r] ? 0u : static_cast<unsigned>(cur.b[r]);
    }
    unsigned addr[kChains], k4[kChains], k8[kChains];
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      addr[c] = ey_s + 4u * E::kStride * tb[c];
      k4[c] = 4u - addr[c];
      k8[c] = k4[c] + 4u;
    }
#pragma unroll
    for (int l = 0; l < kDepth; ++l) {
#pragma unroll
      for (int c = 0; c < kChains; ++c) addr[c] = 2u * addr[c] + (lds1(addr[c]) <= val[c / 2] ? k8[c] : k4[c]);
    }
    float res[kChains];
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      const float4 s = lds4(4u * addr[c] + rec_c + rec_d * tb[c]);
      res[c] = seg_value(val[c / 2], isfinite(val[c / 2]), s);
    }
#pragma unroll
    for (int r = 0; r < kSteps; ++r) {
      float o = __fmaf_rn(__fsub_rn(1.0f, wt[r]), res[2 * r], __fmul_rn(wt[r], res[2 * r + 1]));
      if (bad[r] || isnan(val[r])) o = NAN;
      if (t + r * kBrThreads < t_hi) orow[t + r * kBrThreads] = o;
    }
    cur = nxt;
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

template <int kDepth>
int launch_bracketed(const void* v, const void* xs, const void* ys, const void* nvalid, const void* g0, const void* g1,
                     const void* w, void* out, int sites, int t, int gp, int nq, void* stream) {
  auto* kernel = interp_bracketed_kernel<kDepth, kBrSteps>;
  const int smem = gp * bracketed_table_bytes(nq);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const int chunks = (t + kBrChunk - 1) / kBrChunk;
  const long long blocks = static_cast<long long>(sites) * chunks;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kBrThreads, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<const float*>(xs), static_cast<const float*>(ys),
      static_cast<const int*>(nvalid), static_cast<const int*>(g0), static_cast<const int*>(g1),
      static_cast<const float*>(w), static_cast<float*>(out), t, gp, nq, chunks, kBrChunk);
  return static_cast<int>(cudaGetLastError());
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
// int32, w [t]: out = fma(1 - w, table_g0(v), w * table_g1(v)).  Admits at
// most 46 tables a site, the route's rule (48 KB at 1056 bytes a table:
// ops/cuda/interp_kernel.py:bracketed_fits is the same count).
extern "C" int xsdba_interp_bracketed(const void* v, const void* xs, const void* ys, const void* nvalid,
                                      const void* g0, const void* g1, const void* w, void* out, int sites,
                                      int t, int gp, int nq, int device, void* stream) {
  if (sites < 0 || t < 0 || gp < 1 || nq < 1 || nq > kMaxNq) return static_cast<int>(cudaErrorInvalidValue);
  if (sites == 0 || t == 0) return 0;
  if (gp > kBracketAdmitSmem / kBracketAdmitTable) return static_cast<int>(cudaErrorInvalidValue);
  const xsdba::DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return static_cast<int>(guard.status());
  if (bracketed_depth(nq) == 6) return launch_bracketed<6>(v, xs, ys, nvalid, g0, g1, w, out, sites, t, gp, nq, stream);
  return launch_bracketed<7>(v, xs, ys, nvalid, g0, g1, w, out, sites, t, gp, nq, stream);
}

// The bracketed lookup's kernel as it stood before its H100 redesign (the
// tile kernel: a block per 8192-step tile of a site, each value's two
// seven-probe lookups into the sorted nodes, 16-byte loads of v), four
// cut-down variants of it, and five of the redesigned kernel, that split
// their times, for scripts/probe_bracketed.py.
// Not part of the port: it includes the port's source for the helpers the
// old kernel shares with the row lookups (`lookup`, `stage_table`,
// `table_edge`, `Split`), and the port's kernel is timed through its own
// wrapper.
#include "../xsdba_tpu_torch/csrc/interp_kernel.cu"

namespace tile {
constexpr int kBracketTile = 8192;
constexpr int kBracketSmem = 48 * 1024;
constexpr int kProbeStride = kProbes + 1;
constexpr int kPairStride = kPairs;
constexpr int kTableBytes = 16 + 8 * kPairStride + 4 * kProbeStride + 4;

// kP: 0 the tile kernel; 1 the shell (stage, copy v); 2 one lookup a value;
// 3 both lookups, g0/g1/w fixed (no per-step loads); 4 the staging alone
template <int kP>
__global__ void __launch_bounds__(kThreads)
old_kernel(const float* __restrict__ v, const float* __restrict__ xs, const float* __restrict__ ys,
           const int* __restrict__ nvalid, const int* __restrict__ g0, const int* __restrict__ g1,
           const float* __restrict__ w, float* __restrict__ out, int T, int gp, int nq, int tiles, bool vec) {
  extern __shared__ float4 smem[];
  float4* edge = smem;
  float2* sxy = reinterpret_cast<float2*>(edge + gp);
  float* sx = reinterpret_cast<float*>(sxy + gp * kPairStride);
  int* snv = reinterpret_cast<int*>(sx + gp * kProbeStride);
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
  if (kP == 4) {
    if (threadIdx.x == 0) out[blockIdx.x] = sx[gp * kProbeStride - 1] + edge[gp - 1].w + snv[gp - 1];
    return;
  }
  auto in_group = [&](float val, int grp) {
    const int g = min(max(grp, 0), gp - 1);
    const float r = lookup<false>(val, sx + g * kProbeStride, sxy + g * kPairStride, edge[g], snv[g]);
    return g == grp ? r : NAN;
  };
  auto blended = [&](float val, int tstep) {
    if (kP == 1) return val;
    if (kP == 2) {
      const float ww = w[tstep];
      return __fmaf_rn(__fsub_rn(1.0f, ww), in_group(val, g0[tstep]), ww);
    }
    if (kP == 3) return __fmaf_rn(0.625f, in_group(val, 5), __fmul_rn(0.375f, in_group(val, 6)));
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

template <int kP>
int launch(const void* v, const void* xs, const void* ys, const void* nvalid, const void* g0, const void* g1,
           const void* w, void* out, int sites, int t, int gp, int nq, void* stream) {
  if (gp > kBracketSmem / kTableBytes) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = gp * kTableBytes;
  const int tiles = (t + kBracketTile - 1) / kBracketTile;
  const long long blocks = static_cast<long long>(sites) * tiles;
  old_kernel<kP><<<static_cast<unsigned>(blocks), kThreads, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<const float*>(xs), static_cast<const float*>(ys),
      static_cast<const int*>(nvalid), static_cast<const int*>(g0), static_cast<const int*>(g1),
      static_cast<const float*>(w), static_cast<float*>(out), t, gp, nq, tiles, aligned16(v, out));
  return static_cast<int>(cudaGetLastError());
}
}  // namespace tile

// variant: 0 the tile kernel, 1-4 its cut-down variants (tile::old_kernel)
extern "C" int tile_bracketed(int variant, const void* v, const void* xs, const void* ys, const void* nvalid, const void* g0,
                             const void* g1, const void* w, void* out, int sites, int t, int gp, int nq, void* stream) {
  switch (variant) {
    case 0: return tile::launch<0>(v, xs, ys, nvalid, g0, g1, w, out, sites, t, gp, nq, stream);
    case 1: return tile::launch<1>(v, xs, ys, nvalid, g0, g1, w, out, sites, t, gp, nq, stream);
    case 2: return tile::launch<2>(v, xs, ys, nvalid, g0, g1, w, out, sites, t, gp, nq, stream);
    case 3: return tile::launch<3>(v, xs, ys, nvalid, g0, g1, w, out, sites, t, gp, nq, stream);
    case 4: return tile::launch<4>(v, xs, ys, nvalid, g0, g1, w, out, sites, t, gp, nq, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}


// ---------------------------------------------------------------------------
// The port's kernel (interp_bracketed_kernel, as in the port's source) with
// one part cut, kCut: 1 the shell (its staging, then v copied to out); 2 no
// search (a record picked by the value's bits); 3 no division (a product in
// its place); 4 no per-step loads (groups 5 and 6, w 0.375); 5 one table
// pair a warp (the loads kept, groups 5 and 6).
namespace cut {
// StepOperands with the per-step loads cut (groups 5 and 6, w 0.375) when `fixed`
template <int kSteps>
struct CutOperands : StepOperands<kSteps> {
  __device__ __forceinline__ void load(const int* __restrict__ g0, const int* __restrict__ g1, const float* __restrict__ wt,
                                       const float* __restrict__ vrow, int t, int t_hi, bool fixed) {
    if (!fixed) return StepOperands<kSteps>::load(g0, g1, wt, vrow, t, t_hi);
#pragma unroll
    for (int r = 0; r < kSteps; ++r) {
      const int tr = t + r * kBrThreads;
      this->a[r] = 5;
      this->b[r] = 6;
      this->w[r] = 0.375f;
      this->v[r] = tr < t_hi ? vrow[tr] : 0.0f;
    }
  }
};

template <int kDepth, int kSteps, int kCut>
__global__ void __launch_bounds__(kBrThreads)
cut_kernel(const float* __restrict__ v, const float* __restrict__ xs, const float* __restrict__ ys,
                        const int* __restrict__ nvalid, const int* __restrict__ g0, const int* __restrict__ g1,
                        const float* __restrict__ w, float* __restrict__ out, int T, int gp, int nq, int chunks,
                        int chunk_len) {
  using E = Eytzinger<kDepth>;
  constexpr int kChains = 2 * kSteps;
  extern __shared__ float4 smem[];
  const int nrec = nq + 2;
  float4* rec = smem;                                       // [gp][nrec]
  int4* meta = reinterpret_cast<int4*>(rec + gp * nrec);    // [gp]: first, above, sentinel
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
  CutOperands<kSteps> cur;
  int t = t_lo + threadIdx.x;
  cur.load(g0, g1, w, vrow, t, t_hi, kCut == 4);

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
    if (k + 1 < nq) unsorted |= sorts_before(txs[item + 1], x);
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
      const float* x = ey + tb * E::kStride;
      const float xk = x[k];
      int rank = 0;
      for (int j = 0; j < nq; ++j) rank += sorts_before(x[j], xk) || (j < k && same_key(x[j], xk));
      inv[tb * 4 * nrec + rank] = k;
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
  CutOperands<kSteps> nxt;
  for (; t < t_hi; t += kSteps * kBrThreads) {
    nxt.load(g0, g1, w, vrow, t + kSteps * kBrThreads, t_hi, kCut == 4);
    float val[kSteps], wt[kSteps];
    bool bad[kSteps];
    unsigned tb[kChains];
#pragma unroll
    for (int r = 0; r < kSteps; ++r) {
      if (kCut == 5) {
        cur.a[r] = 5 + (cur.a[r] >> 30);
        cur.b[r] = 6 + (cur.b[r] >> 30);
      }
      val[r] = cur.v[r];
      wt[r] = cur.w[r];
      // a group id outside [0, gp) has no table: NaN (table 0 is read)
      bad[r] = static_cast<unsigned>(cur.a[r]) >= static_cast<unsigned>(gp) || static_cast<unsigned>(cur.b[r]) >= static_cast<unsigned>(gp);
      tb[2 * r] = bad[r] ? 0u : static_cast<unsigned>(cur.a[r]);
      tb[2 * r + 1] = bad[r] ? 0u : static_cast<unsigned>(cur.b[r]);
    }
    if (kCut == 1) {
#pragma unroll
      for (int r = 0; r < kSteps; ++r)
        if (t + r * kBrThreads < t_hi) orow[t + r * kBrThreads] = val[r];
      cur = nxt;
      continue;
    }
    unsigned addr[kChains], k4[kChains], k8[kChains];
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      addr[c] = ey_s + 4u * E::kStride * tb[c];
      k4[c] = 4u - addr[c];
      k8[c] = k4[c] + 4u;
    }
    if (kCut == 2) {
#pragma unroll
      for (int c = 0; c < kChains; ++c) addr[c] += 4u * (E::kSlots + ((__float_as_uint(val[c / 2]) >> (9 + (c & 1))) & 31));
    } else {
#pragma unroll
      for (int l = 0; l < kDepth; ++l) {
#pragma unroll
        for (int c = 0; c < kChains; ++c) addr[c] = 2u * addr[c] + (lds1(addr[c]) <= val[c / 2] ? k8[c] : k4[c]);
      }
    }
    float res[kChains];
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      const float4 s = lds4(4u * addr[c] + rec_c + rec_d * tb[c]);
      res[c] = kCut == 3 ? __fmaf_rn(__fmul_rn(__fsub_rn(val[c / 2], s.x), s.z), s.w, s.y) : seg_value(val[c / 2], isfinite(val[c / 2]), s);
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

template <int kCut>
int launch(const void* v, const void* xs, const void* ys, const void* nvalid, const void* g0, const void* g1,
           const void* w, void* out, int sites, int t, int gp, int nq, void* stream) {
  auto* kernel = cut_kernel<6, kBrSteps, kCut>;
  const int smem = gp * bracketed_table_bytes(nq);
  if (smem > 48 * 1024) cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int chunks = (t + kBrChunk - 1) / kBrChunk;
  kernel<<<static_cast<unsigned>(sites * chunks), kBrThreads, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<const float*>(xs), static_cast<const float*>(ys),
      static_cast<const int*>(nvalid), static_cast<const int*>(g0), static_cast<const int*>(g1),
      static_cast<const float*>(w), static_cast<float*>(out), t, gp, nq, chunks, kBrChunk);
  return static_cast<int>(cudaGetLastError());
}
}  // namespace cut

// kCut 1-5 of the port's kernel (31 <= nq <= 62, gp > 6)
extern "C" int cut_bracketed(int cut, const void* v, const void* xs, const void* ys, const void* nvalid, const void* g0,
                             const void* g1, const void* w, void* out, int sites, int t, int gp, int nq, void* stream) {
  if (nq > 62 || nq < 31 || gp < 7) return static_cast<int>(cudaErrorInvalidValue);
  switch (cut) {
    case 1: return cut::launch<1>(v, xs, ys, nvalid, g0, g1, w, out, sites, t, gp, nq, stream);
    case 2: return cut::launch<2>(v, xs, ys, nvalid, g0, g1, w, out, sites, t, gp, nq, stream);
    case 3: return cut::launch<3>(v, xs, ys, nvalid, g0, g1, w, out, sites, t, gp, nq, stream);
    case 4: return cut::launch<4>(v, xs, ys, nvalid, g0, g1, w, out, sites, t, gp, nq, stream);
    case 5: return cut::launch<5>(v, xs, ys, nvalid, g0, g1, w, out, sites, t, gp, nq, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

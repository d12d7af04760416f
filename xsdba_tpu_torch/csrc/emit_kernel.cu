// Dense emission, stages 2b and 3 of the counting-selection engine's emit
// mode: for each row b of the sorted values and packed labels [B, Tp] and
// each group g, the values of the needed member ranks: the rank lists
// rl, rr [B, G, nq] (non-decreasing along nq) and the rank n[b, g] of the
// group's largest valid value.  An element of label (a, len) is a member of
// the groups a .. a + len - 1 (mod G) unless its value is NaN; its member
// rank in group g is the number of members of g at or before it in the row.
//
// Replaces no TPU kernel: the JAX package computes this in plain JAX
// (xsdba_tpu/ops/selquant.py:336-445, _window / _run / _chunk_emit /
// _assemble), as [B, E, G, S] hit tensors a chunk of E = nb_chunk * Wb
// elements and S rank slots, rerun at S = nq when a chunk needs more than S
// ranks.  At the selection path's width (448 rows of 65536, 365 groups,
// E = 8192, S = 32) one chunk's hit tensor is 2.1e10 elements, more than
// the card holds, so this kernel stores none.  Its plain twin is
// xsdba_tpu_torch/ops/cuda/emit_kernel.py:emit_reference, the JAX form
// chunked under an element budget.
//
// Bound: bytes, about 0.37 GB at that width (each value, label, count and
// rank read once, the picks written: 0.11 ms at 3.35 TB/s).  The function
// needs one operation a (member, group) pair, since an element of label
// (a, len) is in its len groups alone: at most B * T * 31 = 7.6e8 at
// window 31, 0.011 ms at 67 T/s.  This kernel tests every element against
// every group (B * Tp * G = 1.07e10, 0.16 ms at 67 T/s), so its own work
// is above the bound; testing each element against its own len groups
// only is the next design.
//
// Design.  One block of 256 threads a (row, chunk); the chunk-start counts
// clo [B, nchunk, G] give every group's members before the chunk, so the
// blocks are independent.  The block walks its chunk in tiles of 256
// elements, a thread an element:
//   1. membership: for every group, each warp's 32 tests become one
//      __ballot_sync mask (lane j of the warp keeps the mask of group
//      g0 + j, and stores 32 groups' masks in one coalesced store), so the
//      tile's members of g are 8 words in shared memory;
//   2. emission: a thread a group adds up the 8 masks' popcounts, and every
//      needed rank that falls between the group's count before the tile and
//      after it is the m-th member of the tile: the warp is found by the
//      popcounts, the lane by clearing m - 1 low set bits.  Each needed rank
//      is hit by exactly one element of the row, so that element's value is
//      stored at out[b, g, k] for every k of that rank (no accumulators, no
//      slot limit: `slots` is the twin's alone).  A per-group pointer into
//      each rank list (the first rank past the group's count) makes the
//      search a walk, a rank a time.
// A stored value is v + 0: the JAX form sums where(hit, v, 0), so a
// selected -0.0 comes back +0.0, and so it does here.  Ranks never hit
// (groups with no valid value) leave the output as the caller made it: the
// wrapper allocates zeros, the twin's value for them.
//
// Layout: svals [B, Tp] (float or double), slab [B, Tp] int32, clo
// [B, nchunk, G] int32, rl / rr [B, G, nq] int32, n [B, G] int32, left /
// right [B, G, nq] and maxv [B, G] in the values' type, all row-major and
// contiguous; Tp = nchunk * chunk.  Shared memory: the tile's values, the
// masks [8][G] and three [G] int arrays, 2 KB + 44 G bytes (under 48 KB for
// every G below the label packing's 1024).

#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPack = 1024;  // labels are start * kPack + length (ops/selquant.py:_PACK)

// first k in [0, nq) with r[k] > c (r non-decreasing), nq if none
__device__ __forceinline__ int first_above(const int* __restrict__ r, int nq, int c) {
  int lo = 0, hi = nq;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (r[mid] <= c) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// the value of the m-th (1-based) member of group g in the tile
template <typename T>
__device__ __forceinline__ T pick(const unsigned* masks, int G, int g, int m, const T* vals) {
  int w = 0;
  unsigned mask = masks[g];
  for (int p = __popc(mask); m > p; p = __popc(mask)) {
    m -= p;
    ++w;
    mask = masks[w * G + g];
  }
  for (int i = 1; i < m; ++i) mask &= mask - 1;
  return vals[w * 32 + __ffs(mask) - 1];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
emit_kernel(const T* __restrict__ svals, const int* __restrict__ slab, const int* __restrict__ clo,
            const int* __restrict__ rl, const int* __restrict__ rr, const int* __restrict__ n,
            T* __restrict__ left, T* __restrict__ right, T* __restrict__ maxv,
            int Tp, int chunk, int nchunk, int G, int nq) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* vals = reinterpret_cast<T*>(smem);
  unsigned* masks = reinterpret_cast<unsigned*>(smem + kThreads * sizeof(T));
  int* cnt = reinterpret_cast<int*>(masks + kWarps * G);
  int* kl = cnt + G;
  int* kr = kl + G;

  const long long b = blockIdx.x / nchunk;
  const int c = blockIdx.x % nchunk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* row_v = svals + b * Tp;
  const int* row_l = slab + b * Tp;
  const long long bg = b * G;

  // every group's members before the chunk, and the first rank past them
  for (int g = tid; g < G; g += kThreads) {
    const int c0 = clo[(b * nchunk + c) * G + g];
    cnt[g] = c0;
    kl[g] = first_above(rl + (bg + g) * nq, nq, c0);
    kr[g] = first_above(rr + (bg + g) * nq, nq, c0);
  }

  const int end = (c + 1) * chunk;
  for (int base = c * chunk; base < end; base += kThreads) {
    const int i = base + tid;
    T v = T(0);
    int a = 0, len = 0;
    if (i < end) {
      v = row_v[i];
      const int lab = row_l[i];
      a = lab / kPack;
      len = (v != v) ? 0 : lab % kPack;  // NaN: a member of no group
    }
    vals[tid] = v;
    // 1. membership masks: lane j keeps group g0 + j's
    for (int g0 = 0; g0 < G; g0 += 32) {
      const int span = min(32, G - g0);
      unsigned mine = 0;
      for (int j = 0; j < span; ++j) {
        int d = g0 + j - a;
        d += (d < 0) ? G : 0;
        const unsigned m = __ballot_sync(0xffffffffu, d < len);
        if (lane == j) mine = m;
      }
      if (lane < span) masks[warp * G + g0 + lane] = mine;
    }
    __syncthreads();
    // 2. emission: the needed ranks inside the tile, a thread a group
    for (int g = tid; g < G; g += kThreads) {
      int tot = 0;
      for (int w = 0; w < kWarps; ++w) tot += __popc(masks[w * G + g]);
      if (tot == 0) continue;
      const int before = cnt[g], after = before + tot;
      const long long at = (bg + g) * nq;
      int k = kl[g];
      for (; k < nq && rl[at + k] <= after; ++k) left[at + k] = pick(masks, G, g, rl[at + k] - before, vals) + T(0);
      kl[g] = k;
      k = kr[g];
      for (; k < nq && rr[at + k] <= after; ++k) right[at + k] = pick(masks, G, g, rr[at + k] - before, vals) + T(0);
      kr[g] = k;
      const int top = n[bg + g];
      if (top > before && top <= after) maxv[bg + g] = pick(masks, G, g, top - before, vals) + T(0);
      cnt[g] = after;
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* svals, const void* slab, const void* clo, const void* rl, const void* rr, const void* n,
           void* left, void* right, void* maxv, int B, int Tp, int chunk, int G, int nq, cudaStream_t stream) {
  const int nchunk = Tp / chunk;
  const long long blocks = static_cast<long long>(B) * nchunk;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = kThreads * sizeof(T) + static_cast<size_t>(kWarps + 3) * G * sizeof(int);
  emit_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(svals), static_cast<const int*>(slab), static_cast<const int*>(clo),
      static_cast<const int*>(rl), static_cast<const int*>(rr), static_cast<const int*>(n),
      static_cast<T*>(left), static_cast<T*>(right), static_cast<T*>(maxv), Tp, chunk, nchunk, G, nq);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Stages 2b and 3 of the emit mode on B rows of Tp sorted values (module
// comment): writes left / right [B, G, nq] and maxv [B, G], which the
// caller zeroes first.  `chunk` divides Tp; 1 <= G < 1024; `is_double`
// picks float64 values over float32.  Launches on `stream` of CUDA device
// `device` (leaving the calling thread's current device as it found it)
// and returns cudaGetLastError() (0 on success).
extern "C" int xsdba_emit(const void* svals, const void* slab, const void* clo, const void* rl, const void* rr,
                          const void* n, void* left, void* right, void* maxv, int B, int Tp, int chunk, int G,
                          int nq, int is_double, int device, void* stream) {
  if (B < 0 || Tp < 0 || chunk < 1 || Tp % chunk != 0 || G < 1 || G >= kPack || nq < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || Tp == 0) return 0;
  const xsdba::DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return static_cast<int>(guard.status());
  const auto s = static_cast<cudaStream_t>(stream);
  return is_double ? launch<double>(svals, slab, clo, rl, rr, n, left, right, maxv, B, Tp, chunk, G, nq, s)
                   : launch<float>(svals, slab, clo, rl, rr, n, left, right, maxv, B, Tp, chunk, G, nq, s);
}

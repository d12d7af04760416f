// Key-payload row sort, stage 1 of the counting-selection windowed quantile:
// each row of key [B, T] (float, NaN-free) sorted ascending into [B, Tp],
// an int payload following the same permutation, the row padded past T with
// (+inf, 0).  Tp is a power-of-two multiple of 128 (the caller's rule).
//
// Replaces xsdba_tpu/ops/pallas/sort_kernel.py:sort_rows_with_payload (K7:
// _phase1 / _level through _pallas_stage, one Pallas call per cascade
// level).  Its plain twin is
// xsdba_tpu_torch/ops/sort.py:sort_rows_with_payload_reference (a stable
// torch.sort of the keys and a gather of the payload).
//
// Bound.  The floor is bytes: each pair is read once and written once (8 + 8
// bytes; about 196 MB read and 235 MB written at the selection path's
// [448, 54750] -> [448, 65536], 0.129 ms at 3.35 TB/s).  A row does not fit
// in a block's shared memory (65,536 pairs are 512 KB against 227 KB), so
// the sort has two phases, each built to keep the bytes, and not block-wide
// synchronisations or dependent searches, the limit:
//   1. radix_tile_sort_kernel: one block of 1024 threads per tile of kTile
//      = 16384 pairs (128 KB of dynamic shared memory, 160 KB in all) sorts
//      it by an LSD radix sort of the key's order-preserving uint32 image
//      (sign bit flipped for non-negatives, all bits for negatives; +inf
//      pads stay last), 8-bit digits, 4 passes.  Each thread holds 16 pairs
//      in registers; a pass is a per-warp digit histogram (shared-memory
//      atomics), one block-wide exclusive scan of the 256 x 32 counts
//      (digit-major, so a digit's warps follow each other), and a stable
//      scatter of the pairs into shared memory at their ranks (the lanes
//      sharing a digit found by 8 ballots, one leader advancing the warp's
//      count).  The counts sit one pad word apart a digit, so a warp's lanes
//      hit distinct banks.  4 passes of 6 block-wide synchronisations take
//      the place of the 78 synchronised stages of a bitonic network.  What
//      is left is the passes' latency at one block an SM, and the atomics
//      of a high digit that a warp's keys share.
//   2. merge_pass_kernel, log2(Tp / kTile) launches (2 at Tp = 65536):
//      every aligned pair of sorted runs of r pairs merges into one run of
//      2r, ping-ponging between two buffers.  It is a merge path: each
//      block takes kMergeOut consecutive outputs of one merged run, finds
//      where they start and end in the two runs by two co-rank searches
//      (one thread each), loads both input windows into shared memory with
//      coalesced loads, and each thread merges its 16 outputs sequentially
//      after one co-rank search in shared memory (ties: left run first),
//      then the block stores its outputs coalesced, 16 bytes a thread.
// Ties and -0.0 against +0.0 may end in any order: the caller reads only the
// (key, payload) multiset.
//
// Layout: key/lab [B, T] row-major (contiguous), out_key/out_lab and
// tmp_key/tmp_lab [B, Tp] row-major.

#include <cuda_runtime.h>
#include <math.h>

#include "device_guard.cuh"

namespace {

constexpr int kTile = 16384;                          // pairs a block sorts in shared memory
constexpr int kTileThreads = 1024;
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kItems = kTile / kTileThreads;          // pairs a thread holds
constexpr int kDigits = 256;
constexpr int kCounts = kDigits * kTileWarps;         // histogram, digit-major
constexpr int kCountsPerThread = kCounts / kTileThreads;
constexpr int kDigitStride = kTileWarps + 1;          // a pad word per digit: a warp's lanes spread over the banks
static_assert(kTileWarps % kCountsPerThread == 0, "a thread's counts must share one digit");
constexpr unsigned kSentinel = 0xffffffffu;           // above every key's image (no NaN)
constexpr size_t kTileSmem = static_cast<size_t>(kTile) * 8 + (kDigits * kDigitStride + kTileWarps) * sizeof(int);

constexpr int kMergeThreads = 256;
constexpr int kMergeItems = 16;                       // outputs a thread merges
constexpr int kMergeOut = kMergeThreads * kMergeItems;  // outputs a block merges

// Order-preserving map of a float to uint32 and back.
__device__ __forceinline__ unsigned key_bits(float x) {
  const unsigned u = __float_as_uint(x);
  return u ^ ((u >> 31) ? 0xffffffffu : 0x80000000u);
}

__device__ __forceinline__ float bits_key(unsigned u) {
  return __uint_as_float(u ^ ((u >> 31) ? 0x80000000u : 0xffffffffu));
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

// Where the count of (digit d, warp w) lives.
__device__ __forceinline__ int count_at(unsigned d, int w) { return static_cast<int>(d) * kDigitStride + w; }

// Exclusive scan in place of the kCounts counts in digit-major order, by
// all kTileThreads threads (thread i scans counts kCountsPerThread·i on).
__device__ void block_exclusive_scan(int* counts, int* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int f0 = threadIdx.x * kCountsPerThread;  // a thread's counts share one digit
  int* mine = counts + count_at(f0 / kTileWarps, f0 % kTileWarps);
  int local[kCountsPerThread];
  int sum = 0;
#pragma unroll
  for (int c = 0; c < kCountsPerThread; ++c) {
    local[c] = mine[c];
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
    int w = lane < kTileWarps ? warp_sums[lane] : 0;
    const int total = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += v;
    }
    if (lane < kTileWarps) warp_sums[lane] = w - total;  // exclusive
  }
  __syncthreads();
  int run = warp_sums[warp] + incl - sum;
#pragma unroll
  for (int c = 0; c < kCountsPerThread; ++c) {
    mine[c] = run;
    run += local[c];
  }
}

// One block per tile of a row: the row's pairs [base, base + tile) (pads
// (+inf, 0) past t) sorted into out.  A tile shorter than kTile (tp <
// kTile) is filled up with sentinels that sort last and are not written.
__global__ void __launch_bounds__(kTileThreads, 1)
radix_tile_sort_kernel(const float* __restrict__ key, const int* __restrict__ lab, float* __restrict__ out_key,
                       int* __restrict__ out_lab, int t, int tp, int tile) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned* sk = reinterpret_cast<unsigned*>(smem_raw);
  int* sl = reinterpret_cast<int*>(sk + kTile);
  int* counts = sl + kTile;
  int* warp_sums = counts + kDigits * kDigitStride;

  const int tiles = tp / tile;
  const long long row = blockIdx.x / tiles;
  const int base = (blockIdx.x - static_cast<int>(row) * tiles) * tile;
  const float* krow = key + row * t;
  const int* lrow = lab + row * t;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  // pair (warp, it, lane) is tile position warp * (kItems * 32) + it * 32 + lane
  const int first = warp * (kItems * 32) + lane;

  unsigned k[kItems];
  int v[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int p = first + it * 32;
    const int col = base + p;
    if (p >= tile) {
      k[it] = kSentinel;
      v[it] = 0;
    } else if (col < t) {
      k[it] = key_bits(krow[col]);
      v[it] = lrow[col];
    } else {
      k[it] = key_bits(INFINITY);
      v[it] = 0;
    }
  }

  for (int shift = 0; shift < 32; shift += 8) {
#pragma unroll
    for (int c = threadIdx.x; c < kDigits * kDigitStride; c += kTileThreads) counts[c] = 0;
    __syncthreads();
    // per-warp histogram
#pragma unroll
    for (int it = 0; it < kItems; ++it) atomicAdd(counts + count_at((k[it] >> shift) & 0xffu, warp), 1);
    __syncthreads();
    block_exclusive_scan(counts, warp_sums);
    __syncthreads();
    // stable scatter: a pair's rank is its digit's and warp's offset, plus
    // the pairs of its warp with its digit in earlier items or lanes
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const unsigned d = (k[it] >> shift) & 0xffu;
      const unsigned peers = same_digit_lanes(d);
      int* slot = counts + count_at(d, warp);
      const int at = *slot;
      __syncwarp();
      const int rank = at + __popc(peers & lower);
      sk[rank] = k[it];
      sl[rank] = v[it];
      if (lane == 31 - __clz(peers)) *slot = at + __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    if (shift < 24) {
#pragma unroll
      for (int it = 0; it < kItems; ++it) {
        k[it] = sk[first + it * 32];
        v[it] = sl[first + it * 32];
      }
      // the next pass writes counts and sk/sl only after a __syncthreads
    }
  }

  float* ok = out_key + row * tp + base;
  int* ol = out_lab + row * tp + base;
  // tile is a multiple of 128 and the row base of 16 bytes: 4 pairs a store
  for (int i = threadIdx.x * 4; i < tile; i += kTileThreads * 4) {
    const uint4 kk = *reinterpret_cast<const uint4*>(sk + i);
    *reinterpret_cast<float4*>(ok + i) = make_float4(bits_key(kk.x), bits_key(kk.y), bits_key(kk.z), bits_key(kk.w));
    *reinterpret_cast<int4*>(ol + i) = *reinterpret_cast<const int4*>(sl + i);
  }
}

// Co-rank: how many of the first k outputs of merge(a, b) (ties: a first)
// come from a.
__device__ __forceinline__ int co_rank_global(const float* __restrict__ a, int na, const float* __restrict__ b, int nb,
                                              int k) {
  int lo = k > nb ? k - nb : 0;
  int hi = k < na ? k : na;
  while (lo < hi) {
    const int i = (lo + hi) >> 1;
    if (__ldg(a + i) > __ldg(b + k - i - 1)) {
      hi = i;
    } else {
      lo = i + 1;
    }
  }
  return lo;
}

// Shared-memory index with one pad word every 32, so that threads merging
// 16 consecutive outputs each touch distinct banks.
__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

// One pass: every aligned pair of sorted r-pair runs of src becomes one
// sorted 2r-pair run of dst.  Block j merges outputs [j, j + 1) * kMergeOut
// of the whole [B, Tp] array; 2r >= 2 * kTile is a multiple of kMergeOut, so
// a block's outputs lie in one merged run.
__global__ void __launch_bounds__(kMergeThreads)
merge_pass_kernel(const float* __restrict__ src_key, const int* __restrict__ src_lab, float* __restrict__ dst_key,
                  int* __restrict__ dst_lab, int r) {
  constexpr int kPadded = kMergeOut + kMergeOut / 32;
  __shared__ __align__(16) float sk[kPadded];
  __shared__ __align__(16) int sl[kPadded];
  __shared__ int bounds[2];

  const long long o0 = static_cast<long long>(blockIdx.x) * kMergeOut;
  const long long width = 2LL * r;
  const long long start = o0 - o0 % width;
  const float* a = src_key + start;
  const float* b = a + r;
  const int k0 = static_cast<int>(o0 - start);
  if (threadIdx.x < 2) bounds[threadIdx.x] = co_rank_global(a, r, b, r, k0 + threadIdx.x * kMergeOut);
  __syncthreads();
  const int i0 = bounds[0];
  const int na = bounds[1] - i0;
  const int j0 = k0 - i0;
  const int* la = src_lab + start;
  for (int j = threadIdx.x; j < kMergeOut; j += kMergeThreads) {
    const bool from_a = j < na;
    const int src = from_a ? i0 + j : r + j0 + j - na;  // offset from the left run
    sk[padded(j)] = __ldg(a + src);
    sl[padded(j)] = __ldg(la + src);
  }
  __syncthreads();

  // this thread's outputs [k, k + kMergeItems) of the block's window
  const int nb = kMergeOut - na;
  const int k = threadIdx.x * kMergeItems;
  int lo = k > nb ? k - nb : 0;
  int hi = k < na ? k : na;
  while (lo < hi) {
    const int i = (lo + hi) >> 1;
    if (sk[padded(i)] > sk[padded(na + k - i - 1)]) {
      hi = i;
    } else {
      lo = i + 1;
    }
  }
  int ia = lo;
  int ib = k - lo;
  float x = ia < na ? sk[padded(ia)] : 0.f;
  float y = ib < nb ? sk[padded(na + ib)] : 0.f;
  float ok[kMergeItems];
  int ol[kMergeItems];
#pragma unroll
  for (int c = 0; c < kMergeItems; ++c) {
    const bool take_a = ib >= nb || (ia < na && x <= y);
    if (take_a) {
      ok[c] = x;
      ol[c] = sl[padded(ia)];
      ++ia;
      if (ia < na) x = sk[padded(ia)];
    } else {
      ok[c] = y;
      ol[c] = sl[padded(na + ib)];
      ++ib;
      if (ib < nb) y = sk[padded(na + ib)];
    }
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < kMergeItems; ++c) {
    sk[padded(k + c)] = ok[c];
    sl[padded(k + c)] = ol[c];
  }
  __syncthreads();
  float* dk = dst_key + o0;
  int* dl = dst_lab + o0;
  for (int i = threadIdx.x * 4; i < kMergeOut; i += kMergeThreads * 4) {
    const int p = padded(i);  // i .. i + 3 share one 32-word line: contiguous
    *reinterpret_cast<float4*>(dk + i) = make_float4(sk[p], sk[p + 1], sk[p + 2], sk[p + 3]);
    *reinterpret_cast<int4*>(dl + i) = make_int4(sl[p], sl[p + 1], sl[p + 2], sl[p + 3]);
  }
}

}  // namespace

// rows = B rows of t keys each, padded to tp (a power of two, at least 128
// and at most 2^22, not below t).  out_* and tmp_* are [B, tp] buffers; tmp
// may alias out when tp <= kTile (no merge pass).  Launches one tile sort and
// log2(tp / kTile) merge passes on `stream` of CUDA device `device` (leaving
// the calling thread's current device as it found it); the sorted rows end
// in out.  Returns cudaGetLastError() after each launch (0 on success).
extern "C" int xsdba_sort_rows_with_payload(const void* key, const void* lab, void* out_key, void* out_lab,
                                            void* tmp_key, void* tmp_lab, int rows, int t, int tp, int device,
                                            void* stream) {
  if (rows < 0 || t < 0 || tp < 128 || (tp & (tp - 1)) != 0 || tp > (1 << 22) || t > tp)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const xsdba::DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return static_cast<int>(guard.status());
  const auto s = static_cast<cudaStream_t>(stream);
  const int tile = tp < kTile ? tp : kTile;
  int passes = 0;
  for (int r = tile; r < tp; r <<= 1) ++passes;
  if (passes > 0 && (tmp_key == out_key || tmp_lab == out_lab)) return static_cast<int>(cudaErrorInvalidValue);
  // the tile sort writes where an even number of passes leaves the result in out
  float* bufk[2] = {static_cast<float*>(out_key), static_cast<float*>(tmp_key)};
  int* bufl[2] = {static_cast<int*>(out_lab), static_cast<int*>(tmp_lab)};
  int cur = passes & 1;
  const long long blocks = static_cast<long long>(rows) * (tp / tile);
  const long long total = static_cast<long long>(rows) * tp;
  if (blocks >= (1LL << 31) || total / kMergeOut >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(radix_tile_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kTileSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  radix_tile_sort_kernel<<<static_cast<unsigned>(blocks), kTileThreads, kTileSmem, s>>>(
      static_cast<const float*>(key), static_cast<const int*>(lab), bufk[cur], bufl[cur], t, tp, tile);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int r = tile; r < tp; r <<= 1) {
    merge_pass_kernel<<<static_cast<unsigned>(total / kMergeOut), kMergeThreads, 0, s>>>(
        bufk[cur], bufl[cur], bufk[cur ^ 1], bufl[cur ^ 1], r);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    cur ^= 1;
  }
  return 0;
}

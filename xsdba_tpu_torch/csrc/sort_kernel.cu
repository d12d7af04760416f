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
// [448, 54750] -> [448, 65536]).  A row does not fit in a block's shared
// memory (65,536 pairs are 512 KB against 227 KB), so the sort has two
// phases:
//   1. tile_sort_kernel: one block per tile of kTile pairs (32 KB) sorts it
//      in shared memory with a bitonic network (the TPU kernel's phase 1,
//      without its row-parity directions);
//   2. merge_pass_kernel, log2(Tp / kTile) launches: every aligned pair of
//      sorted runs of r pairs merges into one run of 2r, ping-ponging
//      between two buffers.  It is a rank merge, as in merge_kernel.cu's
//      build_level_kernel, carrying the payload: a left element lands at
//      its index plus the count of right keys below it, a right element at
//      its index plus the count of left keys at or below it, so the slots
//      form a permutation for any ties (and -0.0 against +0.0).
// Each merge pass reads and writes every pair once and does one binary
// search (log2 r dependent loads, mostly from L2) per pair: the passes,
// not the bytes, bound it.
//
// Layout: key/lab [B, T] row-major (contiguous), out_key/out_lab and
// tmp_key/tmp_lab [B, Tp] row-major.

#include <cuda_runtime.h>
#include <math.h>

#include "device_guard.cuh"

namespace {

constexpr int kTile = 4096;  // pairs a block sorts in shared memory
constexpr int kTileThreads = 512;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kTileThreads)
tile_sort_kernel(const float* __restrict__ key, const int* __restrict__ lab, float* __restrict__ out_key,
                 int* __restrict__ out_lab, int t, int tp, int tile) {
  __shared__ float sk[kTile];
  __shared__ int sl[kTile];
  const int tiles = tp / tile;
  const long long row = blockIdx.x / tiles;
  const int base = (blockIdx.x - static_cast<int>(row) * tiles) * tile;
  const float* krow = key + row * t;
  const int* lrow = lab + row * t;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const int col = base + i;
    sk[i] = col < t ? krow[col] : INFINITY;
    sl[i] = col < t ? lrow[col] : 0;
  }
  __syncthreads();
  const int pairs = tile >> 1;
  for (int k = 2; k <= tile; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
        const int lo = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const int hi = lo + j;
        const bool up = (lo & k) == 0;
        const float a = sk[lo];
        const float b = sk[hi];
        if (up ? (a > b) : (a < b)) {
          sk[lo] = b;
          sk[hi] = a;
          const int la = sl[lo];
          sl[lo] = sl[hi];
          sl[hi] = la;
        }
      }
      __syncthreads();
    }
  }
  float* ok = out_key + row * tp + base;
  int* ol = out_lab + row * tp + base;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    ok[i] = sk[i];
    ol[i] = sl[i];
  }
}

// Number of keys of the ascending run below x (at most x when inclusive).
__device__ __forceinline__ int rank_in(const float* run, int n, float x, bool inclusive) {
  int lo = 0;
  int hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const float v = run[mid];
    if (inclusive ? (v <= x) : (v < x)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// One pass: every aligned pair of sorted r-pair runs of src becomes one
// sorted 2r-pair run of dst.  One thread per pair.
__global__ void merge_pass_kernel(const float* __restrict__ src_key, const int* __restrict__ src_lab,
                                  float* __restrict__ dst_key, int* __restrict__ dst_lab, int r,
                                  long long total) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long width = 2LL * r;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; e < total; e += stride) {
    const long long start = e - e % width;  // rows are a multiple of 2r long
    const int pos = static_cast<int>(e - start);
    const float* left = src_key + start;
    const float* right = left + r;
    const float x = src_key[e];
    const int slot = pos < r ? pos + rank_in(right, r, x, false) : pos - r + rank_in(left, r, x, true);
    dst_key[start + slot] = x;
    dst_lab[start + slot] = src_lab[e];
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
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = tile / 2 < kTileThreads ? tile / 2 : kTileThreads;
  tile_sort_kernel<<<static_cast<unsigned>(blocks), threads, 0, s>>>(
      static_cast<const float*>(key), static_cast<const int*>(lab), bufk[cur], bufl[cur], t, tp, tile);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(rows) * tp;
  const long long grid = (total + kThreads - 1) / kThreads < (1LL << 30) ? (total + kThreads - 1) / kThreads : (1LL << 30);
  for (int r = tile; r < tp; r <<= 1) {
    merge_pass_kernel<<<static_cast<unsigned>(grid), kThreads, 0, s>>>(bufk[cur], bufl[cur], bufk[cur ^ 1],
                                                                      bufl[cur ^ 1], r, total);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    cur ^= 1;
  }
  return 0;
}

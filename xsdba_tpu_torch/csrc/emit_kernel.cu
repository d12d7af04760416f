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
// Bound: bytes, about 0.10 GB at the path's site chunk of 123 rows (each
// value, label, count and rank read once, the picks written: 0.031 ms at
// 3.35 TB/s).  The function needs one operation a (member, group) pair,
// since an element of label (a, len) is in its len groups alone: at most
// B * T * 31, 2.1e8 there, 0.003 ms at 67 T/s.
//
// Design.  One block of kThreads a (row, chunk); the chunk-start counts
// clo [B, nchunk, G] give every group's members before the chunk, so the
// blocks are independent.  The block walks its chunk in tiles of kTile
// values and keeps the tile's membership as bit masks in shared memory, a
// row of kWords words a group (bit j of word w: the tile's value 32 w + j),
// built in the difference form, so that a value costs two bits, not len:
//   1. toggles: each value flips its bit in group a's row and in group
//      (a + len)'s (shared atomicXor; none where the interval ends at
//      G - 1), and an interval that wraps past G - 1 (or holds every group)
//      sets its bit in seed[w] instead; a warp's 32 values are one word, so
//      seed[w] is one __ballot_sync.  The tile's values go to shared memory,
//      and the next tile's labels and values are loaded meanwhile;
//   2. membership, the prefix XOR of the toggles along the groups: a thread
//      a (word, segment of the groups) XORs its segment's toggles, then,
//      seeded with seed[w] and the segments before its own, walks its
//      segment again storing each group's running XOR;
//   3. emission, in rounds: (a) a thread a group counts its row (storing the
//      eight 16-byte columns' prefix popcounts), loads the next kWindow
//      ranks of each list and lists those at or below its count, with the
//      max's rank, into a shared list (a warp's slots by one atomicAdd and a
//      shuffle scan); (b) a thread a listed rank finds its column from the
//      prefix counts, its word and then the m-th set bit (five popcount
//      halvings), and stores that value at out[b, g, k].  A group with more
//      ranks in the tile, or that found the list full, lists the rest in
//      another round.  Then the counts move on and the rows are zeroed.
// A thread a rank in 3(b), not a thread a group walking its row, keeps the
// warps converged: the ranks a tile holds fall in other words of other
// groups, and a warp that followed 32 groups would run every group's hits
// one after another.  The rows are 16-byte columns swizzled by the group's
// low three bits (at_word), so that stage 3's 16-byte loads of eight
// consecutive groups fall in distinct banks while stage 2's word-wise walks
// stay conflict-free.  No hit tensor, no accumulators, no slot limit
// (`slots` is the twin's alone).
// A stored value is v + 0: the JAX form sums where(hit, v, 0), so a
// selected -0.0 comes back +0.0, and so it does here.  Ranks never hit
// (groups with no valid value) leave the output as the caller made it: the
// wrapper allocates zeros, the twin's value for them.
//
// Layout: svals [B, Tp] (float or double), slab [B, Tp] int32, clo
// [B, nchunk, G] int32, rl / rr [B, G, nq] int32, n [B, G] int32, left /
// right [B, G, nq] and maxv [B, G] in the values' type, all row-major and
// contiguous; Tp = nchunk * chunk.  Shared memory (shared_bytes): the rows
// [G][kWords], their prefix counts [G], the tile's values, the segments'
// XORs, the seeds, four [G] int arrays and the list, 72,880 bytes at 365
// groups of float32 and 182,256 at 1023 of float64, so the launch raises
// the block's limit above the default 48 KB (cudaFuncSetAttribute).

#include <climits>

#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWords = 32;                      // a tile's words a group: tiles of kTile values
constexpr int kTile = 32 * kWords;
constexpr int kSegments = kThreads / kWords;    // stage 2's segments of the groups
constexpr int kPer = kTile / kThreads;          // stage 1's values a thread
constexpr int kList = 1024;                     // hits a round of stage 3
constexpr int kWindow = 4;                      // ranks of each list a thread holds in registers
constexpr int kPack = 1024;  // labels are start * kPack + length (ops/selquant.py:_PACK)
constexpr size_t kMaxShared = 232448;  // the most dynamic shared memory a block can have on sm_90

size_t shared_bytes(int G, size_t value_bytes) {
  return (static_cast<size_t>(G) * (kWords + 4 + 4) + kSegments * kWords + kWords + 2 * kList + 4) *
             sizeof(unsigned) + kTile * value_bytes;
}

// where word w of group g's row lies: its 16-byte column swizzled by g's low
// three bits, so that eight consecutive groups' 16-byte loads of one column
// fall in distinct banks
__device__ __forceinline__ int at_word(int g, int w) {
  return g * kWords + (((w >> 2) ^ (g & 7)) << 2) + (w & 3);
}

// the first k in [0, nq) with r1[k] > c, and with r2[k] > c (each list
// non-decreasing; nq if none): two binary searches, their loads issued together
__device__ __forceinline__ void first_above2(const int* __restrict__ r1, const int* __restrict__ r2, int nq, int c,
                                             int& k1, int& k2) {
  int lo1 = 0, hi1 = nq, lo2 = 0, hi2 = nq;
  while (lo1 < hi1 || lo2 < hi2) {
    const int m1 = (lo1 + hi1) >> 1, m2 = (lo2 + hi2) >> 1;
    const int v1 = lo1 < hi1 ? r1[m1] : 0;
    const int v2 = lo2 < hi2 ? r2[m2] : 0;
    if (lo1 < hi1) {
      if (v1 <= c) lo1 = m1 + 1; else hi1 = m1;
    }
    if (lo2 < hi2) {
      if (v2 <= c) lo2 = m2 + 1; else hi2 = m2;
    }
  }
  k1 = lo1;
  k2 = lo2;
}

// position of the k-th (1-based) set bit of m, k <= popc(m)
__device__ __forceinline__ int nth_set_bit(unsigned m, int k) {
  int pos = 0;
#pragma unroll
  for (int half = 16; half > 0; half >>= 1) {
    const unsigned low = m & ((1u << half) - 1u);
    const int c = __popc(low);
    if (k > c) {
      k -= c;
      m >>= half;
      pos += half;
    } else {
      m = low;
    }
  }
  return pos;
}

__device__ __forceinline__ int popc4(const uint4 q) { return __popc(q.x) + __popc(q.y) + __popc(q.z) + __popc(q.w); }

// one rank list of one group: the next kWindow ranks from k (INT_MAX past
// the list), loaded together, and how many fall at or below `after`
struct Window {
  int r[kWindow];
  int hits = 0;
  // the ranks from `src`, the list at k
  __device__ __forceinline__ void load(const int* __restrict__ src, int k, int nq, int after) {
#pragma unroll
    for (int i = 0; i < kWindow; ++i) r[i] = k + i < nq ? src[i] : INT_MAX;
#pragma unroll
    for (int i = 0; i < kWindow; ++i) hits += r[i] <= after;
  }
  // lists the hits as (g | kind << 10 | (rank - before) << 12, k)
  __device__ __forceinline__ void put(int* e0, int* e1, int slot, int g, int kind, int k, int before) const {
#pragma unroll
    for (int i = 0; i < kWindow; ++i) {
      if (i < hits) {
        e0[slot + i] = g | kind << 10 | (r[i] - before) << 12;
        e1[slot + i] = k + i;
      }
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
emit_kernel(const T* __restrict__ svals, const int* __restrict__ slab, const int* __restrict__ clo,
            const int* __restrict__ rl, const int* __restrict__ rr, const int* __restrict__ n,
            T* __restrict__ left, T* __restrict__ right, T* __restrict__ maxv,
            int Tp, int chunk, int nchunk, int G, int nq) {
  extern __shared__ __align__(16) unsigned smem[];
  unsigned* D = smem;                                       // [G][kWords], swizzled (at_word)
  uint4* P = reinterpret_cast<uint4*>(D + G * kWords);      // [G] each row's 8 prefix popcounts (16 bits each)
  T* vals = reinterpret_cast<T*>(P + G);                    // [kTile], the tile's values
  unsigned* X = reinterpret_cast<unsigned*>(vals + kTile);  // [kSegments][kWords]
  unsigned* seed = X + kSegments * kWords;                  // [kWords]
  int* cnt = reinterpret_cast<int*>(seed + kWords);         // [G] members before the tile
  int* kl = cnt + G;                                        // [G] next needed rank's index, left
  int* kr = kl + G;                                         // [G] the same, right
  int* top = kr + G;                                        // [G] the rank of the max, 0 once stored
  int* e0 = top + G;                                        // [kList] a round's hits
  int* e1 = e0 + kList;
  int* nlist = e1 + kList;                                  // [2] the rounds' hit counts

  const long long b = blockIdx.x / nchunk;
  const int c = blockIdx.x % nchunk;
  const int tid = threadIdx.x, lane = tid & 31;
  const T* row_v = svals + b * Tp;
  const int* row_l = slab + b * Tp;
  const long long bg = b * G;
  const int end = (c + 1) * chunk;

  // the first tile's labels and values, in flight during the set-up
  int lab[kPer];
  T val[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int i = c * chunk + tid + p * kThreads;
    lab[p] = i < end ? row_l[i] : 0;
    val[p] = i < end ? row_v[i] : T(0);
  }
  // every group's members before the chunk, and the first rank past them
  for (int g = tid; g < G; g += kThreads) {
    const int c0 = clo[(b * nchunk + c) * G + g];
    cnt[g] = c0;
    first_above2(rl + (bg + g) * nq, rr + (bg + g) * nq, nq, c0, kl[g], kr[g]);
    top[g] = n[bg + g];
  }
  for (int i = tid; i < G * kWords; i += kThreads) D[i] = 0u;

  // stage 2's thread: word w_s of segment s_s of the groups, a segment a
  // whole number of eight groups; off[u]: the word's place in group u's row
  // for u = 0..7 (the swizzle repeats every eight groups)
  const int w_s = tid % kWords, s_s = tid / kWords;
  const int seg = ((G + kSegments - 1) / kSegments + 7) & ~7;
  const int g_lo = min(G, s_s * seg), g_hi = min(G, g_lo + seg);
  int off[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) off[u] = at_word(u, w_s) - u * kWords;
  for (int base = c * chunk; base < end; base += kTile) {
    // 1. toggles, and the tile's values to shared memory
    __syncthreads();
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int li = tid + p * kThreads;
      const int a = lab[p] / kPack;
      const int len = (base + li >= end || val[p] != val[p]) ? 0 : min(lab[p] % kPack, G);  // NaN: no group
      vals[li] = val[p];
      const bool wraps = len > 0 && (len == G || a + len > G);
      if (len > 0 && len < G) {
        const unsigned bit = 1u << lane;
        atomicXor(D + at_word(a, li >> 5), bit);
        const int e = wraps ? a + len - G : a + len;
        if (e < G) atomicXor(D + at_word(e, li >> 5), bit);
      }
      const unsigned s = __ballot_sync(0xffffffffu, wraps);
      if (lane == 0) seed[li >> 5] = s;
    }
    // the next tile's labels and values, in flight during stages 2 and 3
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int i = base + kTile + tid + p * kThreads;
      if (i < end) {
        lab[p] = row_l[i];
        val[p] = row_v[i];
      }
    }
    if (tid == 0) nlist[0] = 0;
    __syncthreads();
    // 2. membership: the prefix XOR of the toggles along the groups
    {
      unsigned x = 0;
      for (int g8 = g_lo; g8 < g_hi; g8 += 8) {
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          if (g8 + u < g_hi) x ^= D[(g8 + u) * kWords + off[u]];
        }
      }
      X[s_s * kWords + w_s] = x;
    }
    __syncthreads();
    {
      unsigned m = seed[w_s];
      for (int s = 0; s < s_s; ++s) m ^= X[s * kWords + w_s];
      for (int g8 = g_lo; g8 < g_hi; g8 += 8) {
        unsigned t[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) t[u] = g8 + u < g_hi ? D[(g8 + u) * kWords + off[u]] : 0u;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          m ^= t[u];
          if (g8 + u < g_hi) D[(g8 + u) * kWords + off[u]] = m;
        }
      }
    }
    // 3. emission in rounds: (a) a thread a group lists the needed ranks
    // that fall in the tile, up to kWindow of each list; (b) a thread a
    // listed rank finds its element (the m-th set bit of its group's row)
    // and stores its value; a group with more ranks, or that found the list
    // full, lists them in the next round
    for (int round = 0;; ++round) {
      __syncthreads();
      int* count = nlist + (round & 1);
      if (tid == 0) nlist[(round + 1) & 1] = 0;
      bool more = false;
      for (int g0 = 0; g0 < G; g0 += kThreads) {  // every lane runs the warp's scan
        const int g = g0 + tid;
        int before = 0, after = 0, tp = 0, k1 = 0, k2 = 0, h = 0;
        long long at = 0;
        Window L, R;
        if (g < G) {
          const uint4* row = reinterpret_cast<const uint4*>(D + g * kWords);
          int tot = 0;
          unsigned pre[4];
#pragma unroll
          for (int w4 = 0; w4 < kWords / 4; ++w4) {
            tot += popc4(row[w4 ^ (g & 7)]);
            if (w4 & 1) {
              pre[w4 >> 1] |= static_cast<unsigned>(tot) << 16;
            } else {
              pre[w4 >> 1] = tot;
            }
          }
          P[g] = make_uint4(pre[0], pre[1], pre[2], pre[3]);
          before = cnt[g];
          after = before + tot;
          tp = top[g];
          at = (bg + g) * nq;
          k1 = kl[g];
          k2 = kr[g];
          L.load(rl + at + k1, k1, nq, after);
          R.load(rr + at + k2, k2, nq, after);
          if (!(tp > before && tp <= after)) tp = 0;
          h = L.hits + R.hits + (tp > 0);
        }
        // the warp's slots: one atomicAdd a warp, its lanes' offsets by a scan
        int incl = h;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, incl, d);
          if (lane >= d) incl += y;
        }
        int base = 0;
        if (lane == 31 && incl > 0) base = atomicAdd(count, incl);
        const int slot = __shfl_sync(0xffffffffu, base, 31) + incl - h;
        if (h == 0) continue;
        if (slot + h > kList) {  // the list is full: this group waits for the next round
          more = true;
          for (int i = slot; i < min(slot + h, kList); ++i) e0[i] = -1;
          continue;
        }
        L.put(e0, e1, slot, g, 0, k1, before);
        R.put(e0, e1, slot + L.hits, g, 1, k2, before);
        if (tp > 0) {
          e0[slot + h - 1] = g | 2 << 10 | (tp - before) << 12;
          top[g] = 0;
        }
        kl[g] = k1 + L.hits;
        kr[g] = k2 + R.hits;
        more |= L.hits == kWindow || R.hits == kWindow;
      }
      __syncthreads();
      const int listed = min(*count, kList);
      for (int i = tid; i < listed; i += kThreads) {
        const int e = e0[i];
        if (e < 0) continue;
        const int g = e & 1023, kind = (e >> 10) & 3;
        int m = e >> 12;
        // the 16-byte column holding the m-th member: the prefix counts below m
        const uint4 pp = P[g];
        const unsigned pre[8] = {pp.x & 0xffffu, pp.x >> 16, pp.y & 0xffffu, pp.y >> 16,
                                 pp.z & 0xffffu, pp.z >> 16, pp.w & 0xffffu, pp.w >> 16};
        int w4 = 0, below = 0;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (static_cast<int>(pre[i]) < m) {
            w4 = i + 1;
            below = pre[i];
          }
        }
        m -= below;
        const uint4 q = reinterpret_cast<const uint4*>(D + g * kWords)[w4 ^ (g & 7)];
        unsigned word = q.x;
        int j = 0;
        if (m > __popc(q.x)) {
          m -= __popc(q.x);
          word = q.y;
          j = 1;
          if (m > __popc(q.y)) {
            m -= __popc(q.y);
            word = q.z;
            j = 2;
            if (m > __popc(q.z)) {
              m -= __popc(q.z);
              word = q.w;
              j = 3;
            }
          }
        }
        const T v = vals[(4 * w4 + j) * 32 + nth_set_bit(word, m)] + T(0);
        if (kind == 2) {
          maxv[bg + g] = v;
        } else {
          (kind == 0 ? left : right)[(bg + g) * nq + e1[i]] = v;
        }
      }
      if (!__syncthreads_or(more)) break;
    }
    // the members so far, and the rows zeroed for the next tile
    for (int g = tid; g < G; g += kThreads) cnt[g] += P[g].w >> 16;
    for (int i = tid; i < G * kWords / 4; i += kThreads) reinterpret_cast<uint4*>(D)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
}

template <typename T>
int launch(const void* svals, const void* slab, const void* clo, const void* rl, const void* rr, const void* n,
           void* left, void* right, void* maxv, int B, int Tp, int chunk, int G, int nq, cudaStream_t stream) {
  const int nchunk = Tp / chunk;
  const long long blocks = static_cast<long long>(B) * nchunk;
  const size_t smem = shared_bytes(G, sizeof(T));
  if (blocks > 0x7fffffffLL || smem > kMaxShared) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaFuncSetAttribute(emit_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
  if (set != cudaSuccess) return static_cast<int>(set);
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
// picks float64 values over float32.  Launches on `stream` of CUDA device `device` (leaving the
// calling thread's current device as it found it) and returns
// cudaGetLastError() (0 on success).
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

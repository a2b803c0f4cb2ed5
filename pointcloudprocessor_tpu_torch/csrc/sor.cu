// The K-nearest radius search of the SOR filter for Hopper (sm_90a): S1.
//
// Replaces an op that XLA emits on the TPU without a Pallas source:
//   S1 knn_select <- pointcloudprocessor_tpu/ops/knn.py:294-321
//                    (chunked_radius_neighbors over radius_neighbors,
//                    :230-291), as ops/sor.py:23-52 (sor_mask) calls it
//                    (K = sor_mean_k = 60, the query itself excluded,
//                    radius = cell = 0.25 m, B = 60) and as the VGD
//                    upsampler's nearest-source search does (K = 1).
// The hash grid itself (knn.build: a sort, a rank and a scatter into the
// (T, B) bucket table) and the schedule stay torch ops in the wrapper.
//
// In: buckets (T, B) int32 point indices (-1 empty) and counts (T,) int32
// (may exceed B), points (N, 3) f32, queries (M, 3) f32, and a schedule
// order (M,) int32, a permutation of the queries that groups equal cells.
// Out, in query order: idx (M, K) int32, dist (M, K) f32, ok (M, K) bool:
// the K smallest squared distances within the radius, nearest first, ties
// to the lower candidate position, as lax.top_k(-d2, K) orders them; -1 /
// +inf / false in the slots past the in-radius count.
//
// A block takes kChunk queries of the schedule and, for each distinct cell
// among them, stages the cell's 27-bucket window once in shared memory
// (cell_window.cuh); its warps then take the cell's queries, one at a time:
//   - a candidate e of the window is in when d2 = (dx*dx + dy*dy) + dz*dz,
//     each step rounded, is <= r^2 and finite, and its point is not the
//     query itself where the caller excludes it (the index is read only
//     where d2 is 0). Its key (bits of d2) << 32 | e orders the candidates
//     as the plain version's (M, 27 * B) row does: the window lists them in
//     that row's order;
//   - with K <= kSortMax, a warp's next query of the cell guesses a bound,
//     1.5 times the last one's K-th d2 (all of r^2 after one with fewer
//     than K in): one pass keeps the keys under it; when at least K (or,
//     under r^2, all) and at most kBufCap fall under it, they hold the K
//     smallest, narrowed to K by a radix step and sorted by a bitonic
//     network. Else (and for a cell's first query):
//   - pass 1 counts the in-radius keys and builds a histogram of the top
//     kDigit bits of d2 below r^2's highest bit (256 bins of 16 bits, two
//     to a word);
//   - with more than K in, the K-th smallest key is narrowed digit by digit
//     (a radix select): the histogram names the bin that holds it; while
//     that bin holds more than kTieCap keys and d2 has bits left, one more
//     pass builds the next digit's histogram over the keys in that bin;
//   - a last pass keeps the keys below the bin and puts the bin's keys in a
//     tie buffer (or, once every bit of d2 is known, takes the first of them
//     in window order), whose smallest keys fill the K; a bitonic network
//     (or, past kSortMax, each key's rank) orders them;
//   - dist = sqrt(d2), correctly rounded.
// The guess only picks the path: every path keeps exactly the K smallest
// keys, so the results do not depend on the schedule.
//
// What bounds it on the H100 (chip_smoke.py's phase_sor counts it from the
// run's inputs). Unique bytes (each input read once: counts, the occupied
// slots, the points and queries, the schedule, the three outputs, 540 MB of
// them): ~577 MB for the 1M-point corner at K = 60, ~0.17 ms; the
// function's f32 operations (d2 and its test, ~10 a candidate slot) ~0.16
// ms at 67 TFLOP/s. The window replaces ~1,600 dependent random reads a
// query with one staging a cell a block; the passes then read 12 bytes a
// candidate from shared memory, and the instruction issue sets the pace.

#include <cuda_runtime.h>

#include <cstring>

#include "cell_window.cuh"

namespace {

using namespace cell_window;
using u64 = unsigned long long;

constexpr int kChunk = 128;      // queries a block
constexpr int kMaxWarps = 8;     // warps a block (fewer where K's buffers need the room)
constexpr int kMaxB = 128;       // bucket capacity the kernel takes
constexpr int kDigit = 8;        // bits of d2 a radix pass resolves
constexpr int kHistWords = (1 << kDigit) / 2;  // two 16-bit counts a word
constexpr int kTieCap = 64;      // keys of the K-th key's bin kept for ranking
constexpr int kBufCap = 128;     // keys under the guessed bound one pass keeps
constexpr int kSortMax = 64;     // K up to which the kept keys are sorted by a network
constexpr float kGuess = 1.5f;   // the next query's bound: the K-th d2 times this
constexpr u64 kNoKey = ~0ull;

// Per warp, in dynamic shared memory: the histogram, the tie buffer and the
// kept keys (max(K, kBufCap)); then the block's window (27 * cap entries).
__host__ __device__ inline int key_slots(int k) { return k > kBufCap ? k : kBufCap; }
__host__ __device__ inline long long warp_bytes(int k) {
  return kHistWords * 4LL + kTieCap * 8LL + 8LL * key_slots(k);
}

// Zeroes the warp's histogram.
__device__ __forceinline__ void clear_hist(unsigned* hist, int lane) {
  static_assert(kHistWords == 128, "one uint4 a lane");
  reinterpret_cast<uint4*>(hist)[lane] = make_uint4(0u, 0u, 0u, 0u);
  __syncwarp();
}

__device__ __forceinline__ void count_bin(unsigned* hist, unsigned bin) {
  atomicAdd(hist + (bin >> 1), 1u << ((bin & 1u) << 4));
}

__device__ __forceinline__ int warp_incl_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// The bin of the need-th smallest key (1-based) of the histogram: its index,
// the count of keys in lower bins and its own count (every lane gets them).
// Lane l holds bins 8 l .. 8 l + 7.
__device__ __forceinline__ void find_bin(const unsigned* hist, int need, int lane, int& bin,
                                         int& below, int& count) {
  const uint4 v = reinterpret_cast<const uint4*>(hist)[lane];
  const int sum = int((v.x & 0xffffu) + (v.x >> 16) + (v.y & 0xffffu) + (v.y >> 16) +
                      (v.z & 0xffffu) + (v.z >> 16) + (v.w & 0xffffu) + (v.w >> 16));
  const int incl = warp_incl_scan(sum, lane);
  const int owner = __ffs(__ballot_sync(kFull, incl >= need)) - 1;
  const int owner_below = __shfl_sync(kFull, incl - sum, owner);
  const int c =
      lane < 8 ? int((hist[4 * owner + (lane >> 1)] >> ((lane & 1) << 4)) & 0xffffu) : 0;
  const int incl2 = warp_incl_scan(c, lane);
  const int b = __ffs(__ballot_sync(kFull, lane < 8 && owner_below + incl2 >= need)) - 1;
  bin = 8 * owner + b;
  below = owner_below + __shfl_sync(kFull, incl2 - c, b);
  count = __shfl_sync(kFull, c, b);
}

// Sorts the warp's 32 R keys ascending, key lane + 32 r in v[r] (a bitonic
// network: exchanges within a lane's registers, or with lane ^ j).
template <int R>
__device__ __forceinline__ void warp_sort(u64 (&v)[R], int lane) {
#pragma unroll
  for (int k = 2; k <= 32 * R; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j >= 32) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r & (j >> 5)) continue;
          const int r2 = r | (j >> 5);
          const bool up = ((lane + 32 * r) & k) == 0;
          const u64 a = v[r], b = v[r2];
          v[r] = up ? min(a, b) : max(a, b);
          v[r2] = up ? max(a, b) : min(a, b);
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const u64 o = __shfl_xor_sync(kFull, v[r], j);
          const bool up = ((lane + 32 * r) & k) == 0;
          v[r] = (((lane & j) == 0) == up) ? min(v[r], o) : max(v[r], o);
        }
      }
    }
  }
}

// Keeps the k smallest of the warp's n distinct keys (k < n <= kBufCap) in
// keys[0 .. k), in any order: the first digit's histogram (bits lo1 up of
// d2) names the k-th key's bin; the keys below it are compacted in place and
// the bin's keys ranked in the tie buffer. A bin of more than kTieCap keys
// (or no digit to count) is sorted whole instead.
__device__ __forceinline__ void keep_smallest(u64* keys, u64* tie, unsigned* hist, int n, int k,
                                              int lo1, unsigned mask1, int width1, int lane) {
  const unsigned lt = (1u << lane) - 1u;
  int bin = 0, below = 0, count = n;
  if (width1 > 0) {
    clear_hist(hist, lane);
    for (int u = lane; u < n; u += 32) count_bin(hist, unsigned(keys[u] >> (32 + lo1)) & mask1);
    __syncwarp();
    find_bin(hist, k, lane, bin, below, count);
  }
  if (count > kTieCap) {
    u64 v[kBufCap / 32];
#pragma unroll
    for (int r = 0; r < kBufCap / 32; ++r) v[r] = lane + 32 * r < n ? keys[lane + 32 * r] : kNoKey;
    warp_sort(v, lane);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kBufCap / 32; ++r)
      if (lane + 32 * r < k) keys[lane + 32 * r] = v[r];
    __syncwarp();
    return;
  }
  const int need = k - below;
  int n_sel = 0, n_tie = 0;
  for (int base = 0; base < n; base += 32) {
    const int u = base + lane;
    const u64 key = u < n ? keys[u] : kNoKey;
    const unsigned digit = unsigned(key >> (32 + lo1)) & mask1;
    const bool in_bin = u < n && (width1 == 0 || digit == unsigned(bin));
    const bool sel = u < n && ((width1 > 0 && digit < unsigned(bin)) || (in_bin && need == count));
    const bool is_tie = in_bin && need < count;
    const unsigned sels = __ballot_sync(kFull, sel), ties = __ballot_sync(kFull, is_tie);
    __syncwarp();  // every read of this round before its writes
    if (sel) keys[n_sel + __popc(sels & lt)] = key;
    if (is_tie) tie[n_tie + __popc(ties & lt)] = key;
    n_sel += __popc(sels);
    n_tie += __popc(ties);
  }
  __syncwarp();
  for (int u = lane; u < n_tie; u += 32) {
    const u64 key = tie[u];
    int rank = 0;
    for (int v = 0; v < n_tie; ++v) rank += tie[v] < key;
    if (rank < need) keys[n_sel + rank] = key;
  }
  __syncwarp();
}

// Calls f(e, in) for the window's entries, 32 at a time: every lane calls
// it each round, `in` false past the last entry, so f may use warp votes.
template <class F>
__device__ __forceinline__ void scan(int total, int lane, F&& f) {
  for (int base = 0; base < total; base += 32) f(base + lane, base + lane < total);
}

// One output slot: the key's point, sqrt(d2) correctly rounded, ok.
__device__ __forceinline__ void write_slot(const Window& win, u64 key, long long at,
                                           int* out_idx, float* out_dist,
                                           unsigned char* out_ok) {
  out_idx[at] = win.wi[unsigned(key)];
  out_dist[at] = __fsqrt_rn(__uint_as_float(unsigned(key >> 32)));
  out_ok[at] = 1;
}

__global__ void __launch_bounds__(kMaxWarps * 32)
knn_select_kernel(const int* __restrict__ buckets, const int* __restrict__ counts,
                  const float* __restrict__ pts, const float* __restrict__ qs,
                  const int* __restrict__ order, int* __restrict__ out_idx,
                  float* __restrict__ out_dist, unsigned char* __restrict__ out_ok,
                  int* __restrict__ run_sizes, int n_sizes, int m, int table, int cap,
                  float cell, float r2, int hb, int k, int exclude_self) {
  __shared__ Chunk<kChunk> ch;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int n_win = kCells * cap;
  const unsigned lt = (1u << lane) - 1u;
  unsigned* hist = reinterpret_cast<unsigned*>(smem) + w * kHistWords;
  u64* tie = reinterpret_cast<u64*>(smem + nwarps * kHistWords * 4LL) + w * kTieCap;
  u64* keys = reinterpret_cast<u64*>(smem + nwarps * (kHistWords * 4LL + kTieCap * 8LL)) +
              (long long)w * key_slots(k);
  Window win;
  win.wx = reinterpret_cast<float*>(smem + nwarps * warp_bytes(k));
  win.wy = win.wx + n_win;
  win.wz = win.wy + n_win;
  win.wi = reinterpret_cast<int*>(win.wz + n_win);

  const long long base = (long long)blockIdx.x * kChunk;
  load_chunk(ch, order, qs, base, int(min((long long)kChunk, m - base)), cell, run_sizes,
             n_sizes);
  // The first digit: the kDigit bits of d2 below r^2's highest set bit (an
  // in-radius d2 has no bit above it).
  const int lo0 = hb + 1, width1 = min(kDigit, lo0), lo1 = lo0 - width1;
  const unsigned mask1 = (1u << width1) - 1u;

  for (int r = 0; r < ch.n_runs; ++r) {
    const int rs = ch.run_start[r], re = ch.run_start[r + 1];
    stage_window(ch, ch.slot[rs], buckets, counts, pts, table, cap, win);
    const int total = ch.total;
    float tau = -1.f;  // the bound guessed from the warp's last query of the run
    for (int ru = rs + w; ru < re; ru += nwarps) {
      const int t = ch.slot[ru];
      const int i = ch.idx[t];
      const float qx = ch.q[0][t], qy = ch.q[1][t], qz = ch.q[2][t];
      const int self = exclude_self ? i : -1;
      const long long row = (long long)i * k;
      const bool guess = tau >= 0.f;

      // A candidate's d2 when it is in under `bound` (<= r2), else NaN.
      auto d2_in = [&](int e, bool in, float bound) {
        const float d2 = in ? dist2(win.wx[e], win.wy[e], win.wz[e], qx, qy, qz) : 0.f;
        return in && d2 <= bound && (d2 != 0.f || win.wi[e] != self)
                   ? d2 : __int_as_float(0x7fc00000);
      };

      // With a guess, one pass keeps the keys with d2 <= tau (the first
      // kBufCap); they hold the K smallest when at least K fall under tau,
      // or all the in-radius ones when tau is r^2.
      int n_buf = 0;
      if (guess) {
        scan(total, lane, [&](int e, bool in) {
          const float d2 = d2_in(e, in, tau);
          const bool low = d2 == d2;
          const unsigned lows = __ballot_sync(kFull, low);
          const int at = n_buf + __popc(lows & lt);
          if (low && at < kBufCap) keys[at] = (u64(__float_as_uint(d2)) << 32) | unsigned(e);
          n_buf += __popc(lows);
        });
        __syncwarp();
      }
      const bool kept = guess && n_buf <= kBufCap && (n_buf >= k || tau == r2);
      int n_in = n_buf;
      if (!kept) {
        // Pass 1: the in-radius count and the first digit's histogram.
        clear_hist(hist, lane);
        int cnt = 0;
        scan(total, lane, [&](int e, bool in) {
          const float d2 = d2_in(e, in, r2);
          if (d2 == d2) {
            ++cnt;
            if (width1 > 0) count_bin(hist, (__float_as_uint(d2) >> lo1) & mask1);
          }
        });
        n_in = __reduce_add_sync(kFull, cnt);
        __syncwarp();
      }
      const int n_out = min(n_in, k);

      if (kept) {
        if (n_buf > n_out) keep_smallest(keys, tie, hist, n_buf, k, lo1, mask1, width1, lane);
      } else {
        // The kept keys: top = bits of d2 >> lo; below prefix kept, equal
        // to it a tie, `need` of the ties kept.
        u64 prefix;
        int lo, need;
        if (n_in <= k) {
          prefix = 1, lo = 32, need = 0;  // every key
        } else if (n_in <= kTieCap || lo0 == 0) {
          prefix = 0, lo = lo0 == 0 ? 0 : 32, need = k;  // every key a tie
        } else {
          prefix = 0, lo = lo0, need = k;
          int c_match = n_in;
          for (bool first = true; c_match > kTieCap && lo > 0; first = false) {
            const int width = min(kDigit, lo), nlo = lo - width;
            if (!first) {  // this digit's histogram over the prefix's keys
              clear_hist(hist, lane);
              const unsigned pre = unsigned(prefix), mask = (1u << width) - 1u;
              scan(total, lane, [&](int e, bool in) {
                const float d2 = d2_in(e, in, r2);
                const unsigned bits = __float_as_uint(d2);
                if (d2 == d2 && u64(bits) >> lo == pre) count_bin(hist, (bits >> nlo) & mask);
              });
              __syncwarp();
            }
            int bin, below;
            find_bin(hist, need, lane, bin, below, c_match);
            need -= below;
            prefix = (prefix << width) | u64(bin);
            lo = nlo;
            __syncwarp();
          }
          if (need == c_match) prefix += 1, need = 0;  // the whole bin is kept
        }

        // The last pass: keys below the prefix kept, ties to the buffer
        // (or, with every bit known, the first `need` in window order).
        int n_sel = 0, n_tie = 0, taken = 0;
        scan(total, lane, [&](int e, bool in) {
          const float d2 = d2_in(e, in, r2);
          const u64 key = (u64(__float_as_uint(d2)) << 32) | unsigned(e);
          const u64 top = u64(__float_as_uint(d2)) >> lo;
          bool sel = d2 == d2 && top < prefix;
          const bool is_tie = d2 == d2 && need > 0 && top == prefix;
          const unsigned ties = __ballot_sync(kFull, is_tie);
          if (lo == 0) {  // ties in window order
            sel |= is_tie && taken + __popc(ties & lt) < need;
            taken += __popc(ties);
          } else {
            if (is_tie) tie[n_tie + __popc(ties & lt)] = key;
            n_tie += __popc(ties);
          }
          const unsigned sels = __ballot_sync(kFull, sel);
          if (sel) keys[n_sel + __popc(sels & lt)] = key;
          n_sel += __popc(sels);
        });
        __syncwarp();
        if (lo != 0 && need > 0) {  // the need smallest ties (all distinct)
          for (int u = lane; u < n_tie; u += 32) {
            const u64 key = tie[u];
            int rank = 0;
            for (int v = 0; v < n_tie; ++v) rank += tie[v] < key;
            if (rank < need) keys[n_sel + rank] = key;
          }
          __syncwarp();
        }
      }

      // The n_out kept keys (keys[0 .. n_out)) in order.
      if (k <= kSortMax) {
        u64 v[kSortMax / 32];
#pragma unroll
        for (int rr = 0; rr < kSortMax / 32; ++rr) {
          const int at = lane + 32 * rr;
          v[rr] = at < n_out ? keys[at] : kNoKey;
        }
        warp_sort(v, lane);
        u64 kth = kNoKey;
#pragma unroll
        for (int rr = 0; rr < kSortMax / 32; ++rr) {
          const int at = lane + 32 * rr;
          if (at < n_out) write_slot(win, v[rr], row + at, out_idx, out_dist, out_ok);
          if (rr == (k - 1) >> 5) kth = __shfl_sync(kFull, v[rr], (k - 1) & 31);
        }
        // The next query's bound: 1.5 times this one's K-th d2 (all of r^2
        // with fewer than K in).
        tau = n_out == k ? fminf(__fmul_rn(__uint_as_float(unsigned(kth >> 32)), kGuess), r2)
                         : r2;
      } else {  // each kept key's slot is its rank among the kept keys
        for (int u = lane; u < n_out; u += 32) {
          const u64 key = keys[u];
          int rank = 0;
          for (int v = 0; v < n_out; ++v) rank += keys[v] < key;
          write_slot(win, key, row + rank, out_idx, out_dist, out_ok);
        }
      }
      for (int s = n_out + lane; s < k; s += 32) {
        out_idx[row + s] = -1;
        out_dist[row + s] = __int_as_float(0x7f800000);
        out_ok[row + s] = 0;
      }
      __syncwarp();
    }
  }
}

}  // namespace

extern "C" {

// S1: idx (M, k) int32, dist (M, k) f32 and ok (M, k) bool of the M queries
// (M, 3) f32 over the hash grid (buckets (table, cap) int32, counts (table,)
// int32, cap <= 128) of points (N, 3) f32, taken in the schedule order (M,)
// int32 (a permutation of 0 .. M-1), all contiguous; with exclude_self,
// query i skips point i. Where run_sizes ((n_sizes,) int32) is not null,
// adds 1 to run_sizes[min(s, n_sizes - 1)] for each window staged, s its
// queries. One launch on `stream`. Returns cudaGetLastError().
int knn_select(const void* buckets, const void* counts, const void* points, const void* queries,
               const void* order, void* idx, void* dist, void* ok, void* run_sizes, int n_sizes,
               int m, int table, int cap, float cell, float r2, int k, int exclude_self,
               void* stream) {
  if (m < 1 || table < 1 || cap < 1 || cap > kMaxB || k < 1 || k > kCells * cap ||
      (run_sizes != nullptr && n_sizes < 1))
    return cudaErrorInvalidValue;
  // In radius: d2 <= r2 and finite; a NaN r^2 takes none.
  const float r2_in = r2 != r2 ? -1.f : fminf(r2, 3.402823466e38f);
  unsigned bits;
  memcpy(&bits, &r2_in, 4);
  const int hb = r2_in > 0.f ? 31 - __builtin_clz(bits) : -1;
  int device = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const long long window = 16LL * kCells * cap;
  const long long static_smem = sizeof(Chunk<kChunk>);
  int warps = kMaxWarps;
  while (warps > 1 && window + warps * warp_bytes(k) + static_smem > max_smem) --warps;
  const long long smem = window + warps * warp_bytes(k);
  if (smem + static_smem > max_smem) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(knn_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (err != cudaSuccess) return err;
  const unsigned grid = unsigned((m + kChunk - 1) / kChunk);
  knn_select_kernel<<<grid, warps * 32, size_t(smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(buckets), static_cast<const int*>(counts),
      static_cast<const float*>(points), static_cast<const float*>(queries),
      static_cast<const int*>(order), static_cast<int*>(idx), static_cast<float*>(dist),
      static_cast<unsigned char*>(ok), static_cast<int*>(run_sizes), n_sizes, m, table, cap,
      cell, r2_in, hb, k, exclude_self);
  return cudaGetLastError();
}

}  // extern "C"

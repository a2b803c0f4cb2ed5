// Local color smoothing for Hopper (sm_90a): the grid-hash radius search and
// the inverse-distance blend of smooth_colors_local in one kernel (N1).
//
// Replaces ops that XLA emits on the TPU without a Pallas source:
//   N1 smooth_local <- pointcloudprocessor_tpu/ops/fusion.py:196-226
//                      (smooth_colors_local) over knn.radius_neighbors
//                      (pointcloudprocessor_tpu/ops/knn.py:230-291)
// The hash grid itself (knn.build: a sort, a rank and a scatter into the
// (T, B) bucket table) stays torch ops in the wrapper.
//
// In: buckets (T, B) int32 point indices (-1 empty) and counts (T,) int32
// (may exceed B), points (N, 3) f32, rgb (N, 3) f32, colored (N,) bool and
// a schedule order (N,) int32, a permutation of the points that groups
// equal cells and lists the colored points first (the grid's own order when
// knn.build sorts the valid points first). Out: (N, 3) f32 colors.
//
// The schedule of csrc/cell_window.cuh, as S1 and M1 take it. A block takes
// kChunk consecutive points of the schedule. Its colored points, where they
// lead the chunk (always, under such a schedule), are the chunk's queries;
// the uncolored ones after them keep their color and stage nothing. (Under
// another schedule, a chunk that lists an uncolored point before a colored
// one takes all its points as queries; an uncolored query keeps its color.)
// load_chunk groups the queries by cell; for each distinct cell the block
// stages the 27-bucket window once in shared memory (stage_window: the
// occupied slots in the plain version's candidate order, a bucket that two
// cells share listed twice), and its warps take the cell's queries, one at a
// time:
//   - a candidate e of the window is in when d2 (cell_window::dist2, each
//     step rounded) is <= r^2 and finite; its key (bits of d2) << 32 | e
//     orders the candidates as the plain version's (M, 27 * B) row does,
//     since the window lists them in that row's order: ties to the lower
//     position, as lax.top_k(-d2, K) keeps them;
//   - a pass over the window appends the in-radius keys to a buffer of 64.
//     A query with at most 31 (about 80% on the smoke scene) needs no sort:
//     each key's rank among them (a count of the smaller ones) places it.
//     Otherwise the warp keeps the 32 smallest keys in registers, sorted, one
//     a lane: whenever 32 are pending (and at the end) they are sorted by a
//     bitonic network and merged into the kept ones (a bitonic merge of the
//     two sorted halves), and only keys below the 32nd kept one are appended
//     from then on;
//   - the blend, lane l holding the l-th nearest (l < K): w = 1 / (1 +
//     dist * dist), dist = sqrt(d2), correctly rounded, self included (d2
//     = 0); the sums of w * rgb and w over the lanes by a fixed tree; tw > 0
//     ? s / max(tw, 1e-12) : rgb. The colors agree with the plain version up
//     to f32 summation order, whatever the schedule.
// No (N, K) index or distance tensor is written. Where run_sizes is not
// null, the launch adds 1 to run_sizes[min(s, n_sizes - 1)] for each window
// it stages, s its queries (cell_window::load_chunk).
//
// What bounds it on the H100 (chip_smoke.py's phase_smooth counts it from
// the run's inputs). Unique bytes (each input read once: counts, the
// occupied slots, points, rgb, colored, the schedule, the output): ~52 MB
// on the smoke scene (1M points, 736k colored), ~16 us. Per window staged:
// 27 count words and 16 B a slot (its index and point), about 1.7 KB at the
// scene's ~100 slots a window. Per query, its kept neighbors' colors (12 B
// each, L1 / L2 hits among a run's queries). The window turns ~100 dependent
// random reads a query into one staging a cell a block; the passes then read
// 12 B a candidate from shared memory, and the instruction issue and the
// staging's latency set the pace.

#include <cuda_runtime.h>

#include "cell_window.cuh"

namespace {

using namespace cell_window;
using u64 = unsigned long long;

constexpr int kWarps = 4;                   // warps a block
constexpr int kChunk = 64;                  // points of the schedule a block
constexpr int kMaxB = 32;                   // bucket capacity the kernel takes
constexpr int kMaxK = 32;                   // neighbors a query, one a lane
constexpr int kWindow = kCells * kMaxB;     // window entries at most
constexpr u64 kNoKey = ~0ull;
static_assert(kWarps * 32 >= kChunk, "a thread a point of the chunk");

// Sorts the warp's 32 keys ascending, key l in lane l (a bitonic network).
__device__ __forceinline__ u64 sort32(u64 v, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const u64 o = __shfl_xor_sync(kFull, v, j);
      const bool up = (lane & k) == 0;
      v = (((lane & j) == 0) == up) ? min(v, o) : max(v, o);
    }
  }
  return v;
}

// The 32 smallest of two ascending 32-key sequences, ascending: the lane-wise
// minimum of one and the other reversed is bitonic; a merge sorts it.
__device__ __forceinline__ u64 merge32(u64 kept, u64 v, int lane) {
  u64 c = min(kept, __shfl_sync(kFull, v, 31 - lane));
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) {
    const u64 o = __shfl_xor_sync(kFull, c, j);
    c = (lane & j) == 0 ? min(c, o) : max(c, o);
  }
  return c;
}

// A kept key's terms: w * rgb of its point and w = 1 / (1 + dist * dist),
// dist = sqrt(d2) correctly rounded, each step rounded as the plain
// version's.
__device__ __forceinline__ float4 blend_terms(u64 key, const int* wi,
                                              const float* __restrict__ rgb) {
  const float dist = __fsqrt_rn(__uint_as_float(unsigned(key >> 32)));
  const float wt = __fdiv_rn(1.0f, __fadd_rn(1.0f, __fmul_rn(dist, dist)));
  const long long j = wi[unsigned(key)];
  return make_float4(__fmul_rn(__ldg(rgb + 3 * j), wt), __fmul_rn(__ldg(rgb + 3 * j + 1), wt),
                     __fmul_rn(__ldg(rgb + 3 * j + 2), wt), wt);
}

__device__ __forceinline__ void keep_color(const float* __restrict__ rgb, float* __restrict__ out,
                                           long long i, int c) {
  out[3 * i + c] = __ldg(rgb + 3 * i + c);
}

__global__ void __launch_bounds__(kWarps * 32)
smooth_local_kernel(const int* __restrict__ buckets, const int* __restrict__ counts,
                    const float* __restrict__ pts, const float* __restrict__ rgb,
                    const unsigned char* __restrict__ colored, const int* __restrict__ order,
                    float* __restrict__ out, int* __restrict__ run_sizes, int n_sizes, int n,
                    int table, int cap, float cell, float r2, int k_max) {
  __shared__ Chunk<kChunk> ch;
  __shared__ float wx[kWindow], wy[kWindow], wz[kWindow];
  __shared__ int wi[kWindow];
  __shared__ __align__(16) u64 pend_all[kWarps][64];  // keys; then a float4 a lane
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  u64* pend = pend_all[w];
  const Window win{wx, wy, wz, wi};

  // The chunk's colored points lead it under the path's schedule: they are
  // its queries, and the uncolored ones after them keep their color.
  const long long base = (long long)blockIdx.x * kChunk;
  const int len = int(min((long long)kChunk, n - base));
  const int t0 = threadIdx.x;
  int i0 = -1;
  bool col = false;
  if (t0 < len) {
    i0 = __ldg(order + base + t0);
    col = __ldg(colored + i0) != 0;
  }
  const int n_col = __syncthreads_count(col);
  const bool led = !__syncthreads_or(col && t0 >= n_col);
  const int queries = led ? n_col : len;
  if (t0 >= queries && t0 < len)
    for (int c = 0; c < 3; ++c) keep_color(rgb, out, i0, c);
  load_chunk(ch, order, pts, base, queries, cell, run_sizes, n_sizes);

  for (int r = 0; r < ch.n_runs; ++r) {
    const int rs = ch.run_start[r], re = ch.run_start[r + 1];
    stage_window(ch, ch.slot[rs], buckets, counts, pts, table, cap, win);
    const int total = ch.total;
    for (int ru = rs + w; ru < re; ru += kWarps) {
      const int t = ch.slot[ru];
      const long long i = ch.idx[t];
      if (!__ldg(colored + i)) {  // warp-uniform: a query of another schedule
        if (lane < 3) keep_color(rgb, out, i, lane);
        continue;
      }
      const float qx = ch.q[0][t], qy = ch.q[1][t], qz = ch.q[2][t];
      u64 kept = kNoKey;   // lane l: the l-th smallest key so far
      u64 bound = kNoKey;  // the 32nd: a key must be below it to matter
      int n_pend = 0;
      bool first = true;
      auto flush = [&]() {
        __syncwarp();
        u64 v = lane < n_pend ? pend[lane] : kNoKey;
        const u64 rest = lane + 32 < n_pend ? pend[lane + 32] : kNoKey;
        __syncwarp();
        if (lane + 32 < n_pend) pend[lane] = rest;
        v = sort32(v, lane);
        kept = first ? v : merge32(kept, v, lane);
        first = false;
        bound = __shfl_sync(kFull, kept, 31);
        n_pend = max(n_pend - 32, 0);
      };
      for (int b = 0; b < total; b += 32) {
        const int e = b + lane;
        u64 key = kNoKey;
        if (e < total) {
          const float d2 = dist2(wx[e], wy[e], wz[e], qx, qy, qz);
          if (d2 <= r2) key = (u64(__float_as_uint(d2)) << 32) | unsigned(e);
        }
        const bool take = key < bound;
        const unsigned m = __ballot_sync(kFull, take);
        if (take) pend[n_pend + __popc(m & lt)] = key;
        n_pend += __popc(m);
        if (n_pend >= 32) flush();
      }
      float4 term = make_float4(0.f, 0.f, 0.f, 0.f);  // lane l: the l-th nearest's
      if (first) {
        // At most 31 keys, all pending: each one's rank among them puts its
        // terms in that lane, nearest first, with no sort.
        __syncwarp();
        const u64 key = lane < n_pend ? pend[lane] : kNoKey;
        int rank = 0;
        for (int m = 0; m < n_pend; ++m) rank += pend[m] < key;
        if (lane < n_pend && rank < k_max) term = blend_terms(key, wi, rgb);
        __syncwarp();
        float4* slots = reinterpret_cast<float4*>(pend);
        if (lane < n_pend) slots[rank] = term;
        __syncwarp();
        if (lane < n_pend) term = slots[lane];
      } else {
        if (n_pend > 0) flush();
        if (lane < k_max && kept != kNoKey) term = blend_terms(kept, wi, rgb);
      }
      float s0 = term.x, s1 = term.y, s2 = term.z, tw = term.w;
      // The same tree in every lane (each step adds a pair in both orders).
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        s0 = __fadd_rn(s0, __shfl_xor_sync(kFull, s0, o));
        s1 = __fadd_rn(s1, __shfl_xor_sync(kFull, s1, o));
        s2 = __fadd_rn(s2, __shfl_xor_sync(kFull, s2, o));
        tw = __fadd_rn(tw, __shfl_xor_sync(kFull, tw, o));
      }
      if (lane < 3) {
        const float sc = lane == 0 ? s0 : (lane == 1 ? s1 : s2);
        out[3 * i + lane] = tw > 0.f ? __fdiv_rn(sc, fmaxf(tw, 1e-12f)) : __ldg(rgb + 3 * i + lane);
      }
    }
  }
}

}  // namespace

extern "C" {

// N1: out (N, 3) f32 from the hash grid (buckets (table, cap) int32, counts
// (table,) int32; cap <= 32), points and rgb (N, 3) f32, colored (N,) bool
// and the schedule order (N,) int32, all contiguous; the k_max <= 32
// nearest colored neighbors within sqrt(r2). Where run_sizes ((n_sizes,)
// int32) is not null, adds 1 to run_sizes[min(s, n_sizes - 1)] for each
// window staged, s its queries. One launch on `stream`. Returns
// cudaGetLastError().
int smooth_local(const void* buckets, const void* counts, const void* points, const void* rgb,
                 const void* colored, const void* order, void* out, void* run_sizes,
                 int n_sizes, int n, int table, int cap, float cell, float r2, int k_max,
                 void* stream) {
  if (n < 1 || table < 1 || cap < 1 || cap > kMaxB || k_max < 1 || k_max > kMaxK ||
      (run_sizes != nullptr && n_sizes < 1))
    return cudaErrorInvalidValue;
  // In radius: d2 <= r2 and finite; a NaN r^2 takes none.
  const float r2_in = r2 != r2 ? -1.f : fminf(r2, 3.402823466e38f);
  const unsigned grid = unsigned((n + kChunk - 1) / kChunk);
  smooth_local_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(buckets), static_cast<const int*>(counts),
      static_cast<const float*>(points), static_cast<const float*>(rgb),
      static_cast<const unsigned char*>(colored), static_cast<const int*>(order),
      static_cast<float*>(out), static_cast<int*>(run_sizes), n_sizes, n, table, cap, cell,
      r2_in, k_max);
  return cudaGetLastError();
}

}  // extern "C"

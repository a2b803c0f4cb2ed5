// Queries in cell order, each 27-cell candidate window staged once in
// shared memory: the schedule that S1 (csrc/sor.cu) and M1 (csrc/mls.cu)
// share. kernels/build.py digests this header with each source that
// includes it.
//
// A block takes a chunk of kChunk consecutive queries of a schedule (a
// permutation of the queries that groups equal cells; any permutation gives
// the same results). load_chunk reads the chunk's query indices,
// coordinates and cells (floor(q / cell) by IEEE division, the saturating
// float -> int32 cast, NaN -> 0) and groups it into runs, one a distinct
// cell of the chunk.
// stage_window lays out the occupied slots of a run's 27 buckets once, end
// to end in shared memory, in the plain version's candidate order: cells in
// OFFSETS order (dx, then dy, then dz), slots in bucket order, a bucket that
// two cells share listed twice. Each entry holds the point's index and its
// coordinates (NaN where a slot holds -1), so a warp computes d2 for a run's
// queries with no global read per candidate. The cell of a run is computed,
// never taken from the schedule, so colliding hashes, cells beyond any
// packed key and NaN / +-inf queries stage their own windows.

#pragma once

#include <cuda_runtime.h>

namespace cell_window {

constexpr int kCells = 27;
constexpr unsigned kFull = 0xffffffffu;
// vector3i_hash.hpp:14-37 (the JAX package's voxel.py:18-20).
constexpr unsigned kP1 = 73856093u, kP2 = 19349669u, kP3 = 83492791u;

__device__ __forceinline__ int cell_coord(float p, float cell) {
  return __float2int_rz(floorf(__fdiv_rn(p, cell)));  // saturating, NaN -> 0
}

// The offset d = p - q and d2 = (dx*dx + dy*dy) + dz*dz, each step rounded
// (the plain versions' order, no FMA): the one place that rounding is
// written.
__device__ __forceinline__ float offset2(float px, float py, float pz, float qx, float qy,
                                         float qz, float& dx, float& dy, float& dz) {
  dx = __fsub_rn(px, qx);
  dy = __fsub_rn(py, qy);
  dz = __fsub_rn(pz, qz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

__device__ __forceinline__ float dist2(float px, float py, float pz, float qx, float qy,
                                       float qz) {
  float dx, dy, dz;
  return offset2(px, py, pz, qx, qy, qz, dx, dy, dz);
}

// The staged window: entry e of `total` holds point wi[e] at (wx, wy, wz)[e].
struct Window {
  float* wx;
  float* wy;
  float* wz;
  int* wi;
};

// A block's chunk of queries and the layout of its current window.
template <int kChunk>
struct Chunk {
  int idx[kChunk];          // the query's own index
  float q[3][kChunk];       // its coordinates
  int c[3][kChunk];         // its cell
  int lead[kChunk];         // the chunk's first query of that cell, then its run
  int pos[kChunk];          // the chunk's queries of that cell before it
  int slot[kChunk];         // the chunk's queries grouped by run (chunk positions)
  int run_start[kChunk + 1];
  unsigned starts[kChunk / 32];  // ballot of the runs' first queries, 32 a word
  int n_runs, len;
  int first[32];   // exclusive prefix of the 27 cells' occupied slots
  int bucket[32];  // their buckets
  int total;       // occupied slots of the window
};

// Reads queries order[base .. base + len) of the schedule and groups them
// into runs, one a distinct cell of the chunk (in the order of its first
// query; queries of a run in chunk order): run r holds the chunk positions
// slot[run_start[r] .. run_start[r + 1]). A schedule that interleaves two
// cells (as the grid's order does where they share a bucket) still stages
// one window a cell. Where run_sizes is not null, adds 1 to
// run_sizes[min(s, n_sizes - 1)] for each run of s queries: the windows the
// launch stages, by their queries. Ends with __syncthreads().
template <int kChunk>
__device__ void load_chunk(Chunk<kChunk>& ch, const int* __restrict__ order,
                           const float* __restrict__ qs, long long base, int len, float cell,
                           int* __restrict__ run_sizes, int n_sizes) {
  for (int t = threadIdx.x; t < len; t += blockDim.x) {
    const int i = __ldg(order + base + t);
    ch.idx[t] = i;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float v = __ldg(qs + 3LL * i + d);
      ch.q[d][t] = v;
      ch.c[d][t] = cell_coord(v, cell);
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < len; t += blockDim.x) {
    const int cx = ch.c[0][t], cy = ch.c[1][t], cz = ch.c[2][t];
    int lead = t, pos = 0;
    for (int u = 0; u < t; ++u) {
      if (ch.c[0][u] == cx && ch.c[1][u] == cy && ch.c[2][u] == cz) {
        if (pos == 0) lead = u;
        ++pos;
      }
    }
    ch.lead[t] = lead;
    ch.pos[t] = pos;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  for (int s = threadIdx.x >> 5; s < kChunk / 32; s += nwarps) {
    const int t = 32 * s + lane;
    const unsigned bal = __ballot_sync(kFull, t < len && ch.lead[t] == t);
    if (lane == 0) ch.starts[s] = bal;
  }
  __syncthreads();
  // A query's run is its lead's rank among the leads (kept in lead[] from
  // here on); run r's size, the pos of its last query + 1; its start, the
  // sizes of the runs before it.
  for (int t = threadIdx.x; t < len; t += blockDim.x) {
    const int l = ch.lead[t];
    int run = __popc(ch.starts[l >> 5] & ((1u << (l & 31)) - 1u));
    for (int u = 0; u < (l >> 5); ++u) run += __popc(ch.starts[u]);
    ch.lead[t] = run;
    ch.run_start[run + 1] = 0;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < len; t += blockDim.x)
    atomicMax(&ch.run_start[ch.lead[t] + 1], ch.pos[t] + 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    int n = 0;
    for (int u = 0; u < kChunk / 32; ++u) n += __popc(ch.starts[u]);
    ch.run_start[0] = 0;
    for (int r = 0; r < n; ++r) ch.run_start[r + 1] += ch.run_start[r];
    ch.n_runs = n;
    ch.len = len;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < len; t += blockDim.x)
    ch.slot[ch.run_start[ch.lead[t]] + ch.pos[t]] = t;
  if (run_sizes != nullptr)
    for (int r = threadIdx.x; r < ch.n_runs; r += blockDim.x)
      atomicAdd(run_sizes + min(ch.run_start[r + 1] - ch.run_start[r], n_sizes - 1), 1);
  __syncthreads();
}

// Stages the window of chunk position t's cell: warp 0 reads the 27 buckets'
// counts and lays their occupied slots end to end, then every thread reads
// slots (one pass, independent loads) and their points (a second pass).
// Starts and ends with __syncthreads(): the caller's warps must be done with
// the previous window.
template <int kChunk>
__device__ void stage_window(Chunk<kChunk>& ch, int t, const int* __restrict__ buckets,
                             const int* __restrict__ counts, const float* __restrict__ pts,
                             int table, int cap, const Window& win) {
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int occupied = 0, b = 0;
    if (lane < kCells) {
      const unsigned ux = unsigned(ch.c[0][t]) + unsigned(lane / 9 - 1);
      const unsigned uy = unsigned(ch.c[1][t]) + unsigned((lane / 3) % 3 - 1);
      const unsigned uz = unsigned(ch.c[2][t]) + unsigned(lane % 3 - 1);
      b = int(((ux * kP1) ^ (uy * kP2) ^ (uz * kP3)) % unsigned(table));
      occupied = max(min(__ldg(counts + b), cap), 0);
    }
    int incl = occupied;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    ch.first[lane] = incl - occupied;
    ch.bucket[lane] = b;
    if (lane == 31) ch.total = incl;
  }
  __syncthreads();
  const int total = ch.total;
  // The same thread takes entry e in both passes: no barrier between them.
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    int kc = 0;  // the last of the 27 cells whose slots start at or before e
#pragma unroll
    for (int step = 16; step > 0; step >>= 1)
      if (kc + step < kCells && ch.first[kc + step] <= e) kc += step;
    win.wi[e] = __ldg(buckets + (long long)ch.bucket[kc] * cap + (e - ch.first[kc]));
  }
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int j = win.wi[e];
    float x = __int_as_float(0x7fc00000), y = x, z = x;  // NaN: never in radius
    if (j >= 0) {
      x = __ldg(pts + 3LL * j);
      y = __ldg(pts + 3LL * j + 1);
      z = __ldg(pts + 3LL * j + 2);
    }
    win.wx[e] = x;
    win.wy[e] = y;
    win.wz[e] = z;
  }
  __syncthreads();
}

}  // namespace cell_window

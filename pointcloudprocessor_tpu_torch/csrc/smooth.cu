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
// (may exceed B), points (N, 3) f32, rgb (N, 3) f32, colored (N,) bool.
// Out: (N, 3) f32 colors. A warp takes one query point:
//   - an uncolored point keeps its color;
//   - lanes 0..26 hash the 27 cells around the query's cell (floor(p /
//     cell) by IEEE division, int32 offsets and the uint32 XOR hash of
//     vector3i_hash.hpp, wrapping) and read min(count, B) of their bucket;
//     a warp scan lays the occupied slots of the 27 buckets end to end, so
//     each round of the warp reads 32 candidates whatever the occupancy.
//     Empty slots hold -1 in the table, so skipping them changes nothing;
//   - a candidate j at slot s of the k-th cell is in when its d2 =
//     (dx*dx + dy*dy) + dz*dz (rounded as jnp computes it) is <= r^2; its
//     key is (bits of d2) << 32 | (k * B + s), the candidate's position in
//     the JAX package's (M, 27 * B) candidate row. The in-radius keys
//     collect in shared memory (at most 27 * B);
//   - if more than K are in, a candidate is kept when fewer than K keys are
//     below its own: the K nearest, ties to the lower position, as
//     lax.top_k(-d2, K) keeps them. Two of the 27 cells can hash to one
//     bucket; its points are then candidates twice, as in the JAX package,
//     and nothing is deduplicated;
//   - the blend: w = 1 / (1 + dist * dist), dist = sqrt(d2), self included
//     (d2 = 0), sum(w * rgb) / max(sum(w), 1e-12), summed across lanes: the
//     colors agree with the plain version up to f32 summation order.
// No (N, K) index or distance tensor is written.
//
// What bounds it on the H100. Unique bytes (each input read once: counts,
// the occupied slots, points, rgb, colored, the output): 48 MB on the smoke
// scene (1M points, 736k colored), 14 us. Per query, 27 count words, the
// occupied slots and 12 B a candidate (98 candidates a query there): 1.25
// GB, 372 us; the queries of a scanner map come in random order, so the
// 256 MB table is read sector by sector, while the points (12 MB) stay in
// the 50 MB L2. A warp spends one round of dependent loads on the counts
// and candidates / 32 more on slots and points, so latency and occupancy
// (42 KB of shared memory a block of 4 warps), not bytes, set its pace.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;              // queries a block
constexpr int kCells = 27;
constexpr int kMaxB = 32;              // bucket capacity the kernel takes
constexpr int kMaxCand = kCells * kMaxB;
constexpr unsigned kFull = 0xffffffffu;
// vector3i_hash.hpp:14-37 (the JAX package's voxel.py:18-20).
constexpr unsigned kP1 = 73856093u, kP2 = 19349669u, kP3 = 83492791u;

__device__ __forceinline__ int cell_coord(float p, float cell) {
  return __float2int_rz(floorf(__fdiv_rn(p, cell)));  // saturating, NaN -> 0
}

__global__ void __launch_bounds__(kWarps * 32)
smooth_local_kernel(const int* __restrict__ buckets, const int* __restrict__ counts,
                    const float* __restrict__ pts, const float* __restrict__ rgb,
                    const unsigned char* __restrict__ colored, float* __restrict__ out, int n,
                    int table, int cap, float cell, float r2, int k_max) {
  __shared__ unsigned long long keys[kWarps][kMaxCand];
  __shared__ int cand[kWarps][kMaxCand];
  __shared__ int first[kWarps][32];  // exclusive prefix of the occupied slots
  __shared__ int bucket[kWarps][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long i = (long long)blockIdx.x * kWarps + w;
  if (i >= n) return;  // warp-uniform
  if (!colored[i]) {
    if (lane < 3) out[3 * i + lane] = rgb[3 * i + lane];
    return;
  }
  const float qx = pts[3 * i], qy = pts[3 * i + 1], qz = pts[3 * i + 2];

  int occupied = 0, b = 0;
  if (lane < kCells) {
    const unsigned ux = unsigned(cell_coord(qx, cell)) + unsigned(lane / 9 - 1);
    const unsigned uy = unsigned(cell_coord(qy, cell)) + unsigned((lane / 3) % 3 - 1);
    const unsigned uz = unsigned(cell_coord(qz, cell)) + unsigned(lane % 3 - 1);
    b = int(((ux * kP1) ^ (uy * kP2) ^ (uz * kP3)) % unsigned(table));
    occupied = max(min(__ldg(counts + b), cap), 0);
  }
  int incl = occupied;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  const int total = __shfl_sync(kFull, incl, 31);
  first[w][lane] = incl - occupied;
  bucket[w][lane] = b;
  __syncwarp();

  int n_in = 0;
  for (int base = 0; base < total; base += 32) {
    const int c = base + lane;
    bool in = false;
    unsigned long long key = 0;
    int j = -1;
    if (c < total) {
      int k = 0;  // the last of the 27 cells whose slots start at or before c
#pragma unroll
      for (int step = 16; step > 0; step >>= 1)
        if (k + step < kCells && first[w][k + step] <= c) k += step;
      const int slot = c - first[w][k];
      j = __ldg(buckets + (long long)bucket[w][k] * cap + slot);
      if (j >= 0) {
        const float dx = __fsub_rn(__ldg(pts + 3LL * j), qx);
        const float dy = __fsub_rn(__ldg(pts + 3LL * j + 1), qy);
        const float dz = __fsub_rn(__ldg(pts + 3LL * j + 2), qz);
        const float d2 =
            __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
        if (d2 <= r2) {
          in = true;
          key = ((unsigned long long)__float_as_uint(d2) << 32) | unsigned(k * cap + slot);
        }
      }
    }
    const unsigned m = __ballot_sync(kFull, in);
    if (in) {
      const int pos = n_in + __popc(m & ((1u << lane) - 1u));
      keys[w][pos] = key;
      cand[w][pos] = j;
    }
    n_in += __popc(m);
  }
  __syncwarp();

  float s0 = 0.f, s1 = 0.f, s2 = 0.f, tw = 0.f;
  for (int t = lane; t < n_in; t += 32) {
    const unsigned long long key = keys[w][t];
    bool take = true;
    if (n_in > k_max) {
      int rank = 0;
      for (int u = 0; u < n_in; ++u) rank += keys[w][u] < key;
      take = rank < k_max;
    }
    if (take) {
      const float dist = __fsqrt_rn(__uint_as_float(unsigned(key >> 32)));
      const float wt = __fdiv_rn(1.0f, __fadd_rn(1.0f, __fmul_rn(dist, dist)));
      const long long j = cand[w][t];
      s0 += __ldg(rgb + 3 * j) * wt;
      s1 += __ldg(rgb + 3 * j + 1) * wt;
      s2 += __ldg(rgb + 3 * j + 2) * wt;
      tw += wt;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s0 += __shfl_xor_sync(kFull, s0, o);
    s1 += __shfl_xor_sync(kFull, s1, o);
    s2 += __shfl_xor_sync(kFull, s2, o);
    tw += __shfl_xor_sync(kFull, tw, o);
  }
  if (lane < 3) {
    const float s = lane == 0 ? s0 : (lane == 1 ? s1 : s2);
    out[3 * i + lane] = tw > 0.f ? s / fmaxf(tw, 1e-12f) : rgb[3 * i + lane];
  }
}

}  // namespace

extern "C" {

// N1: out (N, 3) f32 from the hash grid (buckets (table, cap) int32, counts
// (table,) int32; cap <= 32), points and rgb (N, 3) f32 and colored (N,)
// bool, all contiguous. One launch on `stream`. Returns cudaGetLastError().
int smooth_local(const void* buckets, const void* counts, const void* points, const void* rgb,
                 const void* colored, void* out, int n, int table, int cap, float cell, float r2,
                 int k_max, void* stream) {
  if (n < 1 || table < 1 || cap < 1 || cap > kMaxB || k_max < 1) return cudaErrorInvalidValue;
  const unsigned grid = unsigned((n + kWarps - 1) / kWarps);
  smooth_local_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(buckets), static_cast<const int*>(counts),
      static_cast<const float*>(points), static_cast<const float*>(rgb),
      static_cast<const unsigned char*>(colored), static_cast<float*>(out), n, table, cap, cell,
      r2, k_max);
  return cudaGetLastError();
}

}  // extern "C"

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
// (T, B) bucket table) stays torch ops in the wrapper.
//
// In: buckets (T, B) int32 point indices (-1 empty) and counts (T,) int32
// (may exceed B), points (N, 3) f32, queries (M, 3) f32. Out: idx (M, K)
// int32, dist (M, K) f32, ok (M, K) bool: the K smallest squared distances
// within the radius, nearest first, ties to the lower candidate position,
// as lax.top_k(-d2, K) orders them; -1 / +inf / false in the slots past the
// in-radius count. A warp takes one query:
//   - lanes 0..26 hash the 27 cells around the query's cell (floor(q /
//     cell) by IEEE division, the uint32 XOR hash of vector3i_hash.hpp) and
//     read min(count, B) of their bucket; a warp scan lays the occupied
//     slots end to end, so each round of the warp reads 32 candidates;
//   - a candidate j at slot s of the c-th cell is in when d2 = (dx*dx +
//     dy*dy) + dz*dz, each step rounded (the plain version's order, no
//     FMA), is <= r^2 and finite, and j is not the query itself where the
//     caller excludes it. Its key, (bits of d2) << 32 | (c * B + s), is
//     its rank in the plain version's (M, 27 * B) candidate row; the keys
//     collect in shared memory (at most 27 * B a warp, 8 bytes each);
//   - with more than K in, the K-th smallest key is found bit by bit (43
//     passes over the keys: the 31 bits of d2, then the 12 of the position;
//     each pass counts the keys below a trial value) and the keys up to it
//     are compacted in place; each kept key's output slot is the count of
//     kept keys below it. Two of the 27 cells can hash to one bucket; its
//     points are then candidates twice, as in the JAX package;
//   - dist = sqrt(d2), correctly rounded.
//
// What bounds it on the H100. Unique bytes (each input read once: counts,
// the occupied slots, the points and queries, the three outputs): ~90 MB
// for 1M queries at K = 60, ~27 us. Per query it reads 27 count words, up
// to 27 * B slots and 12 B a candidate (up to 1,620 candidates for the
// SOR's 0.25 m cells on a dense wall, most of them in radius), so the
// traffic through L2 is ~1,600 random 12-byte reads a query; the selection
// then makes 43 passes over the in-radius keys in shared memory. Latency of
// the dependent reads and the shared-memory passes set its pace.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;              // queries a block
constexpr int kCells = 27;
constexpr int kMaxB = 128;             // bucket capacity the kernel takes
constexpr int kPosBits = 12;           // 27 * kMaxB < 2^12 candidate positions
constexpr unsigned kFull = 0xffffffffu;
// vector3i_hash.hpp:14-37 (the JAX package's voxel.py:18-20).
constexpr unsigned kP1 = 73856093u, kP2 = 19349669u, kP3 = 83492791u;

__device__ __forceinline__ int cell_coord(float p, float cell) {
  return __float2int_rz(floorf(__fdiv_rn(p, cell)));  // saturating, NaN -> 0
}

// Number of the warp's keys below `t` (every lane gets it).
__device__ __forceinline__ int count_below(const unsigned long long* keys, int n, int lane,
                                           unsigned long long t) {
  int c = 0;
  for (int u = lane; u < n; u += 32) c += keys[u] < t;
  return __reduce_add_sync(kFull, c);
}

__global__ void __launch_bounds__(kWarps * 32)
knn_select_kernel(const int* __restrict__ buckets, const int* __restrict__ counts,
                  const float* __restrict__ pts, const float* __restrict__ qs,
                  int* __restrict__ out_idx, float* __restrict__ out_dist,
                  unsigned char* __restrict__ out_ok, int m, int table, int cap, float cell,
                  float r2, int k, int exclude_self) {
  extern __shared__ unsigned long long key_store[];
  __shared__ int first[kWarps][32];  // exclusive prefix of the occupied slots
  __shared__ int bucket[kWarps][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long i = (long long)blockIdx.x * kWarps + w;
  if (i >= m) return;  // warp-uniform
  unsigned long long* keys = key_store + (long long)w * kCells * cap;
  const float qx = qs[3 * i], qy = qs[3 * i + 1], qz = qs[3 * i + 2];

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

  // The in-radius candidates' keys.
  int n_in = 0;
  for (int base = 0; base < total; base += 32) {
    const int c = base + lane;
    bool in = false;
    unsigned long long key = 0;
    if (c < total) {
      int kc = 0;  // the last of the 27 cells whose slots start at or before c
#pragma unroll
      for (int step = 16; step > 0; step >>= 1)
        if (kc + step < kCells && first[w][kc + step] <= c) kc += step;
      const int slot = c - first[w][kc];
      const int j = __ldg(buckets + (long long)bucket[w][kc] * cap + slot);
      if (j >= 0 && !(exclude_self && j == i)) {
        const float dx = __fsub_rn(__ldg(pts + 3LL * j), qx);
        const float dy = __fsub_rn(__ldg(pts + 3LL * j + 1), qy);
        const float dz = __fsub_rn(__ldg(pts + 3LL * j + 2), qz);
        const float d2 =
            __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
        if (d2 <= r2 && d2 < __int_as_float(0x7f800000)) {
          in = true;
          key = ((unsigned long long)__float_as_uint(d2) << 32) | unsigned(kc * cap + slot);
        }
      }
    }
    const unsigned bal = __ballot_sync(kFull, in);
    if (in) keys[n_in + __popc(bal & ((1u << lane) - 1u))] = key;
    n_in += __popc(bal);
  }
  __syncwarp();

  int n_sel = n_in;
  if (n_in > k) {
    // The k-th smallest key: the largest t with fewer than k keys below it.
    unsigned long long t = 0;
    for (int bit = 62; bit >= 0; --bit) {
      if (bit == 31) bit = kPosBits - 1;  // bits 31..12 are 0 in every key
      const unsigned long long trial = t | (1ull << bit);
      if (count_below(keys, n_in, lane, trial) < k) t = trial;
    }
    // Keep the keys <= t (exactly k), compacted in place: a round writes
    // below the slots it has read, and later rounds read above them.
    n_sel = 0;
    for (int base = 0; base < n_in; base += 32) {
      const int u = base + lane;
      const unsigned long long key = u < n_in ? keys[u] : ~0ull;
      const bool keep = u < n_in && key <= t;
      const unsigned bal = __ballot_sync(kFull, keep);
      __syncwarp();
      if (keep) keys[n_sel + __popc(bal & ((1u << lane) - 1u))] = key;
      n_sel += __popc(bal);
      __syncwarp();
    }
  }

  // Each kept key's slot is its rank among the kept keys (all distinct).
  const long long row = i * k;
  for (int u = lane; u < n_sel; u += 32) {
    const unsigned long long key = keys[u];
    int rank = 0;
    for (int v = 0; v < n_sel; ++v) rank += keys[v] < key;
    const int pos = int(key & 0xffffffffu);
    const int kc = pos / cap, slot = pos - kc * cap;
    out_idx[row + rank] = __ldg(buckets + (long long)bucket[w][kc] * cap + slot);
    out_dist[row + rank] = __fsqrt_rn(__uint_as_float(unsigned(key >> 32)));
    out_ok[row + rank] = 1;
  }
  for (int r = n_sel + lane; r < k; r += 32) {
    out_idx[row + r] = -1;
    out_dist[row + r] = __int_as_float(0x7f800000);
    out_ok[row + r] = 0;
  }
}

}  // namespace

extern "C" {

// S1: idx (M, k) int32, dist (M, k) f32 and ok (M, k) bool of the M queries
// (M, 3) f32 over the hash grid (buckets (table, cap) int32, counts (table,)
// int32, cap <= 128) of points (N, 3) f32, all contiguous; with
// exclude_self, query i skips point i. One launch on `stream`. Returns
// cudaGetLastError().
int knn_select(const void* buckets, const void* counts, const void* points, const void* queries,
               void* idx, void* dist, void* ok, int m, int table, int cap, float cell, float r2,
               int k, int exclude_self, void* stream) {
  if (m < 1 || table < 1 || cap < 1 || cap > kMaxB || k < 1 || k > kCells * cap)
    return cudaErrorInvalidValue;
  const int smem = kWarps * kCells * cap * int(sizeof(unsigned long long));
  cudaError_t err = cudaFuncSetAttribute(knn_select_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = unsigned((m + kWarps - 1) / kWarps);
  knn_select_kernel<<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(buckets), static_cast<const int*>(counts),
      static_cast<const float*>(points), static_cast<const float*>(queries),
      static_cast<int*>(idx), static_cast<float*>(dist), static_cast<unsigned char*>(ok), m,
      table, cap, cell, r2, k, exclude_self);
  return cudaGetLastError();
}

}  // extern "C"

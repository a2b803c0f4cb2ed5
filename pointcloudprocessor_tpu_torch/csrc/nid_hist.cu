// NID joint histogram (forward) and its adjoint (backward) for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of pointcloudprocessor_tpu/ops/nid_hist.py:
//   K1 nid_hist_fwd  <- _fwd_kernel (nid_hist.py:71, pallas_call at :180)
//   K2 nid_hist_bwd  <- _bwd_kernel (nid_hist.py:112, pallas_call at :201)
//
// Data, for K keyframes of N points each (row-major, contiguous):
//   taps    (K, N, 2) int32  16 4-bit image bins of the point's 4x4 B-spline
//                            window, nibble t of word t/8 at bit 4*(t%8),
//                            (dy, dx) tap order (opt/nid.pack_tap_nibbles)
//   s       (K, N, 2) f32    fractional projection offsets (sx, sy)
//   bin_pts (K, N)    int32  LiDAR-intensity bin of the point
//   inlier  (K, N)    f32    0/1 gate
//   hist    (K, bins, bins) f32, orientation [point_bin, image_bin]
//
// K1: hist[k][bp][tap_t] += by[t/4] * bx[t%4] * inlier over points and taps.
//   The TPU kernel forms a (bins, block) mass matrix and contracts it on the
//   MXU at HIGHEST precision. Here there is no product at all: each thread
//   adds its 16 weights straight into a block-private 16x16 histogram in
//   shared memory with atomicAdd, so nothing passes through a tensor core and
//   TF32 rounding (the trap the TPU code guards against with HIGHEST) cannot
//   arise. What bounds it on the H100 is the shared-memory atomics: 16 per
//   point onto only 256 addresses, which collide often because neighbouring
//   points see neighbouring pixels. The design spreads the collisions over
//   many blocks (one private histogram per block of POINTS_PER_BLOCK
//   points, grid (ceil(N / POINTS_PER_BLOCK), K), one launch for all
//   keyframes), then a second launch sums the (K, nblocks, 256) partials in a
//   fixed order, so no atomics touch global memory. Warp-private histograms,
//   TMA and wgmma are left for later work.
//
// K2: dsx[n] = inlier * sum_t dB(sx)[t%4] * B(sy)[t/4] * g[bp][tap_t], dsy
//   likewise with the derivative on the y factor. Elementwise over (K, N),
//   g[k] staged in shared memory, no atomics, deterministic. It reads about
//   28 B and writes 8 B per point, so DRAM bandwidth bounds it; the design
//   keeps one pass with coalesced loads and nothing else.
//
// The spline weights use the closed forms of _weights/_dweights
// (nid_hist.py:40-62), valid for s outside [0, 1) too.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPointsPerBlock = 2048;
constexpr int kMaxBins = 16;

__device__ __forceinline__ void bspline(float s, float b[4]) {
  const float s2 = s * s;
  const float s3 = s2 * s;
  b[0] = (1.0f - 3.0f * s + 3.0f * s2 - s3) / 6.0f;
  b[1] = (4.0f - 6.0f * s2 + 3.0f * s3) / 6.0f;
  b[2] = (1.0f + 3.0f * s + 3.0f * s2 - 3.0f * s3) / 6.0f;
  b[3] = s3 / 6.0f;
}

__device__ __forceinline__ void dbspline(float s, float d[4]) {
  const float s2 = s * s;
  d[0] = (-3.0f + 6.0f * s - 3.0f * s2) / 6.0f;
  d[1] = (-12.0f * s + 9.0f * s2) / 6.0f;
  d[2] = (3.0f + 6.0f * s - 9.0f * s2) / 6.0f;
  d[3] = 3.0f * s2 / 6.0f;
}

__device__ __forceinline__ int unpack_tap(uint32_t w0, uint32_t w1, int t) {
  const uint32_t w = t < 8 ? w0 : w1;
  return static_cast<int>((w >> (4 * (t % 8))) & 0xFu);
}

__global__ void __launch_bounds__(kThreads)
nid_hist_fwd_partial(const int2* __restrict__ taps, const float2* __restrict__ s,
                     const int* __restrict__ bin_pts,
                     const float* __restrict__ inlier,
                     float* __restrict__ partial, int n, int bins) {
  __shared__ float sh[kMaxBins * kMaxBins];
  const int k = blockIdx.y;
  const int nb = bins * bins;
  for (int i = threadIdx.x; i < nb; i += blockDim.x) sh[i] = 0.0f;
  __syncthreads();

  const long long base = static_cast<long long>(k) * n;
  const int begin = blockIdx.x * kPointsPerBlock;
  const int end = min(n, begin + kPointsPerBlock);
  for (int i = begin + threadIdx.x; i < end; i += blockDim.x) {
    const float inl = inlier[base + i];
    if (inl == 0.0f) continue;
    const int bp = bin_pts[base + i];
    if (bp < 0 || bp >= bins) continue;  // one_hot drops such a bin
    const float2 si = s[base + i];
    const int2 w = taps[base + i];
    float bx[4], by[4];
    bspline(si.x, bx);
    bspline(si.y, by);
    float* row = sh + bp * bins;
    for (int t = 0; t < 16; ++t) {
      const int tap = unpack_tap(static_cast<uint32_t>(w.x), static_cast<uint32_t>(w.y), t);
      if (tap < bins) atomicAdd(row + tap, by[t / 4] * bx[t % 4] * inl);
    }
  }
  __syncthreads();

  float* out = partial + (static_cast<long long>(k) * gridDim.x + blockIdx.x) * nb;
  for (int i = threadIdx.x; i < nb; i += blockDim.x) out[i] = sh[i];
}

__global__ void __launch_bounds__(kThreads)
nid_hist_reduce(const float* __restrict__ partial, float* __restrict__ hist,
                int nblocks, int bins) {
  const int k = blockIdx.x;
  const int nb = bins * bins;
  for (int i = threadIdx.x; i < nb; i += blockDim.x) {
    const float* p = partial + static_cast<long long>(k) * nblocks * nb + i;
    float acc = 0.0f;
    for (int b = 0; b < nblocks; ++b) acc += p[static_cast<long long>(b) * nb];
    hist[k * nb + i] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
nid_hist_bwd_kernel(const float* __restrict__ g, const int2* __restrict__ taps,
                    const float2* __restrict__ s,
                    const int* __restrict__ bin_pts,
                    const float* __restrict__ inlier, float2* __restrict__ ds,
                    int n, int bins) {
  __shared__ float gs[kMaxBins * kMaxBins];
  const int k = blockIdx.y;
  const int nb = bins * bins;
  for (int i = threadIdx.x; i < nb; i += blockDim.x) gs[i] = g[k * nb + i];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long idx = static_cast<long long>(k) * n + i;
  const float inl = inlier[idx];
  const int bp = bin_pts[idx];
  const float2 si = s[idx];
  const int2 w = taps[idx];
  float bx[4], by[4], dbx[4], dby[4];
  bspline(si.x, bx);
  bspline(si.y, by);
  dbspline(si.x, dbx);
  dbspline(si.y, dby);
  float dsx = 0.0f, dsy = 0.0f;
  if (bp >= 0 && bp < bins) {
    const float* row = gs + bp * bins;
    for (int t = 0; t < 16; ++t) {
      const int tap = unpack_tap(static_cast<uint32_t>(w.x), static_cast<uint32_t>(w.y), t);
      const float gsel = tap < bins ? row[tap] : 0.0f;
      const int ty = t / 4, tx = t % 4;
      dsx += dbx[tx] * by[ty] * gsel;
      dsy += bx[tx] * dby[ty] * gsel;
    }
  }
  ds[idx] = make_float2(dsx * inl, dsy * inl);
}

}  // namespace

extern "C" {

// Number of K1 partial blocks per keyframe, so the caller can size the
// (K, nblocks, bins*bins) scratch buffer.
int nid_hist_fwd_nblocks(int n) {
  return (n + kPointsPerBlock - 1) / kPointsPerBlock;
}

// K1: hist (K, bins, bins) from K keyframes of n points; partial is scratch of
// K * nid_hist_fwd_nblocks(n) * bins * bins floats. Returns cudaGetLastError().
int nid_hist_fwd(const void* taps, const void* s, const void* bin_pts,
                 const void* inlier, void* partial, void* hist, int k, int n,
                 int bins, void* stream) {
  if (bins < 1 || bins > kMaxBins || k < 1 || n < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nblocks = nid_hist_fwd_nblocks(n);
  nid_hist_fwd_partial<<<dim3(nblocks, k), kThreads, 0, st>>>(
      static_cast<const int2*>(taps), static_cast<const float2*>(s),
      static_cast<const int*>(bin_pts), static_cast<const float*>(inlier),
      static_cast<float*>(partial), n, bins);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  nid_hist_reduce<<<k, kThreads, 0, st>>>(static_cast<const float*>(partial),
                                          static_cast<float*>(hist), nblocks, bins);
  return cudaGetLastError();
}

// K2: ds (K, n, 2) from the upstream gradient g (K, bins, bins) of the joint
// histogram and K1's inputs. Returns cudaGetLastError().
int nid_hist_bwd(const void* g, const void* taps, const void* s,
                 const void* bin_pts, const void* inlier, void* ds, int k, int n,
                 int bins, void* stream) {
  if (bins < 1 || bins > kMaxBins || k < 1 || n < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kThreads - 1) / kThreads, k);
  nid_hist_bwd_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(g), static_cast<const int2*>(taps),
      static_cast<const float2*>(s), static_cast<const int*>(bin_pts),
      static_cast<const float*>(inlier), static_cast<float2*>(ds), n, bins);
  return cudaGetLastError();
}

}  // extern "C"

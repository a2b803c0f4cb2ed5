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
// K2: dsx[n] = inlier * sum_t dB(sx)[t%4] * B(sy)[t/4] * g[bp][tap_t], dsy
//     likewise with the derivative on the y factor.
//
// What bounds them on the H100. Both read 24 B a point (K2 also writes 8 B),
// ~50 MB at 8 x 262,144 points: 15 us (K1) and 20 us (K2) at 3.35 TB/s.
// Their arithmetic is a few dozen f32 operations a point, but the SM runs
// several times that many instructions around it, so in practice the
// instructions a point, their divergence within a warp, and the loads in
// flight bound both kernels, not the bytes. The first design ran far more
// than needed: each spline weight divided by 6 (an IEEE division routine, 8 a
// point in K1 and 16 in K2), and K1 made 16 shared-memory float atomicAdds a
// point, each a compare-and-swap loop on sm_90 (ATOMS.CAST.SPIN; there is
// no native f32 add on shared memory). The scene's inputs make that worse:
// a point's 4x4 window nearly always holds one or two image bins and the
// joint histogram is nearly diagonal, so the 16 updates pile onto a few
// cells (and row bp*16 + tap put equal taps of different point bins into one
// bank). The design now:
//   1. multiplies by 1/6;
//   2. K1 combines a point's taps before any update, without branches for a
//      point whose taps hold at most two bins: a is tap 0's bin and b the
//      first other one; nibble masks (XOR against the replicated bin, then
//      nonzero-nibble bits) mark the taps of each, a's mass is the weights
//      summed over its taps row by row, b's the point's total mass less a's.
//      That is one or two updates a point on the scene; a tap in a third
//      bin sends the point's other taps one by one (at most 15 updates on
//      random nibbles);
//   3. K1 adds into one histogram a warp, rows padded to 17 floats so that
//      equal taps of different point bins fall into different banks; the
//      block sums its warps' histograms in a fixed order;
//   4. K1 is one launch: each block writes its partial, and the last block
//      of a keyframe to arrive (a __threadfence plus one atomicInc a block on
//      a per-keyframe counter that atomicInc wraps back to 0) sums the
//      partials in block order, so the result is deterministic and nothing
//      syncs the host;
//   5. both size their grid from N and K (ops/nid_hist.grid): 4 blocks an
//      SM at both of the headline's shapes (8 x 262,144 and 8 x 16,384),
//      where the first grids left the coarse shape at 64 blocks (K1) and
//      launched a block per 256 points (K2); 5 blocks an SM, which K1's 48
//      registers allow, measured slower;
//   6. both read two points with one 16-byte load each of taps and s, and
//      start the next pair's loads before the current pair's arithmetic.
// K2 does the same for the adjoint: for a point of at most two bins,
// ds = g[a] * S_a + g[b] * (T - S_a), with S_a the derivative weights
// summed over a's taps and T over all 16, two shared-memory reads of g
// (staged once a block, rows padded to 17); otherwise each tap row's
// derivative weights are summed against g, a tap equal to the one before
// reusing its g value.
// Tried beside it and dropped, slower on the scene's inputs or no faster
// (PERF.md's table of designs holds their times): K1 with two running (bin, mass) slots a point that
// branch at every tap, those slots aggregated across the warp first
// (__match_any_sync on the cell), a 16-way select into 16 registers, the
// gate read before the rest of a pair, four histograms a warp; K2 per tap
// for every point and with the gate read first.
//
// The spline weights use the closed forms of _weights/_dweights
// (nid_hist.py:40-62), valid for s outside [0, 1) too.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBins = 16;
constexpr int kRow = kMaxBins + 1;      // a padded histogram row
constexpr int kHist = kMaxBins * kRow;  // a padded histogram
// K1's histograms, one a warp, kHist + 1 floats apart so that one cell of
// different warps' histograms falls into different banks.
constexpr int kStride = kHist + 1;

// 1/6 as a product: a division here compiles to an IEEE division routine,
// 16 of them a point in K2, which made both kernels bound by instructions.
constexpr float kSixth = 1.0f / 6.0f;

__device__ __forceinline__ void bspline(float s, float b[4]) {
  const float s2 = s * s;
  const float s3 = s2 * s;
  b[0] = (1.0f - 3.0f * s + 3.0f * s2 - s3) * kSixth;
  b[1] = (4.0f - 6.0f * s2 + 3.0f * s3) * kSixth;
  b[2] = (1.0f + 3.0f * s + 3.0f * s2 - 3.0f * s3) * kSixth;
  b[3] = s3 * kSixth;
}

__device__ __forceinline__ void dbspline(float s, float d[4]) {
  const float s2 = s * s;
  d[0] = (-3.0f + 6.0f * s - 3.0f * s2) * kSixth;
  d[1] = (-12.0f * s + 9.0f * s2) * kSixth;
  d[2] = (3.0f + 6.0f * s - 9.0f * s2) * kSixth;
  d[3] = 3.0f * s2 * kSixth;
}

__device__ __forceinline__ int unpack_tap(uint32_t w0, uint32_t w1, int t) {
  const uint32_t w = t < 8 ? w0 : w1;
  return static_cast<int>((w >> (4 * (t % 8))) & 0xFu);
}

// Bit 4i of the result is set where nibble i of x is nonzero.
__device__ __forceinline__ uint32_t nonzero_nibbles(uint32_t x) {
  x |= x >> 1;
  x |= x >> 2;
  return x & 0x11111111u;
}

// One point's inputs.
struct Point {
  uint32_t w0, w1;  // packed taps
  float sx, sy;
  int bp;
  float inl;        // 0 for a gated-out point or one outside the block's keyframe
};

// The pair of points 2j, 2j+1 of arrays that start at the keyframe's first
// pair (see Range); a point outside [lo, hi) (another keyframe's, or past
// the end) gets inl = 0 and is not read. With kVec the pointers are 16-byte
// (taps, s) and 8-byte (bin_pts, inlier) aligned, and a pair inside the
// keyframe is read with one load of each. All loads of a pair start
// together.
template <bool kVec>
__device__ __forceinline__ void load_pair(const int2* __restrict__ taps,
                                          const float2* __restrict__ s,
                                          const int* __restrict__ bin_pts,
                                          const float* __restrict__ inlier, int j, int lo,
                                          int hi, Point& a, Point& b) {
  const int p = 2 * j;
  const bool in0 = p >= lo && p < hi, in1 = p + 1 >= lo && p + 1 < hi;
  if (kVec && in0 && in1) {
    const float2 g = __ldg(reinterpret_cast<const float2*>(inlier) + j);
    const int4 t = __ldg(reinterpret_cast<const int4*>(taps) + j);
    const float4 f = __ldg(reinterpret_cast<const float4*>(s) + j);
    const int2 q = __ldg(reinterpret_cast<const int2*>(bin_pts) + j);
    a.inl = g.x; b.inl = g.y;
    a.w0 = t.x; a.w1 = t.y; b.w0 = t.z; b.w1 = t.w;
    a.sx = f.x; a.sy = f.y; b.sx = f.z; b.sy = f.w;
    a.bp = q.x; b.bp = q.y;
    return;
  }
  a.inl = in0 ? __ldg(inlier + p) : 0.0f;
  b.inl = in1 ? __ldg(inlier + p + 1) : 0.0f;
  if (in0) {
    const int2 t = __ldg(taps + p);
    const float2 f = __ldg(s + p);
    a.w0 = t.x; a.w1 = t.y; a.sx = f.x; a.sy = f.y; a.bp = __ldg(bin_pts + p);
  }
  if (in1) {
    const int2 t = __ldg(taps + p + 1);
    const float2 f = __ldg(s + p + 1);
    b.w0 = t.x; b.w1 = t.y; b.sx = f.x; b.sy = f.y; b.bp = __ldg(bin_pts + p + 1);
  }
}

// One point into histogram ``wh``, without branches for a point whose taps
// hold at most two bins: a is tap 0's bin, b the first other one. Nibble
// masks mark the taps equal to each; a's mass is the spline weights summed
// over its taps (row by row, each row's sum weighted by its y weight), and
// b's the rest of the point's total mass. A tap in a third bin (rare on a
// smooth image) sends the point's taps outside a to the histogram one by one.
__device__ __forceinline__ void hist_point_masks(float* wh, const Point& p, int bins) {
  if (p.inl == 0.0f || p.bp < 0 || p.bp >= bins) return;  // one_hot drops other bins
  float bx[4], by[4];
  bspline(p.sx, bx);
  bspline(p.sy, by);
  const int row = p.bp * kRow;
  const uint32_t a = p.w0 & 0xFu;
  const uint32_t na0 = nonzero_nibbles(p.w0 ^ a * 0x11111111u);
  const uint32_t na1 = nonzero_nibbles(p.w1 ^ a * 0x11111111u);
  // Taps not in a: bit 4*(t % 8) of na0 (t < 8) or na1 (t >= 8).
  float ma = 0.0f;
#pragma unroll
  for (int ty = 0; ty < 4; ++ty) {
    const uint32_t na = ty < 2 ? na0 : na1;
    float r = 0.0f;
#pragma unroll
    for (int tx = 0; tx < 4; ++tx)
      if (!(na & (1u << (4 * ((ty * 4 + tx) % 8))))) r += bx[tx];
    ma = fmaf(by[ty], r, ma);
  }
  ma *= p.inl;
  if (a < static_cast<uint32_t>(bins)) atomicAdd(wh + row + a, ma);
  if ((na0 | na1) == 0u) return;  // one bin
  const uint32_t wb = na0 ? p.w0 : p.w1;
  const uint32_t b = (wb >> (__ffs(na0 ? na0 : na1) - 1)) & 0xFu;
  const uint32_t other0 = na0 & nonzero_nibbles(p.w0 ^ b * 0x11111111u);
  const uint32_t other1 = na1 & nonzero_nibbles(p.w1 ^ b * 0x11111111u);
  if ((other0 | other1) == 0u) {
    const float total = (((by[0] + by[1]) + by[2]) + by[3]) * (((bx[0] + bx[1]) + bx[2]) + bx[3]);
    if (b < static_cast<uint32_t>(bins)) atomicAdd(wh + row + b, total * p.inl - ma);
    return;
  }
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    const int v = unpack_tap(p.w0, p.w1, t);
    if (v != static_cast<int>(a) && v < bins) atomicAdd(wh + row + v, by[t / 4] * bx[t % 4] * p.inl);
  }
}

// ds of one point. For a point whose taps hold at most two bins, a (tap
// 0's) and b, ds = g[a] * S_a + g[b] * (T - S_a), where S_a sums the
// derivative weights over a's taps (the nibble masks of hist_point_masks)
// and T over all 16; no branch and two shared-memory reads. Otherwise each
// tap row's derivative weights are summed against g (a tap equal to the one
// before reuses its g value), then weighted by the row's spline weight.
__device__ __forceinline__ float2 grad_point(const float* gs, const Point& p, int bins) {
  if (p.inl == 0.0f || p.bp < 0 || p.bp >= bins) return make_float2(0.0f, 0.0f);
  float bx[4], by[4], dbx[4], dby[4];
  bspline(p.sx, bx);
  bspline(p.sy, by);
  dbspline(p.sx, dbx);
  dbspline(p.sy, dby);
  const float* row = gs + p.bp * kRow;
  float dsx = 0.0f, dsy = 0.0f;
  const uint32_t a = p.w0 & 0xFu;
  const uint32_t na0 = nonzero_nibbles(p.w0 ^ a * 0x11111111u);
  const uint32_t na1 = nonzero_nibbles(p.w1 ^ a * 0x11111111u);
  uint32_t b = a, other = 0u;
  if (na0 | na1) {
    b = ((na0 ? p.w0 : p.w1) >> (__ffs(na0 ? na0 : na1) - 1)) & 0xFu;
    other = (na0 & nonzero_nibbles(p.w0 ^ b * 0x11111111u)) |
            (na1 & nonzero_nibbles(p.w1 ^ b * 0x11111111u));
  }
  if (other == 0u) {
    float sx = 0.0f, sy = 0.0f;
#pragma unroll
    for (int ty = 0; ty < 4; ++ty) {
      const uint32_t na = ty < 2 ? na0 : na1;
      float rx = 0.0f, ry = 0.0f;
#pragma unroll
      for (int tx = 0; tx < 4; ++tx) {
        if (!(na & (1u << (4 * ((ty * 4 + tx) % 8))))) {
          rx += dbx[tx];
          ry += bx[tx];
        }
      }
      sx = fmaf(by[ty], rx, sx);
      sy = fmaf(dby[ty], ry, sy);
    }
    const float ga = a < static_cast<uint32_t>(bins) ? row[a] : 0.0f;
    const float gb = b < static_cast<uint32_t>(bins) ? row[b] : 0.0f;
    const float all_x = (((by[0] + by[1]) + by[2]) + by[3]) * (((dbx[0] + dbx[1]) + dbx[2]) + dbx[3]);
    const float all_y = (((dby[0] + dby[1]) + dby[2]) + dby[3]) * (((bx[0] + bx[1]) + bx[2]) + bx[3]);
    dsx = fmaf(ga, sx, gb * (all_x - sx));
    dsy = fmaf(ga, sy, gb * (all_y - sy));
    return make_float2(dsx * p.inl, dsy * p.inl);
  }
  int prev = -1;
  float gsel = 0.0f;
#pragma unroll
  for (int ty = 0; ty < 4; ++ty) {
    float rx = 0.0f, ry = 0.0f;
#pragma unroll
    for (int tx = 0; tx < 4; ++tx) {
      const int tap = unpack_tap(p.w0, p.w1, ty * 4 + tx);
      if (tap != prev) {
        gsel = tap < bins ? row[tap] : 0.0f;
        prev = tap;
      }
      rx = fmaf(dbx[tx], gsel, rx);
      ry = fmaf(bx[tx], gsel, ry);
    }
    dsx = fmaf(by[ty], rx, dsx);
    dsy = fmaf(dby[ty], ry, dsy);
  }
  return make_float2(dsx * p.inl, dsy * p.inl);
}

// Block bx of keyframe k: pairs [j0, j1) counted from the keyframe's first
// pair ``first`` = floor(k * N / 2) of the flattened arrays (points 2j and
// 2j+1 from point 2 * first), of which the keyframe's points are [lo, hi)
// (lo is 0 or 1). The kernels move their pointers to ``first`` once and
// index in 32 bits.
struct Range {
  long long first;
  int lo, hi, j0, j1;
};

__device__ __forceinline__ Range block_range(int n, int ppb) {
  Range r;
  const long long start = static_cast<long long>(blockIdx.y) * n;
  r.first = start >> 1;
  r.lo = static_cast<int>(start - 2 * r.first);
  r.hi = r.lo + n;
  const int pairs = (r.hi + 1) >> 1;
  r.j0 = blockIdx.x * ppb;
  r.j1 = min(pairs, r.j0 + ppb);
  return r;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
nid_hist_fwd_kernel(const int2* __restrict__ taps, const float2* __restrict__ s,
                    const int* __restrict__ bin_pts, const float* __restrict__ inlier,
                    float* __restrict__ partial, unsigned* __restrict__ arrive,
                    float* __restrict__ hist, int n, int bins, int ppb) {
  __shared__ float sh[kWarps * kStride];
  __shared__ bool last;
  for (int i = threadIdx.x; i < kWarps * kStride; i += kThreads) sh[i] = 0.0f;
  __syncthreads();

  const Range r = block_range(n, ppb);
  taps += 2 * r.first;
  s += 2 * r.first;
  bin_pts += 2 * r.first;
  inlier += 2 * r.first;
  float* wh = sh + (threadIdx.x / 32) * kStride;
  // One pair a thread a step; the next step's pair is loaded before this
  // step's arithmetic, so that its loads are in flight meanwhile.
  int j = r.j0 + threadIdx.x;
  Point pa = {}, pb = {};
  if (j < r.j1) load_pair<kVec>(taps, s, bin_pts, inlier, j, r.lo, r.hi, pa, pb);
  for (; j < r.j1; j += kThreads) {
    Point qa = {}, qb = {};
    if (j + kThreads < r.j1)
      load_pair<kVec>(taps, s, bin_pts, inlier, j + kThreads, r.lo, r.hi, qa, qb);
    hist_point_masks(wh, pa, bins);
    hist_point_masks(wh, pb, bins);
    pa = qa;
    pb = qb;
  }
  __syncthreads();

  // The block's partial: its warps' histograms summed in a fixed order.
  const int nb = bins * bins;
  const long long k = blockIdx.y;
  const int per_kf = gridDim.x;
  float* mine = partial + (k * per_kf + blockIdx.x) * nb;
  for (int c = threadIdx.x; c < nb; c += kThreads) {
    const int cell = (c / bins) * kRow + c % bins;
    float acc = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) acc += sh[w * kStride + cell];
    mine[c] = acc;
  }
  // The last block of the keyframe to arrive sums the partials in block
  // order. atomicInc wraps the counter back to 0 for the next launch.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicInc(arrive + k, per_kf - 1) == static_cast<unsigned>(per_kf - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* all = partial + k * per_kf * nb;
  for (int c = threadIdx.x; c < nb; c += kThreads) {
    // 32 loads in flight at a time, added in block order.
    float acc = 0.0f;
    int blk = 0;
    for (; blk + 32 <= per_kf; blk += 32) {
      float v[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) v[i] = __ldcg(all + static_cast<long long>(blk + i) * nb + c);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc += v[i];
    }
    for (; blk < per_kf; ++blk) acc += __ldcg(all + static_cast<long long>(blk) * nb + c);
    hist[k * nb + c] = acc;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
nid_hist_bwd_kernel(const float* __restrict__ g, const int2* __restrict__ taps,
                    const float2* __restrict__ s, const int* __restrict__ bin_pts,
                    const float* __restrict__ inlier, float2* __restrict__ ds, int n,
                    int bins, int ppb) {
  __shared__ float gs[kHist];
  const long long k = blockIdx.y;
  const int nb = bins * bins;
  for (int c = threadIdx.x; c < nb; c += kThreads) gs[(c / bins) * kRow + c % bins] = g[k * nb + c];
  __syncthreads();

  const Range r = block_range(n, ppb);
  taps += 2 * r.first;
  s += 2 * r.first;
  bin_pts += 2 * r.first;
  inlier += 2 * r.first;
  ds += 2 * r.first;
  // One pair a thread a step, the next one's loads started first (as in K1).
  int j = r.j0 + threadIdx.x;
  Point pa = {}, pb = {};
  if (j < r.j1) load_pair<kVec>(taps, s, bin_pts, inlier, j, r.lo, r.hi, pa, pb);
  for (; j < r.j1; j += kThreads) {
    Point qa = {}, qb = {};
    if (j + kThreads < r.j1)
      load_pair<kVec>(taps, s, bin_pts, inlier, j + kThreads, r.lo, r.hi, qa, qb);
    const float2 d0 = grad_point(gs, pa, bins), d1 = grad_point(gs, pb, bins);
    const int p0 = 2 * j;
    const bool in0 = p0 >= r.lo && p0 < r.hi, in1 = p0 + 1 >= r.lo && p0 + 1 < r.hi;
    if (kVec && in0 && in1) {
      reinterpret_cast<float4*>(ds)[j] = make_float4(d0.x, d0.y, d1.x, d1.y);
    } else {
      if (in0) ds[p0] = d0;
      if (in1) ds[p0 + 1] = d1;
    }
    pa = qa;
    pb = qb;
  }
}

bool aligned(const void* p, uintptr_t a) { return reinterpret_cast<uintptr_t>(p) % a == 0; }

// The launch geometry the caller chose (ops/nid_hist.grid): per_kf blocks of
// ppb point pairs a keyframe must cover the keyframe's ceil(N/2) pairs.
bool valid_grid(int k, int n, int bins, int per_kf, int ppb) {
  return bins >= 1 && bins <= kMaxBins && k >= 1 && k <= 65535 && n >= 1 && per_kf >= 1 &&
         ppb >= 1 && static_cast<long long>(per_kf) * ppb >= (static_cast<long long>(n) + 1) / 2;
}

}  // namespace

extern "C" {

// K1: hist (K, bins, bins) from K keyframes of n points, in one launch of
// (per_kf, K) blocks of ppb point pairs. partial is scratch of at least
// K * per_kf * bins * bins floats; arrive holds K counters that are 0 before
// the first launch and are left at 0 by each. Returns cudaGetLastError().
int nid_hist_fwd(const void* taps, const void* s, const void* bin_pts, const void* inlier,
                 void* partial, void* arrive, void* hist, int k, int n, int bins, int per_kf,
                 int ppb, void* stream) {
  if (!valid_grid(k, n, bins, per_kf, ppb)) return cudaErrorInvalidValue;
  const bool vec = aligned(taps, 16) && aligned(s, 16) && aligned(bin_pts, 8) && aligned(inlier, 8);
  auto kernel = vec ? nid_hist_fwd_kernel<true> : nid_hist_fwd_kernel<false>;
  kernel<<<dim3(per_kf, k), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int2*>(taps), static_cast<const float2*>(s),
      static_cast<const int*>(bin_pts), static_cast<const float*>(inlier),
      static_cast<float*>(partial), static_cast<unsigned*>(arrive), static_cast<float*>(hist), n,
      bins, ppb);
  return cudaGetLastError();
}

// K2: ds (K, n, 2) from the upstream gradient g (K, bins, bins) of the joint
// histogram and K1's inputs, on the same (per_kf, K) grid. Returns
// cudaGetLastError().
int nid_hist_bwd(const void* g, const void* taps, const void* s, const void* bin_pts,
                 const void* inlier, void* ds, int k, int n, int bins, int per_kf, int ppb,
                 void* stream) {
  if (!valid_grid(k, n, bins, per_kf, ppb)) return cudaErrorInvalidValue;
  const bool vec = aligned(taps, 16) && aligned(s, 16) && aligned(bin_pts, 8) &&
                   aligned(inlier, 8) && aligned(ds, 16);
  auto kernel = vec ? nid_hist_bwd_kernel<true> : nid_hist_bwd_kernel<false>;
  kernel<<<dim3(per_kf, k), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const int2*>(taps),
      static_cast<const float2*>(s), static_cast<const int*>(bin_pts),
      static_cast<const float*>(inlier), static_cast<float2*>(ds), n, bins, ppb);
  return cudaGetLastError();
}

}  // extern "C"

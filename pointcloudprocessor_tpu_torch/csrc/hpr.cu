// Hidden-point removal for Hopper (sm_90a): the dense support test (H1) and
// the grid parabolic z-buffer (H2).
//
// Both replace ops that XLA emits on the TPU without a Pallas source:
//   H1 hpr_support <- pointcloudprocessor_tpu/ops/hpr.py:57-123 (hpr_mask:
//                     spherical flip, blocked (N,3)x(3,N) max-reduction at
//                     Precision.HIGHEST, support test)
//   H2 hpr_grid    <- pointcloudprocessor_tpu/ops/hpr.py:126-208
//                     (hpr_mask_grid with _erode_parabolic_axis)
// Inputs of both: camera-frame x, y, z (N,) f32 and the caller's gate valid
// (N,) bool, each with its element stride; out: the (N,) bool mask. H2
// takes a batch of K keyframes, each with its own columns (a keyframe
// stride beside the element stride), and writes a (K, N) mask.
//
// H1, two launches.
//   hpr_flip     per point: r = sqrt(fma(z, z, fma(y, y, x*x))) (XLA's and
//                torch's vector norm on the CPU), ok = valid && r >
//                1e-9, u = p / max(r, 1e-12), f = ok ? u * (2R - r) : 0;
//                writes f (N, 4) and u with the self support 2R - r in its
//                fourth lane (NaN where not ok, so the test fails there).
//                An ok point with r = inf has a NaN flip, which makes every
//                support NaN in the plain version (max propagates NaN): such
//                a point sets a flag that hides every point.
//   hpr_support  support_i = max_j <f_j, u_i>, the test support_i - self_i
//                <= tol. A block owns 512 directions, 4 a thread in
//                registers; flipped points stream through shared memory in
//                tiles of 512; the N x N matrix is never written. f32 FMA
//                only, never TF32 (hpr.py:29-31: bf16 buries the depth
//                signal). The dot is fma(z, z', fma(y, y', x * x')), the
//                chain of XLA's CPU dot and torch's CPU matmul, and the norm
//                is theirs too, so the mask equals the plain version run on
//                the CPU bit for bit. (On the card torch's norm and cuBLAS
//                round otherwise: supports drift by up to 4 ulp of 2R.)
//   Bound: N^2 x 3 FMA at the card's f32 rate (67 TFLOP/s, 33.5 T FMA/s):
//   6.2 ms at 262,144 points. Each pair costs 3 FMA-pipe ops and a max, so
//   the FMAs alone can fill at most ~3/4 of the pipe.
//
// H2, one memset and four launches for a batch of K keyframes, nothing on
// the host between them. Each keyframe keeps its own bounds, its own G x G
// key grid and eroded buffer (scratch (K, G*G + 8) u32, eroded (K, G*G)
// f32: 8 MB each at G = 512, K = 8); blockIdx.y (the erosion's blockIdx.z)
// picks the keyframe. The four passes stay four launches in stream order:
// no block waits on another, so no pass needs the grid resident.
//   memset       the K (G*G + 8) u32 scratch to all ones: the cell keys'
//                fill and the bounds' empty state.
//   hpr_bounds   per point: the gate ok = valid && z > 1e-9 && r > 1e-9,
//                the gnomonic coords ax = x / max(z, 1e-9), ay; block
//                min / max of the gated coords (a grid-stride loop over at
//                most 4 blocks an SM a keyframe), then atomics on their
//                order keys (the maximum as the minimum of the complement).
//                A NaN coordinate of a gated point sets its axis' flag: the
//                plain min / max propagate NaN.
//   hpr_scatter  per point: the same gate, the cell clamp(trunc((ax - lo)
//                / cu)) with cu = max((hi - lo) / G, 1e-9); a gated point
//                issues atomicMin of its range's bits (r > 0: the f32 bits
//                order as the floats do; a gated-out point issues nothing).
//   hpr_erode    a block per 32 x 32 tile of cells (K x 256 tiles at G =
//                512): reads the keys of its tile with a window-wide halo
//                into shared memory (decoded as min(float(key), FLT_MAX):
//                the all-ones fill is a NaN, which fminf drops), erodes
//                along v (rows, cv) into shared memory and along u (columns,
//                cu) into the (G, G) f32 buffer: m'[c] = min_{|k|<=w} m[c+k]
//                + R*((k-w)*cell)^2 with the outside read as FLT_MAX, both
//                passes in one launch.
//   hpr_test     per point: the same gate and cell, vis = ok && !(eroded
//                < r - tol).
//   Each f32 step is written with __f*_rn in the JAX package's order, so
//   nvcc contracts nothing into an FMA (r, the penalty, sl + pen), and the
//   mask equals the plain version's bit for bit: divisions are IEEE
//   (__fdiv_rn), casts truncate and saturate (__float2int_rz, NaN -> 0,
//   as XLA and utils/numeric.to_int32 cast), FLT_MAX + pen overflows to
//   +inf as it does there, and a min with a NaN is NaN (a NaN penalty, the
//   only NaN an erosion meets, makes every cell NaN).
//   Bound, camera-frame points: their bytes, K x 14 B a point read or
//   written once (13 in, 1 out): 4.2 us a keyframe at 1M points, 33 us for
//   8 keyframes; the three passes over the points read 40 B a point (11.9
//   us a keyframe). Views: the world points read once (13 B a point) and K
//   B a point out, 6.3 us for 8 views of 1M points, below the ~64 f32
//   operations a point and view (the transform, the pixel, the range, the
//   bearing and the cell) and the erosion's, 11.8 us for 8 at 67 TFLOP/s. The erosion is 2 x G^2 x 33 min-adds a keyframe (17 M at G =
//   512), the scatter 1M atomics a keyframe into its 1 MB buffer, which
//   lives in L2. One launch of each pass for the batch: a keyframe alone
//   left the erosion's 256 tiles under two waves of the 132 SMs, and the
//   gaps between its five launches took 7 of its 48 us.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

#include "zbuffer.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;  // points a thread of H2's scatter and test takes

// ---------------------------------------------------------------------------
// Shared: the points and the key encodings
// ---------------------------------------------------------------------------

// H1's points, and H2's in one of two forms. Camera-frame columns: x, y, z
// and the gate valid, each with its element stride and, in H2's batch, its
// keyframe stride. World points seen by views (R not null; H2): x, y, z
// and valid are the world points' columns, the same for every keyframe, and
// keyframe kf's camera-frame point is R[kf] p + t[kf] (R row-major),
// projected through the camera's intrinsics (fx, fy, cx, cy) and
// distortion (k1, k2, p1, p2, k3); its gate is valid, z > 0 and u, v
// unfloored in the width x height image (the colorize HPR cull's,
// pipeline/colorize.py).
struct Points {
  const float* x;
  const float* y;
  const float* z;
  const unsigned char* valid;
  long long sx, sy, sz, sv;  // element strides
  long long kx, ky, kz, kv;  // keyframe strides (H2's batch; 0 for H1 and views)
  const float* R;            // (K, 3, 3) rotations, or null
  const float* t;            // (K, 3) translations
  const float* intr;         // 4 floats
  const float* dist;         // 5 floats
  float width, height;

  // Keyframe kf's columns or view.
  __device__ __forceinline__ Points view(int kf) const {
    return Points{x + kf * kx, y + kf * ky, z + kf * kz, valid + kf * kv, sx, sy, sz, sv,
                  0, 0, 0, 0, R ? R + 9 * kf : nullptr, t ? t + 3 * kf : nullptr, intr, dist,
                  width, height};
  }
};

// A block's view (pose, then camera), staged in shared memory; null for
// camera-frame points. Every thread of the block must call it.
struct View {
  float pose[12];
  float cam[9];
};

__device__ __forceinline__ const View* stage_view(const Points& p) {
  __shared__ View v;
  if (p.R == nullptr) return nullptr;
  const int i = threadIdx.x;
  if (i < 9) v.pose[i] = p.R[i];
  else if (i < 12) v.pose[i] = p.t[i - 9];
  else if (i < 16) v.cam[i - 12] = p.intr[i - 12];
  else if (i < 21) v.cam[i - 12] = p.dist[i - 16];
  __syncthreads();
  return &v;
}

__device__ __forceinline__ float qnan() { return __int_as_float(0x7fffffff); }

// r = sqrt((x*x + y*y) + z*z), rounded step by step as hpr_mask_grid
// writes it (hpr.py:162).
__device__ __forceinline__ float range3(float x, float y, float z) {
  return __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z)));
}

// Order-preserving f32 <-> u32 map (every non-NaN float; -0 below +0).
__device__ __forceinline__ unsigned okey(float f) {
  const int b = __float_as_int(f);
  return unsigned(b ^ ((b >> 31) & 0x7fffffff)) ^ 0x80000000u;
}
__device__ __forceinline__ float okey_decode(unsigned k) {
  const int b = int(k ^ 0x80000000u);
  return __int_as_float(b ^ ((b >> 31) & 0x7fffffff));
}

// ---------------------------------------------------------------------------
// H1: dense support test
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
hpr_flip(Points p, float4* __restrict__ f, float4* __restrict__ u, unsigned* __restrict__ poison,
         int n, float two_r) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float x = __ldg(p.x + i * p.sx), y = __ldg(p.y + i * p.sy), z = __ldg(p.z + i * p.sz);
  const float r = __fsqrt_rn(__fmaf_rn(z, z, __fmaf_rn(y, y, __fmul_rn(x, x))));
  const bool ok = __ldg(p.valid + i * p.sv) && r > 1e-9f;
  const float inv = fmaxf(r, 1e-12f);
  const float ux = __fdiv_rn(x, inv), uy = __fdiv_rn(y, inv), uz = __fdiv_rn(z, inv);
  const float s = __fsub_rn(two_r, r);
  float4 fi = make_float4(0.f, 0.f, 0.f, 0.f), ui = make_float4(0.f, 0.f, 0.f, qnan());
  if (ok) {
    fi = make_float4(__fmul_rn(ux, s), __fmul_rn(uy, s), __fmul_rn(uz, s), 0.f);
    ui = make_float4(ux, uy, uz, s);
    if (!(isfinite(fi.x) && isfinite(fi.y) && isfinite(fi.z))) atomicOr(poison, 1u);
  }
  f[i] = fi;
  u[i] = ui;
}

constexpr int kDirs = 4;                      // directions a thread
constexpr int kSupThreads = 128;              // a block: 512 directions
constexpr int kTile = 512;                    // flipped points a shared-memory tile

__global__ void __launch_bounds__(kSupThreads)
hpr_support_kernel(const float4* __restrict__ f, const float4* __restrict__ u,
                   const unsigned* __restrict__ poison, unsigned char* __restrict__ vis, int n,
                   float tol) {
  __shared__ float4 tile[kTile];
  const long long base = (long long)blockIdx.x * kSupThreads * kDirs;
  float ux[kDirs], uy[kDirs], uz[kDirs], best[kDirs];
#pragma unroll
  for (int d = 0; d < kDirs; ++d) {
    const long long i = base + threadIdx.x + d * kSupThreads;
    const float4 v = i < n ? u[i] : make_float4(0.f, 0.f, 0.f, 0.f);
    ux[d] = v.x;
    uy[d] = v.y;
    uz[d] = v.z;
    best[d] = -INFINITY;
  }
  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int m = min(kTile, n - t0);
    __syncthreads();
    for (int j = threadIdx.x; j < m; j += kSupThreads) tile[j] = f[t0 + j];
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < m; ++j) {
      const float4 fj = tile[j];
#pragma unroll
      for (int d = 0; d < kDirs; ++d)
        best[d] = fmaxf(best[d], fmaf(fj.z, uz[d], fmaf(fj.y, uy[d], __fmul_rn(fj.x, ux[d]))));
    }
  }
  const bool poisoned = *poison != 0;
#pragma unroll
  for (int d = 0; d < kDirs; ++d) {
    const long long i = base + threadIdx.x + d * kSupThreads;
    if (i < n) {
      const float self = u[i].w;  // 2R - r, NaN where not ok
      vis[i] = (!poisoned && __fsub_rn(best[d], self) <= tol) ? 1 : 0;
    }
  }
}

// ---------------------------------------------------------------------------
// H2: grid parabolic z-buffer
// ---------------------------------------------------------------------------

// Scratch words after the G*G cell keys (all ones = empty after the memset).
enum { kLoX, kNotHiX, kLoY, kNotHiY, kNanX, kNanY, kBoundWords = 8 };

// Point i's range, gnomonic coords and gate (hpr.py:165-170), in its
// view where vw is not null (the transform and the pixel of csrc/zbuffer.cuh,
// rounded as the eager ops in front of the camera-frame form round them).
// The caller's gate is read first: a point it drops reads no coordinate.
__device__ __forceinline__ bool gate(const Points& p, const View* vw, long long i, float& r,
                                     float& ax, float& ay) {
  if (!__ldg(p.valid + i * p.sv)) return false;
  float x = __ldg(p.x + i * p.sx), y = __ldg(p.y + i * p.sy), z = __ldg(p.z + i * p.sz);
  if (vw != nullptr) {
    const float px = x, py = y, pz = z;
    float u, v;
    zbuf::transform(vw->pose, px, py, pz, x, y, z);
    // Wherever ok (z > 1e-9) the projection's x / z and y / z are the
    // bearing's: the same divisions.
    zbuf::pixel(vw->cam, x, y, z, u, v, ax, ay);
    if (!(z > 0.0f && u >= 0.0f && u < p.width && v >= 0.0f && v < p.height)) return false;
  } else {
    const float zz = fmaxf(z, 1e-9f);  // z itself wherever ok
    ax = __fdiv_rn(x, zz);
    ay = __fdiv_rn(y, zz);
  }
  r = range3(x, y, z);
  return z > 1e-9f && r > 1e-9f;
}

struct GridParams {
  float lo_x, lo_y, cu, cv;
};

// jnp.maximum(d / G, 1e-9) with NaN kept.
__device__ __forceinline__ float cell_size(float lo, float hi, int g) {
  const float d = __fdiv_rn(__fsub_rn(hi, lo), float(g));
  return d != d ? d : fmaxf(d, 1e-9f);
}

__device__ __forceinline__ GridParams grid_params(const unsigned* __restrict__ bnd, int g) {
  float lo_x = bnd[kLoX] == ~0u ? INFINITY : okey_decode(bnd[kLoX]);
  float hi_x = bnd[kNotHiX] == ~0u ? -INFINITY : okey_decode(~bnd[kNotHiX]);
  float lo_y = bnd[kLoY] == ~0u ? INFINITY : okey_decode(bnd[kLoY]);
  float hi_y = bnd[kNotHiY] == ~0u ? -INFINITY : okey_decode(~bnd[kNotHiY]);
  if (bnd[kNanX] == 0) lo_x = hi_x = qnan();
  if (bnd[kNanY] == 0) lo_y = hi_y = qnan();
  return GridParams{lo_x, lo_y, cell_size(lo_x, hi_x, g), cell_size(lo_y, hi_y, g)};
}

// The keyframe's grid parameters, decoded once a block. Every thread of the
// block must call it.
__device__ __forceinline__ GridParams block_params(const unsigned* __restrict__ bnd, int g) {
  __shared__ GridParams gp;
  if (threadIdx.x == 0) gp = grid_params(bnd, g);
  __syncthreads();
  return gp;
}

__device__ __forceinline__ int grid_cell(const GridParams& gp, float ax, float ay, int g) {
  const int iu = min(max(__float2int_rz(__fdiv_rn(__fsub_rn(ax, gp.lo_x), gp.cu)), 0), g - 1);
  const int iv = min(max(__float2int_rz(__fdiv_rn(__fsub_rn(ay, gp.lo_y), gp.cv)), 0), g - 1);
  return iv * g + iu;
}

// A grid-stride loop over at most kBoundBlocks blocks: each block's four
// atomics land on the same four words, so fewer blocks contend less.
constexpr int kBoundBlocks = 4 * 132;

// Keyframe kf's scratch: its G*G cell keys, then its bound words.
__device__ __forceinline__ unsigned* kf_keys(unsigned* scratch, int kf, int g) {
  return scratch + (long long)kf * ((long long)g * g + kBoundWords);
}

__global__ void __launch_bounds__(kThreads)
hpr_bounds(Points pts, unsigned* __restrict__ scratch, int n, int g) {
  __shared__ float red[4][kThreads / 32];
  const Points p = pts.view(blockIdx.y);
  const View* vw = stage_view(p);
  unsigned* bnd = kf_keys(scratch, blockIdx.y, g) + (long long)g * g;
  __shared__ int nan_flags[2];
  if (threadIdx.x < 2) nan_flags[threadIdx.x] = 0;
  __syncthreads();
  float lo_x = INFINITY, hi_x = -INFINITY, lo_y = INFINITY, hi_y = -INFINITY;
#pragma unroll 4
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    float r, ax, ay;
    if (gate(p, vw, i, r, ax, ay)) {
      if (ax != ax) {
        nan_flags[0] = 1;
      } else {
        lo_x = fminf(lo_x, ax);
        hi_x = fmaxf(hi_x, ax);
      }
      if (ay != ay) {
        nan_flags[1] = 1;
      } else {
        lo_y = fminf(lo_y, ay);
        hi_y = fmaxf(hi_y, ay);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo_x = fminf(lo_x, __shfl_xor_sync(0xffffffffu, lo_x, o));
    hi_x = fmaxf(hi_x, __shfl_xor_sync(0xffffffffu, hi_x, o));
    lo_y = fminf(lo_y, __shfl_xor_sync(0xffffffffu, lo_y, o));
    hi_y = fmaxf(hi_y, __shfl_xor_sync(0xffffffffu, hi_y, o));
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[0][warp] = lo_x;
    red[1][warp] = hi_x;
    red[2][warp] = lo_y;
    red[3][warp] = hi_y;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) {
      red[0][0] = fminf(red[0][0], red[0][w]);
      red[1][0] = fmaxf(red[1][0], red[1][w]);
      red[2][0] = fminf(red[2][0], red[2][w]);
      red[3][0] = fmaxf(red[3][0], red[3][w]);
    }
    // An empty block's +-inf keys are never below the fill's, or are the
    // extremes the plain version would keep anyway.
    if (red[0][0] != INFINITY) atomicMin(bnd + kLoX, okey(red[0][0]));
    if (red[1][0] != -INFINITY) atomicMin(bnd + kNotHiX, ~okey(red[1][0]));
    if (red[2][0] != INFINITY) atomicMin(bnd + kLoY, okey(red[2][0]));
    if (red[3][0] != -INFINITY) atomicMin(bnd + kNotHiY, ~okey(red[3][0]));
    if (nan_flags[0]) atomicMin(bnd + kNanX, 0u);
    if (nan_flags[1]) atomicMin(bnd + kNanY, 0u);
  }
}

__global__ void __launch_bounds__(kThreads)
hpr_scatter(Points pts, unsigned* __restrict__ scratch, int n, int g) {
  const Points p = pts.view(blockIdx.y);
  const View* vw = stage_view(p);
  unsigned* keys = kf_keys(scratch, blockIdx.y, g);
  const GridParams gp = block_params(keys + (long long)g * g, g);
  const long long base = (long long)blockIdx.x * kThreads * kPerThread + threadIdx.x;
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const long long i = base + q * kThreads;
    float r, ax, ay;
    if (i < n && gate(p, vw, i, r, ax, ay))
      atomicMin(keys + grid_cell(gp, ax, ay, g), __float_as_uint(r));  // r > 0
  }
}

constexpr int kErodeTile = 32;

// The penalty R * ((k - w) * cell)^2 of tap k, rounded as hpr.py:137.
__device__ __forceinline__ float penalty(float radius, int k, int w, float cell) {
  const float t = __fmul_rn(float(k - w), cell);
  return __fmul_rn(radius, __fmul_rn(t, t));
}

constexpr int kErodeRows = 4;  // rows a thread erodes at once: 4 independent min chains

// a[] holds no NaN (min(key, FLT_MAX)) and pen >= 0, so a sum is NaN only
// where its penalty is; a NaN penalty (a NaN or infinite cell) makes every
// in-grid cell NaN, as the plain version's NaN-propagating min does. So the
// taps take fminf, and such a keyframe's cells are written NaN.
__global__ void __launch_bounds__(kThreads)
hpr_erode(unsigned* __restrict__ scratch, float* __restrict__ eroded, int g, int w,
          float radius) {
  extern __shared__ float sm[];
  const unsigned* keys = kf_keys(scratch, blockIdx.z, g);
  const unsigned* bnd = keys + (long long)g * g;
  float* out = eroded + (long long)blockIdx.z * g * g;
  const int span = kErodeTile + 2 * w, taps = 2 * w + 1;
  float* a = sm;                            // span x span: the keys, decoded
  float* b = a + span * span;               // kErodeTile x span: after the v pass
  float* pen_v = b + kErodeTile * span;     // 2w + 1 each
  float* pen_u = pen_v + taps;
  const int r0 = blockIdx.y * kErodeTile, c0 = blockIdx.x * kErodeTile;
  const GridParams gp = grid_params(bnd, g);
  bool nan_pen = false;
  for (int k = threadIdx.x; k < taps; k += kThreads) {
    pen_v[k] = penalty(radius, k, w, gp.cv);
    pen_u[k] = penalty(radius, k, w, gp.cu);
    nan_pen |= pen_v[k] != pen_v[k] || pen_u[k] != pen_u[k];
  }
  for (int i = threadIdx.x; i < span * span; i += kThreads) {
    const int rr = r0 - w + i / span, cc = c0 - w + i % span;
    float v = FLT_MAX;
    if (rr >= 0 && rr < g && cc >= 0 && cc < g)
      v = fminf(__uint_as_float(keys[rr * g + cc]), FLT_MAX);
    a[i] = v;
  }
  const bool nan = __syncthreads_or(nan_pen);
  // Along v (axis 0), kErodeRows rows of one column a thread: rows outside
  // the grid read FLT_MAX (the JAX pad); columns outside it are the u
  // pass's pad, FLT_MAX.
  for (int it = threadIdx.x; it < (kErodeTile / kErodeRows) * span; it += kThreads) {
    const int cc = it % span, rl = (it / span) * kErodeRows, gc = c0 - w + cc;
    float best[kErodeRows];
#pragma unroll
    for (int j = 0; j < kErodeRows; ++j) best[j] = FLT_MAX;
    if (gc >= 0 && gc < g && !nan) {
      for (int k = 0; k < taps; ++k) {
        const float pk = pen_v[k];
#pragma unroll
        for (int j = 0; j < kErodeRows; ++j)
          best[j] = fminf(best[j], __fadd_rn(a[(rl + j + k) * span + cc], pk));
      }
    }
#pragma unroll
    for (int j = 0; j < kErodeRows; ++j)
      b[(rl + j) * span + cc] = gc >= 0 && gc < g && nan ? qnan() : best[j];
  }
  __syncthreads();
  // Along u (axis 1), as along v.
  for (int it = threadIdx.x; it < (kErodeTile / kErodeRows) * kErodeTile; it += kThreads) {
    const int c = it % kErodeTile, rl = (it / kErodeTile) * kErodeRows;
    if (c0 + c >= g) continue;
    float best[kErodeRows];
#pragma unroll
    for (int j = 0; j < kErodeRows; ++j) best[j] = FLT_MAX;
    for (int k = 0; k < taps; ++k) {
      const float pk = pen_u[k];
#pragma unroll
      for (int j = 0; j < kErodeRows; ++j)
        best[j] = fminf(best[j], __fadd_rn(b[(rl + j) * span + c + k], pk));
    }
#pragma unroll
    for (int j = 0; j < kErodeRows; ++j)
      if (r0 + rl + j < g) out[(r0 + rl + j) * g + c0 + c] = nan ? qnan() : best[j];
  }
}

__global__ void __launch_bounds__(kThreads)
hpr_test(Points pts, unsigned* __restrict__ scratch, const float* __restrict__ eroded_all,
         unsigned char* __restrict__ vis_all, int n, int g, float tol) {
  const Points p = pts.view(blockIdx.y);
  const View* vw = stage_view(p);
  const GridParams gp = block_params(kf_keys(scratch, blockIdx.y, g) + (long long)g * g, g);
  const float* eroded = eroded_all + (long long)blockIdx.y * g * g;
  unsigned char* vis = vis_all + (long long)blockIdx.y * n;
  const long long base = (long long)blockIdx.x * kThreads * kPerThread + threadIdx.x;
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const long long i = base + q * kThreads;
    if (i >= n) break;
    float r, ax, ay;
    bool v = false;
    if (gate(p, vw, i, r, ax, ay))
      v = !(__ldg(eroded + grid_cell(gp, ax, ay, g)) < __fsub_rn(r, tol));
    vis[i] = v ? 1 : 0;
  }
}

inline unsigned blocks(long long threads, int per) { return unsigned((threads + per - 1) / per); }

inline size_t erode_smem(int w) {
  const size_t span = kErodeTile + 2 * w;
  return (span * span + kErodeTile * span + 2 * (2 * w + 1)) * sizeof(float);
}

}  // namespace

extern "C" {

// H1: vis (N,) bool from x, y, z (f32) and valid (bool), each with its
// element stride. f and u are (N, 4) f32 scratch, poison one u32 (zeroed
// here). Two launches on `stream`. Returns the first CUDA error.
int hpr_support(const void* x, const void* y, const void* z, const void* valid, long long sx,
                long long sy, long long sz, long long sv, void* f, void* u, void* poison,
                void* vis, int n, float radius, float tol, void* stream) {
  if (n < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Points p{static_cast<const float*>(x), static_cast<const float*>(y),
                 static_cast<const float*>(z), static_cast<const unsigned char*>(valid),
                 sx, sy, sz, sv, 0, 0, 0, 0, nullptr, nullptr, nullptr, nullptr, 0.f, 0.f};
  cudaError_t err = cudaMemsetAsync(poison, 0, sizeof(unsigned), st);
  if (err != cudaSuccess) return err;
  hpr_flip<<<blocks(n, kThreads), kThreads, 0, st>>>(p, static_cast<float4*>(f),
                                                     static_cast<float4*>(u),
                                                     static_cast<unsigned*>(poison), n,
                                                     2.0f * radius);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  hpr_support_kernel<<<blocks(n, kSupThreads * kDirs), kSupThreads, 0, st>>>(
      static_cast<const float4*>(f), static_cast<const float4*>(u),
      static_cast<const unsigned*>(poison), static_cast<unsigned char*>(vis), n, tol);
  return cudaGetLastError();
}

// H2 for a batch of k keyframes: vis (k, N) bool, contiguous, from each
// keyframe's x, y, z (f32) and valid (bool) columns, each with its element
// stride and its keyframe stride; or, where R is not null, from the world
// points' columns (keyframe strides 0) seen by k views: R (k, 3, 3) and t
// (k, 3), and the intrinsics (fx, fy, cx, cy) and distortion (k1, k2, p1,
// p2, k3) of a width x height camera, all contiguous f32. scratch is (k,
// grid * grid + 8) u32
// (each keyframe's cell keys and bounds), eroded (k, grid * grid) f32. One
// memset and four launches on `stream`, whatever k. Returns the first CUDA
// error.
int hpr_grid(const void* x, const void* y, const void* z, const void* valid, long long sx,
             long long sy, long long sz, long long sv, long long kx, long long ky, long long kz,
             long long kv, const void* R, const void* t, const void* intr, const void* dist,
             int width, int height, void* scratch, void* eroded, void* vis, int n, int k,
             int grid, int window, float radius, float tol, void* stream) {
  if (n < 1 || k < 1 || k > 65535 || grid < 1 || window < 0 ||
      (R != nullptr && (!t || !intr || !dist)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Points p{static_cast<const float*>(x), static_cast<const float*>(y),
                 static_cast<const float*>(z), static_cast<const unsigned char*>(valid),
                 sx, sy, sz, sv, kx, ky, kz, kv, static_cast<const float*>(R),
                 static_cast<const float*>(t), static_cast<const float*>(intr),
                 static_cast<const float*>(dist), float(width), float(height)};
  unsigned* keys = static_cast<unsigned*>(scratch);
  const size_t smem = erode_smem(window);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;  // window <= 31: no opt-in needed
  const size_t words = size_t(k) * (size_t(grid) * grid + kBoundWords);
  cudaError_t err = cudaMemsetAsync(keys, 0xff, words * sizeof(unsigned), st);
  if (err != cudaSuccess) return err;
  const dim3 bounds(min(blocks(n, kThreads), unsigned(kBoundBlocks)), k);
  hpr_bounds<<<bounds, kThreads, 0, st>>>(p, keys, n, grid);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 per_point(blocks(n, kThreads * kPerThread), k);
  hpr_scatter<<<per_point, kThreads, 0, st>>>(p, keys, n, grid);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 tiles(blocks(grid, kErodeTile), blocks(grid, kErodeTile), k);
  hpr_erode<<<tiles, kThreads, smem, st>>>(keys, static_cast<float*>(eroded), grid, window,
                                            radius);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  hpr_test<<<per_point, kThreads, 0, st>>>(p, keys, static_cast<const float*>(eroded),
                                           static_cast<unsigned char*>(vis), n, grid, tol);
  return cudaGetLastError();
}

}  // extern "C"

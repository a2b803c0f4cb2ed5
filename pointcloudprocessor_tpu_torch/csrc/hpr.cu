// Hidden-point removal for Hopper (sm_90a): the dense support test (H1) and
// the grid parabolic z-buffer (H2).
//
// Both replace ops that XLA emits on the TPU without a Pallas source:
//   H1 hpr_support <- pointcloudprocessor_tpu/ops/hpr.py:57-123 (hpr_mask:
//                     spherical flip, blocked (N,3)x(3,N) max-reduction at
//                     Precision.HIGHEST, support test)
//   H2 hpr_grid    <- pointcloudprocessor_tpu/ops/hpr.py:126-208
//                     (hpr_mask_grid with _erode_parabolic_axis)
// Inputs of both: a batch of K keyframes of camera-frame x, y, z (N,) f32
// and the caller's gate valid (N,) bool, each column with its element and
// its keyframe stride; out: the (K, N) bool masks.
//
// H1: the support test, max_j <f_j, u_i> - (2R - r_i) <= tol, with the max
// taken only where it can move.
//   hpr_flip     per point: r = sqrt(fma(z, z, fma(y, y, x*x))) (XLA's and
//                torch's vector norm on the CPU), ok = valid && r > 1e-9,
//                u = p / max(r, 1e-12), s = 2R - r, f = u s and the self
//                dot fma(f.z, u.z, fma(f.y, u.y, f.x u.x)); writes u | s and
//                f | self (M = K N rows of 4, 0 where not ok), the key
//                (the keyframe, then the cell of u on a 256 x 256
//                octahedral map of the sphere; K 256^2 where not ok) and
//                per keyframe flag 1 (an ok point's flip is not finite: the
//                plain max is NaN everywhere, so every point is hidden) and
//                flag 2 (some point is not ok: its zero row joins the max).
//   the plan     torch ops (ops/hpr.dense_plan): a stable sort of the keys,
//                each point's rank in its cell's run (a binary search for
//                the run's start) and the running counts of block starts
//                (ranks that are multiples of 128) and subtile starts (of
//                32), so no block or subtile crosses a cell. Then
//   hpr_describe one thread a sorted position: the sorted rows, and for the
//                block or subtile starting there its centre c (the middle
//                of its bounding box), its chord radius rho (|u - c| <= rho
//                for every member, rounded up) and for a block L_b, its
//                least self dot, for a subtile s_max (+inf where s_min <=
//                0); the keyframes' first subtiles and the blocks' count.
//                Torch's own segment reductions (cummax, scatter_reduce_ on
//                runs of 32-128 equal indices) took 1.9 of 2.2 ms at
//                262,144 points; this launch takes 0.1 ms.
//   hpr_support  a persistent walk: a block of 128 threads takes a ticket
//                (one direction block) at a time, since the blocks' loads
//                differ widely (a block on the occluder's rim keeps many
//                subtiles, one in the open a few). Each lane holds up to 4
//                directions in registers; each of the 4 warps scans its
//                share of the keyframe's subtile descriptors, 128 at a time
//                (four rules a lane, four ballots), and stages each kept subtile
//                (<= 32 x 16 B) into shared memory by cp.async, double
//                buffered so that the next kept subtile's copy overlaps the
//                current one's pairs; the warps' maxima meet in shared
//                memory. best starts at 0 where the JAX package's max has a
//                zero row (n % 16384 != 0: its padding, hpr.py:111-112; or
//                flag 2), else at -inf. The dot is fma(z, z', fma(y, y', x *
//                x')), the chain of XLA's CPU dot and torch's CPU matmul,
//                with fmaxf, so the mask equals the plain version run on
//                the CPU bit for bit (the max is exact in any order). f32
//                FMA only: TF32, bf16 and a 3xTF32 split all round
//                otherwise (hpr.py:29-31: bf16 buries the depth signal),
//                so no tensor cores. Scanning every descriptor of the
//                keyframe (B x T rules, 20 B each, from L2) is simpler than
//                enumerating neighbouring cells, whose wrap on the
//                octahedral map and unbounded reach (s_min <= 0) would need
//                their own proof; at 262,144 two-wall points it is ~43M
//                rules. Staging each chunk of descriptors once in shared
//                memory for four blocks (a warp each) was 20-30% slower on
//                the card, so each warp reads its share from L2. The walk
//                counts the pairs it evaluates and the subtiles it keeps
//                (stats, where given).
//
// The skip rule. Subtile t is skipped for block b only if
//   s_min(t) > 0  and  s_max(t) (1 - D^2 / 2)^+ + delta(t) < L_b,
//   D = max(0, |c_b - c_t| - rho_b - rho_t),  delta(t) = 2^-17 s_max(t),
// evaluated as `skips` rounds it (ops/hpr.skip_rule, the same steps). Then
// every computed dot of t's points with b's directions is below L_b, which
// is at most each direction's best (its own self dot is in its max), so the
// max and the mask are unchanged bit for bit. Proof, e = 2^-24 (the unit
// roundoff), for ok points (underflow only shrinks a square by < 2^-149
// next to r^2 > 1e-18, and RHO_FLOOR covers the chord terms it drops):
//  (a) the computed r is |p| (1 +- 2.5e) (three rounded steps of the sum of
//      squares, a correctly rounded root), so the computed bearing U has
//      |U| <= 1 + 3.5e and |U|^2 <= 1 + 7.1e.
//  (b) F_j = fl(U_j s_j) = s_j U_j + g with |g| <= e s_j |U_j| (s_j > 0).
//  (c) the FMA chain's dot is within 3.01 e |F_j| |U_i| of <F_j, U_i>.
//  (d) <U_j, U_i> = (|U_i|^2 + |U_j|^2 - |U_i - U_j|^2) / 2 <= 1 + 7.1e -
//      D*^2 / 2 with D* = max(0, |c_b - c_t| - rho_b - rho_t) in exact
//      arithmetic (the radii bound every member). So dot_ij <= s_max (1 -
//      D*^2 / 2)^+ + 11.2 e s_max.
//  (e) the computed D is at most D*: the centre distance's three rounded
//      steps and root err by at most 4e of it (5e with an ulp-off root),
//      the (1 - 2^-20) factor takes 16e, and the two subtractions err by at
//      most e of it each; where D* = 0 the computed one is <= 0, clamped.
//  (f) fac = fl(1 - fl(D D) / 2), clamped at 0, is at least (1 - D*^2 /
//      2)^+ - 2.1e; g = fl(s_max fac) >= s_max fac - e s_max; so dot_ij <=
//      g + 14.3 e s_max.
//  (g) fl(g + delta) < L_b gives g + delta < L_b + 1.01 e s_max, so dot_ij
//      < L_b + 15.3 e s_max - delta = L_b - 112.7 e s_max: delta = 128 e
//      s_max is 8.4x the 15.3 e the rounding needs.
// A direction's own subtile is never skipped: there D = 0, so the left side
// is s_max (1 + 2^-17) > s_i (1 + 11.2e) >= the self dot. A subtile with a
// point at r >= 2R (s <= 0) is never skipped. NaN descriptors (a keyframe
// with flag 1) compare false: kept.
//   Bounds: the dense N^2 x 3 FMA at the card's f32 rate (67 TFLOP/s, 33.5
//   T FMA/s), 6.2 ms at 262,144 points, kept for comparison; and the
//   inputs' own need: the pairs whose dot reaches the self dot less 2^-18
//   2R (counted by tools/hpr_dense_probe), 4 instructions each at the
//   card's instruction rate, or N x 14 B at 3.35 TB/s, whichever is larger.
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

constexpr unsigned kFlagPoison = 1, kFlagLoose = 2;  // per keyframe, see hpr_flip

constexpr int kGrid = 256;  // cells a side of the octahedral map (ops/hpr.GRID)

// Point u's cell on the octahedral map of the sphere, row-major: o = (u.x,
// u.y) / |u|_1, folded over the lower hemisphere, then clamp((o + 1) G / 2)
// truncated, NaN to 0 (ops/hpr.hpr_flip_plain, the same steps).
__device__ __forceinline__ int octahedral_cell(float ux, float uy, float uz) {
  const float l1 = __fadd_rn(__fadd_rn(fabsf(ux), fabsf(uy)), fabsf(uz));
  float ox = __fdiv_rn(ux, l1), oy = __fdiv_rn(uy, l1);
  if (uz < 0.f) {
    const float fx = __fmul_rn(__fsub_rn(1.f, fabsf(oy)), ox >= 0.f ? 1.f : -1.f);
    oy = __fmul_rn(__fsub_rn(1.f, fabsf(ox)), oy >= 0.f ? 1.f : -1.f);
    ox = fx;
  }
  float cx = __fmul_rn(__fadd_rn(ox, 1.f), 0.5f * kGrid), cy = __fmul_rn(__fadd_rn(oy, 1.f), 0.5f * kGrid);
  cx = cx != cx ? 0.f : fminf(fmaxf(cx, 0.f), float(kGrid - 1));
  cy = cy != cy ? 0.f : fminf(fmaxf(cy, 0.f), float(kGrid - 1));
  return int(cy) * kGrid + int(cx);
}

__global__ void __launch_bounds__(kThreads)
hpr_flip(Points pts, float4* __restrict__ u, float4* __restrict__ f, int* __restrict__ key,
         unsigned* __restrict__ flags, int n, int k, float two_r) {
  const Points p = pts.view(blockIdx.y);
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long o = (long long)blockIdx.y * n + i;
  bool ok = false, bad = false;
  if (i < n) {
    const float x = __ldg(p.x + i * p.sx), y = __ldg(p.y + i * p.sy), z = __ldg(p.z + i * p.sz);
    const float r = __fsqrt_rn(__fmaf_rn(z, z, __fmaf_rn(y, y, __fmul_rn(x, x))));
    ok = __ldg(p.valid + i * p.sv) && r > 1e-9f;
    float4 ui = make_float4(0.f, 0.f, 0.f, 0.f), fi = ui;
    if (ok) {
      const float m = fmaxf(r, 1e-12f);
      const float ux = __fdiv_rn(x, m), uy = __fdiv_rn(y, m), uz = __fdiv_rn(z, m);
      const float s = __fsub_rn(two_r, r);
      const float fx = __fmul_rn(ux, s), fy = __fmul_rn(uy, s), fz = __fmul_rn(uz, s);
      ui = make_float4(ux, uy, uz, s);
      fi = make_float4(fx, fy, fz, __fmaf_rn(fz, uz, __fmaf_rn(fy, uy, __fmul_rn(fx, ux))));
      bad = !(isfinite(fx) && isfinite(fy) && isfinite(fz));
    }
    u[o] = ui;
    f[o] = fi;
    key[o] = ok ? int(blockIdx.y) * kGrid * kGrid + octahedral_cell(ui.x, ui.y, ui.z)
                : k * kGrid * kGrid;
  }
  // One atomic a block: a keyframe has ~N / 256 blocks, and most points
  // of a colorize cull may be gated out.
  const bool any_bad = __syncthreads_or(bad), any_loose = __syncthreads_or(i < n && !ok);
  if (threadIdx.x == 0 && (any_bad || any_loose))
    atomicOr(flags + blockIdx.y, (any_bad ? kFlagPoison : 0u) | (any_loose ? kFlagLoose : 0u));
}

constexpr int kBlockDirs = 128;  // directions a block, at most (ops/hpr.BLOCK_DIRS)
constexpr int kSubtile = 32;     // flipped points a subtile, at most (ops/hpr.SUBTILE)
constexpr int kSupThreads = 128;
constexpr int kSupWarps = kSupThreads / 32;
constexpr int kMaxDirs = kBlockDirs / 32;  // directions a lane
constexpr int kWalkBlocksPerSM = 16;

// H1's plan (ops/hpr.DensePlan, the same order), and the walk's outputs.
struct Plan {
  const float4* u;         // (M,) u | s, key order
  const float4* f;         // (M,) f | self dot, key order
  const long long* order;  // (M,) the points in key order (flat K N index)
  const float4* block;     // c_b | rho_b
  const float* low;        // L_b
  const int* bstart;       // block b is [bstart[b], bstart[b + 1])
  const int* bkf;          // block b's keyframe
  const float4* sub;       // c_t | rho_t
  const float* sub_s;      // s_max, +inf where s_min <= 0
  const int* tstart;       // subtile t is [tstart[t], tstart[t + 1])
  const int* kf_sub;       // keyframe k's subtiles [kf_sub[k], kf_sub[k + 1])
  const int* n_blocks;
  const unsigned* flags;   // (K,)
  unsigned char* vis;      // (M,) flat K N
  unsigned* ticket;
  unsigned long long* stats;  // pairs evaluated, subtiles kept; or null
  int pad_zero;
  float tol;
};

constexpr float kRhoUp = 1.0f + 0x1p-20f, kRhoFloor = 0x1p-60f;  // ops/hpr.RHO_UP, RHO_FLOOR

// A segment's descriptors from its members at sorted positions [p, p + len):
// the bounding box's centre c, rho = max sqrt((dx dx + dy dy) + dz dz) to it
// rounded up, s's range and the least self dot (ops/hpr._segments, the same
// steps; the box's min and max are exact in any order).
struct Segment {
  float4 c;
  float s_min, s_max, low;
};

template <bool kSorted>
__device__ __forceinline__ Segment describe_segment(const long long* __restrict__ order,
                                                    const float4* __restrict__ u4,
                                                    const float4* __restrict__ f4,
                                                    float4* __restrict__ us,
                                                    float4* __restrict__ fs, int p, int len) {
  float lo[4] = {INFINITY, INFINITY, INFINITY, INFINITY};
  float hi[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  float low = INFINITY;
#pragma unroll 8
  for (int j = 0; j < len; ++j) {
    const long long o = __ldg(order + p + j);
    const float4 u = __ldg(u4 + o), f = __ldg(f4 + o);
    if (kSorted) {  // the subtile pass writes the sorted rows
      us[p + j] = u;
      fs[p + j] = f;
    }
    lo[0] = fminf(lo[0], u.x); lo[1] = fminf(lo[1], u.y); lo[2] = fminf(lo[2], u.z);
    lo[3] = fminf(lo[3], u.w);
    hi[0] = fmaxf(hi[0], u.x); hi[1] = fmaxf(hi[1], u.y); hi[2] = fmaxf(hi[2], u.z);
    hi[3] = fmaxf(hi[3], u.w);
    low = fminf(low, f.w);
  }
  const float cx = __fmul_rn(__fadd_rn(lo[0], hi[0]), 0.5f);
  const float cy = __fmul_rn(__fadd_rn(lo[1], hi[1]), 0.5f);
  const float cz = __fmul_rn(__fadd_rn(lo[2], hi[2]), 0.5f);
  float rho = 0.f;
#pragma unroll 8
  for (int j = 0; j < len; ++j) {
    const float4 u = __ldg(u4 + __ldg(order + p + j));
    const float dx = __fsub_rn(u.x, cx), dy = __fsub_rn(u.y, cy), dz = __fsub_rn(u.z, cz);
    rho = fmaxf(rho, __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                          __fmul_rn(dz, dz))));
  }
  return Segment{make_float4(cx, cy, cz, __fadd_rn(__fmul_rn(rho, kRhoUp), kRhoFloor)), lo[3],
                 hi[3], low};
}

// One thread a sorted position p: the subtile that starts at p (its rank in
// its cell's run a multiple of 32), the block that starts there (a multiple
// of 128), and where p starts a keyframe, the keyframes' first subtiles and
// the ok blocks' count. The not-ok points' segments (key K G^2, last) get
// their starts only.
__global__ void __launch_bounds__(kThreads)
hpr_describe(const int* __restrict__ key, const int* __restrict__ rank,
             const int* __restrict__ sub_cs, const int* __restrict__ blk_cs,
             const float4* __restrict__ u4, const float4* __restrict__ f4,
             const long long* __restrict__ order, float4* __restrict__ us,
             float4* __restrict__ fs, float4* __restrict__ block, float* __restrict__ low,
             int* __restrict__ bstart, int* __restrict__ bkf, float4* __restrict__ sub,
             float* __restrict__ sub_s, int* __restrict__ tstart, int* __restrict__ kf_sub,
             int* __restrict__ n_blocks, int m, int k) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= m) return;
  const int kp = __ldg(key + p), kf = kp / (kGrid * kGrid);
  const int prev = p == 0 ? -1 : __ldg(key + p - 1) / (kGrid * kGrid);
  for (int q = prev + 1; q <= kf; ++q) {  // keyframes prev + 1 .. kf start at p
    kf_sub[q] = __ldg(sub_cs + p) - 1;
    if (q == k) *n_blocks = __ldg(blk_cs + p) - 1;
  }
  if (p == m - 1) {
    for (int q = kf + 1; q <= k; ++q) {
      kf_sub[q] = __ldg(sub_cs + p);
      if (q == k) *n_blocks = __ldg(blk_cs + p);
    }
  }
  const int r = __ldg(rank + p);
  if (r % kSubtile != 0) return;
  int len = 1;
  while (len < kBlockDirs && p + len < m && __ldg(key + p + len) == kp) ++len;
  const int t = __ldg(sub_cs + p) - 1, tlen = min(len, kSubtile);
  tstart[t] = p;
  if (p + tlen == m) tstart[t + 1] = m;
  const bool ok = kf < k;
  if (ok) {
    const Segment s = describe_segment<true>(order, u4, f4, us, fs, p, tlen);
    sub[t] = s.c;
    sub_s[t] = s.s_min > 0.f ? s.s_max : INFINITY;
  }
  if (r % kBlockDirs != 0) return;
  const int b = __ldg(blk_cs + p) - 1;
  bstart[b] = p;
  bkf[b] = kf;
  if (p + len == m) bstart[b + 1] = m;
  if (ok) {
    const Segment s = describe_segment<false>(order, u4, f4, us, fs, p, len);
    block[b] = s.c;
    low[b] = s.low;
  }
}

// The skip rule (see the header), each step rounded as ops/hpr.skip_rule's
// torch ops round it. A NaN anywhere compares false: kept.
__device__ __forceinline__ bool skips(float4 b, float low, float4 t, float s) {
  const float dx = __fsub_rn(b.x, t.x), dy = __fsub_rn(b.y, t.y), dz = __fsub_rn(b.z, t.z);
  const float cd = __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                        __fmul_rn(dz, dz)));
  float d = __fsub_rn(__fsub_rn(__fmul_rn(cd, 1.0f - 0x1p-20f), b.w), t.w);
  d = d < 0.f ? 0.f : d;
  float fac = __fsub_rn(1.0f, __fmul_rn(__fmul_rn(d, d), 0.5f));
  fac = fac < 0.f ? 0.f : fac;
  return __fadd_rn(__fmul_rn(s, fac), __fmul_rn(s, 0x1p-17f)) < low;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// One warp's share of a block's walk: steps of 128 subtile descriptors,
// t0 + 128 w, t0 + 128 (w + 4), ... below t1 (4 a lane, loaded before any
// rule is evaluated, so that their latencies overlap), each kept subtile
// staged into `stage` (two buffers of kSubtile) and its pairs taken with ND
// directions a lane. pairs / kept: this warp's counts (the same in every
// lane).
template <int ND>
__device__ __forceinline__ void walk(const Plan& a, int t0, int t1, float4 cb, float low, int nd,
                                     const float (&ux)[kMaxDirs], const float (&uy)[kMaxDirs],
                                     const float (&uz)[kMaxDirs], float (&best)[kMaxDirs],
                                     float4 (*stage)[kSubtile], unsigned long long& pairs,
                                     unsigned long long& kept) {
  const int lane = threadIdx.x & 31;
  int step = t0 + (threadIdx.x >> 5) * 128, base = 0, left = 0;
  unsigned m0 = 0, m1 = 0, m2 = 0, m3 = 0;  // the step's ballots, 32 subtiles each
  auto next = [&]() -> int {  // the next kept subtile, or -1
    for (;;) {
      if (m0 != 0) {
        const int t = base + __ffs(m0) - 1;
        m0 &= m0 - 1;
        return t;
      }
      if (left > 0) {
        m0 = m1;
        m1 = m2;
        m2 = m3;
        m3 = 0;
        base += 32;
        --left;
        continue;
      }
      if (step >= t1) return -1;
      float4 d[4];
      float s[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int t = min(step + 32 * q + lane, t1 - 1);
        d[q] = __ldg(a.sub + t);
        s[q] = __ldg(a.sub_s + t);
      }
      bool keep[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) keep[q] = step + 32 * q + lane < t1 && !skips(cb, low, d[q], s[q]);
      m0 = __ballot_sync(0xffffffffu, keep[0]);
      m1 = __ballot_sync(0xffffffffu, keep[1]);
      m2 = __ballot_sync(0xffffffffu, keep[2]);
      m3 = __ballot_sync(0xffffffffu, keep[3]);
      base = step;
      left = 3;
      step += kSupWarps * 128;
    }
  };
  auto issue = [&](int t, int buf) -> int {  // stages subtile t; its length
    const int s0 = __ldg(a.tstart + t), len = __ldg(a.tstart + t + 1) - s0;
    if (lane < len) cp_async16(&stage[buf][lane], a.f + s0 + lane);
    return len;
  };
  int cur = next();
  if (cur < 0) return;
  int len = issue(cur, 0), buf = 0;
  cp_async_commit();
  for (;;) {
    const int nxt = next();
    const int nlen = nxt >= 0 ? issue(nxt, buf ^ 1) : 0;
    cp_async_commit();
    cp_async_wait_prior();  // this lane's copies of `cur` have landed
    __syncwarp();           // and every lane's
#pragma unroll 4
    for (int j = 0; j < len; ++j) {
      const float4 fj = stage[buf][j];
#pragma unroll
      for (int d = 0; d < ND; ++d)
        best[d] = fmaxf(best[d],
                        __fmaf_rn(fj.z, uz[d], __fmaf_rn(fj.y, uy[d], __fmul_rn(fj.x, ux[d]))));
    }
    pairs += (unsigned long long)len * nd;
    kept += 1;
    __syncwarp();  // every lane is done with `buf` before it is staged again
    if (nxt < 0) return;
    cur = nxt;
    len = nlen;
    buf ^= 1;
  }
}

__global__ void __launch_bounds__(kSupThreads)
hpr_support_kernel(Plan a) {
  __shared__ __align__(16) float4 stage[kSupWarps][2][kSubtile];
  __shared__ float red[kSupWarps][kBlockDirs];
  __shared__ int ticket;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nb = *a.n_blocks;
  unsigned long long pairs = 0, kept = 0;
  for (;;) {
    if (threadIdx.x == 0) ticket = int(atomicAdd(a.ticket, 1u));
    __syncthreads();
    const int b = ticket;
    if (b >= nb) break;
    const int i0 = __ldg(a.bstart + b), nd = __ldg(a.bstart + b + 1) - i0;
    const int kf = __ldg(a.bkf + b);
    const unsigned fl = __ldg(a.flags + kf);
    const float init = (a.pad_zero || (fl & kFlagLoose)) ? 0.f : -INFINITY;
    float ux[kMaxDirs], uy[kMaxDirs], uz[kMaxDirs], best[kMaxDirs];
#pragma unroll
    for (int d = 0; d < kMaxDirs; ++d) {
      const int i = lane + 32 * d;
      const float4 v = i < nd ? __ldg(a.u + i0 + i) : make_float4(0.f, 0.f, 0.f, 0.f);
      ux[d] = v.x;
      uy[d] = v.y;
      uz[d] = v.z;
      best[d] = init;
    }
    const float4 cb = __ldg(a.block + b);
    const float low = __ldg(a.low + b);
    const int t0 = __ldg(a.kf_sub + kf), t1 = __ldg(a.kf_sub + kf + 1);
    switch ((nd + 31) >> 5) {
      case 1: walk<1>(a, t0, t1, cb, low, nd, ux, uy, uz, best, stage[warp], pairs, kept); break;
      case 2: walk<2>(a, t0, t1, cb, low, nd, ux, uy, uz, best, stage[warp], pairs, kept); break;
      case 3: walk<3>(a, t0, t1, cb, low, nd, ux, uy, uz, best, stage[warp], pairs, kept); break;
      default: walk<4>(a, t0, t1, cb, low, nd, ux, uy, uz, best, stage[warp], pairs, kept);
    }
#pragma unroll
    for (int d = 0; d < kMaxDirs; ++d)
      if (lane + 32 * d < nd) red[warp][lane + 32 * d] = best[d];
    __syncthreads();
    if (threadIdx.x < nd) {
      const int i = threadIdx.x;
      const float m = fmaxf(fmaxf(red[0][i], red[1][i]), fmaxf(red[2][i], red[3][i]));
      const float s = __ldg(a.u + i0 + i).w;
      a.vis[__ldg(a.order + i0 + i)] = (!(fl & kFlagPoison) && __fsub_rn(m, s) <= a.tol) ? 1 : 0;
    }
    // The next ticket's barrier orders these reads of red before its writes.
  }
  if (lane == 0 && a.stats != nullptr && kept != 0) {
    atomicAdd(a.stats, pairs);
    atomicAdd(a.stats + 1, kept);
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

// H1, the flip of a batch of k keyframes (k <= 32767): u4 and f4 (k N, 4)
// f32, key (k N) int32 and flags (k,) u32 (zeroed here) from each keyframe's
// x, y, z (f32) and valid (bool) columns, each with its element and
// keyframe stride. A memset and one launch on `stream`. Returns the first
// CUDA error.
int hpr_flip(const void* x, const void* y, const void* z, const void* valid, long long sx,
             long long sy, long long sz, long long sv, long long kx, long long ky, long long kz,
             long long kv, void* u4, void* f4, void* key, void* flags, int n, int k, float radius,
             void* stream) {
  if (n < 1 || k < 1 || k > 32767) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Points p{static_cast<const float*>(x), static_cast<const float*>(y),
                 static_cast<const float*>(z), static_cast<const unsigned char*>(valid),
                 sx, sy, sz, sv, kx, ky, kz, kv, nullptr, nullptr, nullptr, nullptr, 0.f, 0.f};
  cudaError_t err = cudaMemsetAsync(flags, 0, size_t(k) * sizeof(unsigned), st);
  if (err != cudaSuccess) return err;
  hpr_flip<<<dim3(blocks(n, kThreads), k), kThreads, 0, st>>>(
      p, static_cast<float4*>(u4), static_cast<float4*>(f4), static_cast<int*>(key),
      static_cast<unsigned*>(flags), n, k, 2.0f * radius);
  return cudaGetLastError();
}

// H1, the plan's descriptors over the m = k N sorted keys (int32), each
// sorted position's rank in its cell's run and the running counts of
// subtile and block starts (int32), the flip's u4 and f4 and the sort's
// order (int64): the plan's sorted rows, segments and descriptors
// (ops/hpr.DensePlan's tensors from u on, in its order). One launch on
// `stream`. Returns the first CUDA error.
int hpr_describe(const void* key, const void* rank, const void* sub_cs, const void* blk_cs,
                 const void* u4, const void* f4, void* us, void* fs, const void* order,
                 void* block, void* low, void* bstart, void* bkf, void* sub, void* sub_s,
                 void* tstart, void* kf_sub, void* n_blocks, int m, int k, void* stream) {
  if (m < 1 || k < 1) return cudaErrorInvalidValue;
  hpr_describe<<<blocks(m, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(key), static_cast<const int*>(rank),
      static_cast<const int*>(sub_cs), static_cast<const int*>(blk_cs),
      static_cast<const float4*>(u4), static_cast<const float4*>(f4),
      static_cast<const long long*>(order), static_cast<float4*>(us), static_cast<float4*>(fs),
      static_cast<float4*>(block), static_cast<float*>(low), static_cast<int*>(bstart),
      static_cast<int*>(bkf), static_cast<float4*>(sub), static_cast<float*>(sub_s),
      static_cast<int*>(tstart), static_cast<int*>(kf_sub), static_cast<int*>(n_blocks), m, k);
  return cudaGetLastError();
}

// H1, the support test over the plan of m = k N points (ops/hpr.DensePlan's
// twelve tensors in its order; every one contiguous on the card): vis (m,)
// bool, flat (k, N) and zeroed here (a point that is not ok is hidden); the
// ticket one u32 (zeroed here); stats two u64 that gain the pairs evaluated
// and the subtiles kept, or null. pad_zero: n % 16384 != 0. Two memsets and
// one launch, a persistent grid of 16 blocks an SM. Returns the first CUDA
// error.
int hpr_support(const void* u, const void* f, const void* order, const void* block,
                const void* low, const void* bstart, const void* bkf, const void* sub,
                const void* sub_s, const void* tstart, const void* kf_sub, const void* n_blocks,
                const void* flags, void* vis, void* ticket, void* stats, int m, int pad_zero,
                float tol, void* stream) {
  if (m < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  cudaError_t err = cudaMemsetAsync(vis, 0, size_t(m), st);
  if (err == cudaSuccess) err = cudaMemsetAsync(ticket, 0, sizeof(unsigned), st);
  if (err != cudaSuccess) return err;
  const Plan a{static_cast<const float4*>(u), static_cast<const float4*>(f),
               static_cast<const long long*>(order), static_cast<const float4*>(block),
               static_cast<const float*>(low), static_cast<const int*>(bstart),
               static_cast<const int*>(bkf), static_cast<const float4*>(sub),
               static_cast<const float*>(sub_s), static_cast<const int*>(tstart),
               static_cast<const int*>(kf_sub), static_cast<const int*>(n_blocks),
               static_cast<const unsigned*>(flags), static_cast<unsigned char*>(vis),
               static_cast<unsigned*>(ticket), static_cast<unsigned long long*>(stats), pad_zero,
               tol};
  const unsigned grid = unsigned(min(m, sms * kWalkBlocksPerSM));
  hpr_support_kernel<<<grid, kSupThreads, 0, st>>>(a);
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

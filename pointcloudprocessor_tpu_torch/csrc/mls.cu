// The moments MLS pass for Hopper (sm_90a): M1.
//
// Replaces ops that XLA emits on the TPU without a Pallas source, the body
// of the MLS pass's lax.map (pointcloudprocessor_tpu/ops/mls.py:399-429):
//   knn.candidate_points (+ candidate_points_dedup)  knn.py:133-227
//   fit_surfaces_moments                              mls.py:203-317
//   project_onto (each point onto its own surface)    mls.py:181-200
// The hash grid (knn.build: a sort, a rank and a scatter into the (T, B)
// bucket table) stays torch ops in the wrapper. The JAX package's (T, 3B)
// coordinate planes and its cell-sorted, run-deduplicated fetch exist for
// the TPU's row gathers; here a warp reads its query's candidates through
// the bucket table and the points, which stay in L2.
//
// In: buckets (T, B) int32 (-1 empty), counts (T,) int32 (may exceed B),
// points (N, 3) f32; every point is a query. Out, per point: the projected
// position and normal (N, 3), the surface (origin, normal, tangent_u,
// tangent_v (N, 3), coeffs (N, 6), ok (N,) bool) and the in-radius count
// (N,) int32. A warp takes one point:
//   1. lanes 0..26 hash the 27 cells around its cell (floor(p / cell) by
//      IEEE division, the uint32 XOR hash), a warp scan lays the occupied
//      slots of the 27 buckets end to end (a bucket that two cells share is
//      read twice, as in the JAX package);
//   2. pass 1 over the candidates: d = c - p, d2 = (dx*dx + dy*dy) + dz*dz
//      each step rounded (the plain version's order), in when finite z and
//      d2 <= r^2; w = exp(-d2 / sqr_gauss); (dx, dy, dz, w) of the in-radius
//      candidates go to shared memory (at most 27 * B a warp, 16 B each);
//      sums of w and w * d;
//   3. pass 2: the 6 weighted covariance sums about the mean;
//   4. every lane: the normal by the plain version's inverse iteration
//      (C + 1e-6 (tr C + 1e-12) I, seed 0.577, three unrolled Cholesky
//      solves with the max(s, 1e-30) pivot clamp), turned towards the point,
//      and its tangent frame;
//   5. pass 3: the 15 distinct moments sum w u^a v^b (a + b <= 4) and the
//      6 right-hand sides sum w h u^a v^b; the 6x6 system with the 1e-8
//      ridge, solved by one unrolled Cholesky; coefficients 0 under 6
//      neighbors, ok from 3;
//   6. the point projected onto its own surface, as project_onto does.
// Lane sums meet by warp shuffles, so the sums round otherwise than the
// plain version's: positions and normals agree to f32 rounding, the
// in-radius sets and counts exactly. The solves and the projection round
// each step as the plain version does (__f*_rn).
//
// What bounds it on the H100 (chip_smoke.py's phase_mls counts it from the
// run's inputs). Unique bytes (each input read once: the table's counts,
// the occupied slots, the points, 101 bytes out a point): ~119 MB for the
// 1M-point hardened corner, ~36 us. f32 operations (M1_OPS_SLOT,
// M1_OPS_IN, M1_OPS_POINT there): ~10 a candidate slot read over ~241
// slots a point, ~113 an in-radius candidate over ~63 a point and ~350 a
// point for the solves, frame and projection: ~9.8e9 for 1M points,
// ~0.15 ms at 67 TFLOP/s.
// As N1's, each candidate round waits on dependent random reads (count,
// slot, point), so latency, not bytes, sets its pace.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;              // points a block
constexpr int kCells = 27;
constexpr int kMaxB = 128;             // bucket capacity the kernel takes
constexpr unsigned kFull = 0xffffffffu;
// vector3i_hash.hpp:14-37 (the JAX package's voxel.py:18-20).
constexpr unsigned kP1 = 73856093u, kP2 = 19349669u, kP3 = 83492791u;

__device__ __forceinline__ int cell_coord(float p, float cell) {
  return __float2int_rz(floorf(__fdiv_rn(p, cell)));  // saturating, NaN -> 0
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// max(s, 1e-30) with NaN passing through, as jnp.maximum.
__device__ __forceinline__ float clamp_pivot(float s) { return s != s ? s : fmaxf(s, 1e-30f); }

// x <- A^-1 x for SPD A (D x D) by the plain version's unrolled Cholesky.
template <int D>
__device__ __forceinline__ void chol_solve(const float (&A)[D][D], float (&x)[D]) {
  float L[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = A[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) s = __fsub_rn(s, __fmul_rn(L[i][k], L[j][k]));
      L[i][j] = i == j ? __fsqrt_rn(clamp_pivot(s)) : __fdiv_rn(s, L[j][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < D; ++i) {
    float s = x[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = __fsub_rn(s, __fmul_rn(L[i][k], x[k]));
    x[i] = __fdiv_rn(s, L[i][i]);
  }
#pragma unroll
  for (int i = D - 1; i >= 0; --i) {
    float s = x[i];
#pragma unroll
    for (int k = i + 1; k < D; ++k) s = __fsub_rn(s, __fmul_rn(L[k][i], x[k]));
    x[i] = __fdiv_rn(s, L[i][i]);
  }
}

__device__ __forceinline__ float dot3(const float (&a)[3], const float (&b)[3]) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a[0], b[0]), __fmul_rn(a[1], b[1])), __fmul_rn(a[2], b[2]));
}

// v / max(|v|, 1e-20).
__device__ __forceinline__ void unit3(float (&v)[3]) {
  const float n = fmaxf(__fsqrt_rn(dot3(v, v)), 1e-20f);
#pragma unroll
  for (int c = 0; c < 3; ++c) v[c] = __fdiv_rn(v[c], n);
}

__device__ __forceinline__ void cross3(const float (&a)[3], const float (&b)[3], float (&o)[3]) {
  o[0] = __fsub_rn(__fmul_rn(a[1], b[2]), __fmul_rn(a[2], b[1]));
  o[1] = __fsub_rn(__fmul_rn(a[2], b[0]), __fmul_rn(a[0], b[2]));
  o[2] = __fsub_rn(__fmul_rn(a[0], b[1]), __fmul_rn(a[1], b[0]));
}

__device__ __forceinline__ void store3(float* out, long long i, const float (&v)[3]) {
  out[3 * i] = v[0];
  out[3 * i + 1] = v[1];
  out[3 * i + 2] = v[2];
}

__global__ void __launch_bounds__(kWarps * 32)
mls_moments_kernel(const int* __restrict__ buckets, const int* __restrict__ counts,
                   const float* __restrict__ pts, float* __restrict__ out_pos,
                   float* __restrict__ out_nrm, float* __restrict__ out_origin,
                   float* __restrict__ out_normal, float* __restrict__ out_tu,
                   float* __restrict__ out_tv, float* __restrict__ out_coeffs,
                   unsigned char* __restrict__ out_ok, int* __restrict__ out_cnt, int n,
                   int table, int cap, float cell, float r2, float sqr_gauss, int order) {
  extern __shared__ float4 cand_store[];
  __shared__ int first[kWarps][32];  // exclusive prefix of the occupied slots
  __shared__ int bucket[kWarps][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long i = (long long)blockIdx.x * kWarps + w;
  if (i >= n) return;  // warp-uniform
  float4* cand = cand_store + (long long)w * kCells * cap;
  const float q[3] = {pts[3 * i], pts[3 * i + 1], pts[3 * i + 2]};

  int occupied = 0, b = 0;
  if (lane < kCells) {
    const unsigned ux = unsigned(cell_coord(q[0], cell)) + unsigned(lane / 9 - 1);
    const unsigned uy = unsigned(cell_coord(q[1], cell)) + unsigned((lane / 3) % 3 - 1);
    const unsigned uz = unsigned(cell_coord(q[2], cell)) + unsigned(lane % 3 - 1);
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

  // Pass 1: the in-radius candidates, their weights, sum w and sum w d.
  int n_in = 0;
  float sw = 0.f, sx = 0.f, sy = 0.f, sz = 0.f;
  for (int base = 0; base < total; base += 32) {
    const int c = base + lane;
    bool in = false;
    float4 e = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c < total) {
      int kc = 0;  // the last of the 27 cells whose slots start at or before c
#pragma unroll
      for (int step = 16; step > 0; step >>= 1)
        if (kc + step < kCells && first[w][kc + step] <= c) kc += step;
      const int j = __ldg(buckets + (long long)bucket[w][kc] * cap + (c - first[w][kc]));
      if (j >= 0) {
        const float pz = __ldg(pts + 3LL * j + 2);
        const float dx = __fsub_rn(__ldg(pts + 3LL * j), q[0]);
        const float dy = __fsub_rn(__ldg(pts + 3LL * j + 1), q[1]);
        const float dz = __fsub_rn(pz, q[2]);
        const float d2 =
            __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
        if (isfinite(pz) && d2 <= r2) {
          in = true;
          e = make_float4(dx, dy, dz, expf(__fdiv_rn(-d2, sqr_gauss)));
          sw += e.w;
          sx += e.w * dx;
          sy += e.w * dy;
          sz += e.w * dz;
        }
      }
    }
    const unsigned bal = __ballot_sync(kFull, in);
    if (in) cand[n_in + __popc(bal & ((1u << lane) - 1u))] = e;
    n_in += __popc(bal);
  }
  __syncwarp();
  const float wsum = fmaxf(warp_sum(sw), 1e-20f);
  const float m[3] = {__fdiv_rn(warp_sum(sx), wsum), __fdiv_rn(warp_sum(sy), wsum),
                      __fdiv_rn(warp_sum(sz), wsum)};

  // Pass 2: the weighted covariance about the mean.
  float cxx = 0.f, cxy = 0.f, cxz = 0.f, cyy = 0.f, cyz = 0.f, czz = 0.f;
  for (int t = lane; t < n_in; t += 32) {
    const float4 e = cand[t];
    const float ex = e.x - m[0], ey = e.y - m[1], ez = e.z - m[2];
    const float wx = e.w * ex, wy = e.w * ey;
    cxx += wx * ex;
    cxy += wx * ey;
    cxz += wx * ez;
    cyy += wy * ey;
    cyz += wy * ez;
    czz += e.w * ez * ez;
  }
  float C[3][3];
  C[0][0] = warp_sum(cxx);
  C[0][1] = C[1][0] = warp_sum(cxy);
  C[0][2] = C[2][0] = warp_sum(cxz);
  C[1][1] = warp_sum(cyy);
  C[1][2] = C[2][1] = warp_sum(cyz);
  C[2][2] = warp_sum(czz);

  // The normal: inverse iteration on the shifted covariance, every lane.
  const float shift =
      __fmul_rn(1e-6f, __fadd_rn(__fadd_rn(__fadd_rn(C[0][0], C[1][1]), C[2][2]), 1e-12f));
#pragma unroll
  for (int d = 0; d < 3; ++d) C[d][d] = __fadd_rn(C[d][d], shift);
  float nrm[3] = {0.577f, 0.577f, 0.577f};
  chol_solve<3>(C, nrm);
  unit3(nrm);
  chol_solve<3>(C, nrm);
  chol_solve<3>(C, nrm);
  unit3(nrm);
  const float origin[3] = {__fadd_rn(q[0], m[0]), __fadd_rn(q[1], m[1]), __fadd_rn(q[2], m[2])};
  const float side[3] = {__fsub_rn(q[0], origin[0]), __fsub_rn(q[1], origin[1]),
                         __fsub_rn(q[2], origin[2])};
  const float dside = dot3(nrm, side);
  const float sgn = dside > 0.f ? 1.f : (dside < 0.f ? -1.f : (dside == 0.f ? 1.f : dside));
#pragma unroll
  for (int d = 0; d < 3; ++d) nrm[d] = __fmul_rn(nrm[d], sgn);
  const float ref[3] = {fabsf(nrm[0]) < 0.9f ? 1.f : 0.f, fabsf(nrm[0]) < 0.9f ? 0.f : 1.f, 0.f};
  float tu[3], tv[3];
  cross3(nrm, ref, tu);
  unit3(tu);
  cross3(nrm, tu, tv);

  // Pass 3: the polynomial's moments in the tangent frame, and its solve.
  float coef[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (order >= 2) {
    float mom[15], rhs[6];  // mom: a + b <= 4 in the order (0,0..4), (1,0..3), ...
#pragma unroll
    for (int s = 0; s < 15; ++s) mom[s] = 0.f;
#pragma unroll
    for (int s = 0; s < 6; ++s) rhs[s] = 0.f;
    for (int t = lane; t < n_in; t += 32) {
      const float4 e = cand[t];
      const float ex = e.x - m[0], ey = e.y - m[1], ez = e.z - m[2];
      const float u = ex * tu[0] + ey * tu[1] + ez * tu[2];
      const float v = ex * tv[0] + ey * tv[1] + ez * tv[2];
      const float h = ex * nrm[0] + ey * nrm[1] + ez * nrm[2];
      const float pu[5] = {1.f, u, u * u, u * u * u, u * u * u * u};
      const float pv[5] = {1.f, v, v * v, v * v * v, v * v * v * v};
      int s = 0;
#pragma unroll
      for (int a = 0; a < 5; ++a)
#pragma unroll
        for (int bb = 0; bb < 5 - a; ++bb) mom[s++] += e.w * pu[a] * pv[bb];
      const float wh = e.w * h;
      rhs[0] += wh;
      rhs[1] += wh * u;
      rhs[2] += wh * v;
      rhs[3] += wh * pu[2];
      rhs[4] += wh * u * v;
      rhs[5] += wh * pv[2];
    }
#pragma unroll
    for (int s = 0; s < 15; ++s) mom[s] = warp_sum(mom[s]);
#pragma unroll
    for (int s = 0; s < 6; ++s) coef[s] = warp_sum(rhs[s]);
    if (n_in >= 6) {
      // Moment index of (a, b): the (a, b) of a + b <= 4 in row-major order.
      constexpr int kRow[5] = {0, 5, 9, 12, 14};
      constexpr int kEa[6] = {0, 1, 0, 2, 1, 0}, kEb[6] = {0, 0, 1, 0, 1, 2};
      float A[6][6];
#pragma unroll
      for (int r = 0; r < 6; ++r)
#pragma unroll
        for (int c = 0; c < 6; ++c) {
          const float mo = mom[kRow[kEa[r] + kEa[c]] + kEb[r] + kEb[c]];
          A[r][c] = r == c ? __fadd_rn(mo, 1e-8f) : mo;
        }
      chol_solve<6>(A, coef);
    } else {
#pragma unroll
      for (int s = 0; s < 6; ++s) coef[s] = 0.f;
    }
  }
  const bool ok = n_in >= 3;

  // The point projected onto its own surface (project_onto).
  if (lane == 0) {
    const float u = dot3(side, tu), v = dot3(side, tv);
    float hh = __fadd_rn(coef[0], __fmul_rn(coef[1], u));
    hh = __fadd_rn(hh, __fmul_rn(coef[2], v));
    hh = __fadd_rn(hh, __fmul_rn(__fmul_rn(coef[3], u), u));
    hh = __fadd_rn(hh, __fmul_rn(__fmul_rn(coef[4], u), v));
    hh = __fadd_rn(hh, __fmul_rn(__fmul_rn(coef[5], v), v));
    float pos[3], tilt[3];
    const float du = __fadd_rn(__fadd_rn(coef[1], __fmul_rn(__fmul_rn(2.f, coef[3]), u)),
                               __fmul_rn(coef[4], v));
    const float dv = __fadd_rn(__fadd_rn(coef[2], __fmul_rn(coef[4], u)),
                               __fmul_rn(__fmul_rn(2.f, coef[5]), v));
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float p = __fadd_rn(__fadd_rn(__fadd_rn(origin[d], __fmul_rn(u, tu[d])),
                                          __fmul_rn(v, tv[d])),
                                __fmul_rn(hh, nrm[d]));
      pos[d] = ok ? p : q[d];
      tilt[d] = __fsub_rn(__fsub_rn(nrm[d], __fmul_rn(du, tu[d])), __fmul_rn(dv, tv[d]));
    }
    unit3(tilt);
    store3(out_pos, i, pos);
    store3(out_nrm, i, tilt);
    store3(out_origin, i, origin);
    store3(out_normal, i, nrm);
    store3(out_tu, i, tu);
    store3(out_tv, i, tv);
#pragma unroll
    for (int s = 0; s < 6; ++s) out_coeffs[6 * i + s] = coef[s];
    out_ok[i] = ok;
    out_cnt[i] = n_in;
  }
}

}  // namespace

extern "C" {

// M1: the moments MLS pass of the n points (n, 3) f32 over their hash grid
// (buckets (table, cap) int32, counts (table,) int32, cap <= 128): pos,
// nrm, origin, normal, tu, tv (n, 3) f32, coeffs (n, 6) f32, ok (n,) bool
// and cnt (n,) int32, all contiguous; order < 2 fits the plane alone. One
// launch on `stream`. Returns cudaGetLastError().
int mls_moments(const void* buckets, const void* counts, const void* points, void* pos, void* nrm,
                void* origin, void* normal, void* tu, void* tv, void* coeffs, void* ok, void* cnt,
                int n, int table, int cap, float cell, float r2, float sqr_gauss, int order,
                void* stream) {
  if (n < 1 || table < 1 || cap < 1 || cap > kMaxB) return cudaErrorInvalidValue;
  const int smem = kWarps * kCells * cap * int(sizeof(float4));
  cudaError_t err = cudaFuncSetAttribute(mls_moments_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = unsigned((n + kWarps - 1) / kWarps);
  mls_moments_kernel<<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(buckets), static_cast<const int*>(counts),
      static_cast<const float*>(points), static_cast<float*>(pos), static_cast<float*>(nrm),
      static_cast<float*>(origin), static_cast<float*>(normal), static_cast<float*>(tu),
      static_cast<float*>(tv), static_cast<float*>(coeffs), static_cast<unsigned char*>(ok),
      static_cast<int*>(cnt), n, table, cap, cell, r2, sqr_gauss, order);
  return cudaGetLastError();
}

}  // extern "C"

// The moments MLS pass for Hopper (sm_90a): M1.
//
// Replaces ops that XLA emits on the TPU without a Pallas source, the body
// of the MLS pass's lax.map (pointcloudprocessor_tpu/ops/mls.py:399-429):
//   knn.candidate_points (+ candidate_points_dedup)  knn.py:133-227
//   fit_surfaces_moments                              mls.py:203-317
//   project_onto (each point onto its own surface)    mls.py:181-200
// The hash grid (knn.build: a sort, a rank and a scatter into the (T, B)
// bucket table) and the schedule stay torch ops in the wrapper. The JAX
// package's cell-sorted, run-deduplicated fetch becomes the window that a
// block stages once for each cell among its points (cell_window.cuh).
//
// In: buckets (T, B) int32 (-1 empty), counts (T,) int32 (may exceed B),
// points (N, 3) f32, every point a query, and a schedule (N,) int32, a
// permutation of the points that groups equal cells. Out, per point: the
// projected position and normal (N, 3), the surface (origin, normal,
// tangent_u, tangent_v (N, 3), coeffs (N, 6), ok (N,) bool) and the
// in-radius count (N,) int32. A block takes kChunk points of the schedule
// and groups them by cell (cell_window.cuh); for each cell, its window
// staged:
//   1. a warp a point, pass 1 over the window: d = c - p, d2 = (dx*dx +
//      dy*dy) + dz*dz each step rounded (the plain version's order), in
//      when finite z and d2 <= r^2; w = exp(-d2 / sqr_gauss); the sums of
//      w and w * d; the in-radius candidates' window positions (16 bits) to
//      the warp's list; pass 2 over the list: the 6 weighted covariance
//      sums about the mean;
//   2. a thread a point: the normal by the plain version's inverse
//      iteration (C + 1e-6 (tr C + 1e-12) I, seed 0.577, three unrolled
//      Cholesky solves with the max(s, 1e-30) pivot clamp), turned towards
//      the point, and its tangent frame;
//   3. a warp a point: the list rebuilt, pass 3: the 15 distinct moments
//      sum w u^a v^b (a + b <= 4) and the 6 right-hand sides sum w h u^a v^b.
// Then, for the whole chunk, a thread a point: the 6x6 system with the 1e-8
// ridge, solved by one unrolled Cholesky (coefficients 0 under 6
// neighbors, ok from 3), and the point projected onto its own surface, as
// project_onto does. A candidate's offset and weight are recomputed from
// the window in each pass, bit for bit. Lane sums meet by warp shuffles, so
// the sums round otherwise than the plain version's: positions and normals
// agree to f32 rounding, the in-radius sets and counts exactly. The solves and the projection
// round each step as the plain version does (__f*_rn).
//
// What bounds it on the H100 (chip_smoke.py's phase_mls counts it from the
// run's inputs). Unique bytes (each input read once: the table's counts,
// the occupied slots, the points, the schedule, 101 bytes out a point):
// ~123 MB for the 1M-point hardened corner, ~37 us. f32 operations
// (M1_OPS_SLOT, M1_OPS_IN, M1_OPS_POINT there): ~10 a candidate slot read
// over ~241 slots a point, ~113 an in-radius candidate over ~63 a point and
// ~350 a point for the solves, frame and projection: ~9.8e9 for 1M points,
// ~0.15 ms at 67 TFLOP/s. The window replaces the per-point dependent
// random reads (count, slot, point) with one staging a cell a block; the
// passes read shared memory, and the instruction issue sets their pace.

#include <cuda_runtime.h>

#include "cell_window.cuh"

namespace {

using namespace cell_window;

constexpr int kWarps = 4;              // warps a block
constexpr int kChunk = 64;             // points a block
constexpr int kMaxB = 128;             // bucket capacity the kernel takes

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

// The in-radius candidates of the window for a query (its warp): their
// window positions, in window order, to the warp's list, and their count;
// f(dx, dy, dz, d2) on the lane that holds each of them.
template <class F>
__device__ __forceinline__ int in_radius(const Window& win, int total, const float (&q)[3],
                                         float r2, unsigned short* lst, int lane, F&& f) {
  int n_in = 0;
  for (int base = 0; base < total; base += 32) {
    const int e = base + lane;
    bool in = false;
    if (e < total) {
      float dx, dy, dz;
      const float pz = win.wz[e];
      const float d2 = offset2(win.wx[e], win.wy[e], pz, q[0], q[1], q[2], dx, dy, dz);
      in = isfinite(pz) && d2 <= r2;
      if (in) f(dx, dy, dz, d2);
    }
    const unsigned bal = __ballot_sync(kFull, in);
    if (in) lst[n_in + __popc(bal & ((1u << lane) - 1u))] = (unsigned short)e;
    n_in += __popc(bal);
  }
  __syncwarp();
  return n_in;
}

// A candidate's weight exp(-d2 / sqr_gauss).
__device__ __forceinline__ float weight(float d2, float sqr_gauss) {
  return expf(__fdiv_rn(-d2, sqr_gauss));
}

// A listed candidate's offset from the query and its weight.
__device__ __forceinline__ float candidate(const Window& win, int e, const float (&q)[3],
                                           float sqr_gauss, float& dx, float& dy, float& dz) {
  return weight(offset2(win.wx[e], win.wy[e], win.wz[e], q[0], q[1], q[2], dx, dy, dz),
                sqr_gauss);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__global__ void __launch_bounds__(kWarps * 32)
mls_moments_kernel(const int* __restrict__ buckets, const int* __restrict__ counts,
                   const float* __restrict__ pts, const int* __restrict__ sched,
                   float* __restrict__ out_pos, float* __restrict__ out_nrm,
                   float* __restrict__ out_origin, float* __restrict__ out_normal,
                   float* __restrict__ out_tu, float* __restrict__ out_tv,
                   float* __restrict__ out_coeffs, unsigned char* __restrict__ out_ok,
                   int* __restrict__ out_cnt, int* __restrict__ run_sizes, int n_sizes, int n,
                   int table, int cap, float cell, float r2, float sqr_gauss, int order) {
  __shared__ Chunk<kChunk> ch;
  __shared__ int s_cnt[kChunk];
  __shared__ float s_m[3][kChunk];    // the weighted mean's offset from the query
  __shared__ float s_f[9][kChunk];    // normal, tangent_u, tangent_v
  __shared__ float s_sum[21][kChunk]; // the covariance (6); then 15 moments, 6 right-hand sides
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int n_win = kCells * cap;
  Window win;
  win.wx = reinterpret_cast<float*>(smem);
  win.wy = win.wx + n_win;
  win.wz = win.wy + n_win;
  win.wi = reinterpret_cast<int*>(win.wz + n_win);
  unsigned short* lst = reinterpret_cast<unsigned short*>(win.wi + n_win) + w * n_win;

  const long long base = (long long)blockIdx.x * kChunk;
  load_chunk(ch, sched, pts, base, int(min((long long)kChunk, n - base)), cell, run_sizes,
             n_sizes);
  for (int r = 0; r < ch.n_runs; ++r) {
    const int rs = ch.run_start[r], re = ch.run_start[r + 1];
    stage_window(ch, ch.slot[rs], buckets, counts, pts, table, cap, win);
    const int total = ch.total;

    // Passes 1-2 (a warp a point): the in-radius list, the weighted mean,
    // then the covariance about it.
    for (int ru = rs + w; ru < re; ru += kWarps) {
      const int t = ch.slot[ru];
      const float q[3] = {ch.q[0][t], ch.q[1][t], ch.q[2][t]};
      // Pass 1 over the window: the list, the sums of w and w d.
      float sw = 0.f, sx = 0.f, sy = 0.f, sz = 0.f;
      const int n_in = in_radius(win, total, q, r2, lst, lane,
                                 [&](float dx, float dy, float dz, float d2) {
                                   const float wt = weight(d2, sqr_gauss);
                                   sw += wt;
                                   sx += wt * dx;
                                   sy += wt * dy;
                                   sz += wt * dz;
                                 });
      const float wsum = fmaxf(warp_sum(sw), 1e-20f);
      const float m[3] = {__fdiv_rn(warp_sum(sx), wsum), __fdiv_rn(warp_sum(sy), wsum),
                          __fdiv_rn(warp_sum(sz), wsum)};
      // Pass 2 over the list: the covariance about the mean.
      float cxx = 0.f, cxy = 0.f, cxz = 0.f, cyy = 0.f, cyz = 0.f, czz = 0.f;
      for (int u = lane; u < n_in; u += 32) {
        float dx, dy, dz;
        const float wt = candidate(win, lst[u], q, sqr_gauss, dx, dy, dz);
        const float ex = dx - m[0], ey = dy - m[1], ez = dz - m[2];
        const float wx = wt * ex, wy = wt * ey;
        cxx += wx * ex;
        cxy += wx * ey;
        cxz += wx * ez;
        cyy += wy * ey;
        cyz += wy * ez;
        czz += wt * ez * ez;
      }
      const float cov[6] = {warp_sum(cxx), warp_sum(cxy), warp_sum(cxz),
                            warp_sum(cyy), warp_sum(cyz), warp_sum(czz)};
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < 6; ++c) s_sum[c][t] = cov[c];
        s_cnt[t] = n_in;
#pragma unroll
        for (int d = 0; d < 3; ++d) s_m[d][t] = m[d];
      }
      __syncwarp();
    }
    __syncthreads();

    // The normal and its frame (a thread a point): inverse iteration on the
    // shifted covariance, turned towards the point.
    for (int ru = rs + threadIdx.x; ru < re; ru += kWarps * 32) {
      const int t = ch.slot[ru];
      float C[3][3];
      C[0][0] = s_sum[0][t];
      C[0][1] = C[1][0] = s_sum[1][t];
      C[0][2] = C[2][0] = s_sum[2][t];
      C[1][1] = s_sum[3][t];
      C[1][2] = C[2][1] = s_sum[4][t];
      C[2][2] = s_sum[5][t];
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
      float side[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const float qd = ch.q[d][t];
        side[d] = __fsub_rn(qd, __fadd_rn(qd, s_m[d][t]));
      }
      const float dside = dot3(nrm, side);
      const float sgn = dside > 0.f ? 1.f : (dside < 0.f ? -1.f : (dside == 0.f ? 1.f : dside));
#pragma unroll
      for (int d = 0; d < 3; ++d) nrm[d] = __fmul_rn(nrm[d], sgn);
      const float ref[3] = {fabsf(nrm[0]) < 0.9f ? 1.f : 0.f, fabsf(nrm[0]) < 0.9f ? 0.f : 1.f,
                            0.f};
      float tu[3], tv[3];
      cross3(nrm, ref, tu);
      unit3(tu);
      cross3(nrm, tu, tv);
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        s_f[d][t] = nrm[d];
        s_f[3 + d][t] = tu[d];
        s_f[6 + d][t] = tv[d];
      }
    }
    __syncthreads();

    // Pass 3 (a warp a point): the polynomial's moments in the tangent frame.
    if (order >= 2) {
      for (int ru = rs + w; ru < re; ru += kWarps) {
        const int t = ch.slot[ru];
        const float q[3] = {ch.q[0][t], ch.q[1][t], ch.q[2][t]};
        const int n_in =
            in_radius(win, total, q, r2, lst, lane, [](float, float, float, float) {});
        const float m[3] = {s_m[0][t], s_m[1][t], s_m[2][t]};
        const float nrm[3] = {s_f[0][t], s_f[1][t], s_f[2][t]};
        const float tu[3] = {s_f[3][t], s_f[4][t], s_f[5][t]};
        const float tv[3] = {s_f[6][t], s_f[7][t], s_f[8][t]};
        float mom[15], rhs[6];  // mom: a + b <= 4 in the order (0,0..4), (1,0..3), ...
#pragma unroll
        for (int s = 0; s < 15; ++s) mom[s] = 0.f;
#pragma unroll
        for (int s = 0; s < 6; ++s) rhs[s] = 0.f;
        for (int u = lane; u < n_in; u += 32) {
          float dx, dy, dz;
          const float wt = candidate(win, lst[u], q, sqr_gauss, dx, dy, dz);
          const float ex = dx - m[0], ey = dy - m[1], ez = dz - m[2];
          const float pu1 = ex * tu[0] + ey * tu[1] + ez * tu[2];
          const float pv1 = ex * tv[0] + ey * tv[1] + ez * tv[2];
          const float h = ex * nrm[0] + ey * nrm[1] + ez * nrm[2];
          const float pu[5] = {1.f, pu1, pu1 * pu1, pu1 * pu1 * pu1, pu1 * pu1 * pu1 * pu1};
          const float pv[5] = {1.f, pv1, pv1 * pv1, pv1 * pv1 * pv1, pv1 * pv1 * pv1 * pv1};
          int s = 0;
#pragma unroll
          for (int a = 0; a < 5; ++a)
#pragma unroll
            for (int bb = 0; bb < 5 - a; ++bb) mom[s++] += wt * pu[a] * pv[bb];
          const float wh = wt * h;
          rhs[0] += wh;
          rhs[1] += wh * pu1;
          rhs[2] += wh * pv1;
          rhs[3] += wh * pu[2];
          rhs[4] += wh * pu1 * pv1;
          rhs[5] += wh * pv[2];
        }
#pragma unroll
        for (int s = 0; s < 15; ++s) mom[s] = warp_sum(mom[s]);
#pragma unroll
        for (int s = 0; s < 6; ++s) rhs[s] = warp_sum(rhs[s]);
        if (lane == 0) {
#pragma unroll
          for (int s = 0; s < 15; ++s) s_sum[s][t] = mom[s];
#pragma unroll
          for (int s = 0; s < 6; ++s) s_sum[15 + s][t] = rhs[s];
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();

  // The polynomial's solve and the projection (a thread a query).
  for (int t = threadIdx.x; t < ch.len; t += kWarps * 32) {
    const int n_in = s_cnt[t];
    float coef[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (order >= 2 && n_in >= 6) {
      // Moment index of (a, b): the (a, b) of a + b <= 4 in row-major order.
      constexpr int kRow[5] = {0, 5, 9, 12, 14};
      constexpr int kEa[6] = {0, 1, 0, 2, 1, 0}, kEb[6] = {0, 0, 1, 0, 1, 2};
      float A[6][6];
#pragma unroll
      for (int rr = 0; rr < 6; ++rr)
#pragma unroll
        for (int c = 0; c < 6; ++c) {
          const float mo = s_sum[kRow[kEa[rr] + kEa[c]] + kEb[rr] + kEb[c]][t];
          A[rr][c] = rr == c ? __fadd_rn(mo, 1e-8f) : mo;
        }
#pragma unroll
      for (int s = 0; s < 6; ++s) coef[s] = s_sum[15 + s][t];
      chol_solve<6>(A, coef);
    }
    const bool ok = n_in >= 3;
    float q[3], origin[3], side[3], nrm[3], tu[3], tv[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      q[d] = ch.q[d][t];
      origin[d] = __fadd_rn(q[d], s_m[d][t]);
      side[d] = __fsub_rn(q[d], origin[d]);
      nrm[d] = s_f[d][t];
      tu[d] = s_f[3 + d][t];
      tv[d] = s_f[6 + d][t];
    }
    // The point projected onto its own surface (project_onto).
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
    const long long i = ch.idx[t];
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
// (buckets (table, cap) int32, counts (table,) int32, cap <= 128), taken in
// the schedule sched (n,) int32 (a permutation of 0 .. n-1): pos, nrm,
// origin, normal, tu, tv (n, 3) f32, coeffs (n, 6) f32, ok (n,) bool and
// cnt (n,) int32, all contiguous; order < 2 fits the plane alone. Where
// run_sizes ((n_sizes,) int32) is not null, adds 1 to run_sizes[min(s,
// n_sizes - 1)] for each window staged, s its points. One launch on
// `stream`. Returns cudaGetLastError().
int mls_moments(const void* buckets, const void* counts, const void* points, const void* sched,
                void* pos, void* nrm, void* origin, void* normal, void* tu, void* tv,
                void* coeffs, void* ok, void* cnt, void* run_sizes, int n_sizes, int n,
                int table, int cap, float cell, float r2, float sqr_gauss, int order,
                void* stream) {
  if (n < 1 || table < 1 || cap < 1 || cap > kMaxB || (run_sizes != nullptr && n_sizes < 1))
    return cudaErrorInvalidValue;
  // The window (x, y, z, index a slot) and each warp's list of 16-bit positions.
  const int smem = kCells * cap * (16 + 2 * kWarps);
  cudaError_t err = cudaFuncSetAttribute(mls_moments_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = unsigned((n + kChunk - 1) / kChunk);
  mls_moments_kernel<<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(buckets), static_cast<const int*>(counts),
      static_cast<const float*>(points), static_cast<const int*>(sched),
      static_cast<float*>(pos), static_cast<float*>(nrm), static_cast<float*>(origin),
      static_cast<float*>(normal), static_cast<float*>(tu), static_cast<float*>(tv),
      static_cast<float*>(coeffs), static_cast<unsigned char*>(ok), static_cast<int*>(cnt),
      static_cast<int*>(run_sizes), n_sizes, n, table, cap, cell, r2, sqr_gauss, order);
  return cudaGetLastError();
}

}  // extern "C"

// NID projection chain (forward) and its adjoint for Hopper (sm_90a).
//
// Replaces no Pallas kernel. On the TPU, XLA fuses the per-point chain of
// one NID evaluation: the pose and projection of _project_all
// (pointcloudprocessor_tpu/opt/nid.py:435, with core/se3.py:81,195 and
// models/camera.py:91), the point-bin marginal of _histograms_from_taps
// (:307-357), the frozen-tap guard's counts (:770-781) and s, and their
// reverse pass. Eager PyTorch ran them as ~300 launches forward and as many
// in autograd's backward, each moving the (K, N) points through device
// memory (opt/nid.project_points_plain is that chain, the kernels' twin):
//   P1 nid_project_fwd: per point T(q, t) applied to xyz, the plumb_bob
//      projection, the knot, the inlier gate, s, the intensity bin; per
//      keyframe the point-bin histogram and its count; for the frozen-tap
//      cache the guard's three counts over all keyframes;
//   P2 nid_project_bwd: from ds (K2's output), the pose gradient, dL/dq and
//      dL/dt for each row of a (1 or K) pose table.
//
// Data, for K keyframes of N points each (row-major, contiguous):
//   q (R, 4) f32 wxyz, t (R, 3) f32     the pose, R = 1 (shared) or K
//   intrinsic (4,) f32 fx fy cx cy, distortion (5,) f32 k1 k2 p1 p2 k3
//   points (K, N, 3) f32, intensity (K, N) f32, valid (K, N) bool
//   ref_knot (K, N, 2) int32            the frozen-tap cache's knot s is taken
//                                       against (clamped); null: the point's own
//   gate (K, N) f32 0/1                 the histogram's gate; null: the point's own
//   s (K, N, 2) f32, knot (K, N, 2) int32, inl (K, N) f32, bin (K, N) int32
//   hist_points (K, bins) f32, num (K,) f32, counts (3,) int64
//
// What bounds them on the H100: bytes. P1 reads 17 B a point (29 B with the
// cache's knot and gate) and writes 24 B; P2 reads 20 B (28 B clamped). The
// arithmetic is two IEEE divisions and ~60 f32 operations a point, a long
// dependent chain after each load, so a thread loads the next point's
// inputs before this point's arithmetic: at 64 x 262,144 on an H100 at
// 700 W that took P1 from 0.604 to 0.384 ms (0.69 of its bound) and P2
// from 0.327 to 0.190 ms (0.67). The grid gives every SM work at both of a
// solve's shapes (ops/nid_project.grid).
//
// Bit-equality with the eager chain. P1 rounds every operation as the eager
// kernels do, one rounding an op in their order: __fmul_rn / __fadd_rn /
// __fdiv_rn, which nvcc never contracts, except where torch.linalg.cross's
// own CUDA kernel contracts: its a*b - c*d compiles to fma(a, b, -(c*d))
// (probed on the card over 4M random pairs: 100% bit-equal, 83% without the
// FMA). The comparisons take f32 constants, as TensorIterator casts a
// Python scalar to the tensor's dtype. So knots, gates and s are bit-equal
// to the eager chain's, and the counts and hist_points, sums of 0/1 below
// 2^24, are exact whatever the order: the NID value is bit-equal.
//
// Reductions. A block counts in shared memory (a __match_any_sync leader
// adds a warp's points of one bin at once) and adds its integer counts
// into per-keyframe totals with integer atomics, which give the same sum in
// any order. The last block of a keyframe to arrive (a __threadfence and an
// atomicInc on a counter that wraps back to 0, K1's pattern) writes the
// keyframe's histogram and resets its totals to 0 for the next launch; the
// last keyframe to finish writes the guard's totals. P2 sums floats, so it
// keeps a fixed order: a shuffle tree in each warp, the warps in order, one
// partial a block, the blocks in order in the keyframe's last block, and the
// keyframes in order in the last one, which maps the 12 sums of each pose row
// (sum of g, sum of g p^T, g = dL/d(camera-frame point)) to dL/dq and dL/dt.
// No float atomics: a repeated solve takes the same path.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBins = 16;
constexpr unsigned kFull = 0xffffffffu;
// Per keyframe: kMaxBins point-bin counts, then the gate's count.
constexpr int kAcc = kMaxBins + 1;
constexpr int kSums = 12;  // P2: sum g (3), sum g p^T (9, row-major)

struct Camera {
  float fx, fy, cx, cy, k1, k2, p1, p2, k3;
};

struct Pose {
  float w, x, y, z, tx, ty, tz;
};

__device__ __forceinline__ Camera load_camera(const float* intrinsic, const float* distortion) {
  return Camera{intrinsic[0], intrinsic[1], intrinsic[2], intrinsic[3], distortion[0],
                distortion[1], distortion[2], distortion[3], distortion[4]};
}

__device__ __forceinline__ Pose load_pose(const float* q, const float* t, int row) {
  return Pose{q[4 * row], q[4 * row + 1], q[4 * row + 2], q[4 * row + 3],
              t[3 * row], t[3 * row + 1], t[3 * row + 2]};
}

// One component of torch.linalg.cross as its CUDA kernel rounds it.
__device__ __forceinline__ float cross_elem(float a, float b, float c, float d) {
  return __fmaf_rn(a, b, -__fmul_rn(c, d));
}

// se3.transform_points: v + 2 * (w * (u x v) + u x (u x v)), then + t.
__device__ __forceinline__ float3 transform(const Pose& T, float vx, float vy, float vz) {
  const float a = cross_elem(T.y, vz, T.z, vy);
  const float b = cross_elem(T.z, vx, T.x, vz);
  const float c = cross_elem(T.x, vy, T.y, vx);
  const float ua = cross_elem(T.y, c, T.z, b);
  const float ub = cross_elem(T.z, a, T.x, c);
  const float uc = cross_elem(T.x, b, T.y, a);
  const float ox = __fadd_rn(vx, __fmul_rn(2.0f, __fadd_rn(__fmul_rn(T.w, a), ua)));
  const float oy = __fadd_rn(vy, __fmul_rn(2.0f, __fadd_rn(__fmul_rn(T.w, b), ub)));
  const float oz = __fadd_rn(vz, __fmul_rn(2.0f, __fadd_rn(__fmul_rn(T.w, c), uc)));
  return make_float3(__fadd_rn(ox, T.tx), __fadd_rn(oy, T.ty), __fadd_rn(oz, T.tz));
}

struct Projected {
  float u, v;         // pixel
  float x, y, r2, rc;  // normalized point, its squared radius, the radial factor
  float z;            // the divisor (camera.project_xyz's safe_z)
  bool tiny;          // |z| < 1e-9: the divisor is a constant
};

// camera.project_xyz, op for op.
__device__ __forceinline__ Projected project(const Camera& k, float3 p) {
  Projected r;
  r.tiny = fabsf(p.z) < 1e-9f;
  r.z = r.tiny ? (p.z < 0.0f ? -1e-9f : 1e-9f) : p.z;
  r.x = __fdiv_rn(p.x, r.z);
  r.y = __fdiv_rn(p.y, r.z);
  const float x2 = __fmul_rn(r.x, r.x), y2 = __fmul_rn(r.y, r.y), xy = __fmul_rn(r.x, r.y);
  r.r2 = __fadd_rn(x2, y2);
  const float r4 = __fmul_rn(r.r2, r.r2);
  const float r6 = __fmul_rn(r.r2, r4);
  r.rc = __fadd_rn(__fadd_rn(__fadd_rn(1.0f, __fmul_rn(k.k1, r.r2)), __fmul_rn(k.k2, r4)),
                   __fmul_rn(k.k3, r6));
  const float xy2 = __fmul_rn(2.0f, xy);
  const float xd = __fadd_rn(__fadd_rn(__fmul_rn(r.rc, r.x), __fmul_rn(k.p1, xy2)),
                             __fmul_rn(k.p2, __fadd_rn(r.r2, __fmul_rn(2.0f, x2))));
  const float yd = __fadd_rn(__fadd_rn(__fmul_rn(r.rc, r.y),
                                       __fmul_rn(k.p1, __fadd_rn(r.r2, __fmul_rn(2.0f, y2)))),
                             __fmul_rn(k.p2, xy2));
  r.u = __fadd_rn(__fmul_rn(k.fx, xd), k.cx);
  r.v = __fadd_rn(__fmul_rn(k.fy, yd), k.cy);
  return r;
}

// utils/numeric.to_int32: truncate, saturate, NaN -> 0.
__device__ __forceinline__ int to_int32(float x) {
  if (x != x) return 0;
  if (x >= 2147483648.0f) return INT_MAX;
  return static_cast<int>(fmaxf(x, -2147483648.0f));
}

// torch.clamp(x, -1.5, 2.5), which passes NaN through.
__device__ __forceinline__ float clamp_s(float x) {
  return x != x ? x : fminf(fmaxf(x, -1.5f), 2.5f);
}

struct FwdArgs {
  const float *q, *t, *intrinsic, *distortion, *points, *intensity;
  const unsigned char* valid;
  const int2* ref_knot;
  const float* gate;
  float2* s;
  int2* knot;
  float* inl;
  int* bin;
  float *hist_points, *num;
  long long* counts;
  int* acc;                     // (K, kAcc) totals, 0 between launches
  unsigned long long* totals;   // (3,) guard totals, 0 between launches
  unsigned* arrive;             // (K + 1,) counters, 0 between launches
  float thr;                    // the guard's threshold, margin + 1 px
  int pose_rows, n, width, height, bins, ppb, guard;
};

// One point's inputs to P1.
struct FwdIn {
  float x, y, z, intensity, gate;
  int2 ref;
  bool valid;
};

__device__ __forceinline__ void load_fwd(const FwdArgs& a, long long i, FwdIn& in) {
  const float* p = a.points + 3 * i;
  in.x = __ldg(p);
  in.y = __ldg(p + 1);
  in.z = __ldg(p + 2);
  in.intensity = __ldg(a.intensity + i);
  in.valid = __ldg(a.valid + i);
  if (a.ref_knot) in.ref = __ldg(a.ref_knot + i);
  if (a.gate) in.gate = __ldg(a.gate + i);
}

__global__ void __launch_bounds__(kThreads) nid_project_fwd_kernel(const FwdArgs a) {
  // Point-bin counts, then the gate's, care's and the two drift counts.
  __shared__ int sh[kAcc + 3];
  __shared__ bool last;
  if (threadIdx.x < kAcc + 3) sh[threadIdx.x] = 0;
  __syncthreads();

  const int k = blockIdx.y;
  const long long base = static_cast<long long>(k) * a.n;
  const int lo = blockIdx.x * a.ppb, hi = min(a.n, lo + a.ppb);
  const Pose T = load_pose(a.q, a.t, a.pose_rows == 1 ? 0 : k);
  const Camera cam = load_camera(a.intrinsic, a.distortion);
  const int lane = threadIdx.x & 31;
  int n_gate = 0, n_care = 0, n_d1 = 0, n_d2 = 0;  // this warp's, in lane 0
  // One point a thread a step, the next step's inputs loaded before this
  // step's arithmetic, so that they are in flight meanwhile. The same trip
  // count for every thread of the block: the warp votes below.
  FwdIn cur = {}, next = {};
  if (lo + static_cast<int>(threadIdx.x) < hi) load_fwd(a, base + lo + threadIdx.x, cur);
  for (int j0 = lo; j0 < hi; j0 += kThreads) {
    const int j = j0 + threadIdx.x;
    if (j + kThreads < hi) load_fwd(a, base + j + kThreads, next);
    int key = -1;
    bool care = false, d1 = false, d2 = false;
    if (j < hi) {
      const long long i = base + j;
      const float3 c = transform(T, cur.x, cur.y, cur.z);
      const Projected pr = project(cam, c);
      const int kx = to_int32(floorf(pr.u)), ky = to_int32(floorf(pr.v));
      const bool own = cur.valid && kx >= 0 && kx < a.width && ky >= 0 && ky < a.height &&
                       c.z > 0.0f;
      float sx, sy;
      if (a.ref_knot) {
        const int2 r = cur.ref;
        sx = clamp_s(__fsub_rn(pr.u, __int2float_rn(r.x)));
        sy = clamp_s(__fsub_rn(pr.v, __int2float_rn(r.y)));
        if (a.guard) {
          const float shift = fmaxf(fabsf(__fsub_rn(__int2float_rn(kx), __int2float_rn(r.x))),
                                    fabsf(__fsub_rn(__int2float_rn(ky), __int2float_rn(r.y))));
          care = own || cur.gate > 0.0f;
          d1 = care && shift >= a.thr;
          d2 = care && shift >= a.thr + 1.0f;
        }
      } else {
        sx = __fsub_rn(pr.u, __int2float_rn(kx));
        sy = __fsub_rn(pr.v, __int2float_rn(ky));
      }
      const int b = min(max(to_int32(__fmul_rn(cur.intensity, static_cast<float>(a.bins))), 0),
                        a.bins - 1);
      a.s[i] = make_float2(sx, sy);
      a.knot[i] = make_int2(kx, ky);
      a.inl[i] = own ? 1.0f : 0.0f;
      a.bin[i] = b;
      if (a.gate ? cur.gate != 0.0f : own) key = b;
    }
    cur = next;
    const unsigned peers = __match_any_sync(kFull, key);
    if (key >= 0 && lane == __ffs(peers) - 1) atomicAdd(sh + key, __popc(peers));
    const int g = __popc(__ballot_sync(kFull, key >= 0));
    const int c1 = __popc(__ballot_sync(kFull, care));
    const int c2 = __popc(__ballot_sync(kFull, d1));
    const int c3 = __popc(__ballot_sync(kFull, d2));
    if (lane == 0) {
      n_gate += g;
      n_care += c1;
      n_d1 += c2;
      n_d2 += c3;
    }
  }
  if (lane == 0) {
    atomicAdd(sh + kMaxBins, n_gate);
    atomicAdd(sh + kAcc, n_care);
    atomicAdd(sh + kAcc + 1, n_d1);
    atomicAdd(sh + kAcc + 2, n_d2);
  }
  __syncthreads();

  // The block's counts into its keyframe's totals and the guard's.
  int* acc = a.acc + k * kAcc;
  if (threadIdx.x < kAcc && sh[threadIdx.x]) atomicAdd(acc + threadIdx.x, sh[threadIdx.x]);
  if (threadIdx.x >= kAcc && threadIdx.x < kAcc + 3 && sh[threadIdx.x])
    atomicAdd(a.totals + threadIdx.x - kAcc, static_cast<unsigned long long>(sh[threadIdx.x]));
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicInc(a.arrive + k, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // The keyframe's last block: its histogram, the totals reset for the next launch.
  if (threadIdx.x < kAcc) {
    const int v = atomicExch(acc + threadIdx.x, 0);
    if (threadIdx.x < a.bins) a.hist_points[k * a.bins + threadIdx.x] = static_cast<float>(v);
    if (threadIdx.x == kMaxBins) a.num[k] = static_cast<float>(v);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicInc(a.arrive + gridDim.y, gridDim.y - 1) == gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (threadIdx.x < 3)
    a.counts[threadIdx.x] = static_cast<long long>(atomicExch(a.totals + threadIdx.x, 0ull));
}

struct BwdArgs {
  const float2* ds;
  const float *q, *t, *intrinsic, *distortion, *points;
  const int2* ref_knot;  // null: s was not clamped
  float* partial;        // (K, blocks a keyframe, kSums)
  float* kf_sums;        // (K, kSums)
  unsigned* arrive;      // (K + 1,) counters, 0 between launches
  float *dq, *dt;        // (R, 4), (R, 3)
  int pose_rows, n, ppb;
};

// dL/dq and dL/dt of one pose row from its sums: G = sum g, M = sum g p^T.
// The point is v + 2 w (u x v) + 2 u x (u x v) + t, so with a_j =
// sum_ik eps_ijk M_ik: dL/dw = 2 u.a and dL/du = 2 w a + 2 (M u + M^T u -
// 2 tr(M) u).
__device__ void pose_grad(const float* q, const float* S, float* dq, float* dt) {
  const float w = q[0], u[3] = {q[1], q[2], q[3]};
  const float* M = S + 3;
  const float av[3] = {M[7] - M[5], M[2] - M[6], M[3] - M[1]};
  const float tr = M[0] + M[4] + M[8];
  dq[0] = 2.0f * (u[0] * av[0] + u[1] * av[1] + u[2] * av[2]);
  for (int j = 0; j < 3; ++j) {
    const float mu = M[3 * j] * u[0] + M[3 * j + 1] * u[1] + M[3 * j + 2] * u[2];
    const float mtu = M[j] * u[0] + M[3 + j] * u[1] + M[6 + j] * u[2];
    dq[1 + j] = 2.0f * w * av[j] + 2.0f * (mu + mtu - 2.0f * tr * u[j]);
    dt[j] = S[j];
  }
}

// One point's inputs to P2.
struct BwdIn {
  float2 g;
  float x, y, z;
  int2 ref;
};

__device__ __forceinline__ void load_bwd(const BwdArgs& a, long long i, BwdIn& in) {
  in.g = __ldg(a.ds + i);
  const float* p = a.points + 3 * i;
  in.x = __ldg(p);
  in.y = __ldg(p + 1);
  in.z = __ldg(p + 2);
  if (a.ref_knot) in.ref = __ldg(a.ref_knot + i);
}

__global__ void __launch_bounds__(kThreads) nid_project_bwd_kernel(const BwdArgs a) {
  __shared__ float red[kWarps][kSums];
  __shared__ bool last;
  const int k = blockIdx.y;
  const long long base = static_cast<long long>(k) * a.n;
  const int lo = blockIdx.x * a.ppb, hi = min(a.n, lo + a.ppb);
  const Pose T = load_pose(a.q, a.t, a.pose_rows == 1 ? 0 : k);
  const Camera cam = load_camera(a.intrinsic, a.distortion);
  float acc[kSums];
#pragma unroll
  for (int c = 0; c < kSums; ++c) acc[c] = 0.0f;
  // One point a thread a step, the next step's inputs loaded first (as P1).
  BwdIn cur = {}, next = {};
  if (lo + static_cast<int>(threadIdx.x) < hi) load_bwd(a, base + lo + threadIdx.x, cur);
  for (int j = lo + threadIdx.x; j < hi; j += kThreads) {
    const BwdIn in = cur;
    if (j + kThreads < hi) load_bwd(a, base + j + kThreads, next);
    cur = next;
    const float2 g = in.g;
    // A gated-out point has ds = 0 and adds nothing.
    if (g.x == 0.0f && g.y == 0.0f) continue;
    const float px = in.x, py = in.y, pz = in.z;
    const Projected pr = project(cam, transform(T, px, py, pz));
    float gx = g.x, gy = g.y;
    if (a.ref_knot) {  // the clamp's gradient: 1 inside [-1.5, 2.5], ends included
      const int2 r = in.ref;
      const float rx = __fsub_rn(pr.u, __int2float_rn(r.x));
      const float ry = __fsub_rn(pr.v, __int2float_rn(r.y));
      if (!(rx >= -1.5f && rx <= 2.5f)) gx = 0.0f;
      if (!(ry >= -1.5f && ry <= 2.5f)) gy = 0.0f;
    }
    const float x = pr.x, y = pr.y, r2 = pr.r2;
    const float drc = cam.k1 + 2.0f * cam.k2 * r2 + 3.0f * cam.k3 * r2 * r2;
    const float jxy = 2.0f * x * y * drc + 2.0f * cam.p1 * x + 2.0f * cam.p2 * y;
    const float jxx = pr.rc + 2.0f * x * x * drc + 2.0f * cam.p1 * y + 6.0f * cam.p2 * x;
    const float jyy = pr.rc + 2.0f * y * y * drc + 6.0f * cam.p1 * y + 2.0f * cam.p2 * x;
    const float gu = cam.fx * gx, gv = cam.fy * gy;
    const float dx = gu * jxx + gv * jxy, dy = gu * jxy + gv * jyy;
    const float cx = dx / pr.z, cy = dy / pr.z;
    const float cz = pr.tiny ? 0.0f : -(dx * x + dy * y) / pr.z;
    acc[0] += cx;
    acc[1] += cy;
    acc[2] += cz;
    acc[3] += cx * px; acc[4] += cx * py; acc[5] += cx * pz;
    acc[6] += cy * px; acc[7] += cy * py; acc[8] += cy * pz;
    acc[9] += cz * px; acc[10] += cz * py; acc[11] += cz * pz;
  }
  // The block's partial: a shuffle tree in each warp, the warps in order.
#pragma unroll
  for (int c = 0; c < kSums; ++c) {
    float v = acc[c];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
    acc[c] = v;
  }
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int c = 0; c < kSums; ++c) red[warp][c] = acc[c];
  }
  __syncthreads();
  const int per_kf = gridDim.x;
  if (threadIdx.x < kSums) {
    float v = 0.0f;
    for (int w = 0; w < kWarps; ++w) v += red[w][threadIdx.x];
    a.partial[(static_cast<long long>(k) * per_kf + blockIdx.x) * kSums + threadIdx.x] = v;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicInc(a.arrive + k, per_kf - 1) == per_kf - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // The keyframe's last block: its sums, the blocks in order.
  if (threadIdx.x < kSums) {
    const float* part = a.partial + static_cast<long long>(k) * per_kf * kSums + threadIdx.x;
    float v = 0.0f;
    for (int b = 0; b < per_kf; ++b) v += __ldcg(part + static_cast<long long>(b) * kSums);
    a.kf_sums[k * kSums + threadIdx.x] = v;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicInc(a.arrive + gridDim.y, gridDim.y - 1) == gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // The last keyframe: each pose row's sums, the keyframes in order, and its gradient.
  const int kf = gridDim.y;
  for (int row = threadIdx.x; row < a.pose_rows; row += kThreads) {
    float S[kSums];
    for (int c = 0; c < kSums; ++c) S[c] = 0.0f;
    const int k0 = a.pose_rows == 1 ? 0 : row, k1 = a.pose_rows == 1 ? kf : row + 1;
    for (int kk = k0; kk < k1; ++kk)
      for (int c = 0; c < kSums; ++c) S[c] += __ldcg(a.kf_sums + kk * kSums + c);
    pose_grad(a.q + 4 * row, S, a.dq + 4 * row, a.dt + 3 * row);
  }
}

bool valid_grid(int k, int n, int per_kf, int ppb) {
  return k >= 1 && k <= 65535 && n >= 1 && per_kf >= 1 && ppb >= 1 &&
         static_cast<long long>(per_kf) * ppb >= n &&
         static_cast<long long>(per_kf - 1) * ppb < n;
}

}  // namespace

extern "C" {

// P1: one launch of (per_kf, K) blocks of ppb points. With ref_knot, s is
// clamp(proj - ref_knot, -1.5, 2.5), and with guard (ref_knot and gate
// given) counts holds the frozen-tap guard's (care, drifted >= thr,
// drifted >= thr + 1) over all keyframes; otherwise s is proj - knot and
// counts is 0. acc (K * 17 int32), totals (3 uint64) and arrive (K + 1
// uint32) are 0 before the first launch and left at 0 by each. Returns
// cudaGetLastError().
int nid_project_fwd(const void* q, const void* t, const void* intrinsic, const void* distortion,
                    const void* points, const void* intensity, const void* valid,
                    const void* ref_knot, const void* gate, void* s, void* knot, void* inl,
                    void* bin, void* hist_points, void* num, void* counts, void* acc,
                    void* totals, void* arrive, float thr, int pose_rows, int k, int n, int width,
                    int height, int bins, int guard, int per_kf, int ppb, void* stream) {
  if (!valid_grid(k, n, per_kf, ppb) || bins < 1 || bins > kMaxBins ||
      (pose_rows != 1 && pose_rows != k) || (guard && (!ref_knot || !gate)))
    return cudaErrorInvalidValue;
  FwdArgs a;
  a.q = static_cast<const float*>(q);
  a.t = static_cast<const float*>(t);
  a.intrinsic = static_cast<const float*>(intrinsic);
  a.distortion = static_cast<const float*>(distortion);
  a.points = static_cast<const float*>(points);
  a.intensity = static_cast<const float*>(intensity);
  a.valid = static_cast<const unsigned char*>(valid);
  a.ref_knot = static_cast<const int2*>(ref_knot);
  a.gate = static_cast<const float*>(gate);
  a.s = static_cast<float2*>(s);
  a.knot = static_cast<int2*>(knot);
  a.inl = static_cast<float*>(inl);
  a.bin = static_cast<int*>(bin);
  a.hist_points = static_cast<float*>(hist_points);
  a.num = static_cast<float*>(num);
  a.counts = static_cast<long long*>(counts);
  a.acc = static_cast<int*>(acc);
  a.totals = static_cast<unsigned long long*>(totals);
  a.arrive = static_cast<unsigned*>(arrive);
  a.thr = thr;
  a.pose_rows = pose_rows;
  a.n = n;
  a.width = width;
  a.height = height;
  a.bins = bins;
  a.ppb = ppb;
  a.guard = guard;
  nid_project_fwd_kernel<<<dim3(per_kf, k), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

// P2: dq (R, 4) and dt (R, 3) from ds (K, n, 2) on P1's grid; ref_knot as
// P1 took it (null: no clamp). partial (K * per_kf * 12 f32) and kf_sums
// (K * 12 f32) are scratch; arrive (K + 1 uint32) is 0 before the first
// launch and left at 0 by each. Returns cudaGetLastError().
int nid_project_bwd(const void* ds, const void* q, const void* t, const void* intrinsic,
                    const void* distortion, const void* points, const void* ref_knot,
                    void* partial, void* kf_sums, void* arrive, void* dq, void* dt,
                    int pose_rows, int k, int n, int per_kf, int ppb, void* stream) {
  if (!valid_grid(k, n, per_kf, ppb) || (pose_rows != 1 && pose_rows != k))
    return cudaErrorInvalidValue;
  BwdArgs a;
  a.ds = static_cast<const float2*>(ds);
  a.q = static_cast<const float*>(q);
  a.t = static_cast<const float*>(t);
  a.intrinsic = static_cast<const float*>(intrinsic);
  a.distortion = static_cast<const float*>(distortion);
  a.points = static_cast<const float*>(points);
  a.ref_knot = static_cast<const int2*>(ref_knot);
  a.partial = static_cast<float*>(partial);
  a.kf_sums = static_cast<float*>(kf_sums);
  a.arrive = static_cast<unsigned*>(arrive);
  a.dq = static_cast<float*>(dq);
  a.dt = static_cast<float*>(dt);
  a.pose_rows = pose_rows;
  a.n = n;
  a.ppb = ppb;
  nid_project_bwd_kernel<<<dim3(per_kf, k), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // extern "C"

// The z-buffer's shared pieces: the order-preserving range key, the image
// grid and the gate and cell of one point, and the view of a world point
// (its transform into a camera and its pixel). Included by zbuffer.cu (the
// cull, K5/Z1), colorize.cu (C1) and hpr.cu (H2's views), so that one gate
// decides visibility and one transform and projection place a point on
// every path of the program.
//
// Keys. A buffer holds an order-preserving u32 key of each range:
//   key(b) = (b ^ ((b >> 31) & 0x7fffffff)) ^ 0x80000000   on the f32 bits b
// orders every non-NaN f32 as the floats are ordered, negatives included; the
// map without the final xor is its own inverse, which decode uses. It would
// put -0 just below +0, so every range first gets +0.0 added, which turns -0
// into +0: a buffer never holds -0, as the plain version's never does. The
// fill key is 0xffffffff (a byte memset of 0xff), above every range's key; a
// reader takes min(decode, FLT_MAX), so a cell whose points all have +inf
// ranges reads FLT_MAX, the plain version's fill (the all-ones key decodes to
// a NaN, which fminf drops).
//
// Gate and cell in f32 as ops/zbuffer.cells computes them: floorf, IEEE
// division __fdiv_rn (the build has no --use_fast_math), truncation
// __float2int_rz. On a gated-in point u / ds is finite and in [0, W / ds],
// where truncation is what to_int32 gives; a gated-out point's cell is never
// used.

#pragma once

#include <cuda_runtime.h>
#include <float.h>

namespace zbuf {

// Order-preserving f32 bits <-> i32 map; an involution.
__host__ __device__ __forceinline__ int order_bits(int b) { return b ^ ((b >> 31) & 0x7fffffff); }
__host__ __device__ __forceinline__ unsigned encode(int b) { return unsigned(order_bits(b)) ^ 0x80000000u; }
__host__ __device__ __forceinline__ int decode(unsigned k) { return order_bits(int(k ^ 0x80000000u)); }

__device__ __forceinline__ unsigned range_key(float r) {
  return encode(__float_as_int(__fadd_rn(r, 0.0f)));  // -0 -> +0
}

// The cell's minimum range as the depth test reads it.
__device__ __forceinline__ float cell_min(const unsigned* __restrict__ buf, int cell) {
  return fminf(__int_as_float(decode(__ldg(buf + cell))), FLT_MAX);
}

// The image and its z-buffer grid.
struct Grid {
  float width, height, ds;  // image size and cell size in pixels, as f32
  int gw, gh;               // cells a row, rows: width / ds, height / ds
};

inline Grid make_grid(int width, int height, int ds) {
  return Grid{float(width), float(height), float(ds), width / ds, height / ds};
}

// The gate and the cell of one point (`ops/zbuffer.cells`).
__device__ __forceinline__ bool gate_cell(float u, float v, float z, bool valid, const Grid& g,
                                          int& cell) {
  const float uf = floorf(u), vf = floorf(v);
  const bool ok = valid && z > 0.0f && uf >= 0.0f && uf < g.width && vf >= 0.0f && vf < g.height;
  const int ui = min(max(__float2int_rz(__fdiv_rn(u, g.ds)), 0), g.gw - 1);
  const int vi = min(max(__float2int_rz(__fdiv_rn(v, g.ds)), 0), g.gh - 1);
  cell = vi * g.gw + ui;
  return ok;
}

// p_cam = R p + t, R row-major at pose[0..8], t at pose[9..11], each step
// rounded in core/se3.transform_xyz's order.
__device__ __forceinline__ void transform(const float* pose, float px, float py, float pz,
                                          float& x, float& y, float& z) {
  x = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(pose[0], px), __fmul_rn(pose[1], py)),
                          __fmul_rn(pose[2], pz)), pose[9]);
  y = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(pose[3], px), __fmul_rn(pose[4], py)),
                          __fmul_rn(pose[5], pz)), pose[10]);
  z = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(pose[6], px), __fmul_rn(pose[7], py)),
                          __fmul_rn(pose[8], pz)), pose[11]);
}

// The pixel of a camera-frame point (models/camera.project_xyz, each step
// rounded in its order); c = fx, fy, cx, cy, k1, k2, p1, p2, k3. x and y
// are the point over its guarded depth, as the projection forms them.
__device__ __forceinline__ void pixel(const float* c, float px, float py, float pz, float& u,
                                      float& v, float& x, float& y) {
  const float tiny = static_cast<float>(1e-9);
  const float safe_z = fabsf(pz) < tiny ? (pz < 0.0f ? -tiny : tiny) : pz;
  x = __fdiv_rn(px, safe_z);
  y = __fdiv_rn(py, safe_z);
  const float x2 = __fmul_rn(x, x), y2 = __fmul_rn(y, y), xy = __fmul_rn(x, y);
  const float r2 = __fadd_rn(x2, y2), r4 = __fmul_rn(r2, r2), r6 = __fmul_rn(r2, r4);
  const float k1 = c[4], k2 = c[5], p1 = c[6], p2 = c[7], k3 = c[8];
  const float rc = __fadd_rn(__fadd_rn(__fadd_rn(1.0f, __fmul_rn(k1, r2)), __fmul_rn(k2, r4)),
                             __fmul_rn(k3, r6));
  const float xd = __fadd_rn(__fadd_rn(__fmul_rn(rc, x), __fmul_rn(p1, __fmul_rn(2.0f, xy))),
                             __fmul_rn(p2, __fadd_rn(r2, __fmul_rn(2.0f, x2))));
  const float yd = __fadd_rn(__fadd_rn(__fmul_rn(rc, y), __fmul_rn(p1, __fadd_rn(r2, __fmul_rn(2.0f, y2)))),
                             __fmul_rn(p2, __fmul_rn(2.0f, xy)));
  u = __fadd_rn(__fmul_rn(c[0], xd), c[2]);
  v = __fadd_rn(__fmul_rn(c[1], yd), c[3]);
}

__device__ __forceinline__ void pixel(const float* c, float px, float py, float pz, float& u,
                                      float& v) {
  float x, y;
  pixel(c, px, py, pz, u, v, x, y);
}

}  // namespace zbuf

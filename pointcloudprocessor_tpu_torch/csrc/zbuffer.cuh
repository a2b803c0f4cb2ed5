// The z-buffer's shared pieces: the order-preserving range key, the image
// grid and the gate and cell of one point. Included by zbuffer.cu (the cull,
// K5/Z1) and colorize.cu (C1), so that one gate decides visibility on every
// path of the program.
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

}  // namespace zbuf

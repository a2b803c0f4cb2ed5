// Z-buffer cull for Hopper (sm_90a): the scatter-min and the visibility test.
//
// Replaces the Pallas TPU kernel of pointcloudprocessor_tpu/tools/zbuffer_probe.py:
//   K5 zmin  <- _zmin_kernel (zbuffer_probe.py:42, pallas_call at :81)
// and the z-buffer cull that the JAX package leaves to XLA (Z1,
// pointcloudprocessor_tpu/ops/zbuffer.py:57-70: the gate, the cell, the
// `.at[].min` scatter, the cell-min gather and the depth test).
//
// The main path's cull, cull_mask: one memset and two launches on the card.
//   memset         the (gw * gh,) key buffer to all ones, the fill key
//   pass (a) cull_scatter  per point: ok = valid && z > 0 && floor(u) in
//            [0, W) && floor(v) in [0, H); cell = clamp(trunc(v / ds)) * gw +
//            clamp(trunc(u / ds)); if ok, buf[cell] = min(buf[cell], key(rng))
//   pass (b) cull_test     per point: the same ok and cell, then
//            vis = ok && rng <= min(decode(buf[cell]), FLT_MAX) + eps
// Inputs: u, v, z, rng (N,) f32 and valid (N,) bool, each with its element
// stride; vis (N,) bool. One point a thread. Each pass reads 17 B a point;
// (b) writes 1 B.
//
// Keys, the gate and the cell are zbuffer.cuh's, shared with colorize.cu
// (C1). A NaN range on a gated-in point is outside the contract: a range
// sqrt(x^2 + y^2 + z^2) is NaN only where u, v or z is, and the gate drops
// those. The sum decode + eps rounds to f32 and nothing multiplies, so no FMA
// changes it.
//
// What bounds it on the H100: the bytes (17 + 18 B a point) and, in pass
// (a), the rate at which L2 takes random atomics. The buffer (62,488 cells,
// 250 KB, at the reference scale) is more than the 227 KB of shared memory a
// block may use and lives in the 50 MB L2. A gated-out point issues nothing;
// a gated-in one issues its atomicMin (a RED: nothing waits on it). Slower
// on the smoke scene (PERF.md): a read of the cell's key before the atomic,
// warp combining of same-cell lanes, private copies of the buffer in the
// distributed shared memory of thread-block clusters. Four points a thread
// with 16-byte loads was as fast in map order and faster only on a
// raster-sorted copy, which no path of the program produces.
//
// The probe's form, zmin (cells given, any fill, an f32 buffer out), fills
// the keys, scatters and decodes them in place: three launches. Its callers
// send every gated-out point to one sink cell, so its scatter reads the
// cell's key first and skips the atomic where it cannot lower it.
// zbuffer_visible tests given ok, rng and cells against such a buffer.

#include <cuda_runtime.h>
#include <string.h>

#include "zbuffer.cuh"

namespace {

using namespace zbuf;

constexpr int kThreads = 256;

inline int float_bits(float f) {
  int b;
  memcpy(&b, &f, sizeof b);
  return b;
}

// The cull's inputs: five arrays, each with its element stride.
struct Points {
  const float* u;
  const float* v;
  const float* z;
  const float* rng;
  const unsigned char* valid;
  long long su, sv, sz, sr, sval;
};

// Point i's inputs through the strides; its gate and its cell.
__device__ __forceinline__ bool load_gate_cell(const Points& p, const Grid& g, long long i,
                                               float& r, int& cell) {
  r = __ldg(p.rng + i * p.sr);
  return gate_cell(__ldg(p.u + i * p.su), __ldg(p.v + i * p.sv), __ldg(p.z + i * p.sz),
                   __ldg(p.valid + i * p.sval), g, cell);
}

__global__ void __launch_bounds__(kThreads)
cull_scatter(Points p, Grid g, unsigned* __restrict__ buf, int n) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float r;
  int cell;
  if (load_gate_cell(p, g, i, r, cell)) atomicMin(buf + cell, range_key(r));
}

__global__ void __launch_bounds__(kThreads)
cull_test(Points p, Grid g, const unsigned* __restrict__ buf, unsigned char* __restrict__ vis,
          int n, float eps) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float r;
  int cell;
  bool v = false;
  if (load_gate_cell(p, g, i, r, cell)) v = r <= __fadd_rn(cell_min(buf, cell), eps);
  vis[i] = v ? 1 : 0;
}

// The probe's form: cells given.
__global__ void __launch_bounds__(kThreads)
zmin_fill(unsigned* __restrict__ buf, int n_slots, unsigned fill_key) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_slots) buf[i] = fill_key;
}

__global__ void __launch_bounds__(kThreads)
zmin_scatter(const int* __restrict__ cell, const float* __restrict__ rng, unsigned* buf, int n,
             int n_slots) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int c = cell[i];
  if (c < 0 || c >= n_slots) return;
  const unsigned key = range_key(rng[i]);
  // buf[c] only decreases, so a stale read can only cost a needless atomic.
  if (key < buf[c]) atomicMin(buf + c, key);
}

__global__ void __launch_bounds__(kThreads)
zmin_finish(unsigned* __restrict__ buf, int n_slots) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_slots) reinterpret_cast<int*>(buf)[i] = decode(buf[i]);
}

__global__ void __launch_bounds__(kThreads)
zbuffer_visible_kernel(const unsigned char* __restrict__ ok, const float* __restrict__ rng,
                       const float* __restrict__ buf, const int* __restrict__ cell,
                       unsigned char* __restrict__ vis, int n, int n_slots, float eps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int c = cell[i];
  bool v = false;
  if (ok[i] && c >= 0 && c < n_slots) v = rng[i] <= __fadd_rn(buf[c], eps);
  vis[i] = v ? 1 : 0;
}

inline unsigned blocks(long long threads) { return unsigned((threads + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// The cull: vis (N,) bool from u, v, z, rng (f32) and valid (bool), each
// with its element stride, on a width x height image cut into ds x ds cells.
// buf is a (gw * gh,) u32 scratch buffer (its cells' minimum keys on
// return). One memset and two launches on `stream`; n >= 1. Returns the
// first CUDA error.
int cull_mask(const void* u, const void* v, const void* z, const void* rng, const void* valid,
              long long su, long long sv, long long sz, long long sr, long long sval, void* buf,
              void* vis, int n, int width, int height, int ds, float eps, void* stream) {
  if (n < 1 || ds < 1 || width / ds < 1 || height / ds < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Points p{static_cast<const float*>(u), static_cast<const float*>(v),
                 static_cast<const float*>(z), static_cast<const float*>(rng),
                 static_cast<const unsigned char*>(valid), su, sv, sz, sr, sval};
  const Grid g = make_grid(width, height, ds);
  unsigned* b = static_cast<unsigned*>(buf);
  cudaError_t err = cudaMemsetAsync(b, 0xff, size_t(g.gw) * g.gh * sizeof(unsigned), st);
  if (err != cudaSuccess) return err;
  cull_scatter<<<blocks(n), kThreads, 0, st>>>(p, g, b, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cull_test<<<blocks(n), kThreads, 0, st>>>(p, g, b, static_cast<unsigned char*>(vis), n, eps);
  return cudaGetLastError();
}

// K5, cells given: buf (n_slots,) f32 = fill, then the scatter-min of rng
// into buf at cell, dropping cells outside [0, n_slots). Three launches on
// `stream`: fill keys, scatter, decode in place. Returns cudaGetLastError().
int zmin(const void* cell, const void* rng, void* buf, int n, int n_slots, float fill,
         void* stream) {
  if (n < 0 || n_slots < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned* b = static_cast<unsigned*>(buf);
  zmin_fill<<<blocks(n_slots), kThreads, 0, st>>>(b, n_slots, encode(float_bits(fill + 0.0f)));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (n > 0) {
    zmin_scatter<<<blocks(n), kThreads, 0, st>>>(static_cast<const int*>(cell),
                                                 static_cast<const float*>(rng), b, n, n_slots);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  zmin_finish<<<blocks(n_slots), kThreads, 0, st>>>(b, n_slots);
  return cudaGetLastError();
}

// Z1's test, cells given: vis (N,) bool = ok && rng <= buf[cell] + eps.
// Returns cudaGetLastError().
int zbuffer_visible(const void* ok, const void* rng, const void* buf, const void* cell,
                    void* vis, int n, int n_slots, float eps, void* stream) {
  if (n < 0 || n_slots < 1) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  zbuffer_visible_kernel<<<blocks(n), kThreads, 0, st>>>(
      static_cast<const unsigned char*>(ok), static_cast<const float*>(rng),
      static_cast<const float*>(buf), static_cast<const int*>(cell),
      static_cast<unsigned char*>(vis), n, n_slots, eps);
  return cudaGetLastError();
}

}  // extern "C"

// Z-buffer scatter-min and visibility test for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of pointcloudprocessor_tpu/tools/zbuffer_probe.py:
//   K5 zmin  <- _zmin_kernel (zbuffer_probe.py:42, pallas_call at :81)
// and serves, with zbuffer_visible, the z-buffer cull that the JAX package
// leaves to XLA (Z1, pointcloudprocessor_tpu/ops/zbuffer.py:57-70):
//   zmin             buf[c] = min(fill, min over points i with cell[i] == c of rng[i])
//   zbuffer_visible  vis[i] = ok[i] && rng[i] <= buf[cell[i]] + eps
//
// Data (contiguous): cell (N,) int32, rng (N,) f32, ok (N,) bool (one byte,
// 0 or 1), buf (n_slots,) f32, vis (N,) bool.
//
// zmin: the TPU has no vector scatter, so its kernel scalar-loops 2048 points
//   a grid step into an SMEM accumulator that lives across the whole
//   sequential grid. On Hopper the blocks run in parallel in no order, so
//   one thread per point does atomicMin on an order-preserving int32 key of
//   its range: key(b) = b ^ ((b >> 31) & 0x7fffffff) on the f32 bits b
//   orders every non-NaN f32 as the floats are ordered, negatives included.
//   It would put -0 just below +0, so each range and the fill first get
//   +0.0 added, which turns -0 into +0: a buffer never holds -0, and it
//   agrees in bits with the plain version's (which adds +0.0 as well,
//   because its scatter keeps whichever of two equal zeros comes first).
//   atomicMin on the raw bits would be right only for non-negative floats.
//   The map is its own inverse, so a finishing pass turns the keys back into
//   floats in place. A cell outside [0, n_slots) is dropped (XLA's
//   mode="drop"; the TPU kernel's behaviour there is undefined).
//
//   What bounds it on the H100: the atomics. At the reference scale the
//   buffer is 293 x 215 cells + 1 sink, 254 KB in K5's padded (496, 128)
//   layout: more than the 227 KB of shared memory a block may use, so
//   block-private shared-memory buffers do not fit and the buffer stays in
//   global memory, where it lives in the 50 MB L2 (a per-block copy of a
//   tile of the cell range is later work). Each thread first reads the
//   current key and issues the atomic only if its own key is smaller: the
//   buffer only ever decreases, so the test is safe, and it spares the
//   atomic for points that cannot win (every point of the sink, whose range
//   equals the fill, and most points of a crowded cell). The reads of cell
//   and rng are coalesced, 8 B a point.
//
// zbuffer_visible: elementwise, one thread per point, f32 arithmetic (the
//   sum buf[cell] + eps rounds to f32, as the plain torch version and XLA
//   round it, and nothing multiplies, so no FMA can change it). A cell out
//   of range reads nothing and gives false. 13 B a point and one gather
//   from the L2-resident buffer: DRAM-bandwidth bound.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;

// Order-preserving f32 bits <-> int32 key map; an involution.
__host__ __device__ __forceinline__ int order_key(int b) { return b ^ ((b >> 31) & 0x7fffffff); }

inline int float_bits(float f) {
  int b;
  memcpy(&b, &f, sizeof b);
  return b;
}

__global__ void __launch_bounds__(kThreads)
zmin_fill(int* __restrict__ buf, int n_slots, int fill_key) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_slots) buf[i] = fill_key;
}

__global__ void __launch_bounds__(kThreads)
zmin_scatter(const int* __restrict__ cell, const float* __restrict__ rng,
             int* buf, int n, int n_slots) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int c = cell[i];
  if (c < 0 || c >= n_slots) return;
  const int key = order_key(__float_as_int(__fadd_rn(rng[i], 0.0f)));  // -0 -> +0
  // buf[c] only decreases, so a stale read can only cost a needless atomic.
  if (key < buf[c]) atomicMin(buf + c, key);
}

__global__ void __launch_bounds__(kThreads)
zmin_finish(int* __restrict__ buf, int n_slots) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_slots) buf[i] = order_key(buf[i]);
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

inline int blocks(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

// K5 / Z1 scatter: buf (n_slots,) f32 = fill, then the scatter-min of rng
// into buf at cell, dropping cells outside [0, n_slots). Three launches on
// `stream`. Returns cudaGetLastError().
int zmin(const void* cell, const void* rng, void* buf, int n, int n_slots, float fill,
         void* stream) {
  if (n < 0 || n_slots < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* b = static_cast<int*>(buf);
  zmin_fill<<<blocks(n_slots), kThreads, 0, st>>>(b, n_slots, order_key(float_bits(fill + 0.0f)));
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

// Z1 test: vis (N,) bool = ok && rng <= buf[cell] + eps. Returns
// cudaGetLastError().
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

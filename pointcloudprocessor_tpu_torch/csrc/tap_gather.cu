// Grouped tap-row gathers: the selection steps for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of pointcloudprocessor_tpu/ops/tap_gather.py:
//   K3 tap_select    <- _select_kernel   (tap_gather.py:95, pallas_call at :165)
//   K4 tap_streamed  <- _streamed_kernel (tap_gather.py:343, pallas_call at :519)
//
// Both pick, for each point, its two nibble-packed tap words from the
// plane-concat slab table (opt/nid.build_tap_slabs): row j of the table is
// [word0 of pixels j*S .. j*S+S-1 | word1 of the same pixels], 2*S int32.
// A point's offset o says where its row lies in its group's window; word c
// of the point is table[window_row + o / S][c*S + o % S].
//
// K3: out (ng, G, 2) for ng groups of G points; the window of group g is the
//   two slab rows slab_id[g], slab_id[g] + 1, and o = offs[g, p] < 2*S. The
//   TPU kernel receives the windows as XLA-taken (ng, 2*2*S) rows and picks
//   each point's word with a one-hot MXU dot over u16 halves. Materialising
//   those windows costs 16 KB a group: 2 x 131,072 x 16 KB = 4.3 GB at the
//   reference scale (tap_gather.py:326-330), for 8 B a point of output. Here
//   one thread per point reads its two words straight from the table.
//
// K4: out (n_steps, 32, 2, G), one block per step of 32 groups; the window of
//   group g of step i starts at slab row blk0[i]*64 + rel[i*32 + g] and
//   o = offs[i, g, p] < 4*S. The TPU kernel DMAs a 2 x 64-slab-row mega-window
//   (2 x 64 x 16 KB = 2 MB at S = 2048) into VMEM per step and slices each
//   group's 4-row sub-window from it. That window does not fit the 227 KB of
//   shared memory a block may use, and each group reads only 256 B of its
//   64 KB sub-window, so staging any of it would copy far more than is read:
//   the threads read global memory directly, one point each.
//
// What bounds both on the H100: scattered 4-byte reads. The two words of a
// point lie S words apart, so each point touches two 32-byte sectors (less
// where neighbouring raster-sorted points share a sector): about 64 B a
// point, ~134 MB at 8 x 262,144 points, ~40 us at 3.35 TB/s, plus 8 B a point
// of coalesced writes. The design keeps the reads of neighbouring threads on
// neighbouring table words (sorted points) and nothing else.
//
// There is no floating-point arithmetic at all, so the TPU's one-hot MXU
// selection and its HIGHEST-precision trap (a single bf16 pass rounded the
// u16 operands, tap_gather.py:134-138) do not arise: the words are copied.
//
// Offsets and window rows are clamped into the table, so no read leaves it
// even for the unspecified rows of masked points and padded groups; byte
// offsets are 64-bit (row * 2*S exceeds 2^31 words only at ~175 keyframes of
// 4096x3000, but the product is formed in 64 bits regardless).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSubrows = 4;  // slab rows per K4 sub-window (ops/tap_gather._SUBROWS)

__global__ void __launch_bounds__(kThreads)
tap_select_kernel(const int* __restrict__ slabs, const int* __restrict__ slab_id,
                  const int* __restrict__ offs, int2* __restrict__ out,
                  int n_slabs, int slab, long long n_points, int group) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n_points) return;
  const int g = static_cast<int>(t / group);
  const int o = min(max(offs[t], 0), 2 * slab - 1);
  const int hi = o >= slab ? 1 : 0;
  const int row = min(slab_id[g] + hi, n_slabs - 1);
  const int col = o - hi * slab;
  const long long base = static_cast<long long>(row) * (2LL * slab) + col;
  out[t] = make_int2(__ldg(slabs + base), __ldg(slabs + base + slab));
}

__global__ void __launch_bounds__(kThreads)
tap_streamed_kernel(const int* __restrict__ table, const int* __restrict__ blk0,
                    const int* __restrict__ rel, const int* __restrict__ offs,
                    int* __restrict__ out, int n_rows, int slab, int spg,
                    int group, int wblk) {
  const int i = blockIdx.x;
  const long long step0 = static_cast<long long>(blk0[i]) * wblk;
  const int per_step = spg * group;
  for (int e = threadIdx.x; e < per_step; e += blockDim.x) {
    const int g = e / group;
    const int p = e - g * group;
    const long long pt = static_cast<long long>(i) * per_step + e;
    const int o = min(max(offs[pt], 0), kSubrows * slab - 1);
    const int q = o / slab;
    long long row = step0 + rel[static_cast<long long>(i) * spg + g] + q;
    row = row < n_rows ? row : n_rows - 1;
    const long long base = row * (2LL * slab) + (o - q * slab);
    // out[i, g, c, p]: p is the fastest index, so the stores coalesce.
    const long long dst = (static_cast<long long>(i) * spg + g) * 2 * group + p;
    out[dst] = __ldg(table + base);
    out[dst + group] = __ldg(table + base + slab);
  }
}

}  // namespace

extern "C" {

// K3: out (ng, group, 2) int32 from slabs (n_slabs, 2*slab), slab_id (ng,)
// and offs (ng, group) in [0, 2*slab). Returns cudaGetLastError().
int tap_select(const void* slabs, const void* slab_id, const void* offs, void* out,
               int n_slabs, int slab, int ng, int group, void* stream) {
  if (n_slabs < 2 || slab < 1 || ng < 1 || group < 1) return cudaErrorInvalidValue;
  const long long n_points = static_cast<long long>(ng) * group;
  const long long blocks = (n_points + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  tap_select_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(slabs), static_cast<const int*>(slab_id),
      static_cast<const int*>(offs), static_cast<int2*>(out), n_slabs, slab,
      n_points, group);
  return cudaGetLastError();
}

// K4: out (n_steps, spg, 2, group) int32 from table (n_rows, 2*slab), blk0
// (n_steps,), rel (n_steps*spg,) and offs (n_steps, spg, group) in
// [0, 4*slab). Returns cudaGetLastError().
int tap_streamed(const void* table, const void* blk0, const void* rel,
                 const void* offs, void* out, int n_rows, int slab, int n_steps,
                 int spg, int group, int wblk, void* stream) {
  if (n_rows < 1 || slab < 1 || n_steps < 1 || spg < 1 || group < 1 || wblk < 1)
    return cudaErrorInvalidValue;
  tap_streamed_kernel<<<n_steps, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(table), static_cast<const int*>(blk0),
      static_cast<const int*>(rel), static_cast<const int*>(offs),
      static_cast<int*>(out), n_rows, slab, spg, group, wblk);
  return cudaGetLastError();
}

}  // extern "C"

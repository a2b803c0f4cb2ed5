// Tap-row gathers for Hopper (sm_90a): the direct take (G1) with the packer
// of the bin image it reads, and the grouped gathers, each variant ONE
// kernel that plans its groups' windows and selects every point's tap row.
//
// G1 tap_take replaces the main path's direct take, which the JAX package
// leaves to XLA (no Pallas source): pointcloudprocessor_tpu/opt/nid.py:490-516,
// the anchor clip(v, 0, H-1) * W + clip(u, 0, W-1) of each (K, N) knot and a
// vmap'd jnp.take of its (2,) int32 row from the keyframe's (H*W, 2) tap
// table, whose row holds the 16 bins of the anchor's 4x4 window (dy, dx in
// -1..2, rows and columns clamped into the image), nibble t = 4 (dy + 1) +
// (dx + 1) of word t / 8 at bit 4 (t % 8). Here the table is never built: a
// row is a function of the bin image, so G1 reads the image, packed by
// bin_pack at 4 bits a pixel in 8x8-pixel tiles of 32 bytes (one sector),
// one tile every 5 pixels each way (word r of tile (ty, tx) = row 5 ty + r,
// nibble c = column 5 tx + c; 0 past the image). The tiles overlap by 3
// pixels, so every 4x4 window lies in one tile: tile (max(v - 1, 0) / 5,
// max(u - 1, 0) / 5), whose rows and columns hold the window's clamped ones.
// A 4096x3000 keyframe is 15.7 MB packed (the table 98 MB).
// One thread a point, a block row a keyframe (blockIdx.y): the knot in one
// 8-byte load, the clamps, the tile's 4 row words of the window (one
// sector; the first load misses, the other three hit in L1), the 4 nibbles
// of each row cut out (one shift inside the image, nibble by nibble at its
// edges), the row out in one 8-byte store. Every point reads its clipped
// window, whatever its gate, as the plain version (ops/tap_gather.
// direct_take_plain) does. What bounds it: the bytes, 8 B of knot and 8 B
// out a point and each distinct pixel the windows read, once, at 4 bits
// (the whole 32-byte tiles they touch are this layout's floor, not the
// function's). In practice the scattered sector requests hold it, one a
// point as the table's take makes them, but to a 126 MB image of which the
// keyframe in flight (15.7 MB) stays in L2 instead of a 786 MB table that
// misses to DRAM. Measured and
// dropped (PERF.md §6): 8x8 tiles without overlap (1.89 sectors a
// point), 16-byte half-tile loads, an L2 prefetch of each keyframe's image
// and two points a thread.
//
// bin_pack (B1) replaces the tap table's stencil that the JAX package leaves
// to XLA (no Pallas source; opt/nid.py:118-146, _tap_word_planes and
// build_tap_table) on the direct path: (K, H, W) int32 bins -> (K, TH, TW,
// 8) int32 tiles, each bin's low 4 bits. Bound: the bytes, 4 B a pixel read
// and 32 B a tile written (519 MB, 0.155 ms at 8 x 4096x3000). A block owns
// a band of 8 tile rows by a span of 32 tiles: it stages the band's 43
// image rows of 163 columns in shared memory at a byte a pixel, read with
// 16-byte loads where the width is a multiple of 4 pixels and the image
// 16-byte aligned (a pixel a load otherwise), so each image row is read by
// one block but for the 3-row seam between bands and the 3 columns between
// spans; then it builds each word from 8 staged bytes, word r of a tile
// fastest, so a warp writes 4 whole tiles, 128 contiguous bytes. Measured
// (PERF.md §6): 0.177 ms against 0.374 for the first design (a thread a
// word, 8 scalar loads at a 20-byte lane stride, each store instruction 32
// sectors an eighth written); bands of 2, 4, 8 and 16 tile rows by spans of
// 16, 32, 64 and 128 tiles tried, 0.177-0.229 ms.
//
// The frozen-tap cache's kernels (opt/nid.multi_nid_loss_cached) replace
// XLA ops of pointcloudprocessor_tpu/opt/nid.py that have no Pallas source;
// they read the same packed tiles, and no wide table is built (JAX's is
// (H*W, 4 + 2m) int32, 3.1 GB for 8 keyframes of 4096x3000 at m = 2):
//   G2 wide_take         <- _gather_wide's jnp.take from build_wide_tap_table
//                           (nid.py:630-638, :143-167): word r of a point's
//                           window, row clamp(v + r - 1 - m), nibble j the
//                           column clamp(u - 1 - m + j), planes (K, 4+2m, N).
//                           The window lies in at most 2 x 2 tiles (4
//                           sectors), and the kernel reads no other.
//                           Bound: 8 B of knot and 4 (4 + 2m) B out a point
//                           plus each distinct window pixel at 4 bits.
//   G2's block form      <- _partial_refresh_wide (nid.py:670-696)
//   G1's block form      <- _partial_refresh_taps (nid.py:566-613): both re-take
//                           the points of a (K, cap) list of 128-point blocks
//                           in place, ids past the last block dropped.
//   W1 wide_select       <- _select_from_wide's where / shift chain
//                           (nid.py:641-667) and the effective knot (:858-860):
//                           one launch an evaluation. Bound: 16 B of knots, 16
//                           B of selected words and 16 B out a point.
// Each is one thread a point (a listed point for the block forms), a block
// row a keyframe; W1 and G2 stream their planes.
//
// G2, what bounds it and its design. The points come in map order, so the
// 32 lanes of a warp read 32 unrelated tiles, and the keyframe in flight
// (15.7 MB packed) stays in L2: the scattered load requests a point set the
// time. The first design (step 0) chose the tile row per row of the window
// and read tiles a and a + 1 for every row, one 4-byte load each: 16
// requests a point at m = 2 and 12 at m = 1, over up to 2 x 3 tiles, at
// ~0.0145 ms a request a point for 8 x 262,144 points. This design, (a),
// chooses the tile row and column once a point (wide_plan), reads only the
// 16-byte halves of the at most 2 x 2 tiles that hold a needed row
// (ld.global.nc.v4: 5.73 a point at m = 2 and 3.34 at m = 1 on the scene's
// knots, 8 and 6 at most; ops/tap_gather.wide_take_plan counts them) and
// picks each row's words from registers by selects. Measured (chip_smoke.py
// phase 6b, PERF.md §6: 8 x 262,144 map-order knots, H100 80GB HBM3 at
// 700 W): 0.091 ms at m = 2 and 0.070 at m = 1 against step 0's 0.231 and
// 0.179, at 0.39 of the bound. Measured in the same runs and dropped, with
// step 0: (b), each needed sector read once by the warp and staged in
// shared memory (3.22 and 1.95 requests a point), 0.098 and 0.085; (c),
// lane pairs reading whole sectors and swapping halves by shuffles, 0.093
// and 0.072: so fewer requests no longer buy time. What is left, not
// measured apart: the tiles' first reads from DRAM (a call reads most
// sectors of the 8 keyframes' 126 MB; chip_smoke.py counts them), the ~3.2
// L2 sectors a point and the planes' stores.
//
// Replaces the two Pallas TPU kernels of pointcloudprocessor_tpu/ops/tap_gather.py
// together with the XLA index arithmetic (the plan) around each of them:
//   K3 tap_select    <- _select_kernel   (tap_gather.py:95, pallas_call at :165)
//                       and the plan of grouped_take_slabbed (:267-296)
//   K4 tap_streamed  <- _streamed_kernel (tap_gather.py:343, pallas_call at :519)
//                       and the plan of grouped_take_streamed (:427-491)
//
// In: flat indices idx (n,) int32 into the interleaved row table rows
// (n_rows, 2) int32 (the K keyframes' (H*W, 2) tap tables stacked, n_rows =
// n_slabs * S), and the point mask ok (n,) bytes. Out: taps (ng, G, 2) int32,
// the per-group overflow flags (ng,) bytes and their count (one int32).
//
// Addressing. The TPU reads its windows from the plane-concat slab table,
// row j = [word0 of pixels jS..jS+S-1 | word1 of the same pixels]. Word c of
// slab row j, column m is word c of interleaved row j*S + m, so a window of
// slab rows [a, a+w) is the row range [a*S, (a+w)*S) here, and a point at
// offset o in it is row a*S + o: both of its words in one 8-byte load. The
// window and clamp arithmetic is the plan's (ops/tap_gather.plan_slabbed /
// plan_streamed), so the output equals the twin on every row, the
// unspecified rows of masked points and overflowing groups included.
//
// The plan, in the kernel. A warp takes a tile of 128 consecutive points,
// lane l the points l, l+32, l+64 and l+96, so each warp-wide load or store
// covers 32 consecutive points (coalesced idx, ok and taps; the row reads of
// one instruction stay within ~12 KB of table), a K3 group of 16 is a
// half-warp and a K4 group of 32 a whole warp at one of the four positions.
// A group's base (the minimum idx over its ok points) is a shuffle reduction
// across its lanes, and its overflow flag a ballot.
//   K3, G = 16: the window is the 2 slabs from the base's slab.
//   K4, G = 32: a block of 256 threads is one step of 32 groups. The step's
//   first slab is a minimum over the block through shared memory that leaves
//   out groups without an ok point; those adopt the step's base
//   (tap_gather.py:457-471). The step's mega-block is blk0 = clamp(first
//   slab / 64, 0, n_blocks - 2), and each group's 4-slab sub-window starts
//   rel slabs past blk0 * 64.
// Points past n are the masked points of the padded last groups: nothing is
// copied to pad. A group overflows when an ok point lies outside its window;
// its first lane writes the flag, and each block adds its count with one
// atomicAdd (the count is zeroed by the launcher, on the same stream).
//
// What bounds both on the H100: the scattered row reads. Raster-sorted points
// are ~47 pixels (~376 B of table) apart at 8 x 262,144 points of 4096x3000,
// so each point pulls its own 32-byte sector. The compulsory traffic is ~21 B
// a point (idx 4, ok 1, row 8, out 8): ~45 MB, 13 us at 3.35 TB/s for 2M
// points; counted in whole sectors it is ~45 B a point (~28 us). The design
// issues a lane's four row loads before any store (memory-level
// parallelism), reads the table through the non-coherent path without
// allocating in L1 (each sector is read once), and writes the output with
// coalesced streaming stores. There is no floating point: the TPU's
// one-hot MXU selection and its precision trap (tap_gather.py:134-138) do not
// arise, the words are copied.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPts = 4;                     // points a lane, 32 apart
constexpr int kBlockPts = kThreads * kPts;  // 1024 points a block
constexpr int kBig = 0x7fffffff;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kSelectGroup = 16;  // K3 group: a half-warp (ops/tap_gather: group)
constexpr int kStreamGroup = 32;  // K4 group: a warp
constexpr int kSpg = 32;          // K4 groups a step (ops/tap_gather._SPG)
constexpr int kWblk = 64;         // slabs a mega-block (_WBLK)
constexpr int kSubrows = 4;       // slabs a K4 sub-window (_SUBROWS)
static_assert(kSpg * kStreamGroup == kBlockPts, "a K4 step is one block");

// torch's `//` on int32 (floor division), for b > 0.
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// One tap row: both words in one 8-byte read-only load, no L1 allocation.
__device__ __forceinline__ int2 load_row(const int2* p) {
  int2 v;
  asm("ld.global.nc.L1::no_allocate.v2.s32 {%0, %1}, [%2];"
      : "=r"(v.x), "=r"(v.y)
      : "l"(p));
  return v;
}

// The first of this lane's points: lane l of warp w of the block's
// 1024-point tile takes points tile + 128 w + l + 32 j, j < kPts.
__device__ __forceinline__ long long first_point() {
  return static_cast<long long>(blockIdx.x) * kBlockPts + (threadIdx.x / 32) * (32 * kPts) +
         threadIdx.x % 32;
}

// The lane's points: idx clamped to idx_max as the plan clamps it; points at
// or past n are masked with idx 0, as the plan pads them.
__device__ __forceinline__ void load_points(const int* __restrict__ idx,
                                            const unsigned char* __restrict__ ok,
                                            long long p0, long long n, int idx_max,
                                            int (&i)[kPts], bool (&k)[kPts]) {
#pragma unroll
  for (int j = 0; j < kPts; ++j) {
    const long long p = p0 + 32 * j;
    i[j] = p < n ? min(__ldcs(idx + p), idx_max) : 0;
    k[j] = p < n && __ldcs(ok + p) != 0;
  }
}

// The minimum of ok indices over the group's kLanes lanes (16 or 32).
template <int kLanes>
__device__ __forceinline__ int group_base(int i, bool k) {
  int m = k ? i : kBig;
#pragma unroll
  for (int s = 1; s < kLanes; s <<= 1) m = min(m, __shfl_xor_sync(kAll, m, s));
  return m;
}

// Whether any lane of the group of kLanes lanes (16 or 32) has `over` set.
template <int kLanes>
__device__ __forceinline__ bool group_any(bool over) {
  const unsigned b = __ballot_sync(kAll, over);
  return kLanes == 32 ? b != 0 : ((threadIdx.x % 32) < 16 ? b & 0xffffu : b >> 16) != 0;
}

// Adds the block's overflowing groups (c a thread) to the count: one
// atomicAdd a block. Every thread of the block must call it.
__device__ __forceinline__ void count_groups(int* __restrict__ n_ovf, int c) {
  __shared__ int total;
  if (threadIdx.x == 0) total = 0;
  __syncthreads();
  c = __reduce_add_sync(kAll, c);
  if (threadIdx.x % 32 == 0 && c) atomicAdd_block(&total, c);
  __syncthreads();
  if (threadIdx.x == 0 && total) atomicAdd(n_ovf, total);
}

__global__ void __launch_bounds__(kThreads)
tap_select_kernel(const int* __restrict__ idx, const unsigned char* __restrict__ ok,
                  const int2* __restrict__ rows, int2* __restrict__ out,
                  unsigned char* __restrict__ ovf, int* __restrict__ n_ovf,
                  long long n, long long npad, int n_slabs, int slab) {
  const long long p0 = first_point();
  const bool leader = threadIdx.x % kSelectGroup == 0;
  int i[kPts];
  bool k[kPts];
  load_points(idx, ok, p0, n, n_slabs * slab - 1, i, k);
  int2 v[kPts];
  bool over[kPts];
#pragma unroll
  for (int j = 0; j < kPts; ++j) {
    const int m = group_base<kSelectGroup>(i[j], k[j]);
    const int base = m == kBig ? 0 : m;  // no ok point: the window of row 0
    const int start = min(max(floor_div(base, slab), 0), n_slabs - 2) * slab;
    const int o = (k[j] ? i[j] : base) - start;
    over[j] = k[j] && o >= 2 * slab;
    v[j] = p0 + 32 * j < npad ? load_row(rows + (start + min(max(o, 0), 2 * slab - 1)))
                              : make_int2(0, 0);
  }
  int c = 0;
#pragma unroll
  for (int j = 0; j < kPts; ++j) {
    const long long p = p0 + 32 * j;
    const bool g_over = group_any<kSelectGroup>(over[j]);
    if (p < npad) {
      __stcs(out + p, v[j]);
      if (leader) ovf[p / kSelectGroup] = g_over;
      c += leader && g_over;
    }
  }
  count_groups(n_ovf, c);
}

__global__ void __launch_bounds__(kThreads)
tap_streamed_kernel(const int* __restrict__ idx, const unsigned char* __restrict__ ok,
                    const int2* __restrict__ rows, int2* __restrict__ out,
                    unsigned char* __restrict__ ovf, int* __restrict__ n_ovf,
                    long long n, int n_slabs, int n_blocks, int slab) {
  __shared__ int warp_first[kWarps];
  const long long p0 = first_point();
  const bool leader = threadIdx.x % 32 == 0;
  int i[kPts];
  bool k[kPts];
  load_points(idx, ok, p0, n, n_slabs * slab - 1, i, k);
  // Each group's base, and the step's first slab: the minimum over the
  // groups that have an ok point.
  int m[kPts];
  int first = kBig;
#pragma unroll
  for (int j = 0; j < kPts; ++j) {
    m[j] = group_base<kStreamGroup>(i[j], k[j]);
    first = min(first, m[j] == kBig ? kBig : floor_div(m[j], slab));
  }
  if (leader) warp_first[threadIdx.x / 32] = first;
  __syncthreads();
  int step0 = kBig;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) step0 = min(step0, warp_first[w]);
  if (step0 == kBig) step0 = 0;  // no ok point in the step
  const int blk0 = min(max(floor_div(step0, kWblk), 0), n_blocks - 2);
  int2 v[kPts];
  bool over[kPts];
#pragma unroll
  for (int j = 0; j < kPts; ++j) {
    const bool any = m[j] != kBig;
    const int slab_id = any ? floor_div(m[j], slab) : step0;
    const int base = any ? m[j] : slab_id * slab;
    const int win = blk0 * kWblk + min(max(slab_id - blk0 * kWblk, 0), 2 * kWblk - kSubrows);
    const int o = (k[j] ? i[j] : base) - win * slab;
    over[j] = k[j] && (o < 0 || o >= kSubrows * slab);
    const int oc = min(max(o, 0), kSubrows * slab - 1);
    const int q = oc / slab;
    // The slab row is clamped to the table's last, as the twin clamps it.
    v[j] = load_row(rows + (min(win + q, n_slabs - 1) * slab + (oc - q * slab)));
  }
  int c = 0;
#pragma unroll
  for (int j = 0; j < kPts; ++j) {
    const long long p = p0 + 32 * j;
    const bool g_over = group_any<kStreamGroup>(over[j]);
    __stcs(out + p, v[j]);
    if (leader) ovf[p / kStreamGroup] = g_over;
    c += leader && g_over;
  }
  count_groups(n_ovf, c);
}

constexpr int kStride = 5;  // pixels between bin-image tiles (ops/tap_gather.STRIDE)
constexpr int kPartialBlock = 128;  // points a refresh block (ops/tap_gather.PARTIAL_BLOCK)

// The nibble-packed 4x4 window row of knot kn (u, v) clipped into the image,
// read from the keyframe's packed tiles img (G1 and its block form).
__device__ __forceinline__ int2 window_row(const unsigned* __restrict__ img, int2 kn, int width,
                                           int height, int tw) {
  const int u = min(max(kn.x, 0), width - 1);
  const int v = min(max(kn.y, 0), height - 1);
  // The one tile that holds the window: its rows and columns clamped into
  // the image lie in 5 ty .. 5 ty + 7 and 5 tx .. 5 tx + 7. Its 4 row words
  // share the tile's sector: one sector a point, the other words L1 hits.
  const int ty = max(v - 1, 0) / kStride, tx = max(u - 1, 0) / kStride;
  const unsigned* __restrict__ tile =
      img + ((static_cast<long long>(ty) * tw + tx) << 3) - kStride * ty;
  unsigned w[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) w[r] = __ldg(tile + min(max(v - 1 + r, 0), height - 1));
  unsigned word[2] = {0u, 0u};
  const int x0 = kStride * tx;
  if (u >= 1 && u + 2 < width) {
    // Inside the image: the 4 columns are 4 consecutive nibbles of a word.
    const unsigned sh = 4u * (u - 1 - x0);
#pragma unroll
    for (int r = 0; r < 4; ++r) word[r >> 1] |= ((w[r] >> sh) & 0xffffu) << (16 * (r & 1));
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const unsigned sh = 4u * (min(max(u - 1 + c, 0), width - 1) - x0);
#pragma unroll
      for (int r = 0; r < 4; ++r) word[r >> 1] |= ((w[r] >> sh) & 0xfu) << (16 * (r & 1) + 4 * c);
    }
  }
  return make_int2(static_cast<int>(word[0]), static_cast<int>(word[1]));
}

__global__ void __launch_bounds__(kThreads)
tap_take_kernel(const unsigned* __restrict__ tiles, const int2* __restrict__ knot,
                int2* __restrict__ out, int n, int width, int height, int tw, long long plane) {
  const long long kf = blockIdx.y;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= n) return;
  const long long p = kf * n + j;
  __stcs(out + p, window_row(tiles + kf * plane, __ldcs(knot + p), width, height, tw));
}

// G1's block form: thread i of keyframe kf re-takes point 128 b + i % 128 of
// block b = blocks[kf][i / 128]; ids outside [0, n / 128) are padding and
// dropped. The rows go in place into the cache's (k, n, 2) taps.
__global__ void __launch_bounds__(kThreads)
tap_take_blocks_kernel(const unsigned* __restrict__ tiles, const int2* __restrict__ knot,
                       const int* __restrict__ blocks, int2* __restrict__ out, int n, int cap,
                       int width, int height, int tw, long long plane) {
  const long long kf = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= cap * kPartialBlock) return;
  const int b = __ldg(blocks + kf * cap + i / kPartialBlock);
  if (b < 0 || b >= n / kPartialBlock) return;
  const long long p = kf * n + b * kPartialBlock + i % kPartialBlock;
  out[p] = window_row(tiles + kf * plane, __ldg(knot + p), width, height, tw);
}

// G2's wide window of knot kn: word r nibble-packs, in nibble j, the bin at
// row clamp(v + r - 1 - M) and column clamp(u - 1 - M + j) around the
// clipped anchor (u, v), j < kRows = 4 + 2 M. Each coordinate is clamped
// before its tile and nibble are chosen (the tiles hold 0 past the image).

// The row word of the window whose nibble j is column clamp(x0 + j), cut
// from tile a's row word wa and tile a + 1's wb (xa = 5 a): wb's nibbles
// 3..7 continue wa's 8, so the 64-bit run holds columns xa .. xa + 12.
template <int M>
__device__ __forceinline__ unsigned cut_row(unsigned wa, unsigned wb, int x0, int xa, int width) {
  constexpr int kRows = 4 + 2 * M;
  const unsigned long long run = wa | static_cast<unsigned long long>(wb >> 12) << 32;
  unsigned w = 0u;
  if (x0 >= 0 && x0 + kRows <= width) {
    w = static_cast<unsigned>(run >> (4 * (x0 - xa)));
    if constexpr (kRows < 8) w &= (1u << (4 * kRows)) - 1u;
  } else {
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int x = min(max(x0 + j, 0), width - 1);
      w |= static_cast<unsigned>((run >> (4 * (x - xa))) & 0xfu) << (4 * j);
    }
  }
  return w;
}

// What the window needs, chosen once a point. Its rows lie in tile row ty0
// = clamp(v - 1 - M) / 5, which holds rows 5 ty0 .. 5 ty0 + 7, and only
// where the last clamped row passes 5 ty0 + 7 in tile row ty0 + 1 (rows up
// to 5 ty0 + 12: the first row is at most 4 past 5 ty0, the last at most 7
// past the first). Its columns lie in tile a = clamp(u - 1 - M) / 5 and
// only where the last clamped column passes 5 a + 7 in tile a + 1. So a
// point reads at most 2 x 2 tiles (4 sectors). Row r of the window is row
// 5 ty0 + d_r, d_r = clamp(v + r - 1 - M) - 5 ty0 in [d0, dl], at most r + 4.
struct WidePlan {
  int v;           // the clipped anchor's row
  int x0, xa;      // the first column u - 1 - M (before its clamp), 5 a
  int ty0, d0, dl;  // the first tile row; the first and last rows less 5 ty0
  int tile;        // word of tile (ty0, a) in the keyframe's plane
  bool has_b;      // tile a + 1 holds a needed column
  bool row2;       // tile row ty0 + 1 holds a needed row
};

template <int M>
__device__ __forceinline__ WidePlan wide_plan(int2 kn, int width, int height, int th, int tw) {
  constexpr int kRows = 4 + 2 * M;
  WidePlan p;
  const int u = min(max(kn.x, 0), width - 1);
  p.v = min(max(kn.y, 0), height - 1);
  const int y0 = max(p.v - 1 - M, 0), yl = min(p.v + 2 + M, height - 1);
  p.ty0 = min(y0 / kStride, th - 1);
  p.d0 = y0 - kStride * p.ty0;
  p.dl = yl - kStride * p.ty0;
  p.x0 = u - 1 - M;
  const int ta = min(max(p.x0, 0) / kStride, tw - 1);
  p.xa = kStride * ta;
  p.has_b = min(p.x0 + kRows - 1, width - 1) - p.xa > 7;
  p.row2 = p.dl > 7;
  p.tile = (p.ty0 * tw + ta) << 3;
  return p;
}

// d_r: row r of the window less 5 ty0.
template <int M>
__device__ __forceinline__ int window_row_d(const WidePlan& p, int r, int height) {
  return min(max(p.v + r - 1 - M, 0), height - 1) - kStride * p.ty0;
}

__device__ __forceinline__ uint4 load16(const unsigned* __restrict__ p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// One tile column's needed 16-byte halves as a column e of 13 row words:
// e[d] is row 5 ty0 + d, words 0..7 of the tile in tile row ty0, then words
// 3..7 of the one below (tw * 8 words on). Halves not needed stay 0; no
// row d_r reads one.
__device__ __forceinline__ void load_column(const unsigned* __restrict__ t, const WidePlan& p,
                                            bool needed, int below, unsigned (&e)[13]) {
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  const uint4 lo0 = needed && p.d0 <= 3 ? load16(t) : z;
  const uint4 hi0 = needed && p.dl >= 4 ? load16(t + 4) : z;
  const uint4 lo1 = needed && p.dl >= 8 ? load16(t + below) : z;
  const uint4 hi1 = needed && p.dl >= 9 ? load16(t + below + 4) : z;
  const unsigned col[13] = {lo0.x, lo0.y, lo0.z, lo0.w, hi0.x, hi0.y, hi0.z,
                            hi0.w, lo1.w, hi1.x, hi1.y, hi1.z, hi1.w};
#pragma unroll
  for (int d = 0; d < 13; ++d) e[d] = col[d];
}

// e[d] for d <= hi, by a chain of selects (e stays in registers).
__device__ __forceinline__ unsigned pick(const unsigned (&e)[13], int d, int hi) {
  unsigned w = e[0];
#pragma unroll
  for (int k = 1; k < 13; ++k)
    if (k <= hi) w = d == k ? e[k] : w;
  return w;
}

// The window: each lane reads its own tiles' needed halves
// (ld.global.nc.v4) and picks each row's words from registers.
template <int M>
__device__ __forceinline__ void wide_window(const unsigned* __restrict__ img, int2 kn, int width,
                                            int height, int th, int tw,
                                            unsigned (&word)[4 + 2 * M]) {
  const WidePlan p = wide_plan<M>(kn, width, height, th, tw);
  unsigned ea[13], eb[13];
  load_column(img + p.tile, p, true, 8 * tw, ea);
  load_column(img + p.tile + 8, p, p.has_b, 8 * tw, eb);
#pragma unroll
  for (int r = 0; r < 4 + 2 * M; ++r) {
    const int d = window_row_d<M>(p, r, height);
    word[r] = cut_row<M>(pick(ea, d, r + 4), pick(eb, d, r + 4), p.x0, p.xa, width);
  }
}

// G2: one thread a point, a block row a keyframe; the planes (k, kRows, n)
// written plane-major, each plane's words coalesced across the warp.
template <int M>
__global__ void __launch_bounds__(kThreads)
wide_take_kernel(const unsigned* __restrict__ tiles, const int2* __restrict__ knot,
                 unsigned* __restrict__ out, int n, int width, int height, int th, int tw,
                 long long plane) {
  constexpr int kRows = 4 + 2 * M;
  const long long kf = blockIdx.y;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= n) return;
  unsigned word[kRows];
  wide_window<M>(tiles + kf * plane, __ldcs(knot + kf * n + j), width, height, th, tw, word);
  unsigned* __restrict__ dst = out + kf * kRows * n + j;
#pragma unroll
  for (int r = 0; r < kRows; ++r) __stcs(dst + static_cast<long long>(r) * n, word[r]);
}

// G2's block form: as tap_take_blocks_kernel, into the (k, kRows, n) planes.
template <int M>
__global__ void __launch_bounds__(kThreads)
wide_take_blocks_kernel(const unsigned* __restrict__ tiles, const int2* __restrict__ knot,
                        const int* __restrict__ blocks, unsigned* __restrict__ out, int n,
                        int cap, int width, int height, int th, int tw, long long plane) {
  constexpr int kRows = 4 + 2 * M;
  const long long kf = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= cap * kPartialBlock) return;
  const int b = __ldg(blocks + kf * cap + i / kPartialBlock);
  if (b < 0 || b >= n / kPartialBlock) return;
  const int j = b * kPartialBlock + i % kPartialBlock;
  unsigned word[kRows];
  wide_window<M>(tiles + kf * plane, __ldg(knot + kf * n + j), width, height, th, tw, word);
  unsigned* __restrict__ dst = out + kf * kRows * n + j;
#pragma unroll
  for (int r = 0; r < kRows; ++r) dst[static_cast<long long>(r) * n] = word[r];
}

// W1: the 4x4 sub-window at dk = clip(knot_true - knot_cache, -M, M) of each
// point's cached wide window, and the effective knot knot_cache + dk. The
// differences wrap as XLA's int32 arithmetic does (knots of points behind
// the camera reach +-2^31): they are taken in uint32, where C++'s signed
// overflow would be undefined. Row i of the sub-window is plane dv + M + i,
// its 4 nibbles from nibble du + M: two rows make a word of the tap row.
template <int M>
__global__ void __launch_bounds__(kThreads)
wide_select_kernel(const unsigned* __restrict__ wide, const int2* __restrict__ knot_true,
                   const int2* __restrict__ knot_cache, int2* __restrict__ taps,
                   int2* __restrict__ eff, int n) {
  constexpr int kRows = 4 + 2 * M;
  const long long kf = blockIdx.y;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= n) return;
  const long long p = kf * n + j;
  const int2 kt = __ldcs(knot_true + p), kc = __ldcs(knot_cache + p);
  const int du = min(max(static_cast<int>(static_cast<unsigned>(kt.x) - static_cast<unsigned>(kc.x)), -M), M);
  const int dv = min(max(static_cast<int>(static_cast<unsigned>(kt.y) - static_cast<unsigned>(kc.y)), -M), M);
  const unsigned sh = 4u * (du + M);
  const unsigned* __restrict__ src = wide + (kf * kRows + dv + M) * n + j;
  unsigned h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = (__ldcs(src + static_cast<long long>(i) * n) >> sh) & 0xffffu;
  __stcs(taps + p, make_int2(static_cast<int>(h[0] | h[1] << 16), static_cast<int>(h[2] | h[3] << 16)));
  __stcs(eff + p, make_int2(static_cast<int>(static_cast<unsigned>(kc.x) + static_cast<unsigned>(du)),
                            static_cast<int>(static_cast<unsigned>(kc.y) + static_cast<unsigned>(dv))));
}

// bin_pack's block (sizes chosen on the card, see the header): a band of
// kBandTiles tile rows by a span of kSpanTiles tiles, whose 5 m + 3 image
// rows of 5 S + 3 columns it stages in shared memory at a byte a pixel (the
// bin's low 4 bits). kSpanTiles is a multiple of 4, so a span starts on a
// 16-byte pixel boundary; kPitch, the bytes a staged row, is 4 words past a
// multiple of 32 words, so the 8 words of a tile and 4 neighbouring tiles
// (one warp) read 32 distinct banks.
constexpr int kBandTiles = 8;
constexpr int kSpanTiles = 32;
constexpr int kBandRows = kStride * kBandTiles + 3;
constexpr int kSpanCols = kStride * kSpanTiles + 4;  // 5 S + 3, rounded up to 4 pixels
constexpr int kPitch = 4 * ((kSpanCols / 4 + 27) / 32 * 32 + 4);
static_assert(kSpanTiles % 4 == 0 && kPitch >= kSpanCols + 4 && (kPitch / 4) % 32 == 4, "");

__global__ void __launch_bounds__(kThreads)
bin_pack_kernel(const int* __restrict__ bins, unsigned* __restrict__ tiles, int height,
                int width, int th, int tw, int spans, bool vec) {
  __shared__ __align__(16) unsigned char band[kBandRows * kPitch];
  const long long kf = blockIdx.y;
  const int ty0 = blockIdx.x / spans * kBandTiles, tx0 = blockIdx.x % spans * kSpanTiles;
  const int y0 = kStride * ty0, x0 = kStride * tx0;
  const int* __restrict__ img = bins + kf * height * static_cast<long long>(width);
  // Stage the band: with vec (width a multiple of 4 pixels, the image
  // 16-byte aligned) 4 pixels a 16-byte load, else a pixel a load; 0 past
  // the image. Consecutive threads read consecutive pixels of a row.
  if (vec) {
    constexpr int kQuads = kSpanCols / 4;
#pragma unroll 4
    for (int i = threadIdx.x; i < kBandRows * kQuads; i += kThreads) {
      const int row = i / kQuads, c = 4 * (i - row * kQuads);
      const int y = y0 + row, x = x0 + c;
      unsigned b = 0;
      if (y < height && x < width) {
        const int4 p = __ldg(reinterpret_cast<const int4*>(img + static_cast<long long>(y) * width + x));
        b = (p.x & 0xfu) | (p.y & 0xfu) << 8 | (p.z & 0xfu) << 16 | (p.w & 0xfu) << 24;
      }
      *reinterpret_cast<unsigned*>(band + row * kPitch + c) = b;
    }
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < kBandRows * kSpanCols; i += kThreads) {
      const int row = i / kSpanCols, c = i - row * kSpanCols;
      const int y = y0 + row, x = x0 + c;
      band[row * kPitch + c] =
          y < height && x < width ? __ldg(img + static_cast<long long>(y) * width + x) & 0xf : 0;
    }
  }
  __syncthreads();
  // Build the words, word r of a tile fastest: a warp writes 4 whole tiles,
  // 128 contiguous bytes. Word r of tile (ty, tx) is the 8 staged bytes of
  // row 5 ty + r from column 5 tx, each a nibble.
  for (int i = threadIdx.x; i < kBandTiles * kSpanTiles * 8; i += kThreads) {
    const int r = i & 7, dx = (i >> 3) % kSpanTiles, dy = (i >> 3) / kSpanTiles;
    const int ty = ty0 + dy, tx = tx0 + dx;
    if (ty >= th || tx >= tw) continue;
    const int o = (kStride * dy + r) * kPitch + kStride * dx;
    const unsigned* w = reinterpret_cast<const unsigned*>(band + (o & ~3));
    const unsigned sh = 8 * (o & 3);
    unsigned long long b = static_cast<unsigned long long>(__funnelshift_r(w[1], w[2], sh)) << 32 |
                           __funnelshift_r(w[0], w[1], sh);
    b = (b | b >> 4) & 0x00ff00ff00ff00ffull;  // bytes 2j, 2j+1 -> one byte
    b = (b | b >> 8) & 0x0000ffff0000ffffull;
    b = (b | b >> 16) & 0x00000000ffffffffull;
    tiles[((kf * th + ty) * tw + tx) * 8 + r] = static_cast<unsigned>(b);
  }
}

// Tiles along an image side of `size` pixels (ops/tap_gather.bin_tile_shape).
inline int tiles_along(int size) { return (size > 2 ? size - 2 : 0) / kStride + 1; }

bool table_ok(int n_slabs, int slab) {
  return n_slabs >= 2 && slab >= 1 && static_cast<long long>(n_slabs) * slab < 0x7fffffffLL;
}

}  // namespace

extern "C" {

// K3: taps (ng, 16, 2) int32, ovf (ng,) bytes and n_ovf (one int32) from idx
// (n,) int32, ok (n,) bytes and rows (n_slabs * slab, 2) int32; ng * 16 >= n
// is the padded point count; rows and taps 8-byte aligned.
// Returns the first CUDA error (the memset's, or cudaGetLastError()).
int tap_select(const void* idx, const void* ok, const void* rows, void* taps, void* ovf,
               void* n_ovf, int n, int ng, int n_slabs, int slab, void* stream) {
  const long long npad = static_cast<long long>(ng) * kSelectGroup;
  if (n < 1 || npad < n || !table_ok(n_slabs, slab)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = cudaMemsetAsync(n_ovf, 0, sizeof(int), s);
  if (e != cudaSuccess) return e;
  const long long blocks = (npad + kBlockPts - 1) / kBlockPts;
  tap_select_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const int*>(idx), static_cast<const unsigned char*>(ok),
      static_cast<const int2*>(rows), static_cast<int2*>(taps),
      static_cast<unsigned char*>(ovf), static_cast<int*>(n_ovf), n, npad, n_slabs, slab);
  return cudaGetLastError();
}

// K4: taps (n_steps * 32, 32, 2) int32, ovf (n_steps * 32,) bytes and n_ovf
// from the same inputs; n_steps * 1024 >= n, n_blocks = the mega-blocks of
// the padded table (ops/tap_gather.plan_streamed). Returns as tap_select.
int tap_streamed(const void* idx, const void* ok, const void* rows, void* taps, void* ovf,
                 void* n_ovf, int n, int n_steps, int n_slabs, int n_blocks, int slab,
                 void* stream) {
  if (n < 1 || static_cast<long long>(n_steps) * kBlockPts < n || n_blocks < 2 ||
      !table_ok(n_slabs, slab))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = cudaMemsetAsync(n_ovf, 0, sizeof(int), s);
  if (e != cudaSuccess) return e;
  tap_streamed_kernel<<<n_steps, kThreads, 0, s>>>(
      static_cast<const int*>(idx), static_cast<const unsigned char*>(ok),
      static_cast<const int2*>(rows), static_cast<int2*>(taps),
      static_cast<unsigned char*>(ovf), static_cast<int*>(n_ovf), n, n_slabs, n_blocks,
      slab);
  return cudaGetLastError();
}

// G1: taps (k, n, 2) int32, the nibble-packed 4x4 window rows of the knots
// (k, n, 2) int32 (u, v) clipped into the image, from the packed bin tiles
// (k, th, tw, 8) int32 of bin_pack (th = (height - 2) / 5 + 1, tw = (width
// - 2) / 5 + 1, at least 1); knots and taps 8-byte aligned, k <= 65,535.
// One launch on `stream`, none for n = 0. Returns cudaGetLastError().
int tap_take(const void* tiles, const void* knot, void* taps, int k, int n, int width,
             int height, void* stream) {
  if (k < 1 || k > 65535 || n < 0 || width < 1 || height < 1) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const int tw = tiles_along(width);
  const long long plane = static_cast<long long>(tiles_along(height)) * tw * 8;
  const dim3 grid((n + kThreads - 1) / kThreads, k);
  tap_take_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(tiles), static_cast<const int2*>(knot),
      static_cast<int2*>(taps), n, width, height, tw, plane);
  return cudaGetLastError();
}

// bin_pack: tiles (k, th, tw, 8) int32 (as tap_take takes them) from the
// bins (k, height, width) int32, the low 4 bits of each; k <= 65,535. One
// launch on `stream`. Returns cudaGetLastError().
int bin_pack(const void* bins, void* tiles, int k, int height, int width, void* stream) {
  if (k < 1 || k > 65535 || height < 1 || width < 1) return cudaErrorInvalidValue;
  const int th = tiles_along(height), tw = tiles_along(width);
  const int spans = (tw + kSpanTiles - 1) / kSpanTiles;
  const long long blocks = static_cast<long long>((th + kBandTiles - 1) / kBandTiles) * spans;
  const bool vec = width % 4 == 0 && reinterpret_cast<uintptr_t>(bins) % 16 == 0;
  bin_pack_kernel<<<dim3(static_cast<unsigned>(blocks), k), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(bins), static_cast<unsigned*>(tiles), height, width, th, tw, spans,
      vec);
  return cudaGetLastError();
}

// G1's block form: taps (k, n, 2) int32 re-taken in place at the knots (k,
// n, 2) of the points of the listed blocks, blocks (k, cap) int32 of
// 128-point block ids (ids outside [0, n / 128) dropped); n a multiple of
// 128, 1 <= cap <= n / 128. One launch. Returns cudaGetLastError().
int tap_take_blocks(const void* tiles, const void* knot, const void* blocks, void* taps, int k,
                    int n, int cap, int width, int height, void* stream) {
  if (k < 1 || k > 65535 || n < kPartialBlock || n % kPartialBlock || cap < 1 ||
      cap > n / kPartialBlock || width < 1 || height < 1)
    return cudaErrorInvalidValue;
  const int tw = tiles_along(width);
  const long long plane = static_cast<long long>(tiles_along(height)) * tw * 8;
  const dim3 grid((cap * kPartialBlock + kThreads - 1) / kThreads, k);
  tap_take_blocks_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(tiles), static_cast<const int2*>(knot),
      static_cast<const int*>(blocks), static_cast<int2*>(taps), n, cap, width, height, tw, plane);
  return cudaGetLastError();
}

// G2: wide (k, 4 + 2 margin, n) int32 window planes of the knots (k, n, 2)
// int32 from the packed bin tiles, margin 1 or 2; knots 8-byte aligned.
// One launch, none for n = 0. Returns cudaGetLastError().
int wide_take(const void* tiles, const void* knot, void* wide, int k, int n, int width,
              int height, int margin, void* stream) {
  if (k < 1 || k > 65535 || n < 0 || width < 1 || height < 1 || margin < 1 || margin > 2)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const int th = tiles_along(height), tw = tiles_along(width);
  const long long plane = static_cast<long long>(th) * tw * 8;
  const dim3 grid((n + kThreads - 1) / kThreads, k);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned* t = static_cast<const unsigned*>(tiles);
  const int2* kn = static_cast<const int2*>(knot);
  unsigned* out = static_cast<unsigned*>(wide);
  if (margin == 1)
    wide_take_kernel<1><<<grid, kThreads, 0, s>>>(t, kn, out, n, width, height, th, tw, plane);
  else
    wide_take_kernel<2><<<grid, kThreads, 0, s>>>(t, kn, out, n, width, height, th, tw, plane);
  return cudaGetLastError();
}

// G2's block form: the planes wide (k, 4 + 2 margin, n) re-taken in place at
// the points of the listed blocks, as tap_take_blocks. Returns
// cudaGetLastError().
int wide_take_blocks(const void* tiles, const void* knot, const void* blocks, void* wide, int k,
                     int n, int cap, int width, int height, int margin, void* stream) {
  if (k < 1 || k > 65535 || n < kPartialBlock || n % kPartialBlock || cap < 1 ||
      cap > n / kPartialBlock || width < 1 || height < 1 || margin < 1 || margin > 2)
    return cudaErrorInvalidValue;
  const int th = tiles_along(height), tw = tiles_along(width);
  const long long plane = static_cast<long long>(th) * tw * 8;
  const dim3 grid((cap * kPartialBlock + kThreads - 1) / kThreads, k);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned* t = static_cast<const unsigned*>(tiles);
  const int2* kn = static_cast<const int2*>(knot);
  const int* bl = static_cast<const int*>(blocks);
  unsigned* out = static_cast<unsigned*>(wide);
  if (margin == 1)
    wide_take_blocks_kernel<1><<<grid, kThreads, 0, s>>>(t, kn, bl, out, n, cap, width, height,
                                                         th, tw, plane);
  else
    wide_take_blocks_kernel<2><<<grid, kThreads, 0, s>>>(t, kn, bl, out, n, cap, width, height,
                                                         th, tw, plane);
  return cudaGetLastError();
}

// W1: taps (k, n, 2) and eff_knot (k, n, 2) int32 from the planes wide (k,
// 4 + 2 margin, n) and the knots knot_true, knot_cache (k, n, 2); all 8-byte
// aligned, margin 1 or 2. One launch, none for n = 0. Returns
// cudaGetLastError().
int wide_select(const void* wide, const void* knot_true, const void* knot_cache, void* taps,
                void* eff_knot, int k, int n, int margin, void* stream) {
  if (k < 1 || k > 65535 || n < 0 || margin < 1 || margin > 2) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const dim3 grid((n + kThreads - 1) / kThreads, k);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned* w = static_cast<const unsigned*>(wide);
  const int2* kt = static_cast<const int2*>(knot_true);
  const int2* kc = static_cast<const int2*>(knot_cache);
  if (margin == 1)
    wide_select_kernel<1><<<grid, kThreads, 0, s>>>(w, kt, kc, static_cast<int2*>(taps),
                                                    static_cast<int2*>(eff_knot), n);
  else
    wide_select_kernel<2><<<grid, kThreads, 0, s>>>(w, kt, kc, static_cast<int2*>(taps),
                                                    static_cast<int2*>(eff_knot), n);
  return cudaGetLastError();
}

}  // extern "C"

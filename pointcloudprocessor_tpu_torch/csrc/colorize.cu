// Colorize and fuse for Hopper (sm_90a): C1, two passes.
//
// Replaces what the JAX package leaves to XLA on the main path's colorize
// (no Pallas source): pointcloudprocessor_tpu/pipeline/colorize.py:49-140
// (observe_keyframe: the transform, the projection, the z-buffer cull, the
// nearest-pixel sample, the HSV map and the score) with ops/fusion.py:53-81
// (pack_image_rgb, update_topk) and the label and count updates of the
// `lax.scan` body at colorize.py:332. The port's plain versions are
// pipeline/colorize.depth_keys_plain (pass (a)) and fuse_keyframe_plain.
//
// On the card, the z-buffer colorize of a fuse is one memset and one launch
// of pass (a) for all its keyframes, then one launch of pass (b) a keyframe:
//   memset                    the (views, gw * gh) u32 key buffers to all ones
//   pass (a) colorize_scatter  per point, read once, for each of the views
//            (at most kMaxViews, 12 floats each, staged in shared memory):
//            p_cam = R p + t, (u, v) = project(p_cam), the gate and the
//            cell of zbuffer.cuh, then atomicMin(keys_j[cell],
//            key(|p_cam|)) if gated in. It reads nothing of the fusion
//            state, so one launch stands for all the keyframes.
//   pass (b) colorize_update   per point, for one keyframe: the same p_cam,
//            rng, u and v (recomputed, never written), vis = gated in &&
//            rng <= min(decode(keys[cell]), FLT_MAX) + eps; for a visible
//            point the score (orientation and distance, with the
//            reference_compat branch), the replace-first-min update of the
//            (K, N) slot-major top-K registers, count += 1 and, with a mask
//            image, the strictly better best score and its label. The
//            nearest pixel (clamp(to_int32(u), 0, W - 1), the same for v) is
//            read only where it is kept: its 3 bytes from the (H, W, 3)
//            uint8 image (no packed image), with the HSV map where a scale
//            is not 1, where the score replaces a slot; its label where the
//            best score is beaten.
// A keyframe alone (fuse_keyframe without keys, and the mask dumps,
// keyframe_rgb_mask) is a memset and both passes at one view. The HPR branch
// runs H2 on the eager transform and pass (b) alone, with H2's mask in place
// of the depth test. The dumps run pass (b) with the fusion state null and
// the dump outputs set: camera-frame points, the sampled colour (the
// highlight label painted red), the label and vis, for every point.
//
// Exactness. Both passes equal the plain versions bit for bit. The plain
// version rounds every product and sum apart (torch's eager ops), and nvcc
// would contract a*b + c into an FMA, so every step is written with
// __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn / __fsqrt_rn in torch's
// order: ((R00 x + R01 y) + R02 z) + t0, ((1 + k1 r2) + k2 r4) + k3 r6.
// Python-number constants enter as the f32 of the double Python holds (the
// launcher folds 1 - score_floor in double, then casts); 1e-9 and 1e-12 are
// compared as f32. Float -> int conversions are utils/numeric.to_int32's:
// NaN -> 0, saturate, truncate. torch's clamp and amin propagate NaN, so the
// helpers below do. Divisions are IEEE (the plain version divides by 0-dim
// tensors, which torch on the card divides exactly).
//
// What bounds pass (a) on the H100: its f32 operations, ~60 a point and view
// (the transform, the projection with 4 IEEE divisions, the range's square
// root), above its bytes (13 B a point, once, and the key buffers, 250 KB a
// view at 4096x3000 / 14, which stay in L2); in practice the divisions and
// the L2's rate of random atomics. On the main path's 8 views one launch took
// 0.063-0.066 ms against 8 x (0.0145 + a 1.1 us memset) one view at a time
// (PERF.md §6): xyz and valid are read once, not 8 times, 7 launches and
// memsets go, and a point that is invalid or at z <= 0 in a view skips its
// divisions. Measured and dropped: a grid over the views (a view a thread,
// xyz re-read from L2), 0.076 ms. Tried on K5's pass (a), the same gate and
// atomic (zbuffer.cu), and not again: a read of the key before the atomic,
// warp combining, private copies of the buffer, 4 points a thread.
//
// What bounds pass (b): the bytes. It reads xyz and valid (13 B a point)
// and the cell's key, and for a visible point the K scores (20 B at K = 5)
// and the count, and writes the count; for a slot it replaces, the 3-byte sample and 8 B of slot; with masks the best score,
// and where it is beaten the label, the best score and label. About 69 B a
// point a keyframe without masks at most: ~21 us for 1M points at the 3.35
// TB/s of an NVIDIA H100 80GB HBM3 at 700 W (its data sheet). In whole
// sectors more: the slot-major registers of the visible points are ~half
// of every sector, so every sector of the (K, N) scores and of the count is
// read, and each sample is a random 32-byte sector of the 37 MB image. The
// arithmetic (~100 f32 operations a point, six IEEE divisions and one or
// two square roots among them) is below the bytes but not far. One point a
// thread: a warp's loads of xyz and of the registers are coalesced; the key
// and pixel reads are gathers. Reading the sample last, and only where a
// slot takes it, saves its random sector on every visible point whose
// score does not enter the top K (after K keyframes, most of them).
// Measured and dropped (PERF.md §6): the view from kernel arguments, the
// slots loaded early, the pixel in aligned words, 2-4 points a thread. The
// keyframe's pose and camera (24 floats) come from device pointers, so
// nothing is read back to the host, and each block stages them once in
// shared memory.

#include <cuda_runtime.h>
#include <math.h>

#include "zbuffer.cuh"

// What the launcher hands both passes; the field order is the ctypes
// Structure's in pipeline/colorize.py.
struct ColorizeArgs {
  // The map: (n, 3) f32 world points and (n,) bool valid, element strides.
  const float* pts;
  long long sp0, sp1;
  const unsigned char* valid;
  long long sv;
  int n;
  // The keyframe: T_camera_world as R (3x3 row-major) and t (pass (a): the
  // views' (views, 3, 3) and (views, 3)), the camera's intrinsics (fx, fy,
  // cx, cy) and distortion (k1, k2, p1, p2, k3), and its position in the
  // world (reference_compat; null: the camera-frame score).
  const float* R;
  const float* t;
  const float* intr;
  const float* dist;
  const float* pos;
  // The cull: the image size and cell, the depth epsilon, and either the
  // (gw * gh,) key buffer (z-buffer; pass (a): (views, gw * gh)) or a given
  // (n,) bool mask (HPR).
  int width, height, ds;
  float eps;
  unsigned* keys;
  const unsigned char* vis_in;
  // The (img_h, img_w, 3) uint8 image and the (img_h, img_w) int32 labels
  // (null without masks).
  const unsigned char* image;
  int img_h, img_w;
  const int* mask;
  // The HSV map (hsv != 0 where a scale is not 1) and the score.
  int hsv;
  float sat, bri;
  float opt_dist, floor_, one_minus_floor;
  // The fusion state, null in the dump mode: (k, n) slot-major scores and
  // packed colours, (n,) int32 count, and with masks (n,) best score / label.
  int k;
  float* scores;
  int* rgb;
  int* count;
  float* best_s;
  int* best_l;
  // The dump outputs, null on the fusion path: (n, 3) camera-frame points,
  // (n, 3) f32 colours, (n,) int32 labels, (n,) bool vis.
  float* pts_cam;
  float* rgb_out;
  int* label_out;
  unsigned char* vis_out;
  int highlight;
};

namespace {

using namespace zbuf;

constexpr int kThreads = 256;
constexpr int kView = 24;  // R 9, t 3, fx fy cx cy, k1 k2 p1 p2 k3, camera position 3
constexpr int kMaxViews = 32;  // keyframes a pass (a) launch takes (pipeline/colorize.SCATTER_VIEWS)

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// torch.clamp, NaN propagating.
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp_max(float x, float hi) { return x > hi ? hi : x; }
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return clamp_max(clamp_min(x, lo), hi);
}

// utils/numeric.to_int32: NaN -> 0, saturate, truncate toward zero.
__device__ __forceinline__ int to_int32(float x) { return isnan(x) ? 0 : __float2int_rz(x); }

// The keyframe's 24 floats, staged once a block; every thread of the block
// must call it.
__device__ __forceinline__ void stage_view(const ColorizeArgs& a, float* s) {
  const int i = threadIdx.x;
  if (i < 9) s[i] = a.R[i];
  else if (i < 12) s[i] = a.t[i - 9];
  else if (i < 16) s[i] = a.intr[i - 12];
  else if (i < 21) s[i] = a.dist[i - 16];
  else if (i < kView) s[i] = a.pos ? a.pos[i - 21] : 0.0f;
  __syncthreads();
}

struct Projected {
  float x, y, z;  // camera frame (core/se3.transform_xyz)
  float rng;      // |p_cam|
  float u, v;     // pixel (models/camera.project_xyz)
};

__device__ __forceinline__ float range(float x, float y, float z) {
  return __fsqrt_rn(add(add(mul(x, x), mul(y, y)), mul(z, z)));
}

__device__ __forceinline__ void load_point(const ColorizeArgs& a, long long i, float& px,
                                           float& py, float& pz) {
  const float* p = a.pts + i * a.sp0;
  px = __ldg(p);
  py = __ldg(p + a.sp1);
  pz = __ldg(p + 2 * a.sp1);
}

// Point i transformed and projected as the plain version rounds it, in the
// view s (stage_view's layout).
__device__ __forceinline__ Projected project(const ColorizeArgs& a, const float* s, long long i) {
  float px, py, pz;
  load_point(a, i, px, py, pz);
  Projected q;
  transform(s, px, py, pz, q.x, q.y, q.z);
  q.rng = range(q.x, q.y, q.z);
  pixel(s + 12, q.x, q.y, q.z, q.u, q.v);
  return q;
}

__device__ __forceinline__ bool point_valid(const ColorizeArgs& a, long long i) {
  return __ldg(a.valid + i * a.sv) != 0;
}

// ops/fusion.hsv_adjust on one packed sample, then pack_rgb.
__device__ __forceinline__ int hsv_adjust(int packed, float sat, float bri) {
  const float c255 = 255.0f, tiny = static_cast<float>(1e-12);
  float x[3];
  x[0] = dvd(float((packed >> 16) & 0xff), c255);
  x[1] = dvd(float((packed >> 8) & 0xff), c255);
  x[2] = dvd(float(packed & 0xff), c255);
  const float mx = fmaxf(fmaxf(x[0], x[1]), x[2]);
  const float mn = fminf(fminf(x[0], x[1]), x[2]);
  const float delta = sub(mx, mn);
  const float s = mx > 0.0f ? dvd(delta, clamp_min(mx, tiny)) : 0.0f;
  const float s2 = clamp(mul(s, sat), 0.0f, 1.0f);
  const float v2 = clamp(mul(mx, bri), 0.0f, 1.0f);
  int out = 0;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float ratio = delta > 0.0f ? dvd(sub(mx, x[c]), clamp_min(delta, tiny)) : 0.0f;
    const float o = clamp(mul(mul(v2, sub(1.0f, mul(s2, ratio))), c255), 0.0f, c255);
    out = (out << 8) | to_int32(clamp(o, 0.0f, c255));
  }
  return out;
}

// ops/fusion.final_score_xyz: (orientation + distance) / 2.
__device__ __forceinline__ float final_score(const ColorizeArgs& a, const float* s,
                                             const Projected& q) {
  const float tiny = static_cast<float>(1e-12);
  float cosv;
  if (a.pos) {  // reference_compat: the world-frame position off the camera-frame point
    const float vx = sub(q.x, s[21]), vy = sub(q.y, s[22]), vz = sub(q.z, s[23]);
    const float vn = __fsqrt_rn(add(add(mul(vx, vx), mul(vy, vy)), mul(vz, vz)));
    cosv = dvd(vz, clamp_min(vn, tiny));
  } else {
    cosv = dvd(q.z, clamp_min(q.rng, tiny));
  }
  const float o = add(a.floor_, mul(a.one_minus_floor, mul(add(cosv, 1.0f), 0.5f)));
  const float diff = clamp_max(dvd(fabsf(sub(q.rng, a.opt_dist)), a.opt_dist), 1.0f);
  const float d = add(a.floor_, mul(a.one_minus_floor, sub(1.0f, diff)));
  return mul(0.5f, add(o, d));
}

// Pass (a) for `views` keyframes at once: a point's xyz and valid are read
// once, then for each view staged in shared memory its transform,
// projection, gate and cell and, if gated in, an atomicMin of its range key
// into that view's key buffer (keys + j * gw * gh). An invalid point, or one
// at z <= 0 (or NaN) in a view, is dropped before the divisions: the gate
// drops it anyway, so no key changes.
__global__ void __launch_bounds__(kThreads) colorize_scatter(ColorizeArgs a, Grid g, int views) {
  __shared__ float cam[9];
  __shared__ float pose[kMaxViews * 12];
  for (int i = threadIdx.x; i < views * 12; i += kThreads) {
    const int j = i / 12, e = i - 12 * j;
    pose[i] = e < 9 ? a.R[9 * j + e] : a.t[3 * j + e - 9];
  }
  if (threadIdx.x < 4) cam[threadIdx.x] = a.intr[threadIdx.x];
  else if (threadIdx.x < 9) cam[threadIdx.x] = a.dist[threadIdx.x - 4];
  __syncthreads();
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= a.n || !point_valid(a, i)) return;
  float px, py, pz;
  load_point(a, i, px, py, pz);
  const long long cells = static_cast<long long>(g.gw) * g.gh;
  for (int j = 0; j < views; ++j) {
    float x, y, z, u, v;
    transform(pose + 12 * j, px, py, pz, x, y, z);
    if (!(z > 0.0f)) continue;
    pixel(cam, x, y, z, u, v);
    int cell;
    if (gate_cell(u, v, z, true, g, cell)) atomicMin(a.keys + j * cells + cell, range_key(range(x, y, z)));
  }
}

// Pixel `flat` of the (h, w, 3) uint8 image, packed as (R << 16) | (G << 8) | B.
__device__ __forceinline__ int load_pixel(const unsigned char* image, long long flat) {
  const unsigned char* px = image + 3 * flat;
  return (int(__ldg(px)) << 16) | (int(__ldg(px + 1)) << 8) | int(__ldg(px + 2));
}

__global__ void __launch_bounds__(kThreads) colorize_update(ColorizeArgs a, Grid g) {
  __shared__ float view[kView];
  stage_view(a, view);
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= a.n) return;
  const Projected q = project(a, view, i);
  bool vis;
  if (a.keys) {
    int cell;
    vis = gate_cell(q.u, q.v, q.z, point_valid(a, i), g, cell) &&
          q.rng <= __fadd_rn(cell_min(a.keys, cell), a.eps);
  } else {
    vis = __ldg(a.vis_in + i) != 0;
  }
  // The nearest pixel (colorize.py:86-88), read where its sample is kept:
  // for every point in the dump mode; on the fusion path only for a
  // visible point whose score replaces a slot (its colour) or beats its
  // best score (its label).
  const int ui = min(max(to_int32(q.u), 0), a.img_w - 1);
  const int vi = min(max(to_int32(q.v), 0), a.img_h - 1);
  const long long flat = static_cast<long long>(vi) * a.img_w + ui;
  if (a.vis_out) {
    int packed = load_pixel(a.image, flat);
    if (a.hsv) packed = hsv_adjust(packed, a.sat, a.bri);
    const int label = a.mask ? __ldg(a.mask + flat) : 0;
    a.pts_cam[3 * i] = q.x;
    a.pts_cam[3 * i + 1] = q.y;
    a.pts_cam[3 * i + 2] = q.z;
    const bool red = label == a.highlight;
    a.rgb_out[3 * i] = red ? 255.0f : float((packed >> 16) & 0xff);
    a.rgb_out[3 * i + 1] = red ? 0.0f : float((packed >> 8) & 0xff);
    a.rgb_out[3 * i + 2] = red ? 0.0f : float(packed & 0xff);
    a.label_out[i] = label;
    a.vis_out[i] = vis ? 1 : 0;
  }
  if (!a.scores || !vis) return;  // an invisible point's candidate is -inf: no update
  const float score = final_score(a, view, q);
  // ops/fusion.update_topk: the first minimal slot (torch.amin, then the
  // smallest slot equal to it); a NaN slot makes the minimum NaN, and
  // nothing is replaced.
  const long long n = a.n;
  float m = a.scores[i];
  int slot = 0;
  bool nan = isnan(m);
  for (int s = 1; s < a.k; ++s) {
    const float v = a.scores[s * n + i];
    if (isnan(v)) {
      nan = true;
    } else if (v < m) {
      m = v;
      slot = s;
    }
  }
  if (!nan && score > m) {
    int packed = load_pixel(a.image, flat);
    if (a.hsv) packed = hsv_adjust(packed, a.sat, a.bri);
    a.scores[slot * n + i] = score;
    a.rgb[slot * n + i] = packed;
  }
  a.count[i] += 1;
  if (a.best_s && score > a.best_s[i]) {
    a.best_s[i] = score;
    a.best_l[i] = a.mask ? __ldg(a.mask + flat) : 0;
  }
}

inline unsigned blocks(long long threads) { return unsigned((threads + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// C1's pass (a) for `views` keyframes, 1 <= views <= kMaxViews: the (views,
// gw * gh) u32 key buffer memset to all ones, then one launch of
// colorize_scatter (none for n = 0); R (views, 3, 3) and t (views, 3) the
// keyframes' poses. Returns the first CUDA error.
int colorize_keys(const ColorizeArgs* args, int views, void* stream) {
  const ColorizeArgs& a = *args;
  if (a.n < 0 || !a.keys || views < 1 || views > kMaxViews || a.ds < 1)
    return cudaErrorInvalidValue;
  const Grid g = make_grid(a.width, a.height, a.ds);
  if (g.gw < 1 || g.gh < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      cudaMemsetAsync(a.keys, 0xff, size_t(views) * g.gw * g.gh * sizeof(unsigned), st);
  if (err != cudaSuccess || a.n == 0) return err;
  colorize_scatter<<<blocks(a.n), kThreads, 0, st>>>(a, g, views);
  return cudaGetLastError();
}

// C1's pass (b) for one keyframe: against its (gw * gh) keys from
// colorize_keys (z-buffer) or a given mask (vis_in, HPR). Nothing for n = 0.
// Returns the first CUDA error.
int colorize(const ColorizeArgs* args, void* stream) {
  const ColorizeArgs& a = *args;
  const bool dump_ok = !a.vis_out || (a.pts_cam && a.rgb_out && a.label_out);
  const bool fuse_ok = !a.scores || (a.k >= 1 && a.rgb && a.count && (!a.best_s || a.best_l));
  if (a.n < 0 || (!a.keys == !a.vis_in) || !dump_ok || !fuse_ok || a.img_h < 1 || a.img_w < 1)
    return cudaErrorInvalidValue;
  if (a.keys && a.ds < 1) return cudaErrorInvalidValue;
  const Grid g = a.keys ? make_grid(a.width, a.height, a.ds) : Grid{};
  if (a.keys && (g.gw < 1 || g.gh < 1)) return cudaErrorInvalidValue;
  if (a.n == 0) return cudaSuccess;
  colorize_update<<<blocks(a.n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a, g);
  return cudaGetLastError();
}

}  // extern "C"

"""NID joint histogram: CUDA kernels K1/K2 and their plain torch twin.

Port of the fused Pallas kernel pair in `pointcloudprocessor_tpu/ops/
nid_hist.py` (`_fwd_kernel` :71 and `_bwd_kernel` :112, wired through
`jax.custom_vjp`). Given each point's 16 nibble-packed image-bin taps, its
fractional projection offsets ``s``, its intensity bin and its inlier gate,
the forward pass builds the (bins, bins) joint histogram
``hist[point_bin, image_bin] += By[t//4] * Bx[t%4] * inlier`` of cubic
B-spline weights; the backward pass returns the gradient for ``s`` only
(knots, bins and the gate are piecewise constant in the pose).

Every function takes a written-out keyframe dimension K: taps (K, N, 2)
int32, s (K, N, 2) f32, bin_pts (K, N) int32, inlier (K, N) f32 -> hist
(K, bins, bins) f32 in [point_bin, image_bin] orientation.

Dispatch (:func:`joint_histogram`) goes by the tensors' device: on the CPU
the plain twin (:func:`joint_histogram_plain`, the JAX package's XLA branch
`opt/nid.py:335-360`) runs under autograd; on CUDA the hand-written kernels
in `csrc/nid_hist.cu` run through :class:`JointHistogram`, or the call
raises. ``launch_counts`` counts each kernel's launches,
``kernels.build.launch_shapes`` the same by points a keyframe. K1 is one
launch a call: its scratch (partials and arrival counters) is allocated
once per shape and stream, so a call allocates only its histogram.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import build as kbuild

# Launches of each CUDA kernel in this process (see reset_launch_counts).
launch_counts = {"nid_hist_fwd": 0, "nid_hist_bwd": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0
    kbuild.reset_launch_shapes(launch_counts)


# The C launchers of csrc/nid_hist.cu: pointers and the stream as c_void_p
# (a c_int would cut them), ints as c_int.
_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # taps, s, bin_pts, inlier, partial, arrive, hist, K, N, bins, per_kf, ppb, stream
    "nid_hist_fwd": ([_PTR] * 7 + [_I32] * 5 + [_PTR], _I32),
    # g, taps, s, bin_pts, inlier, ds, K, N, bins, per_kf, ppb, stream
    "nid_hist_bwd": ([_PTR] * 6 + [_I32] * 5 + [_PTR], _I32),
}
_fns: dict = {}  # name -> the library's ctypes function, signature declared


def _fn(name: str):
    if name not in _fns:
        _fns[name] = getattr(kbuild.library("nid_hist", _SIGNATURES), name)
    return _fns[name]


# Launch geometry of K1/K2 (csrc/nid_hist.cu). A block of 256 threads walks
# ``ppb`` pairs of consecutive points of one keyframe; ``per_kf`` blocks
# cover a keyframe. The grid aims at 4 blocks on each of the H100's 132 SMs
# whatever N and K are, so that the coarse shape (8 x 16,384) fills the
# card as the fine one (8 x 262,144) does; a block holds at least 64 pairs.
THREADS = 256
TARGET_BLOCKS = 4 * 132
MIN_PAIRS_PER_BLOCK = 64


def grid(k: int, n: int) -> tuple[int, int]:
    """(per_kf, ppb): blocks a keyframe and point pairs a block of K1/K2
    for K keyframes of N points. Block bx of keyframe k walks pairs j of
    the flattened (K*N) arrays (points 2j, 2j+1) from floor(k*N/2) + bx*ppb,
    and handles those of its points inside the keyframe. A keyframe spans
    ceil(N/2) pairs (one that starts on an odd point has an odd N)."""
    pairs = max(1, (n + 1) // 2)
    per_kf = max(1, min(-(-TARGET_BLOCKS // k), -(-pairs // MIN_PAIRS_PER_BLOCK)))
    ppb = -(-pairs // per_kf)
    return -(-pairs // ppb), ppb


# ---------------------------------------------------------------------------
# Plain twin
# ---------------------------------------------------------------------------


_SPLINE = torch.tensor(
    [
        [1.0, -3.0, 3.0, -1.0],
        [4.0, 0.0, -6.0, 3.0],
        [1.0, 3.0, 3.0, -3.0],
        [0.0, 0.0, 0.0, 1.0],
    ],
    dtype=torch.float32,
) / 6.0


def spline_weights(s: torch.Tensor) -> torch.Tensor:
    """(...,) fractional offsets -> (..., 4) uniform cubic B-spline weights,
    beta = C @ [1, s, s^2, s^3] (`nid_cost.hpp:71-77`)."""
    powers = torch.stack([torch.ones_like(s), s, s * s, s * s * s], dim=-1)
    return powers @ _SPLINE.T.to(device=s.device, dtype=s.dtype)


def unpack_tap_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """(..., 2) int32 -> (..., 16) int32 tap values; nibble t of word t//8
    at bit 4*(t%8), read as unsigned."""
    w = packed.to(torch.int64) & 0xFFFFFFFF
    shifts = 4 * (torch.arange(16, device=packed.device) % 8)
    words = w[..., torch.arange(16, device=packed.device) // 8]
    return ((words >> shifts) & 0xF).to(torch.int32)


def joint_histogram_plain(taps, s, bin_pts, inlier, bins: int = 16) -> torch.Tensor:
    """The twin: the XLA branch of `opt/nid._histograms_from_taps`
    (`nid.py:335-360`) in torch, differentiable in ``s`` by autograd, on any
    device. Returns (K, bins, bins) [point_bin, image_bin]."""
    inlier = inlier.detach()
    bx = spline_weights(s[..., 0])  # (K, N, 4)
    by = spline_weights(s[..., 1])
    b_img = unpack_tap_nibbles(taps)  # (K, N, 16)
    # Weights in matching (dy, dx) order.
    w = (by[..., :, None] * bx[..., None, :]).reshape(s.shape[:-1] + (16,))
    w = w * inlier[..., None]
    # Per-point image-bin mass: the 16 taps accumulated into `bins` buckets
    # (a tap value outside [0, bins) adds nothing, as one_hot drops it).
    levels = torch.arange(bins, device=s.device)
    w_img = torch.zeros(s.shape[:-1] + (bins,), dtype=w.dtype, device=s.device)
    for t in range(16):
        w_img = w_img + w[..., t:t + 1] * (b_img[..., t:t + 1] == levels).to(w.dtype)
    P = (bin_pts[..., None] == levels).to(w.dtype) * inlier[..., None]  # (K, N, bins)
    return torch.einsum("knb,knc->kbc", P, w_img)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------


def _check(taps, s, bin_pts, inlier, bins):
    """K1/K2's argument checks: one expression on the path that passes (a
    call's host time is most of what it costs at the coarse shape), the
    detailed checks and their errors when it fails. The two hold the same
    conditions, term for term: a change to one is a change to both."""
    dev = taps.device
    if (1 <= bins <= 16 and dev.type == "cuda" and taps.dim() == 3
            and s.device == dev and bin_pts.device == dev and inlier.device == dev
            and taps.dtype == torch.int32 and s.dtype == torch.float32
            and bin_pts.dtype == torch.int32 and inlier.dtype == torch.float32
            and taps.shape[2] == 2 and s.shape == taps.shape
            and bin_pts.shape == taps.shape[:2] and inlier.shape == taps.shape[:2]
            and taps.is_contiguous() and s.is_contiguous() and bin_pts.is_contiguous()
            and inlier.is_contiguous()
            and (taps.data_ptr() | s.data_ptr() | bin_pts.data_ptr() | inlier.data_ptr()) % 8 == 0
            and taps.shape[1] < 2**30 and 1 <= taps.shape[0] <= 65535):
        return
    _check_detailed(taps, s, bin_pts, inlier, bins)


def _check_detailed(taps, s, bin_pts, inlier, bins):
    """Raises the error of the first condition of :func:`_check` that fails;
    what is left when the tensors pass is the (K, N) range."""
    if not 1 <= bins <= 16:
        raise ValueError(f"bins must be in [1, 16] (4-bit taps), got {bins}")
    if taps.dim() != 3 or taps.shape[-1] != 2:
        raise ValueError(f"taps must be (K, N, 2), got {tuple(taps.shape)}")
    k, n = taps.shape[:2]
    want = {
        "taps": (taps, torch.int32, (k, n, 2)),
        "s": (s, torch.float32, (k, n, 2)),
        "bin_pts": (bin_pts, torch.int32, (k, n)),
        "inlier": (inlier, torch.float32, (k, n)),
    }
    for name, (t, dtype, shape) in want.items():
        if t.device != taps.device or t.device.type != "cuda":
            raise ValueError(f"{name} must be on {taps.device} (CUDA), got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 8:
            raise ValueError(f"{name} must be contiguous and 8-byte aligned")
    raise ValueError(f"(K, N) = ({k}, {n}) exceeds the kernels' index range")


# K1's scratch, allocated once per (device, stream, K, N): the blocks'
# partial histograms and the per-keyframe arrival counters, which each
# launch leaves at 0. One stream's launches run in order, so they may share
# them; another stream gets its own.
_scratch_cache: dict = {}
_SCRATCH_KEYS = 16


def _scratch(device: torch.device, stream: int, k: int, n: int):
    key = (device, stream, k, n)
    buf = _scratch_cache.get(key)
    if buf is None:
        if len(_scratch_cache) >= _SCRATCH_KEYS:
            _scratch_cache.clear()
        per_kf, _ = grid(k, n)
        buf = _scratch_cache[key] = (
            torch.empty((k, per_kf, 256), dtype=torch.float32, device=device),
            torch.zeros((k,), dtype=torch.int32, device=device),
        )
    return buf


def hist_fwd_cuda(taps, s, bin_pts, inlier, bins: int = 16) -> torch.Tensor:
    """K1: (K, bins, bins) joint histograms, one launch for all K."""
    _check(taps, s, bin_pts, inlier, bins)
    k, n = taps.shape[:2]
    dev = taps.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    per_kf, ppb = grid(k, n)
    partial, arrive = _scratch(dev, stream, k, n)
    hist = torch.empty((k, bins, bins), dtype=torch.float32, device=dev)
    err = _fn("nid_hist_fwd")(
        taps.data_ptr(), s.data_ptr(), bin_pts.data_ptr(), inlier.data_ptr(), partial.data_ptr(),
        arrive.data_ptr(), hist.data_ptr(), k, n, bins, per_kf, ppb, stream,
    )
    if err != 0:
        raise RuntimeError(f"nid_hist_fwd launch failed: CUDA error {err}")
    launch_counts["nid_hist_fwd"] += 1
    kbuild.launch_shapes["nid_hist_fwd", n] += 1
    return hist


def hist_bwd_cuda(g, taps, s, bin_pts, inlier, bins: int = 16) -> torch.Tensor:
    """K2: (K, N, 2) gradient of sum(g * hist) with respect to ``s``."""
    _check(taps, s, bin_pts, inlier, bins)
    k, n = taps.shape[:2]
    dev = taps.device
    if g.dtype != torch.float32 or not g.is_contiguous():
        g = g.to(torch.float32).contiguous()
    if g.shape != (k, bins, bins) or g.device != dev:
        raise ValueError(f"g must be ({k}, {bins}, {bins}) on {dev}")
    per_kf, ppb = grid(k, n)
    ds = torch.empty((k, n, 2), dtype=torch.float32, device=dev)
    err = _fn("nid_hist_bwd")(
        g.data_ptr(), taps.data_ptr(), s.data_ptr(), bin_pts.data_ptr(), inlier.data_ptr(),
        ds.data_ptr(), k, n, bins, per_kf, ppb,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"nid_hist_bwd launch failed: CUDA error {err}")
    launch_counts["nid_hist_bwd"] += 1
    kbuild.launch_shapes["nid_hist_bwd", n] += 1
    return ds


class JointHistogram(torch.autograd.Function):
    """K1 forward, K2 backward; a gradient for ``s`` only."""

    @staticmethod
    def forward(ctx, taps, s, bin_pts, inlier, bins):
        s = s.contiguous()
        ctx.save_for_backward(taps, s, bin_pts, inlier)
        ctx.bins = bins
        return hist_fwd_cuda(taps, s, bin_pts, inlier, bins)

    @staticmethod
    def backward(ctx, g):
        taps, s, bin_pts, inlier = ctx.saved_tensors
        ds = hist_bwd_cuda(g, taps, s, bin_pts, inlier, ctx.bins)
        return None, ds, None, None, None


def joint_histogram(taps, s, bin_pts, inlier, bins: int = 16) -> torch.Tensor:
    """(K, bins, bins) joint histograms [point_bin, image_bin].

    CPU tensors take the plain twin; CUDA tensors take kernels K1/K2 (a
    build or launch failure raises). Any other device raises."""
    dev = s.device.type
    if dev == "cpu":
        return joint_histogram_plain(taps, s, bin_pts, inlier, bins)
    if dev == "cuda":
        return JointHistogram.apply(taps, s, bin_pts, inlier.detach(), bins)
    raise NotImplementedError(f"joint_histogram: no kernel for device {s.device}")

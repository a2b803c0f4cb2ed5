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
raises. ``launch_counts`` counts each kernel's launches.
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


# The C launchers of csrc/nid_hist.cu: pointers and the stream as c_void_p
# (a c_int would cut them), ints as c_int.
_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "nid_hist_fwd_nblocks": ([_I32], _I32),
    # taps, s, bin_pts, inlier, partial, hist, K, N, bins, stream
    "nid_hist_fwd": ([_PTR] * 6 + [_I32] * 3 + [_PTR], _I32),
    # g, taps, s, bin_pts, inlier, ds, K, N, bins, stream
    "nid_hist_bwd": ([_PTR] * 6 + [_I32] * 3 + [_PTR], _I32),
}


def _lib() -> ctypes.CDLL:
    return kbuild.library("nid_hist", _SIGNATURES)


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
    if n >= 2**31 // 2 or k > 65535:
        raise ValueError(f"(K, N) = ({k}, {n}) exceeds the kernels' index range")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def hist_fwd_cuda(taps, s, bin_pts, inlier, bins: int = 16) -> torch.Tensor:
    """K1: (K, bins, bins) joint histograms, one launch pair for all K."""
    _check(taps, s, bin_pts, inlier, bins)
    lib = _lib()
    k, n = taps.shape[:2]
    nblocks = lib.nid_hist_fwd_nblocks(n)
    partial = torch.empty((k, nblocks, bins * bins), dtype=torch.float32, device=s.device)
    hist = torch.empty((k, bins, bins), dtype=torch.float32, device=s.device)
    err = lib.nid_hist_fwd(
        taps.data_ptr(), s.data_ptr(), bin_pts.data_ptr(), inlier.data_ptr(),
        partial.data_ptr(), hist.data_ptr(), k, n, bins, _stream(s),
    )
    if err != 0:
        raise RuntimeError(f"nid_hist_fwd launch failed: CUDA error {err}")
    launch_counts["nid_hist_fwd"] += 1
    return hist


def hist_bwd_cuda(g, taps, s, bin_pts, inlier, bins: int = 16) -> torch.Tensor:
    """K2: (K, N, 2) gradient of sum(g * hist) with respect to ``s``."""
    _check(taps, s, bin_pts, inlier, bins)
    k, n = taps.shape[:2]
    g = g.to(torch.float32).contiguous()
    if tuple(g.shape) != (k, bins, bins) or g.device != s.device:
        raise ValueError(f"g must be ({k}, {bins}, {bins}) on {s.device}")
    ds = torch.empty((k, n, 2), dtype=torch.float32, device=s.device)
    err = _lib().nid_hist_bwd(
        g.data_ptr(), taps.data_ptr(), s.data_ptr(), bin_pts.data_ptr(),
        inlier.data_ptr(), ds.data_ptr(), k, n, bins, _stream(s),
    )
    if err != 0:
        raise RuntimeError(f"nid_hist_bwd launch failed: CUDA error {err}")
    launch_counts["nid_hist_bwd"] += 1
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

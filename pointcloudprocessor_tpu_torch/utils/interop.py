"""Build the port's objects from state handed over as numpy arrays.

The JAX package's objects (camera, SE3, PointCloud, NIDKeyframe, HashGrid,
MLSSurface) convert to
numpy with ``np.asarray`` on each field; these functions turn those arrays
into the port's objects on a given device, so one set of inputs can feed
both packages. They take numpy, never jax arrays: the port does not import
jax.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import se3
from ..core.cloud import PointCloud
from ..models.camera import PinholeCamera
from ..ops.knn import HashGrid
from ..ops.mls import MLSSurface
from ..opt.nid import NIDKeyframe


def tensor(a, device, dtype=None) -> torch.Tensor:
    """numpy (or nested sequence) -> a torch tensor (a copy) on ``device``;
    float64 becomes float32 unless ``dtype`` says otherwise."""
    a = np.asarray(a)
    if dtype is None and a.dtype == np.float64:
        dtype = torch.float32
    return torch.tensor(a, device=device, dtype=dtype)


def camera(intrinsic, distortion, width: int, height: int, device) -> PinholeCamera:
    return PinholeCamera(
        intrinsic=tensor(intrinsic, device, torch.float32),
        distortion=tensor(distortion, device, torch.float32),
        width=int(width),
        height=int(height),
    )


def pose(q, t, device) -> se3.SE3:
    """SE3 from wxyz quaternion(s) and translation(s), as given (no
    renormalization, so values match the source bit for bit)."""
    return se3.SE3(tensor(q, device, torch.float32), tensor(t, device, torch.float32))


def cloud(points, intensity, valid, device, rgb=None, mask_label=None,
          normals=None) -> PointCloud:
    def opt(a, dtype):
        return None if a is None else tensor(a, device, dtype)

    return PointCloud(
        points=tensor(points, device, torch.float32),
        intensity=tensor(intensity, device, torch.float32),
        valid=tensor(valid, device, torch.bool),
        rgb=opt(rgb, torch.float32),
        mask_label=opt(mask_label, torch.int32),
        normals=opt(normals, torch.float32),
    )


def nid_keyframes(points, intensity, valid, bin_image, device,
                  tap_rows: Optional[np.ndarray] = None) -> NIDKeyframe:
    """Batched (K leading) NID keyframes."""
    return NIDKeyframe(
        points=tensor(points, device, torch.float32),
        intensity=tensor(intensity, device, torch.float32),
        valid=tensor(valid, device, torch.bool),
        bin_image=tensor(bin_image, device, torch.int32),
        tap_rows=None if tap_rows is None else tensor(tap_rows, device, torch.int32),
    )


def hash_grid(buckets, counts, cell_size: float, table_size: int, device,
              bucket_points=None) -> HashGrid:
    """A grid-hash table (buckets (T, B) int32, counts (T,) int32, optional
    (T, 3B) ``bucket_points`` planes)."""
    return HashGrid(
        buckets=tensor(buckets, device, torch.int32),
        counts=tensor(counts, device, torch.int32),
        cell_size=float(cell_size),
        table_size=int(table_size),
        bucket_points=None if bucket_points is None else tensor(bucket_points, device,
                                                               torch.float32),
    )


def mls_surface(origin, normal, tangent_u, tangent_v, coeffs, ok, device) -> MLSSurface:
    """Fitted MLS surfaces, one a point."""
    return MLSSurface(
        origin=tensor(origin, device, torch.float32),
        normal=tensor(normal, device, torch.float32),
        tangent_u=tensor(tangent_u, device, torch.float32),
        tangent_v=tensor(tangent_v, device, torch.float32),
        coeffs=tensor(coeffs, device, torch.float32),
        ok=tensor(ok, device, torch.bool),
    )

"""The (kf, pt) process mesh and the sharding helpers.

Port of `pointcloudprocessor_tpu/parallel/mesh.py`. The reference is one
process; its only parallelism is OpenMP thread teams (the keyframe NID costs,
`visual_camera_calibration.cpp:110-114`). The JAX package scales across
devices with a `jax.sharding.Mesh`; here each rank of a `torch.distributed`
world is one device of a ``DeviceMesh`` with two axes:

* ``kf``: keyframes. Each row of the mesh holds a contiguous slice of the
  keyframes, and the per-keyframe NIDs sum over the ``kf`` axis.
* ``pt``: map points. Each column holds a contiguous slice of every
  keyframe's points, and the histograms sum over the ``pt`` axis.

Rank r sits at (r // pt, r % pt), as JAX's row-major ``reshape(kf, pt)`` of
its devices. Gloo carries the collectives of CPU tensors, NCCL those of CUDA
tensors; a tensor on the other device raises (:func:`check_backend`), and
nothing is staged through the host to make a backend fit.

In place of JAX's ``NamedSharding`` placements, a rank takes its slice of a
full array itself (:func:`shard_keyframes`, :func:`shard_kf`,
:func:`shard_pt`), and results come back whole through the all-gathers
:func:`gather_kf` and :func:`gather_pt`.
"""

from __future__ import annotations

import os
from dataclasses import replace
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..opt.nid import NIDKeyframe

KF_AXIS = "kf"
PT_AXIS = "pt"


def init_distributed(backend: Optional[str] = None) -> None:
    """Bring up the default process group (JAX `mesh.py:69-76`). A no-op
    when one is up. Reads torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); a process without it
    gets a world of 1 over an in-process store, as JAX's single-process
    ``init_distributed`` does. ``backend`` None takes NCCL where CUDA is
    available (each process on the card ``LOCAL_RANK`` names) and Gloo
    otherwise."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    device_id = None
    if backend == "nccl":
        device_id = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device_id)
    kw = dict(backend=backend, device_id=device_id)
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(init_method="env://", **kw)
    else:
        dist.init_process_group(store=dist.HashStore(), rank=0, world_size=1, **kw)


def make_mesh(kf: Optional[int] = None, pt: Optional[int] = None,
              device_type: Optional[str] = None) -> DeviceMesh:
    """A (kf, pt) ``DeviceMesh`` over every rank of the world (JAX
    `mesh.py:33-51`), dimension names ``("kf", "pt")``. Defaults as JAX's:
    every rank on ``kf``; one axis given, the other is what the world
    leaves. ``device_type`` None follows the default group's backend
    ("cuda" under NCCL, else "cpu"). Brings the default group up first
    where it is not (:func:`init_distributed`)."""
    init_distributed()
    n = dist.get_world_size()
    if kf is None and pt is None:
        kf, pt = n, 1
    elif kf is None:
        kf = n // pt
    elif pt is None:
        pt = n // kf
    if kf * pt != n:
        raise ValueError(f"mesh {kf}x{pt} != {n} ranks")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (kf, pt), mesh_dim_names=(KF_AXIS, PT_AXIS))


def coordinate(mesh: DeviceMesh) -> tuple[int, int]:
    """This rank's (kf, pt) place in the mesh."""
    return mesh.get_local_rank(KF_AXIS), mesh.get_local_rank(PT_AXIS)


def check_backend(t: torch.Tensor, group) -> None:
    """Raise unless ``group``'s backend carries ``t``'s device: Gloo for
    CPU tensors, NCCL for CUDA tensors."""
    want = {"cpu": "gloo", "cuda": "nccl"}.get(t.device.type)
    backend = dist.get_backend(group)
    if want != backend:
        raise ValueError(f"a {t.device.type} tensor cannot ride a {backend} group "
                         "(CPU tensors take Gloo, CUDA tensors NCCL)")


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` all-reduced over ``group``, in place; returns it."""
    check_backend(t, group)
    dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` of ``group``, concatenated along ``dim`` in the
    group's rank order (along a mesh axis: its coordinate order)."""
    check_backend(t, group)
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def _rows(n: int, parts: int, index: int, what: str) -> slice:
    if n % parts:
        raise ValueError(f"{n} {what} do not split evenly over {parts} ranks")
    size = n // parts
    return slice(index * size, (index + 1) * size)


def keyframe_rows(mesh: DeviceMesh, k: int) -> slice:
    """This rank's contiguous slice of ``k`` keyframes (``kf`` axis)."""
    return _rows(k, mesh.size(0), coordinate(mesh)[0], "keyframes")


def point_rows(mesh: DeviceMesh, n: int) -> slice:
    """This rank's contiguous slice of ``n`` points (``pt`` axis)."""
    return _rows(n, mesh.size(1), coordinate(mesh)[1], "points")


def shard_kf(mesh: DeviceMesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's keyframes of an array with a leading keyframe axis
    (images, masks, poses), replicated over ``pt``."""
    return x[keyframe_rows(mesh, x.shape[0])]


def shard_pt(mesh: DeviceMesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's points of an array with a leading point axis (the map),
    replicated over ``kf``."""
    return x[point_rows(mesh, x.shape[0])]


def shard_keyframes(mesh: DeviceMesh, kfs: NIDKeyframe,
                    split_points: bool = True) -> NIDKeyframe:
    """This rank's part of a full keyframe batch (JAX's ``P(kf, pt)`` for the
    points and ``P(kf)`` for the images, `nid_shard.py:98-107`): keyframes
    over ``kf``; with ``split_points`` each keyframe's points over ``pt``,
    else all of them (the per-keyframe solve's layout, `nid_shard.py:
    404-411`). Images, packed bin tiles and tap tables follow the
    keyframes and replicate over ``pt``."""
    rows = keyframe_rows(mesh, kfs.points.shape[0])
    pts = point_rows(mesh, kfs.points.shape[1]) if split_points else slice(None)

    def kf_only(a):
        return None if a is None else a[rows]

    return replace(
        kfs,
        points=kfs.points[rows, pts], intensity=kfs.intensity[rows, pts],
        valid=kfs.valid[rows, pts], bin_image=kfs.bin_image[rows],
        bin_tiles=kf_only(kfs.bin_tiles), tap_rows=kf_only(kfs.tap_rows),
        tap_slabs=kf_only(kfs.tap_slabs),
    )


def gather_kf(mesh: DeviceMesh, x: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`shard_kf`: every keyframe row, on every rank."""
    return all_gather(x, mesh.get_group(KF_AXIS), 0)


def gather_pt(mesh: DeviceMesh, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The inverse of :func:`shard_pt` (points along ``dim``): every point,
    on every rank."""
    return all_gather(x, mesh.get_group(PT_AXIS), dim)

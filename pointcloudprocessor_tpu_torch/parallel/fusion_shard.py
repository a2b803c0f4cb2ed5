"""Colorization fusion over the (kf, pt) mesh.

Port of `pointcloudprocessor_tpu/parallel/fusion_shard.py`. The work splits
both ways: each row of the mesh fuses only its keyframes, each column only
its slice of the map. Every rank runs the port's fuse on its shard
(``pipeline/colorize.fuse_state``: C1 on the card, its twin on the CPU),
then the top-K registers of the ``kf`` row all-gather and re-insert into one
register: the top K of a union is the top K of the concatenated per-shard
top Ks. The rest merges as JAX's does: the best-score label is the first
arg-max over the gathered best scores, the observation counts sum.

Each shard's z-buffer culls only the points it holds, as in the JAX
package (``observe_keyframe`` culls the points it is given,
`pipeline/colorize.py:87-115`): with ``pt`` > 1 an occluder held by another
column hides nothing, so the result can differ from the serial fuse.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..core import se3
from ..models import camera as cam
from ..ops import fusion
from ..pipeline import colorize
from . import mesh as mesh_lib


@torch.no_grad()
def fuse_sharded(
    camera: cam.PinholeCamera,
    points_world: torch.Tensor,  # (N/pt, 3): this rank's points
    valid: torch.Tensor,  # (N/pt,)
    images: torch.Tensor,  # (K/kf, H, W, 3) uint8: this rank's keyframes
    kf_poses: se3.SE3,  # (K/kf,) camera->world
    T_correction: se3.SE3,  # one correction, or this rank's (K/kf,) rows
    mesh: DeviceMesh,
    mask_images: Optional[torch.Tensor] = None,  # (K/kf, H, W) int32
    **kwargs,
) -> colorize.FusionResult:
    """``pipeline/colorize.fuse`` over the mesh (`fusion_shard.py:42-153`):
    the map's points over ``pt`` (:func:`mesh.shard_pt`), the keyframes,
    their poses and masks over ``kf`` (:func:`mesh.shard_kf`); keywords
    those of ``colorize.fuse``. Returns this rank's points' result, the same
    on every rank of a ``pt`` column (:func:`mesh.gather_pt` makes it
    whole). The registers' S x top_k rows re-insert in JAX's order,
    shard-major and slot-minor (`:106-117`), through ``fusion.update_topk``."""
    state = colorize.fuse_state(camera, points_world, valid, images, kf_poses, T_correction,
                                mask_images, **kwargs)
    kf = mesh.get_group(mesh_lib.KF_AXIS)
    scores = mesh_lib.all_gather(state.topk.scores, kf)  # (S * top_k, N/pt)
    rgb = mesh_lib.all_gather(state.topk.rgb, kf)
    top_k, n = state.topk.scores.shape
    merged = fusion.init_topk(n, points_world.device, top_k)
    for row, packed in zip(scores, rgb):
        merged = fusion.update_topk(merged, row, packed, torch.isfinite(row))
    blended, colored = fusion.blend_topk(merged)
    best_label = None
    if state.best_label is not None:
        best_s = mesh_lib.all_gather(state.best_score[None], kf)  # (S, N/pt)
        labels = mesh_lib.all_gather(state.best_label[None], kf)
        winner = torch.argmax(best_s, dim=0)  # the first maximum, as jnp.argmax
        best_label = torch.take_along_dim(labels, winner[None], dim=0)[0]
    count = mesh_lib.all_reduce(state.count, kf)
    return colorize.FusionResult(rgb=blended, colored=colored & valid, best_label=best_label,
                                 observation_count=count)

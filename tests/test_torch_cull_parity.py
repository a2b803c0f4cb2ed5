"""PyTorch port vs the JAX package: the culling step of the main path at
the reference scale (the bench scene of chip_smoke.py and
`tools/bench_scene.py`: a 1,000,000-point map seen by 4096x3000 keyframes),
without images.

The JAX runner's ``cull_keyframe_host`` and the port's
``zbuffer.cull_world_points`` see the same map and the same camera-to-world
pose. Tolerance class: bit-exact visibility masks, and so bit-exact
``linspace`` picks of the 262,144 points each runner keeps."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pointcloudprocessor_tpu.core import cloud as jcl
from pointcloudprocessor_tpu.core import se3 as jse3
from pointcloudprocessor_tpu.models import camera as jcam
from pointcloudprocessor_tpu.pipeline import runner as jrunner
from pointcloudprocessor_tpu.utils import config as jcfg
from pointcloudprocessor_tpu_torch.core import se3 as tse3
from pointcloudprocessor_tpu_torch.ops import zbuffer as tzb
from pointcloudprocessor_tpu_torch.tools import bench_scene as bs
from pointcloudprocessor_tpu_torch.utils import interop

CPU = "cpu"


@pytest.fixture(scope="module")
def scene():
    points, inten = bs.scene_map()
    _, odom = bs.scene_odometry()
    return points, inten, odom.q.numpy(), odom.t.numpy()


@pytest.mark.parametrize("kf", [0, bs.K - 1])
def test_full_scale_cull_masks_and_picks_bit_equal(scene, kf):
    points, inten, q, t = scene
    w, h = bs.WIDTH, bs.HEIGHT
    f_px = bs.focal(w)
    intrinsic = (f_px, f_px, w / 2.0, h / 2.0)
    cfg = jcfg.PipelineConfig()
    cj = jcam.create_camera("pinhole", intrinsic, (0.0,) * 5, w, h)
    ct = interop.camera(intrinsic, (0.0,) * 5, w, h, CPU)

    # JAX: the runner's own per-keyframe cull (pose normalized as _frame_pose does).
    cloud_j = jcl.make(points, inten)
    T_j = jse3.SE3(jse3.quat_normalize(jnp.asarray(q[kf])), jnp.asarray(t[kf]))
    vis_j, _ = jrunner.cull_keyframe_host(cj, cloud_j, T_j, cfg)

    # Port: what its runner's build_nid_keyframes calls.
    T_t = tse3.SE3(tse3.quat_normalize(torch.from_numpy(q[kf])), torch.from_numpy(t[kf]))
    _, mask = tzb.cull_world_points(
        ct, tse3.inverse(T_t), torch.from_numpy(points),
        torch.ones(len(points), dtype=torch.bool),
        downsample_factor=cfg.culling.downsample_factor,
        depth_epsilon=cfg.culling.depth_epsilon,
    )
    vis_t = torch.nonzero(mask, as_tuple=True)[0].numpy()

    np.testing.assert_array_equal(vis_t, vis_j)
    cap = bs.N_CULL
    assert len(vis_j) > cap  # the linspace pick runs at this scale
    pick = np.linspace(0, len(vis_j) - 1, cap).astype(np.int64)
    np.testing.assert_array_equal(vis_t[pick], vis_j[pick])

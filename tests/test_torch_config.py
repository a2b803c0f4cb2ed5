"""PyTorch port: config tree, import isolation, CLI, the newly ported
branches and the kernel build's failure mode."""

import dataclasses
import json
import os
import subprocess
import sys

import pytest

from pointcloudprocessor_tpu.utils import config as jcfg
from pointcloudprocessor_tpu_torch import cli
from pointcloudprocessor_tpu_torch.kernels import build as kbuild
from pointcloudprocessor_tpu_torch.pipeline import runner
from pointcloudprocessor_tpu_torch.utils import config as tcfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree(cls):
    """{field: default or nested tree} of a config dataclass."""
    out = {}
    for f in dataclasses.fields(cls):
        if f.default_factory is not dataclasses.MISSING:
            val = f.default_factory()
            out[f.name] = _tree(type(val)) if dataclasses.is_dataclass(val) else val
        else:
            out[f.name] = f.default
    return out


def test_config_tree_equals_jax():
    """One JSON config drives both packages: same fields, same defaults
    (exact equality, including every float)."""
    assert _tree(tcfg.PipelineConfig) == _tree(jcfg.PipelineConfig)
    assert set(tcfg._NESTED) == set(jcfg._NESTED)


def test_config_json_round_trip_across_packages():
    cfg = jcfg.PipelineConfig()
    cfg.nid.max_outer_iterations = 2
    cfg.camera.width = 640
    ported = tcfg.PipelineConfig.from_json(cfg.to_json())
    assert json.loads(ported.to_json()) == json.loads(cfg.to_json())


def test_port_imports_no_jax():
    """Importing the port's runner and CLI leaves jax and the JAX package
    out of sys.modules (a fresh interpreter: this test process has both)."""
    code = (
        "import sys\n"
        "import pointcloudprocessor_tpu_torch.pipeline.runner\n"
        "import pointcloudprocessor_tpu_torch.cli\n"
        "import pointcloudprocessor_tpu_torch.utils.interop\n"
        "import pointcloudprocessor_tpu_torch.opt.pose_graph\n"
        "import pointcloudprocessor_tpu_torch.ops.hpr\n"
        "import pointcloudprocessor_tpu_torch.ops.knn\n"
        "import pointcloudprocessor_tpu_torch.ops.voxel\n"
        "import pointcloudprocessor_tpu_torch.ops.mls\n"
        "import pointcloudprocessor_tpu_torch.ops.sor\n"
        "import pointcloudprocessor_tpu_torch.tools.bench_scene\n"
        "import pointcloudprocessor_tpu_torch.opt.pnp\n"
        "import pointcloudprocessor_tpu_torch.pipeline.manual_guess\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'pointcloudprocessor_tpu'\n"
        "       or m.startswith('pointcloudprocessor_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stdout + r.stderr


def test_cli_dump_config(capsys):
    assert cli.main(["--dump-config"]) == 0
    cfg = json.loads(capsys.readouterr().out)
    assert cfg["nid"]["bins"] == 16


def test_cli_missing_args():
    assert cli.main([]) == 2


def test_cli_device_defaults_to_cuda():
    assert cli.build_parser().parse_args([]).device == "cuda"


@pytest.mark.parametrize(
    "path, value",
    [
        ("enable_manual_guess", True),
        ("nid.frozen_partial_frac", 0.25),
        ("nid.frozen_margin", 1),
    ],
)
def test_unported_branches_raise(path, value):
    """The three branches that raised NotImplementedError until they were
    ported (the manual guess, the frozen-tap cache's partial refresh and
    wide window) pass the check now, with frozen taps on. What still
    raises, before any stage, is a margin no branch can run: outside 0..2
    the shared solve refuses it with ValueError (JAX asserts 1 <= m <= 2,
    `nid.py:154`)."""
    cfg = tcfg.PipelineConfig()
    cfg.nid.frozen_taps = True
    obj = cfg
    *parents, leaf = path.split(".")
    for p in parents:
        obj = getattr(obj, p)
    setattr(obj, leaf, value)
    runner.check_supported(cfg)
    cfg.nid.frozen_margin = 3
    with pytest.raises(ValueError, match="frozen_margin"):
        runner.check_supported(cfg)


@pytest.mark.parametrize(
    "options",
    [
        dict(per_keyframe=True),
        dict(per_keyframe=True, smooth_trajectory=True),
        dict(recull_every_outer_iter=True),
        dict(recull_every_outer_iter=True, per_keyframe=True, frozen_taps=True),
        dict(per_keyframe=True, frozen_partial_frac=0.25, frozen_margin=1),
    ],
    ids=["per_keyframe", "smoothed", "recull", "recull_per_keyframe", "cache_options_unread"],
)
def test_per_keyframe_and_recull_are_supported(options):
    """Per-keyframe refinement, the pose-graph smoother and re-culling run in
    the port (tests/test_torch_refine_per_keyframe.py,
    tests/test_torch_pose_graph.py, tests/test_torch_recull.py). The
    per-keyframe solve reads none of the cache options, as in the JAX
    runner, so even a margin outside 0..2 passes under it; the shared solve
    runs the options (tests/test_torch_wide_cache.py) and refuses that
    margin."""
    cfg = tcfg.PipelineConfig()
    for key, value in options.items():
        setattr(cfg.nid, key, value)
    runner.check_supported(cfg)
    if cfg.nid.frozen_partial_frac > 0:
        cfg.nid.frozen_taps = True
        cfg.nid.frozen_margin = 5
        runner.check_supported(cfg)
        cfg.nid.per_keyframe = False
        with pytest.raises(ValueError, match="frozen_margin"):
            runner.check_supported(cfg)
        cfg.nid.frozen_margin = 1
        runner.check_supported(cfg)


def test_default_config_is_supported():
    runner.check_supported(tcfg.PipelineConfig())


@pytest.mark.parametrize("upsampling", ["none", "sample_local_plane", "random_uniform_density",
                                        "voxel_grid_dilation"])
def test_enable_mls_is_supported(upsampling):
    """The MLS map stage runs in the port (tests/test_torch_mls.py,
    tests/test_torch_mls_pipeline.py), with each upsampling method; an
    unknown method raises before any stage runs."""
    cfg = tcfg.PipelineConfig(enable_mls=True)
    cfg.mls.upsampling = upsampling
    runner.check_supported(cfg)
    cfg.mls.upsampling = "poisson"
    with pytest.raises(ValueError, match="upsampling"):
        runner.check_supported(cfg)


@pytest.mark.parametrize("impl", ["auto", "grid", "dense"])
def test_hpr_and_local_smoothing_are_supported(impl):
    """HPR culling and local color smoothing run in the port
    (tests/test_torch_hpr.py, tests/test_torch_hpr_pipeline.py)."""
    cfg = tcfg.PipelineConfig()
    cfg.culling.method = "hpr"
    cfg.culling.hpr_impl = impl
    cfg.fusion.local_smoothing_radius = 0.05
    runner.check_supported(cfg)


def test_mask_path_is_supported():
    """The mask path runs in the port (tests/test_torch_masks.py)."""
    runner.check_supported(tcfg.PipelineConfig(mask_image_folder="masks/"))


def test_cuda_device_without_cuda_raises(monkeypatch, tmp_path):
    """No silent fallback to the CPU when the named device is missing."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runner.process(tcfg.PipelineConfig(output_path=str(tmp_path)), "cuda")


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A build that cannot run raises; it never falls back to the twin."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(kbuild, "BUILD_DIR", str(tmp_path / "_build"))
    real_isfile = os.path.isfile
    monkeypatch.setattr(
        kbuild.os.path, "isfile",
        lambda p: False if p.endswith("nvcc") else real_isfile(p),
    )
    with pytest.raises(RuntimeError, match="nvcc"):
        kbuild._compile("nid_hist")

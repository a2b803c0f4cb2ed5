"""pointcloudprocessor_tpu_torch — the PyTorch / CUDA port of
pointcloudprocessor_tpu, for one NVIDIA H100.

The JAX package `pointcloudprocessor_tpu` is the reference; this package
mirrors its layout and module names so each counterpart is easy to find,
and never imports jax or the JAX package. The kernels that the JAX package
wrote in Pallas for the TPU are hand-written CUDA C++ for Hopper here
(`csrc/`, built at first use by `kernels/build.py`); everything else is
plain torch.

Package layout:
    core/      SE(3)/quaternion math, SoA point-cloud container
    models/    pinhole + plumb_bob camera
    ops/       z-buffer, NID histogram kernels (K1/K2) + twins, fusion
    opt/       NID objective, BFGS, pose refinement
    pipeline/  ingest, keyframes, colorize + fuse, orchestration
    parallel/  the (kf, pt) mesh on torch.distributed: sharded NID, fuse, pose graph
    io/        PCD / odometry / image readers and writers (host side)
    utils/     config tree, profiling, numpy interop
    csrc/      CUDA sources;  kernels/  their build and ctypes binding
"""

__version__ = "0.1.0"

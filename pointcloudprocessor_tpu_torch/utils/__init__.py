"""Config tree, profiling, numeric helpers, numpy interop, colormaps,
console styling and headless visualization."""

from .config import (
    CameraConfig,
    CullingConfig,
    FusionConfig,
    KeyframeConfig,
    MLSConfig,
    NIDConfig,
    PipelineConfig,
)

__all__ = [
    "CameraConfig",
    "CullingConfig",
    "FusionConfig",
    "KeyframeConfig",
    "MLSConfig",
    "NIDConfig",
    "PipelineConfig",
]

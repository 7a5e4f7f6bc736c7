"""tpu-ray-tracer: a differentiable ray tracer in JAX for NVIDIA GPUs.

A from-scratch re-design of the capabilities of JaworWr/CUDA-ray-tracer
(implicit algebraic surfaces of degree <= 3, analytic root solving, Lambertian
shading with shadows and mirror reflections, YAML scenes): vectorized batched
math lowered by XLA, a fused Pallas kernel through Triton for the forward hot
path on the GPU, implicit-function-theorem custom VJPs for differentiability,
and ``shard_map`` pixel-grid sharding for multi-device scaling.
"""

from .models.loader import load_from_file, load_from_string
from .models.scene import Scene, build_scene
from .models.errors import SceneError
from .ops.camera import Camera
from .render.pipeline import (
    FAST_CONFIG,
    GOLDEN_CONFIG,
    RenderConfig,
    render_image,
    render_rays,
)

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "FAST_CONFIG",
    "GOLDEN_CONFIG",
    "RenderConfig",
    "Scene",
    "SceneError",
    "build_scene",
    "load_from_file",
    "load_from_string",
    "render_image",
    "render_rays",
]

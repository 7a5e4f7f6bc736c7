"""Scene model: a JAX pytree of stacked object/light tables.

The reference keeps a ``Scene`` of ``vector<Object>`` + ``vector<LightSource>``
plus image parameters (reference: include/scene.h:17-36). On an accelerator
the natural layout is struct-of-arrays: one ``[N, 20]`` coefficient matrix for all
objects, ``[N, 3]`` colors, ``[N]`` reflection ratios, and a struct-of-arrays
light table — replicated across devices while the pixel grid is sharded.

``Scene`` is a registered dataclass pytree: the array tables are leaves
(differentiable — this is what inverse rendering optimizes), while image
dimensions and ``max_reflections`` are static metadata that participate in
jit specialization (they set loop trip counts and output shapes).

The degree-0/1/2 split the reference performs at solve time via EPS branches
is data-driven here; geometry dtype is configurable (f64 golden path on CPU,
f32 fast path on the GPU).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from . import light as light_mod
from . import surface as surface_mod
from .errors import SceneError, validate_color, validate_positive

# Reference defaults (reference: src/scene.cpp:6-7). Note the reference's
# README claims a black default background but the code says white; the code
# wins for parity.
DEFAULT_MAX_REFLECTIONS = 5
DEFAULT_BG_COLOR = (1.0, 1.0, 1.0)


@dataclasses.dataclass(frozen=True)
class Object:
    """One object prior to stacking (reference: include/scene.h:8-15)."""

    surface: np.ndarray        # [20] f64 coefficient vector
    reflection_ratio: float
    color: np.ndarray          # [3] f32

    def __post_init__(self):
        validate_positive("object reflection ratio", self.reflection_ratio)
        validate_color(self.color)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Scene:
    """Stacked scene tables (pytree leaves) + static render parameters."""

    # --- data fields (pytree leaves) ---
    coefs: jax.Array             # [N, 20] surface coefficients
    colors: jax.Array            # [N, 3] object albedo
    reflection: jax.Array        # [N] reflection ratios
    light_p: jax.Array           # [L, 3] direction-to-light (unit) or position
    light_color: jax.Array       # [L, 3] intensity-premultiplied color
    light_is_spherical: jax.Array  # [L] bool mask
    bg_color: jax.Array          # [3] background color
    tan_half_fov: jax.Array      # scalar: tan(fov_rad / 2), precomputed as in
    #                              reference src/update-cpu.cpp:28
    # --- static fields (jit specialization) ---
    width: int = dataclasses.field(metadata=dict(static=True))
    height: int = dataclasses.field(metadata=dict(static=True))
    max_reflections: int = dataclasses.field(metadata=dict(static=True))

    @property
    def n_objects(self) -> int:
        return self.coefs.shape[0]

    @property
    def n_lights(self) -> int:
        return self.light_p.shape[0]

    @property
    def aspect_ratio(self) -> float:
        """width/height as double (reference: include/scene.h:32-33)."""
        return float(self.width) / float(self.height)

    def astype(self, geom_dtype, color_dtype=jnp.float32) -> "Scene":
        """Cast geometry tables (coefs, light positions) and color tables."""
        return dataclasses.replace(
            self,
            coefs=self.coefs.astype(geom_dtype),
            light_p=self.light_p.astype(geom_dtype),
            tan_half_fov=self.tan_half_fov.astype(geom_dtype),
            colors=self.colors.astype(color_dtype),
            reflection=self.reflection.astype(color_dtype),
            light_color=self.light_color.astype(color_dtype),
            bg_color=self.bg_color.astype(color_dtype),
        )

    def device_put(self, sharding=None) -> "Scene":
        """Transfer the scene tables to device (replicated when sharded)."""
        if sharding is None:
            return jax.device_put(self)
        return jax.device_put(self, sharding)


def build_scene(
    width: int,
    height: int,
    fov_deg: float,
    objects: Sequence[Object],
    lights: Sequence[light_mod.Light],
    max_reflections: int = DEFAULT_MAX_REFLECTIONS,
    bg_color=DEFAULT_BG_COLOR,
) -> Scene:
    """Assemble a ``Scene`` pytree from parsed objects/lights.

    Performs the constructor-time validation of the reference
    (reference: src/scene.cpp:9-22): color range checks and the
    degrees->radians fov conversion.
    """
    bg = np.asarray(bg_color, dtype=np.float32)
    validate_color(bg)
    if not objects:
        # The reference tolerates empty sequences; we keep shape [0, 20].
        coefs = np.zeros((0, surface_mod.N_COEFS), dtype=np.float64)
        obj_colors = np.zeros((0, 3), dtype=np.float32)
        refl = np.zeros((0,), dtype=np.float32)
    else:
        coefs = np.stack([np.asarray(o.surface, dtype=np.float64) for o in objects])
        obj_colors = np.stack([np.asarray(o.color, dtype=np.float32) for o in objects])
        refl = np.asarray([o.reflection_ratio for o in objects], dtype=np.float32)
    if not lights:
        light_p = np.zeros((0, 3), dtype=np.float64)
        light_color = np.zeros((0, 3), dtype=np.float32)
        light_sph = np.zeros((0,), dtype=bool)
    else:
        light_p = np.stack([l.p for l in lights])
        light_color = np.stack([l.color for l in lights])
        light_sph = np.asarray([l.is_spherical for l in lights], dtype=bool)

    fov_rad = math.radians(float(fov_deg))
    return Scene(
        coefs=coefs,
        colors=obj_colors,
        reflection=refl,
        light_p=light_p,
        light_color=light_color,
        light_is_spherical=light_sph,
        bg_color=bg,
        tan_half_fov=np.float64(math.tan(0.5 * fov_rad)),
        width=int(width),
        height=int(height),
        max_reflections=int(max_reflections),
    )


def static_bounce_count(scene: Scene) -> int:
    """Host-side specialization: trip count for the reflection chain.

    If no object is reflective (all ratios <= EPS, the loop-entry condition at
    reference src/update-cpu.cpp:97) the reflection scan is statically skipped;
    otherwise the chain runs ``scene.max_reflections`` traced bounces followed
    by the at-cap background blend (reference src/update-cpu.cpp:98-101).
    Requires concrete (non-traced) reflection values.
    """
    refl = np.asarray(scene.reflection)
    if refl.size == 0 or float(refl.max()) <= 1e-7:
        return 0
    return scene.max_reflections

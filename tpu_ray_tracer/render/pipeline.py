"""The render pipeline: trace -> shade -> reflect, vectorized over rays.

This is the XLA replacement for both reference backends — the serial CPU
loop (reference: src/update-cpu.cpp:45-119) and the per-pixel CUDA kernel
(reference: src/update-cuda.cu:65-158) are line-for-line parallel
implementations of the same per-pixel program; here that program is written
once over a flat ray batch and lowered by XLA. It is the gradient route on
every platform and the forward route on the CPU; the GPU forward is the
fused kernel in ``tpu_ray_tracer.render.pallas_backend`` (``render/route.py``).

Structure per ray (reference: update-cpu.cpp:82-119):

1. primary trace: nearest object with EPS <= t < MAX_T (first index wins
   ties, matching the reference's strict-< scan);
2. shading: per light, shadow ray from ``point + SHADOW_BIAS*normal``,
   occluded iff any object has EPS < t < max_t; sum unshadowed Lambertian
   contributions, clamp each channel to <= 1;
3. reflection chain with the reference's cumulative-ratio blend
   ``result = (1 - cur_ratio)*result + cur_ratio*new`` (update-cpu.cpp:97-117),
   realized as a masked unrolled loop: every lane advances in lockstep, with
   an active mask replacing ``break`` — same math as CUDA warp lockstep.

The early-exit `break` in the reference's shadow loop is replaced by a masked
``any`` over objects; visibility booleans are non-differentiable by
construction (comparisons), and the occlusion intersect is wrapped in
stop_gradient so the backward pass skips it entirely.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..models.scene import Scene, static_bounce_count
from ..ops import camera as camera_ops
from ..ops.constants import EPS, MAX_T, SHADOW_BIAS
from ..ops.intersect import intersect_all, occluder_mask, valid_hit_mask
from ..ops.poly import normal_vector
from ..ops.shading import reflect_ray, shadow_ray_dirs, surface_color


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render-path configuration (participates in jit specialization).

    geom_dtype: geometry precision. f64 = golden path (CPU parity oracle),
      f32 = fast path.
    polish_iters: Newton refinement steps for the f32 path (0 for f64).
    bounces: reflection-chain trip count; None derives it from the scene
      (0 when no object is reflective, else scene.max_reflections).
    chunk_px: rays per sequential chunk to bound [rays, lights, objects]
      intermediates; None renders in one shot.
    """

    geom_dtype: str = "float32"
    polish_iters: int = 2
    bounces: int | None = None
    chunk_px: int | None = 65536

    @property
    def dtype(self):
        return jnp.dtype(self.geom_dtype)


GOLDEN_CONFIG = RenderConfig(geom_dtype="float64", polish_iters=0, chunk_px=65536)
FAST_CONFIG = RenderConfig(geom_dtype="float32", polish_iters=3, chunk_px=None)


class TraceResult(NamedTuple):
    hit: jax.Array        # [...] bool
    idx: jax.Array        # [...] int32 (garbage where ~hit)
    point: jax.Array      # [..., 3]
    normal: jax.Array     # [..., 3]
    lit_color: jax.Array  # [..., 3] f32, shadow-tested + clamped


def trace_and_shade(scene: Scene, origin, dir, polish_iters: int) -> TraceResult:
    """Nearest-hit + lighting, the analogue of reference
    ``get_color_and_object`` (src/update-cpu.cpp:45-80)."""
    t_all = intersect_all(scene.coefs, origin, dir, polish_iters)   # [..., N]
    valid = valid_hit_mask(t_all)
    hit = jnp.any(valid, axis=-1)
    t_masked = jnp.where(valid, t_all, jnp.asarray(MAX_T, t_all.dtype))
    idx = jnp.argmin(t_masked, axis=-1).astype(jnp.int32)
    best_t = jnp.take_along_axis(t_all, idx[..., None].astype(jnp.int32), axis=-1)[..., 0]
    # Freeze miss lanes at t=0 so downstream math stays finite.
    best_t = jnp.where(hit, best_t, jnp.zeros_like(best_t))

    point = origin + best_t[..., None] * dir
    sel_coefs = scene.coefs[idx]                                     # [..., 20]
    normal = normal_vector(sel_coefs, point)
    obj_color = scene.colors[idx]                                    # [..., 3]

    # Shadows: occlusion is non-differentiable visibility; stop_gradient
    # prunes the (expensive) backward intersect entirely.
    shadow_origin = point + SHADOW_BIAS * normal
    sdir, max_t = shadow_ray_dirs(scene.light_p, scene.light_is_spherical, point)
    occ_t = intersect_all(
        jax.lax.stop_gradient(scene.coefs),
        jax.lax.stop_gradient(shadow_origin)[..., None, :],
        jax.lax.stop_gradient(sdir),
        polish_iters,
    )                                                                # [..., L, N]
    in_shadow = jnp.any(occluder_mask(occ_t, max_t[..., None]), axis=-1)

    contrib = surface_color(
        scene.light_p, scene.light_is_spherical, scene.light_color,
        point, normal, obj_color,
    )                                                                # [..., L, 3]
    lit = jnp.sum(jnp.where(in_shadow[..., None], 0.0, contrib), axis=-2)
    lit = jnp.minimum(jnp.float32(1.0), lit)
    return TraceResult(hit=hit, idx=idx, point=point, normal=normal, lit_color=lit)


def _blend(result, color, ratio):
    """Cumulative-ratio reflection blend (reference: update-cpu.cpp:96)."""
    r = ratio[..., None]
    return (1.0 - r) * result + r * color


def render_rays(scene: Scene, origin, dir, *, polish_iters: int, bounces: int):
    """Full per-ray pipeline -> [..., 3] f32 colors.

    `bounces` is the static number of *traced* reflection iterations
    (scene.max_reflections when any object is reflective, else 0); the
    reference's at-cap background blend (update-cpu.cpp:98-101) is applied
    after the unrolled loop.
    """
    if scene.n_objects == 0:
        # Every ray misses (legal input: the reference tolerates an empty
        # objects sequence, src/scene.cpp:169-170); argmin over a zero-size
        # object axis would fail, so short-circuit to the background —
        # differentiably w.r.t. bg_color, with zero cotangent to the
        # (empty) object tables and lights.
        bg = scene.bg_color.astype(jnp.float32)
        return jnp.broadcast_to(bg, origin.shape[:-1] + (3,))
    res = trace_and_shade(scene, origin, dir, polish_iters)
    bg = scene.bg_color.astype(jnp.float32)
    result = jnp.where(res.hit[..., None], res.lit_color, bg)
    if bounces == 0:
        return result

    refl = scene.reflection

    def bounce(state, _):
        result, ratio, active, idx, point, normal, cur_dir = state
        r = refl[idx]
        enter = active & (r > EPS)
        ratio = jnp.where(enter, ratio * r, ratio)

        new_dir = reflect_ray(cur_dir, normal)
        new_origin = point + SHADOW_BIAS * normal
        nxt = trace_and_shade(scene, new_origin, new_dir, polish_iters)

        bounce_color = jnp.where(nxt.hit[..., None], nxt.lit_color, bg)
        result = jnp.where(
            enter[..., None], _blend(result, bounce_color, ratio), result
        )

        advanced = enter & nxt.hit
        idx = jnp.where(advanced, nxt.idx, idx)
        point = jnp.where(advanced[..., None], nxt.point, point)
        normal = jnp.where(advanced[..., None], nxt.normal, normal)
        cur_dir = jnp.where(enter[..., None], new_dir, cur_dir)
        return (result, ratio, advanced, idx, point, normal, cur_dir), None

    # lax.scan (not Python unroll): the traced bounce body — two full
    # intersection passes — is compiled once regardless of max_reflections.
    init = (
        result,
        jnp.ones(res.hit.shape, dtype=jnp.float32),
        res.hit,
        res.idx,
        res.point,
        res.normal,
        dir,
    )
    (result, ratio, active, idx, *_rest), _ = jax.lax.scan(
        bounce, init, None, length=bounces
    )

    # At-cap blend: lanes still wanting to reflect absorb the background
    # (reference: update-cpu.cpp:98-101).
    r = refl[idx]
    enter = active & (r > EPS)
    result = jnp.where(enter[..., None], _blend(result, bg, ratio * r), result)
    return result


def resolve_bounces(scene: Scene, config: RenderConfig) -> int:
    if config.bounces is not None:
        return config.bounces
    return static_bounce_count(scene)


@partial(jax.jit, static_argnames=("config",))
def _render_image_jit(scene: Scene, camera: camera_ops.Camera, config: RenderConfig):
    dtype = config.dtype
    scene = scene.astype(dtype)
    camera = jax.tree.map(lambda x: jnp.asarray(x, dtype), camera)
    bounces = config.bounces if config.bounces is not None else 0

    rotation, eye = camera_ops.camera_frame(camera)
    dirs = camera_ops.pixel_directions(
        rotation, scene.width, scene.height, scene.aspect_ratio, scene.tan_half_fov
    )                                                            # [H, W, 3]
    height, width = scene.height, scene.width
    n_px = height * width
    flat_dirs = dirs.reshape(n_px, 3)

    def run(d):
        o = jnp.broadcast_to(eye, d.shape)
        return render_rays(scene, o, d, polish_iters=config.polish_iters,
                           bounces=bounces)

    chunk = config.chunk_px
    if chunk is None or chunk >= n_px:
        colors = run(flat_dirs)
    else:
        pad = (-n_px) % chunk
        padded = jnp.concatenate(
            [flat_dirs, jnp.ones((pad, 3), dtype=flat_dirs.dtype)], axis=0
        )
        chunked = padded.reshape(-1, chunk, 3)
        colors = jax.lax.map(run, chunked).reshape(-1, 3)[:n_px]
    return colors.reshape(height, width, 3)


def render_image(scene: Scene, camera: camera_ops.Camera | None = None,
                 config: RenderConfig = FAST_CONFIG):
    """Render the full frame -> [H, W, 3] f32, row 0 = bottom (GL convention).

    The analogue of one reference ``update()`` call (src/update-cpu.cpp:121-139),
    minus the GL upload: the framebuffer is returned as an array.
    """
    if camera is None:
        camera = camera_ops.Camera.initial(config.dtype)
    if config.bounces is None:
        # Specialize the reflection trip count on the concrete scene (host-side).
        config = dataclasses.replace(config, bounces=resolve_bounces(scene, config))
    return _render_image_jit(scene, camera, config)

"""Multi-chip pixel-grid sharding.

The reference's only parallelism is single-GPU SIMT (one CUDA thread per
pixel, 8x8 blocks — reference: src/update-cuda.cu:104-109, 162-163). The
multi-device scaling model (SURVEY.md §2.2):

* **Data parallel over pixels**: the image's row axis is sharded across a 1-D
  ``jax.sharding.Mesh`` axis ``"px"``; every device renders its row block.
  Rays are embarrassingly parallel and share only the (small) scene tables.
* **Scene replicated**: the object/light pytree is broadcast to all devices.
* **Collectives are tiny**: the only cross-device traffic is the gradient
  all-reduce of scene parameters in inverse rendering (a ``psum`` inserted
  by AD through ``shard_map``) and the optional framebuffer gather for
  host output. Forward rendering is collective-free.

Implementation uses ``shard_map`` (explicit per-device program — each device
computes its own camera rays from its axis index, so no full-image ray
buffer ever materializes) rather than relying on GSPMD propagation.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.scene import Scene
from ..ops import camera as camera_ops
from ..render.pipeline import RenderConfig, render_rays, resolve_bounces

AXIS = "px"


def make_mesh(devices=None) -> Mesh:
    """1-D device mesh over the pixel-row axis."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (AXIS,))


def padded_rows(height: int, n_devices: int) -> int:
    """Rows after padding so the row axis divides the mesh."""
    return -(-height // n_devices) * n_devices


def render_image_sharded(scene: Scene, camera: camera_ops.Camera, mesh: Mesh,
                         config: RenderConfig = RenderConfig(),
                         backend: str | None = None, interpret: bool = False):
    """Render with rows sharded over `mesh`; returns [H, W, 3] f32 laid out
    row-sharded (callers can ``jax.device_get`` for a host copy).

    Per-device program: compute this device's row block from its mesh axis
    index and render it locally. No collectives in the forward pass — the
    device kernel IS the parallel path, as in the reference's CUDA grid
    (src/update-cuda.cu:104-163).

    backend: None asks ``render/route.py`` for the forward route of the
    mesh's platform; "pallas" runs the fused kernel per device (``interpret``
    runs it in the Pallas interpreter, for tests on CPU meshes); "xla" runs
    the jnp pipeline.
    """
    if backend is None:
        from ..render.route import FORWARD, choose_route
        backend = choose_route(FORWARD,
                               platform=mesh.devices.flat[0].platform)
    if backend not in ("pallas", "xla"):
        raise ValueError(f"unknown backend {backend!r}")
    n_dev = mesh.shape[AXIS]
    height_padded = padded_rows(scene.height, n_dev)
    rows_local = height_padded // n_dev
    bounces = resolve_bounces(scene, config)
    dtype = config.dtype
    scene = scene.astype(dtype)
    camera = jax.tree.map(lambda x: jnp.asarray(x, dtype), camera)
    statics = None
    if backend == "pallas":
        # degree partition + light kinds need concrete scene tables:
        # host-side, shared by every device (static data compiled in)
        from ..render.pallas_backend import scene_statics
        statics = scene_statics(scene)

    # One compiled executable per (mesh, geometry, statics) class: building
    # jax.jit(shard_map(...)) per call would RETRACE AND RECOMPILE every
    # frame (and closing over the camera would bake it in as a constant,
    # defeating the cache for moving cameras — found via the weak-scaling
    # sanity test, r4).
    key = (mesh, backend, rows_local, height_padded, scene.width,
           scene.height, bounces, config.polish_iters, str(dtype),
           statics, interpret)
    fn = _SHARD_RENDER_CACHE.get(key)
    if fn is None:
        def device_program(scene_local: Scene, camera):
            idx = jax.lax.axis_index(AXIS)
            y0 = idx * rows_local
            if backend == "pallas":
                from ..render.pallas_backend import render_rows_pallas
                return render_rows_pallas(
                    scene_local, camera, y0, rows_local,
                    polish_iters=config.polish_iters, bounces=bounces,
                    statics=statics, interpret=interpret,
                )
            rotation, eye = camera_ops.camera_frame(camera)
            dirs = camera_ops.pixel_directions(
                rotation, scene_local.width, scene_local.height,
                scene_local.aspect_ratio, scene_local.tan_half_fov,
                y0=y0, rows=rows_local,
            )
            origin = jnp.broadcast_to(eye, dirs.shape)
            colors = render_rays(
                scene_local, origin, dirs,
                polish_iters=config.polish_iters, bounces=bounces,
            )
            return colors

        # check_vma=False: pallas_call output avals carry no varying-axis
        # info, so shard_map's vma checker cannot type them (same escape
        # hatch as the custom-vjp train step in diff/inverse.py).
        shard_fn = jax.shard_map(
            device_program,
            mesh=mesh,
            in_specs=(P(), P()),      # scene + camera replicated
            out_specs=P(AXIS),        # rows sharded
            check_vma=False,
        )
        # jit is mandatory: eager shard_map dispatches op-by-op over the mesh
        fn = jax.jit(shard_fn)
        if len(_SHARD_RENDER_CACHE) > 32:
            _SHARD_RENDER_CACHE.clear()
        _SHARD_RENDER_CACHE[key] = fn
    image = fn(scene, camera)
    return image[: scene.height]


_SHARD_RENDER_CACHE: dict = {}


def replicate(tree, mesh: Mesh):
    """Place a pytree replicated on every device of the mesh."""
    sharding = NamedSharding(mesh, P())
    return jax.device_put(tree, sharding)


def shard_rows(array, mesh: Mesh):
    """Place an array row-sharded across the mesh (axis 0)."""
    sharding = NamedSharding(mesh, P(AXIS))
    return jax.device_put(array, sharding)

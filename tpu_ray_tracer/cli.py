"""Command-line app shell.

The reference's shell is a GLFW window with a fly camera
(reference: src/ray-tracer.cpp:136-248). Accelerator hosts are headless, so
the shell becomes subcommands:

* ``render <scene.yml> [-o out.png] [--pose X Y Z YAW PITCH] [--size W H]``
  — one frame to a PNG/NPY, either backend.
* ``bench <scene.yml> [--frames N]`` — frame-time / FPS / Mrays/s report,
  printing the reference's ``FPS: ..., last render time: ... ms`` line.
* ``animate <scene.yml>`` — render a camera path (the offline analogue of
  fly-camera interaction), writing numbered PNGs.

Window size arguments exist for parity but only affect output scaling, as in
the reference (scene resolution is independent of window size,
reference: src/ray-tracer.cpp:160-169, 209-214).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _add_common(p):
    p.add_argument("scene", help="YAML scene description")
    p.add_argument("--backend", choices=["auto", "jax", "pallas", "numpy"],
                   default="auto",
                   help="renderer route (auto = chosen per pass and platform "
                        "by render/route.py; jax = XLA pipeline; pallas = "
                        "fused GPU kernel, forward only; numpy = f64 oracle)")
    p.add_argument("--size", nargs=2, type=int, metavar=("W", "H"), default=None,
                   help="override scene resolution")
    p.add_argument("--pose", nargs=5, type=float,
                   metavar=("X", "Y", "Z", "YAW", "PITCH"), default=None,
                   help="camera pose (default: reference initial pose)")


def _load(args):
    import dataclasses

    from . import load_from_file

    scene = load_from_file(args.scene)
    if args.size:
        scene = dataclasses.replace(scene, width=args.size[0], height=args.size[1])
    return scene


def _render(scene, args):
    from .render.route import FORWARD, KERNEL, NUMPY, choose_route

    route = choose_route(FORWARD, args.backend)
    if route == NUMPY:
        from .render.reference_cpu import render_image_np

        pose = args.pose or (0.0, 0.0, 0.0, 90.0, 0.0)
        return render_image_np(
            scene, position=pose[:3], yaw_deg=pose[3], pitch_deg=pose[4]
        )
    from . import FAST_CONFIG, render_image

    camera = _camera_from_pose(args.pose) if args.pose else None
    if route == KERNEL:
        from .render.pallas_backend import render_image_pallas

        return np.asarray(render_image_pallas(scene, camera))
    return np.asarray(render_image(scene, camera, FAST_CONFIG))


def cmd_render(args) -> int:
    from .models.errors import SceneError
    from .utils.io import write_npy, write_png

    try:
        scene = _load(args)
    except SceneError as exc:
        # reference error surface (src/ray-tracer.cpp:151-158)
        print(f"Error during scene loading\n{exc}", file=sys.stderr)
        return 1
    image = _render(scene, args)
    if getattr(args, "check", False):
        # device-error surface (the checkCudaErrors analog): report
        # non-finite pixels with indices and exit nonzero
        from .utils.guard import RenderCheckError, check_image

        try:
            check_image(image, context=args.scene)
        except RenderCheckError as exc:
            print(f"Render check failed\n{exc}", file=sys.stderr)
            return 1
    out = args.output or "render.png"
    if out.endswith(".npy"):
        write_npy(out, image)
    else:
        write_png(out, image)
    print(f"Wrote {out} ({scene.width}x{scene.height})")
    return 0


def cmd_bench(args) -> int:
    """Frame-time / Mrays/s report.

    N frames with distinct camera poses inside one jitted ``lax.map``,
    each frame reduced to a scalar and the result fetched: wall time / N.
    The reference's analogue is cudaEvent timing around the kernel
    (src/update-cuda.cu:178-189).
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    from . import Camera, FAST_CONFIG
    from .utils.timing import FrameTimer, mrays_per_s

    from .render.route import FORWARD, KERNEL, NUMPY, choose_route

    scene = _load(args)
    n_px = scene.width * scene.height
    backend = choose_route(FORWARD, args.backend)

    if backend == NUMPY:
        # the reference's serial-CPU-backend analogue: honest wall timing
        from .render.reference_cpu import render_image_np

        timer = FrameTimer()
        times = []
        for i in range(args.frames):
            t0 = time.perf_counter()
            render_image_np(scene, yaw_deg=90.0 + 1e-3 * i)
            dt = time.perf_counter() - t0
            times.append(dt)
            timer.frame(dt * 1e3)
        best = min(times)
        print(f"backend numpy | frame best {best*1e3:.3f} ms mean "
              f"{sum(times)/len(times)*1e3:.3f} ms | "
              f"{mrays_per_s(n_px, best):.1f} Mrays/s (primary)")
        return 0

    scene32 = jax.tree.map(jnp.asarray, scene.astype(jnp.float32))

    def cam(yaw):
        return Camera(
            position=jnp.zeros(3, jnp.float32),
            yaw_deg=jnp.asarray(yaw, jnp.float32),
            pitch_deg=jnp.asarray(0.0, jnp.float32),
        )

    if backend == KERNEL:
        from .render.pallas_backend import _render_pallas_raw
        from .render.pipeline import resolve_bounces

        bounces = resolve_bounces(scene, FAST_CONFIG)
        render = lambda y: _render_pallas_raw(scene32, cam(y), 3, bounces)
    else:
        from .render.pipeline import RenderConfig, _render_image_jit

        config = RenderConfig(geom_dtype="float32", polish_iters=3,
                              chunk_px=None)
        render = lambda y: _render_image_jit(scene32, cam(y), config)

    yaws = 90.0 + 1e-3 * jnp.arange(args.frames, dtype=jnp.float32)

    @jax.jit
    def frames_fn(yaws):
        return jax.lax.map(lambda y: jnp.sum(render(y)), yaws)

    t0 = time.perf_counter()
    np.asarray(frames_fn(yaws))  # compile + warm (fetch forces execution)
    compile_s = time.perf_counter() - t0

    profile_ctx = None
    if args.profile:
        profile_ctx = jax.profiler.trace(args.profile)
        profile_ctx.__enter__()

    t0 = time.perf_counter()
    np.asarray(frames_fn(yaws))
    frame_s = (time.perf_counter() - t0) / args.frames

    if profile_ctx is not None:
        profile_ctx.__exit__(None, None, None)
        print(f"profiler trace written to {args.profile}")

    # the reference's FPS line (src/ray-tracer.cpp:239), from the measured
    # per-frame time
    print(f"FPS: {1.0 / frame_s:.4f}, last render time: {frame_s * 1e3:.4f} ms")
    print(
        f"backend {backend} | compile {compile_s:.1f} s | frame "
        f"{frame_s*1e3:.3f} ms over {args.frames} in-jit frames | "
        f"{mrays_per_s(n_px, frame_s):.1f} Mrays/s (primary)"
    )
    return 0


def cmd_fit(args) -> int:
    """Inverse rendering: recover perturbed scene parameters from a target
    image by gradient descent (BASELINE.json config; no reference analog)."""
    import jax
    import numpy as np

    from .diff.inverse import InverseProblem, fit
    from .parallel.sharding import make_mesh, render_image_sharded
    from .render.pipeline import RenderConfig
    from .render.route import GRADIENT, choose_route

    # fit differentiates the render: only the XLA route has a backward, so
    # --backend numpy and --backend pallas are refused here
    choose_route(GRADIENT, args.backend)
    scene = _load(args)
    config = RenderConfig(geom_dtype="float32", polish_iters=2, chunk_px=None)
    if args.distributed:
        # multi-process job: bring up jax.distributed (coordinator/process
        # info from the environment) and span the mesh over every device in
        # the job; the gradient psum then crosses processes.
        from .parallel.multihost import global_pixel_mesh, initialize_distributed

        initialize_distributed()
        mesh = global_pixel_mesh()
    else:
        mesh = make_mesh()

    # --pose sets the camera the self-recovery target is rendered at (and
    # the fixed render camera for scene-parameter fits); default is the
    # reference initial pose
    true_cam = _camera_from_pose(args.pose) if args.pose else _default_camera()
    if args.target:
        target = np.load(args.target)
    else:
        # self-recovery: target = render of the unperturbed scene
        target = render_image_sharded(scene, true_cam, mesh, config)

    fields = args.params.split(",")
    perturbed = _perturb_scene(scene, fields, args.perturb)
    camera = true_cam
    if "camera" in fields and not args.target:
        # SELF-recovery pose fit: start from a perturbed pose; the target
        # above was rendered at ``true_cam``, which descent must recover.
        # With an external --target the true pose is unknown and --pose IS
        # the user's initial guess — start exactly there, unperturbed.
        camera = _perturbed_camera(true_cam, args.pose_perturb)
    problem = InverseProblem(
        scene_template=perturbed,
        config=config,
        param_fields=tuple(fields),
        learning_rate=args.lr,
        soft_tau=args.soft_tau,
    )
    log = print if jax.process_index() == 0 else (lambda *a, **k: None)
    params, losses = fit(
        problem, target, camera=camera, steps=args.steps, mesh=mesh,
        checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every,
        print_fn=log,
        tau_final=args.soft_tau_final,
    )
    log(f"loss: {losses[0]:.3e} -> {losses[-1]:.3e} over {len(losses)} steps")
    if "camera" in params:
        cam = params["camera"]
        pos = np.asarray(cam.position)
        if args.target:
            hint = ""
        else:
            tp = np.asarray(true_cam.position)
            hint = (f" (self-recovery truth: ({tp[0]:g}, {tp[1]:g}, {tp[2]:g}),"
                    f" {float(np.asarray(true_cam.yaw_deg)):g},"
                    f" {float(np.asarray(true_cam.pitch_deg)):g})")
        log(f"recovered pose: position ({pos[0]:.4f}, {pos[1]:.4f}, "
            f"{pos[2]:.4f}), yaw {float(np.asarray(cam.yaw_deg)):.3f} deg, "
            f"pitch {float(np.asarray(cam.pitch_deg)):.3f} deg{hint}")
    return 0


def _perturb_scene(scene, fields, factor):
    """Perturb exactly the scene fields being optimized (``--params``), so
    self-recovery descends on the parameters that actually differ from the
    target. ``coefs`` perturbs only the constant monomial column: a uniform
    scaling of all 20 coefficients leaves the zero set F = 0 unchanged, so
    it would be an unrecoverable (and invisible) perturbation."""
    import dataclasses

    import numpy as np

    updates = {}
    for field in fields:
        if field == "camera":
            continue  # pose perturbation is handled by _perturbed_camera
        value = np.asarray(getattr(scene, field))
        if field == "coefs":
            value = value.copy()
            value[:, 19] = value[:, 19] * factor
        else:
            value = value * factor
        updates[field] = value
    return dataclasses.replace(scene, **updates)


def _perturbed_camera(base, pose_perturb_deg: float):
    """Initial pose guess for camera recovery: ``base`` offset by
    ``pose_perturb_deg`` in yaw (half of it in pitch) and a proportional
    position shift — the self-recovery analogue of _perturb_scene."""
    import dataclasses

    import jax.numpy as jnp

    d = float(pose_perturb_deg)
    return dataclasses.replace(
        base,
        position=base.position + jnp.asarray(
            [0.02 * d, -0.02 * d, 0.01 * d], jnp.float32),
        yaw_deg=base.yaw_deg + d,
        pitch_deg=base.pitch_deg - 0.5 * d,
    )


def _default_camera():
    return _camera_from_pose((0.0, 0.0, 0.0, 90.0, 0.0))


def _camera_from_pose(pose):
    """(X, Y, Z, YAW, PITCH) — the --pose argument order — to a Camera."""
    import jax.numpy as jnp

    from . import Camera

    return Camera(
        position=jnp.asarray(pose[:3], jnp.float32),
        yaw_deg=jnp.asarray(pose[3], jnp.float32),
        pitch_deg=jnp.asarray(pose[4], jnp.float32),
    )


def cmd_view(args) -> int:
    """Interactive terminal viewer (the reference's GLFW window analogue).

    As in the reference, the render resolution is the SCENE resolution and
    the view (window) size only scales the display (src/ray-tracer.cpp:
    160-169, 209-214 — the texture is scene-sized regardless of window
    size). ``--size`` sets the terminal cell grid; ``--render-size``
    overrides the scene resolution itself (useful on CPU hosts where the
    full-resolution frame is slow, mirroring the reference's CPU backend).
    """
    import dataclasses

    import numpy as np

    from .utils.term_view import downsample_for_view, run_viewer

    scene = _load_scene_only(args)
    if args.render_size:
        scene = dataclasses.replace(
            scene, width=args.render_size[0], height=args.render_size[1])
    view_w = args.size[0] if args.size else 120
    view_h = args.size[1] if args.size else 72
    from .render.route import FORWARD, KERNEL, NUMPY, choose_route

    backend = choose_route(FORWARD, args.backend)

    if backend == NUMPY:
        from .render.reference_cpu import render_image_np

        def render_raw(camera):
            return render_image_np(
                scene,
                position=np.asarray(camera.position),
                yaw_deg=float(np.asarray(camera.yaw_deg)),
                pitch_deg=float(np.asarray(camera.pitch_deg)),
            )
    elif backend == KERNEL:
        from .render.pallas_backend import render_image_pallas

        def render_raw(camera):
            return np.asarray(render_image_pallas(scene, camera))
    else:
        from . import FAST_CONFIG, render_image

        def render_raw(camera):
            return np.asarray(render_image(scene, camera, FAST_CONFIG))

    def render_fn(camera):
        return downsample_for_view(render_raw(camera), view_w, view_h)

    run_viewer(render_fn, view_w, view_h, print_fn=None)
    return 0


def _load_scene_only(args):
    """Scene load without the --size resolution override (viewer: the view
    size must not change the render resolution)."""
    from . import load_from_file

    return load_from_file(args.scene)


def cmd_animate(args) -> int:
    from .utils.io import write_png

    scene = _load(args)
    for i in range(args.frames):
        yaw = 90.0 + args.yaw_rate * i
        frame_args = argparse.Namespace(**vars(args))
        frame_args.pose = [0.0, 0.0, 0.0, yaw, 0.0]
        image = _render(scene, frame_args)
        path = f"{args.prefix}{i:04d}.png"
        write_png(path, image)
        print(f"Wrote {path}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="tpu-ray-tracer",
        description="differentiable ray tracer for algebraic surfaces",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("render", help="render one frame to an image file")
    _add_common(p)
    p.add_argument("-o", "--output", default=None, help="output file (.png/.npy)")
    p.add_argument("--check", action="store_true",
                   help="fail with pixel indices if the render produces "
                        "non-finite values (device-error surface)")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("bench", help="benchmark frame time / Mrays/s")
    _add_common(p)
    p.add_argument("--frames", type=int, default=10)
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a jax.profiler trace of the timed frames")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("fit", help="inverse rendering: recover scene params")
    _add_common(p)
    p.add_argument("--target", default=None, help=".npy target image (default: self)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=5e-2)
    p.add_argument("--perturb", type=float, default=0.6,
                   help="light-intensity perturbation factor to recover from")
    p.add_argument("--params", default="light_color",
                   help="comma-separated scene fields to optimize; the "
                        "pseudo-field 'camera' optimizes the camera pose "
                        "(position/yaw/pitch) itself")
    p.add_argument("--pose-perturb", type=float, default=3.0,
                   help="initial pose offset in degrees for --params camera "
                        "self-recovery (plus a proportional position shift)")
    p.add_argument("--checkpoint", default=None, help="checkpoint .npz path")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--distributed", action="store_true",
                   help="multi-process job: initialize jax.distributed from "
                        "the environment and shard over every device in the "
                        "job")
    p.add_argument("--soft-tau", type=float, default=None,
                   help="soft-visibility temperature for surface-coefficient "
                        "recovery across silhouette discontinuities "
                        "(e.g. 0.15); default: hard render")
    p.add_argument("--soft-tau-final", type=float, default=None,
                   help="continuation: anneal the temperature geometrically "
                        "from --soft-tau down to this value (e.g. 1e-3) so "
                        "the run finishes on the hard-render limit")
    p.set_defaults(fn=cmd_fit)

    p = sub.add_parser("view", help="interactive terminal viewer (fly camera)")
    _add_common(p)
    p.add_argument("--render-size", nargs=2, type=int, metavar=("W", "H"),
                   default=None,
                   help="override the scene's render resolution (the view "
                        "--size only scales the display, as in the "
                        "reference)")
    p.set_defaults(fn=cmd_view)

    p = sub.add_parser("animate", help="render a yaw-sweep camera path")
    _add_common(p)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--yaw-rate", type=float, default=2.0, help="deg per frame")
    p.add_argument("--prefix", default="frame_")
    p.set_defaults(fn=cmd_animate)

    args = parser.parse_args(argv)
    from .render.route import RouteError
    from .utils.cache import configure_compile_cache

    configure_compile_cache()
    try:
        return args.fn(args)
    except RouteError as exc:
        print(f"{args.command}: {exc}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    raise SystemExit(main())

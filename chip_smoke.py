"""Smoke test of the whole system on one GPU: the quickest proof that it
still starts and renders correctly on the card.

    python3 chip_smoke.py               # one GPU: every phase below
    python3 chip_smoke.py --four-cards  # four GPUs: the sharded path only

One process drives the card. With no arguments it:

1. compiles the forward of every bundled scene at full resolution on both
   GPU routes (the fused Triton kernel and the XLA pipeline) and the
   gradient functions, in threads, so compilation overlaps;
2. checks image parity of both routes against the f64 goldens
   (bench_goldens/*.npz) under bench.py's PARITY_GATES, and the kernel
   against XLA under the larger of the two gates;
3. checks gradients of mean(img^2) w.r.t. coefficients, colours,
   reflection ratios, lights and camera on dingdong and reflection_test:
   the card against the CPU backend at 320x180 (relative L2 <= 1e-3 per
   group under "highest" matmul precision, geometry in float64), and
   finite and non-zero at full resolution in float32. The comparison runs
   in float64 because dingdong's float32 coefficient and camera gradients
   move by tens of percent when an input moves by one ulp (PERF.md), so a
   float32 comparison would gate on noise;
4. runs ``fit scenes/clebsch.yml --params light_color`` for 5 steps (the
   loss must fall), ``render`` of dingdong and ``bench`` of dingdong at 32
   frames through the CLI's ``main``;
5. prints ``memory_analysis()`` of the 20spheres forward on both routes;
6. times both forward routes on dingdong, 20spheres and reflection_test
   (median of 5 windows of 32 frames) and the XLA forward+backward on
   dingdong;
7. runs the ``gpu``-marked tests.

``--four-cards`` runs only the row-sharded render on a 4-GPU mesh against a
single-device image (max abs <= 1e-6) and one sharded train step against the
same step on one card (loss relative <= 1e-5, gradients relative L2 <= 1e-5).

It exits nonzero, with no result line, when JAX finds no GPU or any phase
fails. The last line of a passing run is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out")
SCENES = ("dingdong", "20spheres", "reflection_test", "quadratic", "cayley",
          "clebsch", "cubic", "monkey_saddle")
TIMED = ("dingdong", "20spheres", "reflection_test")
GRAD_SCENES = ("dingdong", "reflection_test")
T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def bad_px(a, b) -> float:
    """Fraction of pixels whose max channel error exceeds 2/255."""
    import numpy as np

    return float((np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
                  .max(-1) > 2.0 / 255.0).mean())


def rel_l2(a, b) -> float:
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def camera(yaw=90.0, dtype="float32"):
    import jax.numpy as jnp

    from tpu_ray_tracer import Camera

    return Camera(position=jnp.zeros(3, dtype),
                  yaw_deg=jnp.asarray(yaw, dtype),
                  pitch_deg=jnp.asarray(0.0, dtype))


def load(name, size=None, dtype="float32"):
    import jax
    import jax.numpy as jnp

    import tpu_ray_tracer as trt

    scene = trt.load_from_file(os.path.join(REPO, "scenes", name + ".yml"))
    if size is not None:
        scene = dataclasses.replace(scene, width=size[0], height=size[1])
    return jax.tree.map(jnp.asarray, scene.astype(jnp.dtype(dtype)))


def forward_fns(scene):
    """(kernel, xla) jitted forwards of ``scene`` taking a camera."""
    import jax

    from tpu_ray_tracer.render import pallas_backend as pb
    from tpu_ray_tracer.render.pipeline import (FAST_CONFIG, _render_image_jit,
                                                resolve_bounces)

    bounces = resolve_bounces(scene, FAST_CONFIG)
    perm, n_cubic, kinds, posdef = pb.scene_statics(scene)
    config = dataclasses.replace(FAST_CONFIG, bounces=bounces)
    kernel = jax.jit(lambda s, c: pb._render_pallas_jit(
        s, c, FAST_CONFIG.polish_iters, bounces, n_cubic, perm, kinds,
        posdef))
    xla = jax.jit(lambda s, c: _render_image_jit(s, c, config))
    return kernel, xla


def grad_fn(scene):
    """jitted gradient of mean(img^2) through the gradient route w.r.t.
    every differentiable group, traced under "highest" matmul precision,
    with the geometry in the scene's dtype."""
    import jax
    import jax.numpy as jnp

    from tpu_ray_tracer.render.pipeline import (FAST_CONFIG, render_image,
                                                resolve_bounces)
    from tpu_ray_tracer.render.route import GRADIENT, XLA, choose_route

    assert choose_route(GRADIENT) == XLA
    dtype = scene.coefs.dtype.name
    config = dataclasses.replace(FAST_CONFIG, geom_dtype=dtype,
                                 bounces=resolve_bounces(scene, FAST_CONFIG))

    def loss(params):
        with jax.default_matmul_precision("highest"):
            s = dataclasses.replace(
                scene, coefs=params["coefs"], colors=params["colors"],
                reflection=params["reflection"], light_p=params["light_p"],
                light_color=params["light_color"])
            img = render_image(s, params["camera"], config)
            return jnp.mean(img * img)

    params = {"coefs": scene.coefs, "colors": scene.colors,
              "reflection": scene.reflection, "light_p": scene.light_p,
              "light_color": scene.light_color, "camera": camera(dtype=dtype)}
    return jax.jit(jax.grad(loss)), params


def golden(name):
    """The committed f64 NumPy golden of ``name`` at full resolution."""
    import numpy as np

    path = os.path.join(REPO, "bench_goldens", name + ".npz")
    return np.load(path)["image"].astype(np.float32)


def compile_all(jobs, x64=()):
    """AOT-compile ``{key: (jitted, args)}`` in threads -> {key: compiled}.
    XLA compiles outside the interpreter lock, so the jobs overlap. Keys in
    ``x64`` are traced with 64-bit types on (a per-thread setting)."""
    import jax

    def one(item):
        key, (fn, args) = item
        t = time.perf_counter()
        with jax.enable_x64(key in x64):
            compiled = fn.lower(*args).compile()
        return key, compiled, time.perf_counter() - t

    out = {}
    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as pool:
        for key, compiled, secs in pool.map(one, jobs.items()):
            log(f"compiled {key} in {secs:.1f}s")
            out[key] = compiled
    return out


def run_cli(argv):
    """``cli.main(argv)`` in this process; returns (rc, captured stdout)."""
    from tpu_ray_tracer.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    text = buf.getvalue()
    for line in text.strip().splitlines()[-4:]:
        log(f"  | {line}")
    return rc, text


class Smoke:
    def __init__(self):
        self.failed = []

    def phase(self, name, fn):
        log(f"=== {name}")
        try:
            ok = fn()
        except Exception:  # a phase that raises fails; the rest still run
            traceback.print_exc(file=sys.stdout)
            ok = False
        log(f"=== {name}: {'PASS' if ok else 'FAIL'}")
        if not ok:
            self.failed.append(name)
        return ok


def single_card(smoke: Smoke):
    import jax
    import numpy as np

    from bench import PARITY_GATES
    from tpu_ray_tracer.utils.timing import time_frames

    scenes = {name: load(name) for name in SCENES}
    fns = {name: forward_fns(s) for name, s in scenes.items()}
    cam0 = camera()
    cpu = jax.devices("cpu")[0]
    jobs = {}
    for name, (kernel, xla) in fns.items():
        jobs[(name, "pallas")] = (kernel, (scenes[name], cam0))
        jobs[(name, "xla")] = (xla, (scenes[name], cam0))
    grads = {}
    for name in GRAD_SCENES:
        grads[(name, "full")] = grad_fn(load(name))
        with jax.enable_x64(True):
            fn, params = grad_fn(load(name, (320, 180), "float64"))
            grads[(name, "card")] = (fn, params)
            grads[(name, "cpu")] = (fn, jax.device_put(params, cpu))
    for key, (fn, params) in grads.items():
        jobs[key + ("grad",)] = (fn, (params,))
    x64 = {key + ("grad",) for key in grads if key[1] != "full"}
    compiled = {}

    def do_compile():
        compiled.update(compile_all(jobs, x64))
        return True

    if not smoke.phase("compile", do_compile):
        return

    def parity():
        ok = True
        for name in SCENES:
            gold = golden(name)
            imgs = {}
            for route in ("pallas", "xla"):
                img = np.asarray(compiled[(name, route)](scenes[name], cam0))
                imgs[route] = img
                frac = bad_px(img, gold)
                gate = PARITY_GATES[route][name]
                good = (img.shape == gold.shape and np.isfinite(img).all()
                        and frac <= gate)
                ok &= good
                log(f"parity {name:16s} {route:6s} bad-px {frac:.6f} "
                    f"gate {gate} {'ok' if good else 'FAIL'}")
            frac = bad_px(imgs["pallas"], imgs["xla"])
            gate = max(PARITY_GATES["pallas"][name], PARITY_GATES["xla"][name])
            good = frac <= gate
            ok &= good
            log(f"parity {name:16s} kernel-vs-xla bad-px {frac:.6f} "
                f"gate {gate} {'ok' if good else 'FAIL'}")
        return ok

    def gradients():
        ok = True
        for name in GRAD_SCENES:
            with jax.enable_x64(True):
                gpu_small, cpu_small = (
                    jax.device_get(compiled[(name, at, "grad")](
                        grads[(name, at)][1])) for at in ("card", "cpu"))
            full = compiled[(name, "full", "grad")](grads[(name, "full")][1])
            reflective = float(np.asarray(load(name).reflection).max()) > 1e-7
            for group in gpu_small:
                a = jax.tree.leaves(gpu_small[group])
                b = jax.tree.leaves(cpu_small[group])
                f = jax.tree.leaves(full[group])
                err = rel_l2(np.concatenate([np.ravel(x) for x in a]),
                             np.concatenate([np.ravel(x) for x in b]))
                finite = all(np.isfinite(np.asarray(x)).all() for x in f)
                norm = float(sum(np.abs(np.asarray(x)).sum() for x in f))
                # a scene without a reflection chain has no reflection
                # gradient by construction
                needs_signal = group != "reflection" or reflective
                good = (err <= 1e-3 and finite
                        and (norm > 0 or not needs_signal))
                ok &= good
                log(f"grad {name:16s} {group:12s} card-vs-cpu f64 rel-L2 "
                    f"{err:.2e} (<= 1e-3), full-res f32 |g|_1 {norm:.3e} "
                    f"finite {finite} {'ok' if good else 'FAIL'}")
        return ok

    def fit():
        rc, out = run_cli(["fit", os.path.join(REPO, "scenes", "clebsch.yml"),
                           "--params", "light_color", "--steps", "5"])
        m = re.search(r"loss: (\S+) -> (\S+) over 5 steps", out)
        return rc == 0 and m is not None and float(m[2]) < float(m[1])

    def render_and_bench():
        os.makedirs(OUT_DIR, exist_ok=True)
        out = os.path.join(OUT_DIR, "render_dingdong.png")
        rc, _ = run_cli(["render", os.path.join(REPO, "scenes", "dingdong.yml"),
                         "-o", out, "--check"])
        rc2, text = run_cli(["bench", os.path.join(REPO, "scenes",
                                                   "dingdong.yml"),
                             "--frames", "32"])
        return rc == 0 and os.path.exists(out) and rc2 == 0 and "FPS" in text

    def memory():
        for route in ("pallas", "xla"):
            log(f"memory 20spheres forward {route}: "
                f"{compiled[('20spheres', route)].memory_analysis()}")
        return True

    def timings():
        cams = [camera(90.0 + 0.05 * i) for i in range(32)]
        for name in TIMED:
            for route in ("pallas", "xla"):
                fn = compiled[(name, route)]
                med, windows = time_frames(
                    lambda c, fn=fn, s=scenes[name]: fn(s, c), cams)
                log(f"time {name:16s} forward {route:6s} median "
                    f"{med * 1e3:.4f} ms/frame; windows "
                    f"{[round(w * 1e3, 4) for w in windows]}")
        params = grads[("dingdong", "full")][1]
        step = compiled[("dingdong", "full", "grad")]
        med, windows = time_frames(
            lambda c: step(dict(params, camera=c)), cams)
        log(f"time dingdong         forward+backward xla median "
            f"{med * 1e3:.4f} ms/frame; windows "
            f"{[round(w * 1e3, 4) for w in windows]}")
        return True

    def gpu_tests():
        import pytest

        rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                          os.path.join(REPO, "tests", "test_pallas.py")])
        return rc == 0

    smoke.phase("parity", parity)
    smoke.phase("gradients", gradients)
    smoke.phase("fit", fit)
    smoke.phase("render and bench", render_and_bench)
    smoke.phase("memory", memory)
    smoke.phase("timings", timings)
    smoke.phase("gpu tests", gpu_tests)


def four_cards(smoke: Smoke, scene_name="dingdong", fit_name="clebsch",
               size=None):
    """Row-sharded render and one sharded train step on a 4-device mesh,
    each against the same work on one device."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tpu_ray_tracer.diff.inverse import (InverseProblem, extract_params,
                                             make_loss_fn, make_train_step,
                                             pad_target)
    from tpu_ray_tracer.parallel.sharding import make_mesh, render_image_sharded
    from tpu_ray_tracer.render.pipeline import RenderConfig

    devices = jax.devices()
    if len(devices) < 4:
        log(f"--four-cards needs 4 devices, found {len(devices)}")
        smoke.failed.append("devices")
        return
    mesh4, mesh1 = make_mesh(devices[:4]), make_mesh(devices[:1])
    config = RenderConfig(geom_dtype="float32", polish_iters=3, chunk_px=None)

    def render():
        scene = load(scene_name, size)
        one = np.asarray(render_image_sharded(scene, camera(), mesh1, config))
        four = np.asarray(render_image_sharded(scene, camera(), mesh4, config))
        err = float(np.abs(one - four).max())
        log(f"sharded render {scene_name} {four.shape} on 4 devices vs 1: "
            f"max abs {err:.3e} (<= 1e-6)")
        return one.shape == four.shape and err <= 1e-6

    def train_step():
        scene = load(fit_name, size)
        fit_config = RenderConfig(geom_dtype="float32", polish_iters=2,
                                  chunk_px=None)
        # host copies: each mesh places them itself
        target = np.asarray(
            render_image_sharded(scene, camera(), mesh1, fit_config))
        perturbed = dataclasses.replace(scene,
                                        light_color=scene.light_color * 0.6)
        problem = InverseProblem(scene_template=perturbed, config=fit_config,
                                 param_fields=("light_color",),
                                 learning_rate=5e-2)
        params = jax.tree.map(np.asarray,
                              extract_params(perturbed, ("light_color",)))
        jobs, inputs = {}, {}
        for n, mesh in (("1", mesh1), ("4", mesh4)):
            tgt = pad_target(jnp.asarray(target), mesh, scene.height)
            opt_state = problem.optimizer().init(params)
            inputs[n] = ((params, camera(), tgt),
                         (params, opt_state, camera(), tgt))
            jobs[(n, "grad")] = (
                jax.jit(jax.value_and_grad(make_loss_fn(problem, mesh))),
                inputs[n][0])
            jobs[(n, "step")] = (make_train_step(problem, mesh), inputs[n][1])
        compiled = compile_all(jobs)
        out = {}
        for n in ("1", "4"):
            loss, g = compiled[(n, "grad")](*inputs[n][0])
            new, _, step_loss = compiled[(n, "step")](*inputs[n][1])
            out[n] = (float(loss), np.asarray(g["light_color"]),
                      float(step_loss), np.asarray(new["light_color"]))
        loss_rel = abs(out["4"][0] - out["1"][0]) / abs(out["1"][0])
        grad_rel = rel_l2(out["4"][1], out["1"][1])
        step_rel = abs(out["4"][2] - out["1"][2]) / abs(out["1"][2])
        param_rel = rel_l2(out["4"][3], out["1"][3])
        log(f"sharded train step {fit_name} 4 devices vs 1: loss "
            f"{out['4'][0]:.6e} vs {out['1'][0]:.6e} rel {loss_rel:.2e} "
            f"(<= 1e-5); grad rel-L2 {grad_rel:.2e} (<= 1e-5); step loss rel "
            f"{step_rel:.2e}; updated params rel-L2 {param_rel:.2e}")
        return (loss_rel <= 1e-5 and grad_rel <= 1e-5 and step_rel <= 1e-5
                and np.abs(out["1"][1]).max() > 0)

    smoke.phase("four-card sharded render", render)
    smoke.phase("four-card sharded train step", train_step)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["--four-cards"]):
        print("usage: chip_smoke.py [--four-cards]", file=sys.stderr)
        return 2
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {dev.platform!r})",
              file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "tpu_ray_tracer")):
        print(f"chip_smoke: no tpu_ray_tracer package beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from tpu_ray_tracer.utils.cache import configure_compile_cache

    log(f"compile cache: {configure_compile_cache()}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    log(f"jax {jax.__version__}: {len(jax.devices())} x {dev.device_kind}")

    smoke = Smoke()
    if argv == ["--four-cards"]:
        four_cards(smoke)
    else:
        single_card(smoke)
    if smoke.failed:
        log(f"FAILED phases: {smoke.failed}")
        return 1
    log("all phases passed")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

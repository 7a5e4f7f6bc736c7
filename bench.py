"""Benchmark: forward Mrays/s on the reference's headline config, on a GPU.

Renders scenes/dingdong.yml (1280x720, 3 objects, 2 lights — the scene the
reference publishes ~25 ms / ~36.9 Mrays/s for its CUDA backend on,
BASELINE.md) through the forward route ``render/route.py`` picks for the
GPU and prints the headline JSON line. ``vs_baseline`` is the ratio to the
reference GPU's derived 36.9 Mrays/s. monkey_saddle (the reference's second
published datapoint, 28.2 Mrays/s), 20spheres (many lights x many objects),
the 5-bounce reflection scene and the rest of the corpus are measured as aux
figures, as is forward+backward throughput (gradients w.r.t. surface
coefficients and light colors through ``jax.grad`` of the XLA pipeline).

The bench prints a complete cumulative JSON line after EVERY stage,
headline scene first, so a run cut by a timeout still ends in the latest
complete result with the remaining stages under ``aux.pending``. Every line
names the device it ran on (platform, device kind, device count, and the
card's name and power limit from nvidia-smi). With no GPU the bench prints
no result and exits nonzero; a failed stage or parity gate also exits
nonzero.

Timing: N frames with distinct camera poses inside one jitted ``lax.map``,
each frame reduced to a scalar and the result fetched — wall time / N.

Parity is a GATE, not a report: each benched scene's full-resolution frame
is compared against the f64 NumPy golden oracle (bench_goldens/*.npz, see
tools/make_bench_goldens.py), and the process exits nonzero if any scene
exceeds its committed bad-pixel threshold.
"""

import json
import os
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
try:  # installed package (pip install -e . --no-build-isolation)
    import tpu_ray_tracer  # noqa: F401
except ImportError:  # fresh checkout without install: run from the repo
    sys.path.insert(0, REPO)

BASELINE_MRAYS = 36.864  # 921600 px / 25 ms (BASELINE.md, derived row 1)
BASELINE_MRAYS_MONKEY = 28.235  # 480000 px / 17 ms (BASELINE.md, derived row 2)

# Committed full-resolution parity gates per forward route: bad-pixel
# fraction (max channel error > 2/255 vs the f64 NumPy golden) per scene —
# all 8 bundled scenes. Each gate is ~2x the value measured at the
# reference pose on an NVIDIA H100 80GB HBM3 (power limit 400 W), floored
# at 1e-4 (~92 px at 720p) so a one-pixel wobble cannot flake the gate.
# Measured: kernel dingdong 0.001411, cayley 0.000327, 20spheres 1.46e-5,
# clebsch 6.3e-6, the rest 0; XLA dingdong 0.001717, cayley 0.003625,
# clebsch 2.29e-5, 20spheres 6.3e-6, the rest 0. A change that moves parity
# updates its gate in the same commit. Exceeding a gate exits nonzero.
# chip_smoke.py reads this table too; it compares the two routes with each
# other under the larger of their two gates.
PARITY_GATES = {
    "pallas": {
        "dingdong": 0.0029,
        "monkey_saddle": 1e-4,
        "20spheres": 1e-4,
        "reflection_test": 1e-4,
        "quadratic": 1e-4,
        "cayley": 7e-4,
        "clebsch": 1e-4,
        "cubic": 1e-4,
    },
    "xla": {
        "dingdong": 0.0035,
        "monkey_saddle": 1e-4,
        "20spheres": 1e-4,
        "reflection_test": 1e-4,
        "quadratic": 1e-4,
        "cayley": 0.0073,
        "clebsch": 1e-4,
        "cubic": 1e-4,
    },
}

FRAMES = 32
BUDGET_S = 1500.0

_T0 = time.perf_counter()
_STAGE = ["startup"]


def _elapsed():
    return time.perf_counter() - _T0


def _log(msg):
    print(f"[bench t={_elapsed():7.1f}s] {msg}", file=sys.stderr, flush=True)


def _heartbeat():
    while True:
        time.sleep(60.0)
        _log(f"heartbeat: stage={_STAGE[0]}")


def _load_golden(name, scene):
    """Committed f16 golden if present and matching, else live NumPy f64."""
    from tpu_ray_tracer.render.reference_cpu import render_image_np
    import numpy as np

    path = os.path.join(REPO, "bench_goldens", name + ".npz")
    if os.path.exists(path):
        golden = np.load(path)["image"].astype(np.float32)
        if golden.shape == (scene.height, scene.width, 3):
            return golden
        _log(f"golden {name}: committed shape {golden.shape} stale, recomputing")
    _log(f"golden {name}: computing live (NumPy f64)")
    return render_image_np(scene)


def _bench_fwd(name, scene, *, fwd_frames=FRAMES, bounces=0):
    """Forward throughput + parity frame for one scene, ONE compiled
    executable: lax.map over fwd_frames distinct poses (each reduced to a
    scalar) plus the parity frame at the reference pose, through the
    forward route ``render/route.py`` picks."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import tpu_ray_tracer as trt
    from tpu_ray_tracer.render.pipeline import RenderConfig, _render_image_jit
    from tpu_ray_tracer.render.route import FORWARD, KERNEL, choose_route

    n_px = scene.width * scene.height
    route = choose_route(FORWARD)
    scene32 = jax.tree.map(jnp.asarray, scene.astype(jnp.float32))
    config = RenderConfig(geom_dtype="float32", polish_iters=3,
                          bounces=bounces, chunk_px=None)

    def cam(yaw):
        return trt.Camera(
            position=jnp.zeros(3, jnp.float32),
            yaw_deg=jnp.asarray(yaw, jnp.float32),
            pitch_deg=jnp.asarray(0.0, jnp.float32),
        )

    if route == KERNEL:
        from tpu_ray_tracer.render.pallas_backend import _render_pallas_raw

        render = lambda s, c: _render_pallas_raw(s, c, config.polish_iters,
                                                 bounces)
    else:
        render = lambda s, c: _render_image_jit(s, c, config)

    yaws = 90.0 + 1e-3 * jnp.arange(fwd_frames, dtype=jnp.float32)

    @jax.jit
    def fwd_many(yaws):
        sums = jax.lax.map(lambda y: jnp.sum(render(scene32, cam(y))), yaws)
        parity = render(scene32, cam(90.0))  # reference pose, same kernel
        return sums, parity

    _STAGE[0] = f"{name}:fwd compile"
    _log(f"{name}: compiling fwd ({fwd_frames} frames + parity frame)")
    sums, image = fwd_many(yaws)
    image = np.asarray(image)  # fetch -> forces the warm run to execute
    np.asarray(sums)
    _STAGE[0] = f"{name}:fwd measure"
    t0 = time.perf_counter()
    np.asarray(fwd_many(yaws)[0])  # the executable runs whole
    # the executable renders fwd_frames map frames + 1 parity frame
    fwd_s = (time.perf_counter() - t0) / (fwd_frames + 1)
    _log(f"{name}: fwd {fwd_s*1e3:.3f} ms/frame ({n_px/fwd_s/1e6:.1f} Mrays/s)")

    _STAGE[0] = f"{name}:parity"
    golden = _load_golden(name, scene)
    err = np.abs(image - golden).max(axis=-1)
    bad_px_fraction = float((err > 2.0 / 255.0).mean())
    _log(f"{name}: parity bad-px fraction {bad_px_fraction:.6f}")

    return {
        "forward_route": route,
        "frame_ms_fwd": fwd_s * 1e3,
        "mrays_fwd": n_px / fwd_s / 1e6,
        "parity_bad_px_fraction": bad_px_fraction,
    }


def _bench_fwdbwd(name, scene, *, bounces=0):
    """Forward+backward throughput: per-frame grads of a scalar image loss
    w.r.t. surface coefficients + light colors, through ``jax.grad`` of the
    XLA pipeline (the gradient route of ``render/route.py``)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import tpu_ray_tracer as trt
    from tpu_ray_tracer.diff.inverse import apply_params, extract_params
    from tpu_ray_tracer.render.pipeline import RenderConfig, _render_image_jit
    from tpu_ray_tracer.render.route import GRADIENT, XLA, choose_route

    assert choose_route(GRADIENT) == XLA
    n_px = scene.width * scene.height
    scene32 = jax.tree.map(jnp.asarray, scene.astype(jnp.float32))
    config = RenderConfig(geom_dtype="float32", polish_iters=3,
                          bounces=bounces, chunk_px=None)

    def cam(yaw):
        return trt.Camera(
            position=jnp.zeros(3, jnp.float32),
            yaw_deg=jnp.asarray(yaw, jnp.float32),
            pitch_deg=jnp.asarray(0.0, jnp.float32),
        )

    render = lambda s, c: _render_image_jit(s, c, config)

    template = scene32
    params = extract_params(template)

    def loss_fn(params, yaw):
        s = apply_params(template, params)
        img = render(s, cam(yaw))
        return jnp.mean(img * img)

    @jax.jit
    def fwdbwd_many(params, yaws):
        def one(y):
            g = jax.grad(loss_fn)(params, y)
            return sum(jnp.sum(v) for v in g.values())
        return jax.lax.map(one, yaws)

    yaws_b = 90.0 + 1e-3 * jnp.arange(FRAMES, dtype=jnp.float32)
    _STAGE[0] = f"{name}:fwdbwd compile"
    _log(f"{name}: compiling fwd+bwd ({FRAMES} frames)")
    np.asarray(fwdbwd_many(params, yaws_b))  # compile + warm
    _STAGE[0] = f"{name}:fwdbwd measure"
    t0 = time.perf_counter()
    np.asarray(fwdbwd_many(params, yaws_b))
    fwdbwd_s = (time.perf_counter() - t0) / FRAMES
    _log(f"{name}: fwd+bwd {fwdbwd_s*1e3:.3f} ms/frame "
         f"({n_px/fwdbwd_s/1e6:.1f} Mrays/s)")
    return {
        "frame_ms_fwd_bwd": fwdbwd_s * 1e3,
        "mrays_fwd_bwd": n_px / fwdbwd_s / 1e6,
    }


def device_stamp() -> dict:
    """The device a result was measured on: JAX's view of it plus the
    card's name and power limit as nvidia-smi reports them."""
    import jax

    dev = jax.devices()[0]
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        card = "unavailable"
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices()), "card": card}


def _emit(results, pending, skipped, stamp):
    """Print one complete cumulative JSON line from whatever is measured so
    far. A reader keeps the LAST parseable line."""
    ding = results.get("dingdong", {})
    if "mrays_fwd" not in ding:
        return  # nothing headline-worthy yet
    aux = {
        "frame_ms_fwd_dingdong": round(ding["frame_ms_fwd"], 3),
    }
    # the reflective scene runs its full 5-bounce chain -> distinct key
    display = {"reflection_test": "reflection5b"}
    for key, r in results.items():
        name = display.get(key, key)
        if key != "dingdong" and "mrays_fwd" in r:
            aux[f"mrays_per_s_fwd_{name}"] = round(r["mrays_fwd"], 2)
        if "mrays_fwd_bwd" in r:
            aux[f"mrays_per_s_fwd_bwd_{name}"] = round(r["mrays_fwd_bwd"], 2)
    if "mrays_fwd_bwd" in ding:
        aux["frame_ms_fwd_bwd_dingdong"] = round(ding["frame_ms_fwd_bwd"], 3)
    monkey = results.get("monkey_saddle", {})
    if "mrays_fwd" in monkey:
        aux["monkey_saddle_vs_baseline"] = round(
            monkey["mrays_fwd"] / BASELINE_MRAYS_MONKEY, 3)
    spheres = results.get("20spheres", {})
    if "mrays_fwd" in spheres:
        aux["frame_ms_fwd_20spheres"] = round(spheres["frame_ms_fwd"], 3)
    aux["parity_bad_px_fraction"] = {
        k: round(v["parity_bad_px_fraction"], 6)
        for k, v in results.items() if "parity_bad_px_fraction" in v
    }
    failed = sorted(
        s for v in results.values() for s in v.get("failed_stages", ())
    )
    if failed:
        aux["failed"] = failed
    if pending:
        aux["pending"] = list(pending)
    if skipped:
        aux["skipped"] = list(skipped)
    aux["elapsed_s"] = round(_elapsed(), 1)
    aux["forward_route"] = ding.get("forward_route")
    print(json.dumps({
        "device": stamp,
        "metric": "mrays_per_s_fwd_dingdong_1280x720",
        "value": round(ding["mrays_fwd"], 2),
        "unit": "Mrays/s",
        "vs_baseline": round(ding["mrays_fwd"] / BASELINE_MRAYS, 3),
        "aux": aux,
    }), flush=True)


def main():
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        print(f"BENCH FAILED: no GPU (JAX platform {platform!r}); the "
              "bench measures the GPU only", file=sys.stderr)
        sys.exit(1)
    threading.Thread(target=_heartbeat, daemon=True).start()
    _log(f"starting: budget={BUDGET_S:.0f}s frames={FRAMES}")

    import tpu_ray_tracer as trt
    from tpu_ray_tracer.utils.cache import configure_compile_cache

    configure_compile_cache()
    stamp = device_stamp()
    _log(f"device: {stamp}")

    def load(name):
        return trt.load_from_file(os.path.join(REPO, "scenes", name + ".yml"))

    # Stage list, headline first; each entry = (key, scene name, callable).
    # 20spheres goes last: it is the largest compile, and with incremental
    # emission its loss under a timeout costs only its own row.
    refl_name = "reflection_test"
    stages = []
    scenes = {}

    def scene_for(name):
        if name not in scenes:
            scenes[name] = load(name)
        return scenes[name]

    results = {}

    stages.append(("dingdong.fwd", "dingdong",
                   lambda: _bench_fwd("dingdong", scene_for("dingdong"))))
    stages.append(("dingdong.fwdbwd", "dingdong",
                   lambda: _bench_fwdbwd("dingdong", scene_for("dingdong"))))
    stages.append(("monkey_saddle.fwd", "monkey_saddle",
                   lambda: _bench_fwd("monkey_saddle",
                                      scene_for("monkey_saddle"))))
    # backward on the pure-cubic polynomial scene
    stages.append(("monkey_saddle.fwdbwd", "monkey_saddle",
                   lambda: _bench_fwdbwd("monkey_saddle",
                                         scene_for("monkey_saddle"))))
    # the reflective scene runs its full 5-bounce chain, fwd AND bwd
    # through the chain (reference update-cuda.cu:126-146)
    stages.append((f"{refl_name}.fwd", refl_name,
                   lambda: _bench_fwd(
                       refl_name, scene_for(refl_name),
                       bounces=scene_for(refl_name).max_reflections)))
    stages.append((f"{refl_name}.fwdbwd", refl_name,
                   lambda: _bench_fwdbwd(
                       refl_name, scene_for(refl_name),
                       bounces=scene_for(refl_name).max_reflections)))
    stages.append(("20spheres.fwd", "20spheres",
                   lambda: _bench_fwd("20spheres", scene_for("20spheres"))))
    # backward on the widest scene (20 objects x 19 lights)
    stages.append(("20spheres.fwdbwd", "20spheres",
                   lambda: _bench_fwdbwd("20spheres",
                                         scene_for("20spheres"))))
    # remaining corpus: full-resolution forward + parity gate per scene
    for extra in ("quadratic", "cubic", "clebsch", "cayley"):
        stages.append((f"{extra}.fwd", extra,
                       lambda extra=extra: _bench_fwd(extra,
                                                      scene_for(extra))))

    skipped = []
    for i, (stage_name, scene_key, run) in enumerate(stages):
        remaining = [s[0] for s in stages[i + 1:]]
        if _elapsed() > BUDGET_S and "dingdong" in results:
            _log(f"budget exhausted ({_elapsed():.0f}s > {BUDGET_S:.0f}s): "
                 f"skipping {stage_name} and the rest")
            skipped = [stage_name] + remaining
            break
        _STAGE[0] = stage_name
        try:
            out = run()
        except Exception as exc:  # one broken stage must not kill the rest
            _log(f"STAGE FAILED {stage_name}: {type(exc).__name__}: {exc}")
            import traceback
            traceback.print_exc(file=sys.stderr)
            results.setdefault(scene_key, {}).setdefault(
                "failed_stages", []).append(stage_name)
            # emit so the failure is visible in aux.failed
            _emit(results, remaining, [], stamp)
            continue
        results.setdefault(scene_key, {}).update(out)
        _emit(results, remaining, [], stamp)
    _emit(results, [], skipped, stamp)

    failed = sorted(s for v in results.values()
                    for s in v.get("failed_stages", ()))
    if failed or skipped:
        print(f"BENCH FAILED: stages failed {failed}, skipped {skipped}",
              file=sys.stderr)
        sys.exit(1)

    failures = [
        f"{k}: {r['parity_bad_px_fraction']:.6f} > {gate}"
        for k, r in results.items() if "parity_bad_px_fraction" in r
        for gate in [PARITY_GATES[r["forward_route"]][k]]
        if r["parity_bad_px_fraction"] > gate
    ]
    if failures:
        print("PARITY GATE FAILED: " + "; ".join(failures), file=sys.stderr)
        sys.exit(1)
    _log("done")


if __name__ == "__main__":
    main()

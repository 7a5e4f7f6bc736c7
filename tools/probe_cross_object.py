"""Cross-object soft-visibility probe.

Two geometries separate the two cross-object boundary types:

A. OCCLUDING SILHOUETTE (sphere A in front of sphere B, A's limb against
   B): the boundary is A's own tangent silhouette — a root-PAIR event of
   A — so the existing pair blend should cover it: branch B (A's pair
   annihilated) reveals sphere B behind, giving alpha a correct
   two-object comparison. Expectation: soft radius recovery of A works.

B. ORDERING BOUNDARY (sphere B poking THROUGH sphere A toward the
   camera): the visible edge of B's cap is the 3-D intersection curve,
   where BOTH objects keep real roots and only the argmin order swaps —
   no discriminant crossing anywhere, so the pair blend is inert there.
   Expectation: recovering B's radius (the cap size) from the hard OR
   soft loss must rely on B's smooth interior shading alone; measure
   whether descent stalls.

Run CPU-only: PYTHONPATH= JAX_PLATFORMS=cpu python tools/probe_cross_object.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax
import jax.numpy as jnp
import optax

import tpu_ray_tracer as trt
from tpu_ray_tracer.diff.inverse import InverseProblem, make_loss_fn, pad_target
from tpu_ray_tracer.models.surface import COEF_INDEX
from tpu_ray_tracer.parallel.sharding import make_mesh, render_image_sharded
from tpu_ray_tracer.utils.cache import configure_compile_cache
from tpu_ray_tracer.render.pipeline import RenderConfig

CI = COEF_INDEX["c"]


def cam():
    return trt.Camera(
        position=jnp.zeros(3, jnp.float32),
        yaw_deg=jnp.asarray(90.0, jnp.float32),
        pitch_deg=jnp.asarray(0.0, jnp.float32),
    )


OCCLUDING_YAML = """\
width: 40
height: 30
fov: 60
bg_color: [0, 0.1, 0.2]
objects:
  - {type: sphere, center: [0.6, 0.2, 4], radius: 1.0, color: [0.9, 0.8, 0.1]}
  - {type: sphere, center: [-0.4, -0.2, 7], radius: 2.2, color: [0.9, 0.15, 0.1]}
light_sources:
  - {type: directional, intensity: 2, direction: [0.4, -1, 0.5], color: [1, 1, 1]}
"""

# B center on A's near surface: A at (0,0,5) r=1.5 -> near pole (0,0,3.5).
# B at (0.3, 0.1, 3.6) r=0.55 pokes through toward the camera; its tangent
# silhouette is buried inside A, so B's visible edge is the intersection
# curve (pure ordering event).
POKING_YAML = """\
width: 40
height: 30
fov: 60
bg_color: [0, 0.1, 0.2]
objects:
  - {type: sphere, center: [0, 0, 5], radius: 1.5, color: [0.9, 0.8, 0.1]}
  - {type: sphere, center: [0.3, 0.1, 3.6], radius: 0.55, color: [0.9, 0.15, 0.1]}
light_sources:
  - {type: directional, intensity: 2, direction: [0.4, -1, 0.5], color: [1, 1, 1]}
"""


def run_case(label, yaml_text, obj_idx, dc, steps, lr, soft_tau, tau_final):
    """Perturb object ``obj_idx``'s constant term by +dc and descend on the
    degree-<=2 sub-rows; report loss track + recovered constant."""
    scene = trt.load_from_string(yaml_text)
    mesh = make_mesh()
    config = RenderConfig(geom_dtype="float32", polish_iters=2, bounces=0,
                          chunk_px=None)
    camera = cam()
    target = render_image_sharded(scene, camera, mesh, config)
    tgt = pad_target(jnp.asarray(target, jnp.float32), mesh, scene.height)

    c0 = np.asarray(scene.coefs, np.float32).copy()
    true_c = float(c0[obj_idx, CI])
    c0[obj_idx, CI] += dc
    import dataclasses
    pert = dataclasses.replace(scene, coefs=c0)
    problem = InverseProblem(scene_template=pert, config=config,
                             param_fields=("coefs",), soft_tau=soft_tau)
    loss_fn = make_loss_fn(problem, mesh)
    base = jnp.asarray(c0)

    if soft_tau is not None:
        def sl(sub, tau):
            return loss_fn({"coefs": base.at[:, 10:].set(sub)}, camera, tgt, tau)
    else:
        def sl(sub, tau):
            return loss_fn({"coefs": base.at[:, 10:].set(sub)}, camera, tgt)

    vg = jax.jit(jax.value_and_grad(sl))
    from tpu_ray_tracer.diff.inverse import tau_schedule
    if soft_tau is not None and tau_final is not None:
        ntau = int(steps * 0.75)
        taus = tau_schedule(soft_tau, tau_final, ntau) + [tau_final] * (
            steps - ntau)
    else:
        taus = [soft_tau] * steps
    sub = base[:, 10:]
    opt = optax.adam(lr)
    st = opt.init(sub)
    losses = []
    for i in range(steps):
        loss, g = vg(sub, taus[i])
        losses.append(float(loss))
        up, st = opt.update(g, st)
        sub = optax.apply_updates(sub, up)
    cf = np.asarray(base.at[:, 10:].set(sub))
    got_c = float(cf[obj_idx, CI])
    print(f"[{label}] loss {losses[0]:.4e} -> {losses[-1]:.4e} "
          f"({losses[0]/max(losses[-1],1e-30):.1f}x)  "
          f"c[{obj_idx}]: start {true_c + dc:.3f} true {true_c:.3f} "
          f"recovered {got_c:.3f}", flush=True)
    return losses, got_c, true_c


if __name__ == "__main__":
    configure_compile_cache()
    t0 = time.perf_counter()
    # A: occluding silhouette — perturb FRONT sphere A's radius
    run_case("occl_soft", OCCLUDING_YAML, 0, +0.5, 200, 3e-3, 0.15, 0.005)
    run_case("occl_hard", OCCLUDING_YAML, 0, +0.5, 200, 3e-3, None, None)
    # B: ordering boundary — perturb POKING sphere B's radius
    run_case("poke_soft", POKING_YAML, 1, +0.25, 200, 3e-3, 0.15, 0.005)
    run_case("poke_hard", POKING_YAML, 1, +0.25, 200, 3e-3, None, None)
    print(f"total {time.perf_counter()-t0:.0f}s")

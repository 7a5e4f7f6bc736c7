"""Inverse rendering end-to-end (BASELINE.json configuration: recover
perturbed clebsch.yml parameters from a rendered target image).

Scope note: gradients through the renderer are implicit-function-theorem
gradients — exact almost everywhere, but blind to visibility/root-selection
discontinuities. For multi-sheet cubics like the Clebsch surface, large
surface-coefficient perturbations create a loss landscape whose slope is
carried by dense selection-flip discontinuities, where first-order descent
stalls (verified empirically: the c-coefficient loss is a clean V whose
a.e.-gradient opposes the jump-dominated trend on one side). Light and
shading parameters are smooth and recover cleanly; that is what this test
pins. The limitation is documented in ARCHITECTURE.md.
"""

import dataclasses

import numpy as np
import pytest

import tpu_ray_tracer as trt

from conftest import scene_path


@pytest.fixture(scope="module")
def jaxmod():
    import jax
    import jax.numpy as jnp
    return jax, jnp


def test_recover_clebsch_light_params(jaxmod):
    jax, jnp = jaxmod
    from tpu_ray_tracer.diff.inverse import (
        InverseProblem, extract_params, make_train_step, pad_target,
    )
    from tpu_ray_tracer.parallel.sharding import make_mesh, render_image_sharded
    from tpu_ray_tracer.render.pipeline import RenderConfig

    mesh = make_mesh()
    config = RenderConfig(geom_dtype="float32", polish_iters=2, bounces=0,
                          chunk_px=None)
    scene = dataclasses.replace(
        trt.load_from_file(scene_path("clebsch")), width=32, height=24
    )
    camera = trt.Camera(
        position=jnp.zeros(3, jnp.float32),
        yaw_deg=jnp.asarray(90.0, jnp.float32),
        pitch_deg=jnp.asarray(0.0, jnp.float32),
    )
    target = render_image_sharded(scene, camera, mesh, config)

    perturbed = dataclasses.replace(
        scene, light_color=np.asarray(scene.light_color) * 0.55
    )
    problem = InverseProblem(
        scene_template=perturbed, config=config, learning_rate=5e-2,
        param_fields=("light_color",),
    )
    params = extract_params(perturbed.astype(jnp.float32), ("light_color",))
    opt = problem.optimizer()
    opt_state = opt.init(params)
    step = make_train_step(problem, mesh)
    tgt = pad_target(jnp.asarray(target, jnp.float32), mesh, scene.height)

    losses = []
    for _ in range(40):
        params, opt_state, loss = step(params, opt_state, camera, tgt)
        losses.append(float(loss))

    assert np.isfinite(losses).all()
    assert losses[0] > 1e-5
    assert min(losses) < losses[0] * 0.05, (
        f"loss {losses[0]:.3e} -> {min(losses):.3e}"
    )
    # The recovered parameters reproduce the target image. (The light table
    # itself is non-identifiable: six symmetric directional lights admit many
    # tables with identical renders, so parameter-space closeness is not a
    # valid criterion.)
    from tpu_ray_tracer.diff.inverse import apply_params

    import jax as _jax
    recovered_scene = apply_params(
        _jax.tree.map(jnp.asarray, perturbed.astype(jnp.float32)), params
    )
    recovered = render_image_sharded(recovered_scene, camera, mesh, config)
    err = np.abs(np.asarray(recovered) - np.asarray(target))
    assert err.max() < 0.04, err.max()


def test_loss_landscape_minimum_at_truth(jaxmod):
    """The image loss over the surface constant term has its minimum at the
    true value — the objective is well-posed even where first-order descent
    is discontinuity-limited."""
    jax, jnp = jaxmod
    from tpu_ray_tracer.diff.inverse import InverseProblem, make_loss_fn, pad_target
    from tpu_ray_tracer.models.surface import COEF_INDEX
    from tpu_ray_tracer.parallel.sharding import make_mesh, render_image_sharded
    from tpu_ray_tracer.render.pipeline import RenderConfig

    mesh = make_mesh()
    config = RenderConfig(geom_dtype="float32", polish_iters=2, bounces=0,
                          chunk_px=None)
    scene = dataclasses.replace(
        trt.load_from_file(scene_path("clebsch")), width=32, height=24
    )
    camera = trt.Camera(
        position=jnp.zeros(3, jnp.float32),
        yaw_deg=jnp.asarray(90.0, jnp.float32),
        pitch_deg=jnp.asarray(0.0, jnp.float32),
    )
    target = render_image_sharded(scene, camera, mesh, config)
    tgt = pad_target(jnp.asarray(target, jnp.float32), mesh, scene.height)
    problem = InverseProblem(scene_template=scene, config=config,
                             param_fields=("coefs",))
    loss_fn = jax.jit(make_loss_fn(problem, mesh))

    losses = {}
    for cval in [0.8, 1.0, 1.2]:
        c = np.asarray(scene.coefs, dtype=np.float32).copy()
        c[0, COEF_INDEX["c"]] = cval
        losses[cval] = float(loss_fn({"coefs": jnp.asarray(c)}, camera, tgt))
    assert losses[1.0] < 1e-8
    assert losses[0.8] > losses[1.0]
    assert losses[1.2] > losses[1.0]


def _pose(jnp, position, yaw, pitch):
    return trt.Camera(
        position=jnp.asarray(position, jnp.float32),
        yaw_deg=jnp.asarray(yaw, jnp.float32),
        pitch_deg=jnp.asarray(pitch, jnp.float32),
    )


def test_recover_camera_pose(jaxmod):
    """Camera-pose inverse rendering: the reference's fly
    camera IS a pose (src/ray-tracer.cpp:24-58); optimize it by descent from
    a perturbed initial guess against a fixed scene via the 'camera'
    pseudo-field.

    Recovery criterion is IMAGE space, following the light-table precedent
    above: on this scene the pose itself is gauge-ambiguous — the visible
    surfaces sit at nearly constant depth, so a small rotation is locally
    indistinguishable from a perpendicular translation. Measured: descent
    reaches loss ~1e-8 (an image-exact match) at a pose ~2 deg off the
    generator, i.e. the objective is genuinely minimized along a flat
    rotation-translation valley. Pose-parameter closeness would therefore
    be a wrong assertion; see ARCHITECTURE.md 'Camera-pose recovery'."""
    jax, jnp = jaxmod
    from tpu_ray_tracer.diff.inverse import InverseProblem, apply_params, fit
    from tpu_ray_tracer.parallel.sharding import make_mesh, render_image_sharded
    from tpu_ray_tracer.render.pipeline import RenderConfig

    mesh = make_mesh()
    config = RenderConfig(geom_dtype="float32", polish_iters=2, bounces=0,
                          chunk_px=None)
    scene = dataclasses.replace(
        trt.load_from_file(scene_path("quadratic")), width=32, height=24
    )
    true_cam = _pose(jnp, [0.0, -25.0, 0.0], 90.0, 0.0)
    target = render_image_sharded(scene, true_cam, mesh, config)

    start = _pose(jnp, [0.4, -24.7, 0.2], 92.0, -1.0)
    problem = InverseProblem(scene_template=scene, config=config,
                             param_fields=("camera",), learning_rate=4e-2)
    params, losses = fit(problem, target, camera=start, steps=80, mesh=mesh,
                         log_every=0)
    assert np.isfinite(losses).all()
    # measured 2026-08-21: 1.2e-6 -> 9.7e-9 (125x); gate at 20x
    assert losses[-1] < losses[0] * 0.05, (losses[0], losses[-1])
    # the recovered pose reproduces the target frame
    scene32 = jax.tree.map(jnp.asarray, scene.astype(jnp.float32))
    recovered = render_image_sharded(
        apply_params(scene32, params), params["camera"], mesh, config)
    err = np.abs(np.asarray(recovered) - np.asarray(target))
    assert err.max() < 2.0 / 255.0, err.max()


@pytest.mark.slow  # ~6 min on the 2-core CI host (150 soft-render steps)
def test_camera_pose_soft_visibility_descent(jaxmod):
    """Pose error whose image signal is carried by SILHOUETTE translation
    (the 20spheres corpus scene) stalls under hard-render IFT gradients —
    measured: hard descent plateaus after a ~10x loss drop with the pose
    still ~1.7 deg off. The soft-visibility blend is differentiable in the
    ray origin/direction too, so the same tau-continuation machinery built
    for coefficient recovery gives pose descent silhouette gradients:
    measured 66x here vs 10x hard (this gate: 30x, and strictly deeper
    than the hard plateau). With full budget (64x40, tau 0.2 -> 1e-3 over
    400 steps, ~25 min) the same setup converges to the METRIC pose —
    yaw error 0.04 deg, position within 0.09 — recorded in
    ARCHITECTURE.md 'Camera-pose recovery'; this test pins the cheap
    descent mechanism, not the full recipe."""
    jax, jnp = jaxmod
    from tpu_ray_tracer.diff.inverse import InverseProblem, fit
    from tpu_ray_tracer.parallel.sharding import make_mesh, render_image_sharded
    from tpu_ray_tracer.render.pipeline import RenderConfig

    mesh = make_mesh()
    config = RenderConfig(geom_dtype="float32", polish_iters=2, bounces=0,
                          chunk_px=None)
    scene = dataclasses.replace(
        trt.load_from_file(scene_path("20spheres")), width=40, height=24
    )
    true_cam = _pose(jnp, [0.0, 0.0, 0.0], 90.0, 0.0)
    target = render_image_sharded(scene, true_cam, mesh, config)
    start = _pose(jnp, [0.3, -0.2, 0.15], 92.0, -1.0)
    problem = InverseProblem(scene_template=scene, config=config,
                             param_fields=("camera",), learning_rate=3e-2,
                             soft_tau=0.15)
    params, losses = fit(problem, target, camera=start, steps=150, mesh=mesh,
                         log_every=0, tau_final=2e-3)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] / 30.0, (losses[0], losses[-1])


def test_checkpoint_roundtrip_restores_opt_state_and_camera(jaxmod, tmp_path):
    """save_checkpoint/load_checkpoint must restore the OPTIMIZER state and
    dataclass (Camera) params — previously _flatten wrote namedtuple fields
    under numeric keys while rebuild looked up named keys, so a resumed fit
    silently restarted Adam's moments from zero."""
    jax, jnp = jaxmod
    import optax

    from tpu_ray_tracer.diff.inverse import load_checkpoint, save_checkpoint

    params = {
        "light_color": jnp.ones((2, 3)),
        "camera": _pose(jnp, [1.0, 2.0, 3.0], 92.0, -1.5),
    }
    opt = optax.adam(1e-2)
    state = opt.init(params)
    grads = jax.tree.map(lambda x: jnp.full_like(x, 0.5), params)
    _, state = opt.update(grads, state, params)

    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, params, state, 7)
    fresh_params = {
        "light_color": jnp.zeros((2, 3)),
        "camera": _pose(jnp, [0.0, 0.0, 0.0], 90.0, 0.0),
    }
    p2, s2, step = load_checkpoint(path, fresh_params, opt.init(fresh_params))
    assert step == 7
    mu = np.asarray(s2[0].mu["light_color"])
    assert np.abs(mu).max() > 0.01, "optimizer moments not restored"
    assert float(np.asarray(s2[0].count)) == 1
    assert float(np.asarray(p2["camera"].yaw_deg)) == 92.0
    np.testing.assert_allclose(np.asarray(p2["camera"].position), [1.0, 2.0, 3.0])

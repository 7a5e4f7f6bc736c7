"""Multi-device sharding tests on the simulated 8-device CPU mesh
(SURVEY.md §4.4): sharded rendering matches single-device output, and the
distributed inverse-rendering train step (grad psum over the mesh) runs and
reduces the loss."""

import dataclasses

import numpy as np
import pytest

import tpu_ray_tracer as trt

from conftest import scene_path


@pytest.fixture(scope="module")
def jaxmod():
    import jax
    import jax.numpy as jnp
    assert len(jax.devices()) >= 8, "conftest should have forced 8 CPU devices"
    return jax, jnp


def test_mesh_has_8_devices(jaxmod):
    jax, _ = jaxmod
    from tpu_ray_tracer.parallel.sharding import make_mesh

    mesh = make_mesh()
    assert mesh.shape["px"] == 8


def test_sharded_render_matches_single_device(jaxmod):
    jax, jnp = jaxmod
    from tpu_ray_tracer.parallel.sharding import make_mesh, render_image_sharded
    from tpu_ray_tracer.render.pipeline import RenderConfig, render_image

    scene = dataclasses.replace(
        trt.load_from_file(scene_path("quadratic")), width=32, height=24
    )
    config = RenderConfig(geom_dtype="float32", polish_iters=2, bounces=0,
                          chunk_px=None)
    camera = trt.Camera(
        position=jnp.zeros(3, jnp.float32),
        yaw_deg=jnp.asarray(90.0, jnp.float32),
        pitch_deg=jnp.asarray(0.0, jnp.float32),
    )
    single = np.asarray(render_image(scene, camera, config))
    mesh = make_mesh()
    sharded = np.asarray(render_image_sharded(scene, camera, mesh, config))
    assert sharded.shape == single.shape
    np.testing.assert_allclose(sharded, single, atol=1e-6)


def test_sharded_render_nondivisible_rows(jaxmod):
    jax, jnp = jaxmod
    from tpu_ray_tracer.parallel.sharding import make_mesh, render_image_sharded
    from tpu_ray_tracer.render.pipeline import RenderConfig, render_image

    # 21 rows over 8 devices: padding path
    scene = dataclasses.replace(
        trt.load_from_file(scene_path("quadratic")), width=16, height=21
    )
    config = RenderConfig(geom_dtype="float32", polish_iters=2, bounces=0,
                          chunk_px=None)
    camera = trt.Camera(
        position=jnp.zeros(3, jnp.float32),
        yaw_deg=jnp.asarray(90.0, jnp.float32),
        pitch_deg=jnp.asarray(0.0, jnp.float32),
    )
    single = np.asarray(render_image(scene, camera, config))
    sharded = np.asarray(render_image_sharded(scene, camera, make_mesh(), config))
    assert sharded.shape == single.shape
    np.testing.assert_allclose(sharded, single, atol=1e-6)


def test_distributed_train_step_reduces_loss(jaxmod):
    jax, jnp = jaxmod
    from tpu_ray_tracer.diff.inverse import (
        InverseProblem, extract_params, make_train_step, pad_target,
    )
    from tpu_ray_tracer.parallel.sharding import make_mesh, render_image_sharded
    from tpu_ray_tracer.render.pipeline import RenderConfig

    mesh = make_mesh()
    config = RenderConfig(geom_dtype="float32", polish_iters=2, bounces=0,
                          chunk_px=None)
    # cayley: six O(1)-intensity directional lights — the image is a smooth
    # function of light color (no geometry change), and Adam's unit-scale
    # steps can close an O(1) parameter gap in a few iterations. (A scene
    # perturbation must actually change the image: e.g. shifting an infinite
    # plane along its normal does not change its Lambertian shading at all.)
    scene = dataclasses.replace(
        trt.load_from_file(scene_path("cayley")), width=24, height=16
    )
    camera = trt.Camera(
        position=jnp.zeros(3, jnp.float32),
        yaw_deg=jnp.asarray(90.0, jnp.float32),
        pitch_deg=jnp.asarray(0.0, jnp.float32),
    )
    target = render_image_sharded(scene, camera, mesh, config)

    # perturb the light intensities DIMMER and ask the optimizer to pull
    # them back (brighter would saturate the reference's min(1, .) clamp,
    # which correctly zeroes the gradient)
    perturbed = dataclasses.replace(
        scene, light_color=np.asarray(scene.light_color) * 0.6
    )
    # optimize only the light table: a surface-coefficient step of Adam's
    # unit scale would deform the cubic out of view in one iteration
    problem = InverseProblem(scene_template=perturbed, config=config,
                             learning_rate=5e-2,
                             param_fields=("light_color",))
    params = extract_params(perturbed.astype(jnp.float32), ("light_color",))
    opt = problem.optimizer()
    opt_state = opt.init(params)
    step = make_train_step(problem, mesh)
    tgt = pad_target(jnp.asarray(target, jnp.float32), mesh, scene.height)

    losses = []
    for _ in range(20):
        params, opt_state, loss = step(params, opt_state, camera, tgt)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[0] > 0
    assert losses[-1] < losses[0] * 0.5, losses


def test_sharded_pallas_matches_single_device_pallas(jaxmod):
    """The fused kernel under shard_map (each device renders its row
    block) is BIT-EQUAL to the single-device kernel: per-pixel math is
    identical, only the grid decomposition changes."""
    jax, jnp = jaxmod
    from tpu_ray_tracer.parallel.sharding import make_mesh, render_image_sharded
    from tpu_ray_tracer.render.pallas_backend import render_image_pallas
    from tpu_ray_tracer.render.pipeline import RenderConfig

    # dingdong: cubic + quadrics (exercises the degree partition), both
    # light kinds; 21 rows over 8 devices exercises the padding path
    scene = dataclasses.replace(
        trt.load_from_file(scene_path("dingdong")), width=32, height=21
    )
    camera = trt.Camera(
        position=jnp.zeros(3, jnp.float32),
        yaw_deg=jnp.asarray(90.0, jnp.float32),
        pitch_deg=jnp.asarray(0.0, jnp.float32),
    )
    config = RenderConfig(geom_dtype="float32", polish_iters=3, bounces=0,
                          chunk_px=None)
    single = np.asarray(render_image_pallas(scene, camera, bounces=0,
                                            interpret=True))
    sharded = np.asarray(
        render_image_sharded(scene, camera, make_mesh(), config,
                             backend="pallas", interpret=True)
    )
    assert sharded.shape == single.shape
    np.testing.assert_array_equal(sharded, single)


def test_checkpoint_roundtrip(tmp_path, jaxmod):
    jax, jnp = jaxmod
    import optax

    from tpu_ray_tracer.diff.inverse import load_checkpoint, save_checkpoint

    params = {"coefs": jnp.ones((2, 20)), "light_color": jnp.full((1, 3), 0.5)}
    opt = optax.adam(1e-2)
    opt_state = opt.init(params)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, params, opt_state, 7)
    restored = load_checkpoint(path, params, opt_state)
    assert restored is not None
    r_params, r_opt, step = restored
    assert step == 7
    np.testing.assert_allclose(np.asarray(r_params["coefs"]), 1.0)
    chex_equal = jax.tree.map(
        lambda a, b: np.testing.assert_allclose(np.asarray(a), np.asarray(b)),
        opt_state, r_opt,
    )
    del chex_equal


@pytest.mark.slow
def test_weak_scaling_sharded_overhead_bounded(jaxmod):
    """Weak-scaling sanity on the virtual mesh: rendering
    the SAME total pixel load sharded over 8 virtual devices must not cost
    materially more wall time than unsharded on one device. On this host
    the 8 virtual devices share 2 physical cores, so per-device wall-time
    FLATNESS (the real weak-scaling curve) is unmeasurable here — what is
    measurable is that shard_map adds no serialization or collective
    overhead at fixed total work: both programs do identical arithmetic,
    and the sharded one is allowed 3x slack for scheduling noise (the
    pathologies this guards against are categorical, 8x+ — see the assert
    comment). Wall-clock asserts are flake-prone on a loaded 2-core CI
    host, hence the slow mark."""
    import time

    jax, jnp = jaxmod
    from tpu_ray_tracer.parallel.sharding import make_mesh, render_image_sharded
    from tpu_ray_tracer.render.pipeline import RenderConfig, render_image

    scene = dataclasses.replace(
        trt.load_from_file(scene_path("quadratic")), width=64, height=64
    )
    config = RenderConfig(geom_dtype="float32", polish_iters=2, bounces=0,
                          chunk_px=None)
    camera = trt.Camera(
        position=jnp.zeros(3, jnp.float32),
        yaw_deg=jnp.asarray(90.0, jnp.float32),
        pitch_deg=jnp.asarray(0.0, jnp.float32),
    )
    mesh = make_mesh()

    def time_best(fn, reps=3):
        np.asarray(fn())  # compile + warm
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            np.asarray(fn())
            best = min(best, time.perf_counter() - t0)
        return best

    # backend="xla" on BOTH sides: compare sharding overhead only
    t_single = time_best(lambda: render_image(scene, camera, config))
    t_sharded = time_best(
        lambda: render_image_sharded(scene, camera, mesh, config,
                                     backend="xla"))
    # generous slack: 8 virtual devices time-slice 2 physical cores, so
    # scheduler noise is real; the pathologies this guards against are
    # categorical (the retrace-per-call bug it originally caught measured
    # 40-230x, full serialization would be ~8x)
    assert t_sharded <= 3.0 * t_single + 0.1, (
        f"sharded render {t_sharded:.3f}s vs single-device {t_single:.3f}s "
        f"— shard_map is adding serialization overhead"
    )

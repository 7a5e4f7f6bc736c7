"""Degenerate and fallback scene shapes.

Scenes with more than 31 lights (the kernel's gradient recomputes through
XLA, ``_diff_bwd``), no lights, or no objects each get a scene built here.
The
reference REQUIRES both sequence keys to be present (check_sequence throws
``undefined_value`` on an absent key, reference: src/scene.cpp:56-66) but
iterates EMPTY sequences zero times (src/scene.cpp:169-170) — so
``objects: []`` / ``light_sources: []`` are legal inputs, not error paths,
and this loader replicates both sides of that contract.
"""

import dataclasses

import numpy as np
import pytest

import tpu_ray_tracer as trt
from tpu_ray_tracer.models import light as light_mod
from tpu_ray_tracer.models.scene import Object, build_scene
from tpu_ray_tracer.models import surface


@pytest.fixture(scope="module")
def jaxmod():
    import jax
    import jax.numpy as jnp
    return jax, jnp


def _cam(jnp):
    return trt.Camera(
        position=jnp.zeros(3, jnp.float32),
        yaw_deg=jnp.asarray(90.0, jnp.float32),
        pitch_deg=jnp.asarray(0.0, jnp.float32),
    )


def _sphere_objects():
    return [
        Object(surface=surface.sphere((0.0, 0.0, 6.0), 2.0),
               reflection_ratio=0.0, color=np.asarray([0.8, 0.3, 0.2])),
        Object(surface=surface.plane((0.0, -3.0, 0.0), (0.0, 1.0, 0.0)),
               reflection_ratio=0.0, color=np.asarray([0.2, 0.6, 0.9])),
    ]


def _many_lights(n=33):
    """n directional lights fanned over the hemisphere, intensities small
    enough that the lit sum stays below the per-channel clamp (a clamp at
    1.0 would hide per-light errors)."""
    lights = []
    for i in range(n):
        ang = 2.0 * np.pi * i / n
        d = np.array([np.cos(ang) * 0.5, -1.0, np.sin(ang) * 0.5 + 0.3])
        lights.append(light_mod.directional(
            0.08, d, (1.0, 1.0 - 0.5 * (i % 3) / 2.0, 0.5 + 0.5 * (i % 2))))
    return lights


def _scene_many_lights(n=33, width=64, height=32):
    return build_scene(width, height, 60.0, _sphere_objects(),
                       _many_lights(n), bg_color=(0.1, 0.1, 0.1))


def test_33_light_forward_parity(jaxmod):
    """Forward render with 33 lights (more than one 32-bit word of lights):
    the kernel's light sweep has no light-count limit, so the forward must
    still match the f64 oracle."""
    jax, jnp = jaxmod
    from tpu_ray_tracer.render.pallas_backend import render_image_pallas
    from tpu_ray_tracer.render.reference_cpu import render_image_np

    scene = _scene_many_lights()
    assert scene.n_lights == 33
    img = np.asarray(render_image_pallas(scene, _cam(jnp), interpret=True))
    gold = render_image_np(scene)
    assert np.isfinite(img).all()
    err = np.abs(img - gold).max(axis=-1)
    frac = float((err > 2.0 / 255.0).mean())
    assert frac <= 0.005, f"33-light: {frac:.4%} bad pixels"


def test_33_light_gradient_fallback_matches_xla(jaxmod):
    """jax.grad through render_image_pallas on a 33-light scene takes the
    kernel's one VJP, the ``_diff_bwd`` XLA recompute — its gradients must
    equal plain AD through the XLA pipeline, since that is literally what
    it recomputes."""
    jax, jnp = jaxmod
    from tpu_ray_tracer.render.pallas_backend import render_image_pallas
    from tpu_ray_tracer.render.pipeline import RenderConfig, render_image

    scene = _scene_many_lights(width=32, height=16)
    scene32 = jax.tree.map(jnp.asarray, scene.astype(jnp.float32))
    cam = _cam(jnp)

    def loss_pallas(light_color, coefs):
        s = dataclasses.replace(scene32, light_color=light_color, coefs=coefs)
        return jnp.sum(render_image_pallas(s, cam, polish_iters=3, bounces=0,
                                           interpret=True))

    config = RenderConfig(geom_dtype="float32", polish_iters=3, bounces=0,
                          chunk_px=None)

    def loss_xla(light_color, coefs):
        s = dataclasses.replace(scene32, light_color=light_color, coefs=coefs)
        return jnp.sum(render_image(s, cam, config))

    gl_p, gc_p = jax.jit(jax.grad(loss_pallas, argnums=(0, 1)))(
        scene32.light_color, scene32.coefs)
    gl_x, gc_x = jax.jit(jax.grad(loss_xla, argnums=(0, 1)))(
        scene32.light_color, scene32.coefs)
    gl_p, gc_p, gl_x, gc_x = map(np.asarray, (gl_p, gc_p, gl_x, gc_x))
    assert np.isfinite(gl_p).all() and np.isfinite(gc_p).all()
    assert np.abs(gl_p).max() > 0  # gradients genuinely flow
    np.testing.assert_allclose(gl_p, gl_x, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(gc_p, gc_x, rtol=1e-4,
                               atol=1e-6 * max(1.0, np.abs(gc_x).max()))


def test_zero_light_scene(jaxmod):
    """0 lights: hit pixels shade to black (empty lit sum), misses show bg
    — through the Pallas entry and against the f64 oracle."""
    jax, jnp = jaxmod
    from tpu_ray_tracer.render.pallas_backend import render_image_pallas
    from tpu_ray_tracer.render.reference_cpu import render_image_np

    scene = build_scene(64, 32, 60.0, _sphere_objects(), [],
                        bg_color=(0.25, 0.5, 0.75))
    assert scene.n_lights == 0
    img = np.asarray(render_image_pallas(scene, _cam(jnp), interpret=True))
    gold = render_image_np(scene)
    assert np.isfinite(img).all()
    err = np.abs(img - gold).max(axis=-1)
    assert float((err > 2.0 / 255.0).mean()) <= 0.005
    # the scene geometry guarantees both classes are present
    flat = img.reshape(-1, 3)
    assert (flat == 0.0).all(axis=-1).any(), "no black (hit) pixels rendered"
    assert np.isclose(flat, [0.25, 0.5, 0.75]).all(axis=-1).any(), \
        "no background pixels rendered"


def test_zero_object_scene_forward_and_grad(jaxmod):
    """0 objects: every pixel is bg; the gradient route is the XLA-recompute
    fallback and must return zero (not NaN) for light parameters."""
    jax, jnp = jaxmod
    from tpu_ray_tracer.render.pallas_backend import render_image_pallas

    scene = build_scene(
        64, 32, 60.0, [],
        [light_mod.directional(1.0, (0.0, -1.0, 0.0), (1.0, 1.0, 1.0))],
        bg_color=(0.3, 0.6, 0.9),
    )
    assert scene.n_objects == 0
    scene32 = jax.tree.map(jnp.asarray, scene.astype(jnp.float32))
    cam = _cam(jnp)
    img = np.asarray(render_image_pallas(scene32, cam, interpret=True))
    np.testing.assert_allclose(
        img, np.broadcast_to([0.3, 0.6, 0.9], img.shape), atol=1e-6)

    def loss(light_color):
        s = dataclasses.replace(scene32, light_color=light_color)
        return jnp.sum(render_image_pallas(s, cam, interpret=True))

    g = np.asarray(jax.jit(jax.grad(loss))(scene32.light_color))
    assert np.isfinite(g).all()
    np.testing.assert_allclose(g, 0.0, atol=1e-8)


def test_degenerate_scenes_through_cli(jaxmod, tmp_path, capsys):
    """The CLI render path on YAML scenes with an EMPTY ``objects`` sequence
    and with 33 lights. The reference requires both keys present
    (check_sequence throws on an absent key, src/scene.cpp:56-66,169-170)
    but iterates empty sequences zero times — ``objects: []`` is a legal
    scene."""
    from tpu_ray_tracer import cli

    no_objects = tmp_path / "empty.yml"
    no_objects.write_text(
        "width: 32\nheight: 16\nfov: 60\n"
        "bg_color: [0.2, 0.4, 0.6]\n"
        "objects: []\n"
        "light_sources:\n"
        "  - type: directional\n"
        "    direction: [0, -1, 0]\n"
    )
    out = tmp_path / "empty.png"
    rc = cli.main(["render", str(no_objects), "-o", str(out)])
    assert rc == 0 and out.exists()

    many = ["width: 32", "height: 16", "fov: 60", "objects:",
            "  - type: sphere", "    position: [0, 0, 6]", "    radius: 2",
            "    color: [0.8, 0.3, 0.2]", "light_sources:"]
    for i in range(33):
        many += [
            "  - type: directional",
            f"    direction: [{0.3 * (i % 5 - 2)}, -1, {0.2 * (i % 3)}]",
            "    intensity: 0.05",
        ]
    many_yml = tmp_path / "many.yml"
    many_yml.write_text("\n".join(many) + "\n")
    out2 = tmp_path / "many.png"
    rc = cli.main(["render", str(many_yml), "-o", str(out2), "--check"])
    assert rc == 0 and out2.exists()


def test_zero_object_soft_render(jaxmod):
    """render_rays_soft on a 0-object scene: bg everywhere, finite zero
    gradients — previously crashed on argmin over the empty object axis
    (reachable via `fit --soft-tau` on an `objects: []` scene)."""
    jax, jnp = jaxmod
    from tpu_ray_tracer.diff.soft import render_rays_soft

    scene = build_scene(
        16, 8, 60.0, [],
        [light_mod.directional(1.0, (0.0, -1.0, 0.0), (1.0, 1.0, 1.0))],
        bg_color=(0.2, 0.4, 0.8),
    )
    scene32 = jax.tree.map(jnp.asarray, scene.astype(jnp.float32))
    origin = jnp.zeros((8, 16, 3), jnp.float32)
    d = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], jnp.float32),
                         (8, 16, 3))

    img = np.asarray(render_rays_soft(scene32, origin, d, polish_iters=2,
                                      tau=0.1))
    np.testing.assert_allclose(
        img, np.broadcast_to([0.2, 0.4, 0.8], img.shape), atol=1e-6)

    def loss(light_color):
        s = dataclasses.replace(scene32, light_color=light_color)
        return jnp.sum(render_rays_soft(s, origin, d, polish_iters=2,
                                        tau=0.1))

    g = np.asarray(jax.jit(jax.grad(loss))(scene32.light_color))
    assert np.isfinite(g).all()
    np.testing.assert_allclose(g, 0.0, atol=1e-8)


def test_33_light_fit_routes_to_xla_and_descends(jaxmod):
    """A fit on a > 31-light scene (gradients always take the XLA route)
    produces a finite, descending optimization."""
    jax, jnp = jaxmod
    from tpu_ray_tracer.diff.inverse import InverseProblem, fit
    from tpu_ray_tracer.parallel.sharding import make_mesh, render_image_sharded
    from tpu_ray_tracer.render.pipeline import RenderConfig

    scene = _scene_many_lights(width=32, height=16)
    config = RenderConfig(geom_dtype="float32", polish_iters=2, bounces=0,
                          chunk_px=None)
    mesh = make_mesh()
    target = render_image_sharded(scene, _cam(jnp), mesh, config,
                                  backend="xla")
    perturbed = dataclasses.replace(
        scene, light_color=np.asarray(scene.light_color) * 0.5)
    problem = InverseProblem(
        scene_template=perturbed, config=config,
        param_fields=("light_color",), learning_rate=5e-2,
    )
    params, losses = fit(problem, target, camera=_cam(jnp), steps=8,
                         mesh=mesh, log_every=0)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.5, losses


def test_plane_only_scene_pallas(jaxmod):
    """All-linear scene (planes only): n_cubic == 0 and no quadric slots —
    the degree partition's third class. Forward parity vs the f64 oracle
    through the kernel path."""
    jax, jnp = jaxmod
    from tpu_ray_tracer.render.pallas_backend import render_image_pallas
    from tpu_ray_tracer.render.reference_cpu import render_image_np

    objs = [
        Object(surface=surface.plane((0.0, -2.0, 0.0), (0.0, 1.0, 0.0)),
               reflection_ratio=0.0, color=np.asarray([0.2, 0.7, 0.3])),
        Object(surface=surface.plane((0.0, 0.0, 12.0), (0.1, 0.2, -1.0)),
               reflection_ratio=0.0, color=np.asarray([0.8, 0.4, 0.1])),
    ]
    lights = [light_mod.directional(1.5, (0.3, -1.0, 0.4), (1.0, 1.0, 1.0)),
              light_mod.spherical(40.0, (0.0, 3.0, 6.0), (1.0, 0.9, 0.8))]
    scene = build_scene(64, 32, 60.0, objs, lights, bg_color=(0.1, 0.1, 0.3))
    img = np.asarray(render_image_pallas(scene, _cam(jnp), interpret=True))
    gold = render_image_np(scene)
    assert np.isfinite(img).all()
    err = np.abs(img - gold).max(axis=-1)
    assert float((err > 2.0 / 255.0).mean()) <= 0.005

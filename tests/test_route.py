"""The route chooser (render/route.py) and the compile-cache placement."""

import os

import pytest

from tpu_ray_tracer.render import route as route_mod
from tpu_ray_tracer.render.route import (
    FORWARD, GRADIENT, KERNEL, NUMPY, XLA, RouteError, choose_route,
)


@pytest.mark.parametrize("pass_,requested,platform,expected", [
    (FORWARD, "auto", "cpu", XLA),
    (GRADIENT, "auto", "cpu", XLA),
    (FORWARD, "auto", "gpu", route_mod.GPU_FORWARD_ROUTE),
    (GRADIENT, "auto", "gpu", XLA),
    (FORWARD, "jax", "gpu", XLA),
    (FORWARD, "pallas", "gpu", KERNEL),
    (FORWARD, "numpy", "cpu", NUMPY),
])
def test_choose_route(pass_, requested, platform, expected):
    assert choose_route(pass_, requested, platform) == expected


@pytest.mark.parametrize("pass_,requested,platform,message", [
    (FORWARD, "auto", "metal", "no render route for platform 'metal'"),
    (GRADIENT, "jax", "rocm", "no render route"),
    (FORWARD, "pallas", "cpu", "needs a GPU"),
    (GRADIENT, "pallas", "gpu", "forward only"),
    (GRADIENT, "numpy", "cpu", "not differentiable"),
])
def test_choose_route_refuses(pass_, requested, platform, message):
    with pytest.raises(RouteError, match=message):
        choose_route(pass_, requested, platform)


def test_choose_route_defaults_to_jax_platform():
    # the test harness runs on CPU
    assert choose_route(FORWARD) == XLA


def test_cli_pallas_on_cpu_is_an_error(capsys):
    from tpu_ray_tracer.cli import main

    from conftest import scene_path

    rc = main(["render", scene_path("quadratic"), "--backend", "pallas",
               "--size", "16", "12"])
    assert rc == 2
    assert "needs a GPU" in capsys.readouterr().err


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_placement(monkeypatch, tmp_path, env_set):
    import jax

    from tpu_ray_tracer.utils import cache

    before = jax.config.jax_compilation_cache_dir
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert cache.configure_compile_cache() == str(tmp_path)
        # the variable is JAX's own; nothing is set in code
        assert jax.config.jax_compilation_cache_dir == before
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        try:
            path = cache.configure_compile_cache()
            repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
            assert path == os.path.join(repo, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
        finally:
            jax.config.update("jax_compilation_cache_dir", before)

"""Test harness configuration.

Tests run on CPU with a simulated 8-device mesh (the standard JAX trick for
exercising multi-device sharding logic without several cards — SURVEY.md
§4.4) and with x64 enabled so the f64 golden path is available as the
parity oracle. A persistent compilation cache keeps repeated test runs fast.

Tests marked ``gpu`` need the card (compiled GPU kernels have no CPU form);
they skip elsewhere. ``chip_smoke.py`` runs them in its own process, which
already holds the GPU when pytest starts: then the platform is left alone.
"""

import os

from jax._src import xla_bridge

ON_CARD = xla_bridge.backends_are_initialized()
if not ON_CARD:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not ON_CARD:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

from tpu_ray_tracer.utils.cache import configure_compile_cache  # noqa: E402

configure_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

SCENE_DIR = os.path.join(os.path.dirname(__file__), os.pardir, "scenes")
SCENE_NAMES = [
    "quadratic", "20spheres", "reflection_test", "dingdong",
    "cayley", "clebsch", "cubic", "monkey_saddle",
]


@pytest.fixture(scope="session")
def scene_dir():
    return SCENE_DIR


def scene_path(name: str) -> str:
    return os.path.join(SCENE_DIR, name + ".yml")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(20260817)


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests unless JAX's first device is a GPU —
    decided when the test runs, never at import."""
    if request.node.get_closest_marker("gpu") is not None:
        platform = jax.devices()[0].platform
        if platform != "gpu":
            pytest.skip(f"needs a GPU (JAX platform is {platform!r})")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running integration test (multi-process etc.)"
    )
    config.addinivalue_line(
        "markers", "gpu: needs a GPU (a compiled kernel); run by chip_smoke.py"
    )

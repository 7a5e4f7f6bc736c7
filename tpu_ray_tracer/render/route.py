"""The one place that chooses a render route for a pass and a platform.

* ``cpu`` -> the XLA pipeline (``render/pipeline.py``), for every pass.
* ``gpu``, forward -> ``GPU_FORWARD_ROUTE``: whichever of the fused kernel
  (``render/pallas_backend.py``) and the XLA pipeline was faster on an H100
  in every timed scene (PERF.md).
* ``gpu``, gradient (forward+backward, fit) -> ``jax.grad`` through the XLA
  pipeline.
* any other platform -> ``RouteError``.

An explicit request (``--backend``) is checked against the same table: the
kernel needs a GPU and has no backward, and the NumPy oracle has no
gradient.
"""

from __future__ import annotations

FORWARD = "forward"
GRADIENT = "gradient"

XLA = "xla"
KERNEL = "pallas"
NUMPY = "numpy"

GPU_FORWARD_ROUTE = KERNEL


class RouteError(ValueError):
    """No route serves this pass on this platform."""


def choose_route(pass_: str, requested: str = "auto",
                 platform: str | None = None) -> str:
    """Route for ``pass_`` (FORWARD or GRADIENT) -> XLA, KERNEL or NUMPY.

    ``requested`` is the user's ``--backend``: "auto", "jax" (= XLA),
    "pallas" (= KERNEL) or "numpy". ``platform`` defaults to JAX's first
    device's platform."""
    if pass_ not in (FORWARD, GRADIENT):
        raise ValueError(f"unknown pass {pass_!r}")
    if requested not in ("auto", "jax", KERNEL, NUMPY):
        raise ValueError(f"unknown backend {requested!r}")
    if requested == NUMPY:
        if pass_ == GRADIENT:
            raise RouteError("--backend numpy is not differentiable; use "
                             "--backend jax or auto")
        return NUMPY
    if platform is None:
        import jax

        platform = jax.devices()[0].platform
    if platform not in ("cpu", "gpu"):
        raise RouteError(f"no render route for platform {platform!r}; "
                         "supported: cpu, gpu")
    if requested == "jax":
        return XLA
    if requested == KERNEL:
        if pass_ == GRADIENT:
            raise RouteError("--backend pallas renders forward only; "
                             "gradients use --backend jax or auto")
        if platform != "gpu":
            raise RouteError("--backend pallas needs a GPU; this host's "
                             f"platform is {platform!r}")
        return KERNEL
    if platform == "gpu" and pass_ == FORWARD:
        return GPU_FORWARD_ROUTE
    return XLA

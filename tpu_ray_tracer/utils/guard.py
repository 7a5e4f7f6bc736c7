"""Device-side error surface: the ``checkCudaErrors`` analog.

The reference wraps every CUDA call in ``checkCudaErrors``/``getLastCudaError``
which print ``file:line code(name) "expr"`` and terminate
(reference: include/helper_cuda_opengl.h:13-44). A JAX render has no per-call
error codes — the failure mode that actually occurs is numeric: non-finite
pixels escaping the masked-lane arithmetic. This module gives that failure a
first-class, opt-in surface:

* ``checked(render_fn)`` — wraps a jittable render function with
  ``jax.experimental.checkify`` user checks so the non-finite test runs ON
  DEVICE inside the same jit (no extra transfer), raising
  ``RenderCheckError`` at the call site when it trips. Only user checks are
  enabled: the render paths intentionally produce inf/NaN in masked lanes
  (e.g. background falloff at t = 0), so instrumenting every float op would
  drown in false positives — the contract is on the OUTPUT.
* ``check_image(image)`` — host-side: locates the offending pixels and
  raises ``RenderCheckError`` listing their (row, col) indices and values,
  the debugging detail the reference's print-and-exit never had.

Wired into the CLI as ``render --check`` (print error and exit nonzero,
mirroring the reference's error path at src/ray-tracer.cpp:151-158).
"""

from __future__ import annotations

import numpy as np


class RenderCheckError(RuntimeError):
    """Non-finite pixels (or a failed device-side check) in a render."""


def checked(render_fn):
    """Wrap a jittable ``(*args) -> image`` with an on-device finiteness
    check. Returns a callable with the same signature that raises
    ``RenderCheckError`` when the rendered image contains non-finite values.

    The check executes inside the jitted computation (checkify user-check),
    so it costs one reduction on device — not a host round-trip per call.
    """
    import jax.numpy as jnp
    from jax.experimental import checkify

    def body(*args, **kwargs):
        image = render_fn(*args, **kwargs)
        checkify.check(
            jnp.all(jnp.isfinite(image)),
            "non-finite pixels in render output",
        )
        return image

    checked_fn = checkify.checkify(body, errors=checkify.user_checks)

    def wrapper(*args, **kwargs):
        err, image = checked_fn(*args, **kwargs)
        try:
            err.throw()
        except checkify.JaxRuntimeError as exc:
            raise RenderCheckError(str(exc)) from None
        return image

    return wrapper


def find_nonfinite(image):
    """(row, col) indices of pixels with any non-finite channel."""
    arr = np.asarray(image)
    bad = ~np.isfinite(arr).all(axis=-1)
    ys, xs = np.nonzero(bad)
    return list(zip(ys.tolist(), xs.tolist()))


def check_image(image, context: str = "render"):
    """Raise ``RenderCheckError`` naming the offending pixels, else return
    the image unchanged."""
    idx = find_nonfinite(image)
    if idx:
        arr = np.asarray(image)
        sample = ", ".join(
            f"({y},{x})={arr[y, x].tolist()}" for y, x in idx[:8]
        )
        more = "" if len(idx) <= 8 else f" (+{len(idx) - 8} more)"
        raise RenderCheckError(
            f"{context}: {len(idx)} non-finite pixel(s): {sample}{more}"
        )
    return image

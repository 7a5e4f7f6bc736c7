"""Ray-surface intersection with an implicit-function-theorem custom VJP.

Forward: expand F(o + t*d) per object into a cubic in t (``poly.ray_poly_coeffs``)
and select the reference's root (``roots.min_positive_root``), optionally
polished by Newton steps — the vectorized analogue of reference
``intersect_ray`` (include/surface_impl.h:21-155).

Backward: rather than differentiating through Cardano/acos (numerically
fragile near branch points), we use the implicit function theorem at the
root: with g(t; coefs, o, d) = F(o + t*d),

    dt/dtheta = -(dg/dtheta) / (dg/dt)        at g(t) = 0

where dg/dt = grad F . d, dg/dcoefs_m = monomial_m(o + t*d),
dg/do = grad F, dg/dd = t * grad F. Lanes with no valid positive root or a
grazing hit (|dg/dt| below a clamp) receive zero gradient — the discrete
branch/selection structure is treated as locally constant (stop-gradient),
which is the standard differentiable-rendering treatment for visibility.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .constants import EPS, MAX_T
from .poly import monomial_basis, poly_gradient, ray_poly_coeffs
from .roots import make_newton_polisher, min_positive_root

# Below this |dF/dt| the hit is grazing and dt/dtheta blows up; zero it out.
_GRAZING_CLAMP = 1e-6


@partial(jax.custom_vjp, nondiff_argnums=(3,))
def intersect_all(coefs, origin, dir, polish_iters: int = 0):
    """Ray parameters for all (ray, object) pairs.

    Args:
      coefs: [N, 20] object coefficients.
      origin: [..., 3] ray origins.
      dir: [..., 3] ray directions.
      polish_iters: Newton refinement steps (static; 0 for the f64 golden
        path, ~2 for the f32 fast path).

    Returns:
      t: [..., N] per the reference's return-value semantics (may be
      negative / -1 on miss; validity is decided by the caller via
      ``EPS <= t < MAX_T``, reference src/update-cpu.cpp:52).
    """
    t3, t2, t1, t0 = ray_poly_coeffs(coefs, origin, dir)
    polish_fn = make_newton_polisher(coefs, origin, dir, polish_iters)
    return min_positive_root(t3, t2, t1, t0, polish_fn)


def _intersect_fwd(coefs, origin, dir, polish_iters):
    t = intersect_all(coefs, origin, dir, polish_iters)
    return t, (coefs, origin, dir, t)


def _intersect_bwd(polish_iters, residuals, g):
    coefs, origin, dir, t = residuals
    # Point on each object's candidate hit: [..., N, 3]
    point = origin[..., None, :] + t[..., None] * dir[..., None, :]
    grad_f = poly_gradient(coefs, point)                      # [..., N, 3]
    df_dt = jnp.sum(grad_f * dir[..., None, :], axis=-1)      # [..., N]

    valid = (t >= EPS) & (t < MAX_T) & (jnp.abs(df_dt) > _GRAZING_CLAMP)
    inv = jnp.where(valid, -1.0 / jnp.where(valid, df_dt, 1.0), 0.0)
    scale = g * inv                                           # [..., N]

    # dg/dcoefs_m = monomial_m(point): accumulate over rays -> [N, 20]
    basis = monomial_basis(point)                             # [..., N, 20]
    d_coefs = jnp.sum(
        (scale[..., None] * basis).reshape(-1, *basis.shape[-2:]), axis=0
    ).astype(coefs.dtype)

    # dg/do = grad F, dg/dd = t * grad F: reduce over objects -> [..., 3]
    d_origin = jnp.sum(scale[..., None] * grad_f, axis=-2).astype(origin.dtype)
    d_dir = jnp.sum((scale * t)[..., None] * grad_f, axis=-2).astype(dir.dtype)
    return d_coefs, d_origin, d_dir


intersect_all.defvjp(_intersect_fwd, _intersect_bwd)


def valid_hit_mask(t):
    """Primary-hit validity: ``EPS <= t < MAX_T`` (reference:
    src/update-cpu.cpp:52)."""
    return (t >= EPS) & (t < MAX_T)


def occluder_mask(t, max_t):
    """Shadow-ray occlusion validity: ``EPS < t < max_t`` — note the strict
    lower bound, unlike primary hits (reference: src/update-cpu.cpp:68)."""
    return (t > EPS) & (t < max_t)

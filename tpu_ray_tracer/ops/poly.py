"""Trivariate polynomial evaluation and ray-restriction expansion, vectorized.

The reference expands F(origin + t*dir) into a cubic in t with hand-written
macros, one object at a time (reference: include/surface_impl.h:25-103). Here
the same expansion is expressed as four basis matrices: for a batch of rays,

    basis_k[..., m] = coefficient of t^k in monomial_m(origin + t*dir)

so the polynomial-in-t coefficients for *all* objects at once are batched
contractions ``t_k = basis_k @ coefs.T`` of shape ``[..., 20] x [20, N] ->
[..., N]`` — dense vector math instead of a scalar per-object loop.

The expansion table is generated from the monomial exponents via the binomial
theorem at import time, which provably matches the reference's macro algebra
(COEF_3/COEF_2_3/COEF_2_21/... at surface_impl.h:25-41) — both are the unique
polynomial expansion of (o_x + t d_x)^px (o_y + t d_y)^py (o_z + t d_z)^pz.
"""

from __future__ import annotations

from functools import partial
from math import comb

import jax
import jax.numpy as jnp

from ..models.surface import MONOMIAL_POWERS, N_COEFS

# _EXPANSION[k][m] = [(binom_coeff, (origin powers), (dir powers)), ...] such
# that coefficient of t^k in monomial_m(o + t*d) = sum of
# binom * o_x^ix o_y^iy o_z^iz * d_x^jx d_y^jy d_z^jz with jx+jy+jz = k.
def _build_expansion():
    table = [[[] for _ in range(N_COEFS)] for _ in range(4)]
    for m, (px, py, pz) in enumerate(MONOMIAL_POWERS):
        for jx in range(px + 1):
            for jy in range(py + 1):
                for jz in range(pz + 1):
                    k = jx + jy + jz
                    coeff = comb(px, jx) * comb(py, jy) * comb(pz, jz)
                    table[k][m].append(
                        (float(coeff), (px - jx, py - jy, pz - jz), (jx, jy, jz))
                    )
    return table


_EXPANSION = _build_expansion()


def _powers(x, y, z, max_pow=3):
    """Cache x^e, y^e, z^e for e in [0, max_pow]."""
    cache = [[None] * (max_pow + 1) for _ in range(3)]
    comps = (x, y, z)
    for axis in range(3):
        cache[axis][0] = None  # power 0 contributes nothing (factor 1)
        cache[axis][1] = comps[axis]
        for e in range(2, max_pow + 1):
            cache[axis][e] = cache[axis][e - 1] * comps[axis]
    return cache


def _product(cache, powers, scalar_one):
    """Product of cached powers; returns `scalar_one` for the empty product."""
    out = None
    for axis, e in enumerate(powers):
        if e == 0:
            continue
        term = cache[axis][e]
        out = term if out is None else out * term
    return scalar_one if out is None else out


def ray_basis(origin, dir):
    """Per-ray expansion basis.

    Args:
      origin: [..., 3] ray origins.
      dir: [..., 3] ray directions (need not be normalized).

    Returns:
      (b3, b2, b1, b0), each [..., 20]: coefficient of t^k in each monomial
      restricted to the ray, matching reference surface_impl.h:25-41.
    """
    origin, dir = jnp.broadcast_arrays(origin, dir)
    o = _powers(origin[..., 0], origin[..., 1], origin[..., 2])
    d = _powers(dir[..., 0], dir[..., 1], dir[..., 2])
    one = jnp.ones_like(origin[..., 0])

    out = []
    for k in range(3, -1, -1):
        cols = []
        for m in range(N_COEFS):
            acc = None
            for coeff, o_pows, d_pows in _EXPANSION[k][m]:
                term = _product(o, o_pows, one) * _product(d, d_pows, one)
                if coeff != 1.0:
                    term = term * coeff
                acc = term if acc is None else acc + term
            cols.append(acc if acc is not None else jnp.zeros_like(one))
        out.append(jnp.stack(cols, axis=-1))
    b3, b2, b1, b0 = out
    return b3, b2, b1, b0


def ray_poly_coeffs(coefs, origin, dir):
    """Cubic-in-t coefficients of F(origin + t*dir) for every object.

    Args:
      coefs: [N, 20] object coefficient matrix.
      origin: [..., 3], dir: [..., 3].

    Returns:
      (t3, t2, t1, t0), each [..., N] — the reference's t3/t2/t1/t0
      (surface_impl.h:44-103) for all ray x object pairs.
    """
    b3, b2, b1, b0 = ray_basis(origin, dir)
    # Full-f32 contraction: a reduced default matmul precision (TF32 on the
    # GPU, bf16 passes on some CPU lowerings) is catastrophic for the root
    # solve's cancellation-heavy coefficients — observed as wholesale
    # hit/miss flips. HIGHEST forces true f32 dots.
    contract = partial(
        jnp.einsum, "...m,nm->...n", precision=jax.lax.Precision.HIGHEST
    )
    return (
        contract(b3, coefs),
        contract(b2, coefs),
        contract(b1, coefs),
        contract(b0, coefs),
    )


def monomial_basis(point):
    """[..., 20] values of every monomial at `point` (for F evaluation and
    the coefficient-gradient of the implicit function theorem VJP)."""
    p = _powers(point[..., 0], point[..., 1], point[..., 2])
    one = jnp.ones_like(point[..., 0])
    return jnp.stack(
        [_product(p, pows, one) for pows in MONOMIAL_POWERS], axis=-1
    )


def eval_poly(coefs, point):
    """F(point) per object: coefs [..., 20] (possibly gathered per ray),
    point [..., 3] -> [...]."""
    basis = monomial_basis(point)
    return jnp.sum(coefs * basis, axis=-1)


def eval_poly_magnitude(coefs, point):
    """sum_m |coef_m * monomial_m(point)| — the evaluation's absolute
    magnitude, the natural scale for root-residual tests (a genuine root has
    |F| of order eps * magnitude; a fake candidate does not)."""
    basis = monomial_basis(point)
    return jnp.sum(jnp.abs(coefs * basis), axis=-1)


def poly_gradient(coefs, point):
    """Unnormalized gradient of F at `point` (closed form, matching
    reference normal_vector before normalization, surface_impl.h:157-172).

    Args:
      coefs: [..., 20] per-ray gathered coefficients (or broadcastable).
      point: [..., 3].

    Returns:
      [..., 3] gradient dF/d(x, y, z).
    """
    p = _powers(point[..., 0], point[..., 1], point[..., 2])
    one = jnp.ones_like(point[..., 0])
    grads = []
    for axis in range(3):
        cols = []
        for px, py, pz in MONOMIAL_POWERS:
            pows = [px, py, pz]
            e = pows[axis]
            if e == 0:
                cols.append(jnp.zeros_like(one))
                continue
            dpows = list(pows)
            dpows[axis] = e - 1
            term = _product(p, dpows, one)
            if e != 1:
                term = term * float(e)
            cols.append(term)
        dbasis = jnp.stack(cols, axis=-1)
        grads.append(jnp.sum(coefs * dbasis, axis=-1))
    return jnp.stack(grads, axis=-1)


def normal_vector(coefs, point):
    """Unit surface normal = normalized gradient (reference:
    surface_impl.h:157-172)."""
    grad = poly_gradient(coefs, point)
    norm = jnp.linalg.norm(grad, axis=-1, keepdims=True)
    return grad / jnp.where(norm > 0, norm, 1.0)

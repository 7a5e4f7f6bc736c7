"""Branch-free vectorized polynomial root selection.

Re-implements the reference's ``intersect_ray`` root-finding tail
(reference: include/surface_impl.h:106-154) as masked vector math so one
call solves every (ray, object) pair at once:

* degree 3 (|t3| > EPS): depressed-cubic Cardano when the discriminant is
  positive (single real root, returned unconditionally even if negative —
  reference surface_impl.h:114-120); trigonometric (Viete) formula when three
  real roots exist, with the reference's *asymmetric* selection: start from
  the k=0 candidate without checking >= EPS, replace only by candidates that
  are >= EPS and strictly smaller (surface_impl.h:121-135).
* degree 2 (|t2| > EPS): smaller quadratic root if >= EPS, else the larger
  root even if negative; -1 on negative discriminant (surface_impl.h:138-149).
* degree 1 (|t1| > EPS): -t0/t1 (surface_impl.h:150-153).
* else: -1 (surface_impl.h:154).

All branches are evaluated with sanitized operands (no NaN poisoning) and
combined with ``jnp.where``; classification thresholds use the reference's
EPS = 1e-7 on the raw (unnormalized) coefficients.
"""

from __future__ import annotations

import jax.numpy as jnp

from .constants import EPS, TWO_THIRD_PI
from .poly import eval_poly, eval_poly_magnitude, poly_gradient


def _safe_div(num, den):
    """num/den with 1.0 substituted for near-zero denominators; callers mask
    the result out of the final select."""
    return num / jnp.where(den == 0, jnp.ones_like(den), den)


def min_positive_root(t3, t2, t1, t0, polish_fn=None):
    """Select a ray parameter following the reference's branch semantics.

    Args/returns are broadcast-compatible arrays; the result contains the
    reference's per-pair return value (possibly negative or -1 for miss).

    polish_fn: optional ``t -> refined t`` applied to every *candidate*
    root before the selection comparisons. The f32 fast path passes a
    direct-evaluation Newton refiner here: candidate accuracy (not branch
    algebra) is what decides the >= EPS / strictly-smaller comparisons, so
    polishing candidates first makes f32 selection agree with f64.
    """
    dtype = jnp.result_type(t3, t2, t1, t0)
    eps = jnp.asarray(EPS, dtype)
    neg_one = jnp.asarray(-1.0, dtype)
    polished = polish_fn is not None
    if polish_fn is None:
        polish_fn = lambda t: t  # noqa: E731

    is_cubic = jnp.abs(t3) > eps
    is_quad = jnp.abs(t2) > eps
    is_lin = jnp.abs(t1) > eps

    # --- cubic branch (reference surface_impl.h:107-136) ---
    s3 = jnp.where(is_cubic, t3, jnp.ones_like(t3))
    a = t2 / s3
    b = t1 / s3
    c = t0 / s3
    # Scale-normalize t = s*u before the discriminant: near-degenerate
    # cubics (|t3| barely above EPS) give |a| ~ 1e6+, and q^3 + r^2 then
    # overflows f32. The substitution keeps q, r, delta O(1) and preserves
    # the discriminant's sign exactly (delta scales by s^-6 > 0), so branch
    # selection matches the reference's unscaled double math.
    s = jnp.maximum(
        jnp.maximum(jnp.abs(a), jnp.sqrt(jnp.abs(b))),
        jnp.maximum(jnp.cbrt(jnp.abs(c)), jnp.asarray(1e-30, dtype)),
    )
    a = a / s
    b = b / (s * s)
    c = c / (s * s * s)
    q = (3.0 * b - a * a) / 9.0
    r = (9.0 * a * b - 27.0 * c - 2.0 * a * a * a) / 54.0
    delta = q * q * q + r * r

    # delta > 0: Cardano, single real root, returned unconditionally.
    sqrt_delta = jnp.sqrt(jnp.maximum(delta, 0.0))
    cardano = polish_fn(
        s * (jnp.cbrt(r + sqrt_delta) + jnp.cbrt(r - sqrt_delta) - a / 3.0)
    )

    # delta <= 0: three real roots via the trigonometric formula. Here
    # q <= 0 (since q^3 <= -r^2 <= 0), so -q >= 0.
    q_neg = jnp.maximum(-q, 0.0)
    denom = jnp.sqrt(q_neg * q_neg * q_neg)
    ratio = jnp.clip(_safe_div(r, denom), -1.0, 1.0)
    theta = jnp.arccos(ratio) / 3.0
    two_sqrt_q = 2.0 * jnp.sqrt(q_neg)
    a_third = a / 3.0
    trig = [
        polish_fn(s * (two_sqrt_q * jnp.cos(theta + k * TWO_THIRD_PI) - a_third))
        for k in (0.0, 1.0, 2.0)
    ]

    if polished:
        # Robust selection for the refined fast path. With candidates
        # polished onto the true real-root set (and non-roots rejected),
        # the reference's asymmetric rule — start from the largest trig
        # root, replace by strictly-smaller candidates >= EPS; Cardano
        # returned unconditionally — reduces exactly to "smallest genuine
        # root >= EPS, else miss": every sub-EPS outcome is a miss either
        # way. Taking the min over *all* candidates removes the f32
        # sensitivity to the sign of delta (near-degenerate cubics flip it),
        # while agreeing with the branch form wherever f64 agrees with
        # itself. For |t3| barely above EPS the trig/Cardano seeds are
        # garbage, so the roots of the dominant-balance quadratic
        # t2 t^2 + t1 t + t0 are seeded as extra candidates — for such
        # cubics the true small roots are near them (the third root is
        # ~ -t2/t3, huge), and for well-conditioned cubics they either
        # converge to genuine roots or get rejected.
        sq2 = jnp.where(jnp.abs(t2) > eps, t2, jnp.ones_like(t2))
        qdisc = t1 * t1 - 4.0 * t2 * t0
        qsq = jnp.sqrt(jnp.maximum(qdisc, 0.0))
        sub_lo = polish_fn((-t1 - qsq) / (2.0 * sq2))
        sub_hi = polish_fn((-t1 + qsq) / (2.0 * sq2))
        big = jnp.asarray(2.0 * _FAKE_ROOT, dtype)
        cubic_root = jnp.full_like(t3, big)
        for cand in (cardano, *trig, sub_lo, sub_hi):
            take = (cand >= eps) & (cand < cubic_root)
            cubic_root = jnp.where(take, cand, cubic_root)
        cubic_root = jnp.where(cubic_root >= big, neg_one, cubic_root)
    else:
        # Exact reference branching (golden path, f64).
        x = trig[0]
        for cand in trig[1:]:
            x = jnp.where((cand >= eps) & (cand < x), cand, x)
        cubic_root = jnp.where(delta > 0, cardano, x)

    # --- quadratic branch (reference surface_impl.h:138-149) ---
    s2 = jnp.where(is_quad, t2, jnp.ones_like(t2))
    disc = t1 * t1 - 4.0 * t2 * t0
    sqrt_disc = jnp.sqrt(jnp.maximum(disc, 0.0))
    lo = polish_fn((-t1 - sqrt_disc) / (2.0 * s2))
    hi = polish_fn((-t1 + sqrt_disc) / (2.0 * s2))
    quad_root = jnp.where(disc < 0, neg_one, jnp.where(lo >= eps, lo, hi))

    # --- linear branch (reference surface_impl.h:150-153) ---
    lin_root = -_safe_div(t0, jnp.where(is_lin, t1, jnp.ones_like(t1)))

    return jnp.where(
        is_cubic,
        cubic_root,
        jnp.where(is_quad, quad_root, jnp.where(is_lin, lin_root, neg_one)),
    )


# Sanitized value for candidates that fail the genuine-root residual test:
# past MAX_T so hit-validity rejects them, and larger than any real candidate
# so the strictly-smaller selection never picks them.
_FAKE_ROOT = 2e6
# |F(p)| must be below this fraction of the evaluation magnitude for a
# polished candidate to count as a root. Genuine roots polish to ~1e-7
# relative; grazing near-misses bottom out around 1e-4..1e-5 relative.
_RESIDUAL_TOL = 1e-5


def make_newton_polisher(coefs, origin, dir, iters: int):
    """Build a candidate refiner ``t [..., N] -> t`` for ``min_positive_root``.

    Newton steps against a *direct* evaluation of F(origin + t*dir) — not the
    expanded t-polynomial — so the refinement is free of the expansion's
    cancellation error. This is the core of the f32 fast path: the analytic
    solver supplies branch structure and seeds, direct Newton supplies the
    final bits.

    After refinement a residual test rejects candidates that are not genuine
    roots (f32 branch misclassification on near-degenerate cubics produces
    phantom candidates the f64 reference never returns); rejects are mapped
    past MAX_T so they read as misses, which is what the reference's f64
    arithmetic yields in those lanes. Negative candidates are left untouched
    — the reference's semantics (e.g. Cardano's unconditional return) rely
    on their sign only.

    Args:
      coefs: [N, 20]; origin/dir: [..., 3] (broadcast against candidates).
    """
    if iters <= 0:
        return None

    def polish(t):
        seed = t
        step = jnp.zeros_like(t)
        for _ in range(iters):
            point = origin[..., None, :] + t[..., None] * dir[..., None, :]
            f = eval_poly(coefs, point)
            df = jnp.sum(poly_gradient(coefs, point) * dir[..., None, :], axis=-1)
            ok_df = jnp.abs(df) > 1e-12
            step = jnp.where(ok_df, f / jnp.where(ok_df, df, 1.0), 0.0)
            t_new = t - step
            t = jnp.where(jnp.isfinite(t_new), t_new, t)
        point = origin[..., None, :] + t[..., None] * dir[..., None, :]
        residual = jnp.abs(eval_poly(coefs, point))
        magnitude = eval_poly_magnitude(coefs, point)
        genuine = residual <= _RESIDUAL_TOL * magnitude
        fake = jnp.asarray(_FAKE_ROOT, t.dtype)
        # Genuine roots keep their polished value. Non-roots: a negative
        # seed stays negative (it reads as a miss and sign-based reference
        # semantics survive); a positive fake candidate is pushed past
        # MAX_T so neither validity nor strictly-smaller selection takes it.
        return jnp.where(genuine, t, jnp.where(seed < 0, seed, fake))

    return polish

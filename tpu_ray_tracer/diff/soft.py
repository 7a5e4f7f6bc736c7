"""Soft-visibility rendering for inverse problems on multi-sheet surfaces.

The pipeline's gradients are implicit-function-theorem gradients at the
selected root — exact almost everywhere, but blind to the jumps where the
set of real roots itself changes. For multi-sheet cubics (Clebsch), the
loss trend over large surface-coefficient perturbations is carried almost
entirely by those jumps: pixels whose nearest sheet appears or disappears.
Measured on clebsch.yml's constant term, the smooth a.e. gradient points
AWAY from the truth on both sides of the minimum, so plain first-order
descent stalls (ARCHITECTURE.md "Differentiability: scope and limitation").

The jump events are root PAIR creation/annihilation, and they happen
exactly where the depressed cubic's discriminant delta = q^3 + r^2 crosses
zero — a quantity the solver already computes, and a smooth function of the
surface coefficients. This module exploits that:

* ``pair_coverage`` returns the normalized discriminant
  ``delta_n = (r^2 + q^3) / (r^2 + |q|^3)  in [-1, 1]`` per (ray, object):
  negative iff three real roots (a sheet pair exists ahead), crossing 0
  smoothly at every silhouette/sheet-merge event.
* ``render_rays_soft`` renders TWO hard images — branch A with the normal
  root selection, branch B with the merging pair excluded (the world in
  which the pair has annihilated) — and blends them per pixel with
  ``alpha = sigmoid(-delta_n / tau)``. In the one-real-root region A == B,
  so the blend is exact there; across a pair event the blend interpolates
  continuously between "sheet visible" and "sheet gone", giving the loss a
  usable gradient THROUGH the event. As tau -> 0 the soft render converges
  to the hard render (continuation: anneal tau, or finish with the hard
  loss).

Scope: the pair blend is driven by the pixel's GOVERNING object — the
selected hit, or (for misses) the object closest to producing a pair — so
each pixel smooths the sheet/silhouette events of the object that owns it.
The r4 extension covers quadric objects too: their pair event is the
quadratic discriminant crossing zero (the silhouette of a sphere or
paraboloid), with branch B the world where the quadric contributes no
root, which makes multi-object coefficient recoveries (e.g. a sphere
constant term jointly with a cubic's — see
tests/test_soft.py::test_multi_object_recovery_without_mask) descend
without gradient masks. Cross-OBJECT boundaries and shadow booleans stay
hard (stop-gradient) — and the r5 probe measured that this is NOT a
practical limitation: (a) an occluding silhouette (A's limb against B) is
a pair event of A, so branch B already reveals the object behind; (b) a
t-ORDERING boundary (B poking through A; both objects keep real roots,
only the nearest-hit order swaps along the 3-D intersection curve) is
depth-CONTINUOUS (the surfaces meet where the order swaps), so the smooth
IFT gradient carries the signal — measured: clean V-shaped loss at truth,
FD == AD on both branches, single-parameter hard recovery to < 1e-2
(tests/test_soft.py::test_cross_object_ordering_boundary_descends_hard).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..models.scene import Scene
from ..ops.constants import EPS, MAX_T, SHADOW_BIAS, TWO_THIRD_PI
from ..ops.poly import normal_vector, ray_poly_coeffs
from ..ops.roots import _FAKE_ROOT, make_newton_polisher
from ..ops.shading import shadow_ray_dirs, surface_color
from ..ops.intersect import (
    _intersect_bwd, occluder_mask, valid_hit_mask, intersect_all,
)


@jax.custom_vjp
def _ift_root(coefs, origin, dir, t):
    """Identity on a (detached) root table that reattaches gradients via the
    implicit function theorem — the same backward rule as ``intersect_all``.
    Lets branch-B roots be computed with arbitrary non-differentiable
    machinery (acos/cbrt seeds, candidate masking) without autodiff ever
    traversing it."""
    return t


def _ift_fwd(coefs, origin, dir, t):
    return t, (coefs, origin, dir, t)


def _ift_bwd(res, g):
    d_coefs, d_origin, d_dir = _intersect_bwd(0, res, g)
    return d_coefs, d_origin, d_dir, jnp.zeros_like(res[3])


_ift_root.defvjp(_ift_fwd, _ift_bwd)


def _normalized_qr(t3, t2, t1, t0):
    """Scale-normalized depressed-cubic (q, r, s, a) per (ray, object) —
    the same normalization as ops.roots.min_positive_root."""
    dtype = jnp.result_type(t3, t2, t1, t0)
    eps = jnp.asarray(EPS, dtype)
    is_cubic = jnp.abs(t3) > eps
    s3 = jnp.where(is_cubic, t3, jnp.ones_like(t3))
    a = t2 / s3
    b = t1 / s3
    c = t0 / s3
    # The scale is sign/structure-only (delta scales by s^-6 > 0); detach it
    # so autodiff never traverses cbrt/sqrt at zero (inf gradients).
    s = jax.lax.stop_gradient(jnp.maximum(
        jnp.maximum(jnp.abs(a), jnp.sqrt(jnp.abs(b))),
        jnp.maximum(jnp.cbrt(jnp.abs(c)), jnp.asarray(1e-30, dtype)),
    ))
    a = a / s
    b = b / (s * s)
    c = c / (s * s * s)
    q = (3.0 * b - a * a) / 9.0
    r = (9.0 * a * b - 27.0 * c - 2.0 * a * a * a) / 54.0
    return q, r, s, a, is_cubic


def pair_coverage(coefs, origin, dir, pair_kinds=None,
                  quad_width: float = 0.01):
    """Normalized pair discriminant ``delta_n in [-1, 1]`` per
    (ray, object): < 0 iff a root pair exists ahead, smoothly crossing 0
    at pair creation/annihilation.

    Cubic rays use the depressed cubic's discriminant (three real roots
    <=> a sheet pair exists). Quadric rays (r4 extension — the quadric
    analogue of the same event) use the quadratic discriminant
    ``t1^2 - 4 t2 t0``: its zero crossing IS the silhouette of a sphere/
    paraboloid, where the hit pair appears or annihilates, so e.g. a
    sphere-radius recovery gets a usable gradient across its silhouette
    instead of a hard jump. Linear rays return +1 (a single root never
    appears or vanishes; the blend is inert — branch B equals branch A).

    ``pair_kinds`` (static per-object tuple, True = cubic-class; derive it
    from the problem TEMPLATE like the kernel's degree partition) pins
    which discriminant each object uses. It matters during coefficient
    DESCENT: the moment a sphere's cubic entries drift off exact zero,
    its rays classify as near-degenerate cubics whose normalized
    discriminant is pure f32 cancellation noise (q^3 and r^2 cancel to
    O(t3) for t3 -> 0) — measured in-session, that noise-signed alpha
    destroys the optimization within ~5 Adam steps. With the static
    routing the quadric-class object keeps the accurate quadratic
    discriminant for the whole run. None falls back to the per-ray
    |t3| > EPS test (fine for frozen-coefficient evaluation).

    ``quad_width`` sets the quadric transition width as a fraction of the
    coefficient scale (the 0.01*qscale term below). The default is tuned
    to the bundled scenes' distance/radius ratios: for a sphere of radius
    r at distance D the on-sphere discriminant fraction is ~(r/D)^2/2,
    so once D/r exceeds ~30 the knee falls below disc/qscale, delta_q
    saturates toward 0 over the whole sphere, and the blend leaks a
    visible fraction of branch B (object deleted) at any useful tau.
    Large-scene inverse problems should shrink ``quad_width`` (roughly
    (r/D)^2/20) rather than raise tau."""
    t3, t2, t1, t0 = ray_poly_coeffs(coefs, origin, dir)
    q, r, _s, _a, is_cubic = _normalized_qr(t3, t2, t1, t0)
    r2 = r * r
    q3 = q * q * q
    delta_n = (r2 + q3) / (r2 + jnp.abs(q3) + 1e-30)
    # Self-referential normalization: |disc| dominates away from the event
    # (delta -> -sign(disc), i.e. +-1), while the small coefficient-scale
    # fraction sets the transition width. A plain coefficient-scale
    # denominator is wrong for distant quadrics: a robust sphere hit at
    # distance D has disc/(t1^2 + 4 t2 t0) ~ (r/D)^2/2 — delta ~ -0.03 for
    # the bundled scenes, alpha ~ 0.55 at any useful tau, and the blend
    # showed half background across the WHOLE sphere (measured; descent
    # then moved both test radii in the wrong direction).
    qdisc = t1 * t1 - 4.0 * t2 * t0
    qscale = t1 * t1 + jnp.abs(4.0 * t2 * t0)
    delta_q = -qdisc / (jnp.abs(qdisc) + quad_width * qscale + 1e-30)
    ones = jnp.ones_like(delta_n)
    is_quad = jnp.abs(t2) > jnp.asarray(EPS, t2.dtype)
    cubic_col = jnp.where(is_cubic, delta_n, ones)
    quad_col = jnp.where(is_quad, delta_q, ones)
    if pair_kinds is None:
        return jnp.where(is_cubic, delta_n, quad_col)
    kinds = jnp.asarray(np.asarray(pair_kinds, bool))
    return jnp.where(kinds, cubic_col, quad_col)


def _roots_excluding_pair(coefs, origin, dir, polish_iters: int,
                          pair_kinds=None):
    """Per-(ray, object) root as if the merging pair had already
    annihilated: cubic-class objects get the reference's polished-selection
    semantics with the two pair candidates removed; quadric-class objects
    contribute NO root (both of their intersections ARE the pair). For
    delta > 0 (and for linear rays) this equals the normal selection.
    ``pair_kinds`` routes statically per object (see ``pair_coverage``)."""
    t3, t2, t1, t0 = ray_poly_coeffs(coefs, origin, dir)
    q, r, s, a, is_cubic = _normalized_qr(t3, t2, t1, t0)
    dtype = q.dtype
    eps = jnp.asarray(EPS, dtype)
    polish = make_newton_polisher(coefs, origin, dir, max(1, polish_iters))

    delta = q * q * q + r * r
    sqrt_delta = jnp.sqrt(jnp.maximum(delta, 0.0))
    cardano = polish(
        s * (jnp.cbrt(r + sqrt_delta) + jnp.cbrt(r - sqrt_delta) - a / 3.0)
    )
    q_neg = jnp.maximum(-q, 0.0)
    denom = jnp.sqrt(q_neg * q_neg * q_neg)
    ratio = jnp.clip(
        r / jnp.where(denom == 0, jnp.ones_like(denom), denom), -1.0, 1.0
    )
    theta = jnp.arccos(ratio) / 3.0
    two_sqrt_q = 2.0 * jnp.sqrt(q_neg)
    a_third = a / 3.0
    trig = [
        s * (two_sqrt_q * jnp.cos(theta + k * TWO_THIRD_PI) - a_third)
        for k in (0.0, 1.0, 2.0)
    ]
    # Which two trig candidates merge at delta -> 0^-: theta -> 0 (r > 0)
    # merges k=1,2 (survivor k=0); theta -> pi/3 (r < 0) merges k=0,2
    # (survivor k=1).
    r_pos = r >= 0
    survivor = polish(jnp.where(r_pos, trig[0], trig[1]))
    pair_a = jnp.where(r_pos, trig[1], trig[0])
    pair_b = trig[2]
    # Dominant-balance quadratic candidates (kept for near-degenerate |t3|),
    # masked out where they polish onto a pair root.
    sq2 = jnp.where(jnp.abs(t2) > eps, t2, jnp.ones_like(t2))
    qdisc = t1 * t1 - 4.0 * t2 * t0
    qsq = jnp.sqrt(jnp.maximum(qdisc, 0.0))
    sub = [polish((-t1 - qsq) / (2.0 * sq2)), polish((-t1 + qsq) / (2.0 * sq2))]
    pair_tol = 1e-3 * s + 1e-6
    fake = jnp.asarray(2.0 * _FAKE_ROOT, dtype)

    big = jnp.asarray(2.0 * _FAKE_ROOT, dtype)
    cubic_root = jnp.full_like(t3, big)
    candidates = [cardano, survivor] + [
        jnp.where(
            (jnp.abs(c_ - pair_a) < pair_tol) | (jnp.abs(c_ - pair_b) < pair_tol),
            fake, c_,
        )
        for c_ in sub
    ]
    for cand in candidates:
        take = (cand >= eps) & (cand < cubic_root)
        cubic_root = jnp.where(take, cand, cubic_root)
    cubic_root = jnp.where(cubic_root >= big, jnp.asarray(-1.0, dtype), cubic_root)

    # quadric rays: the pair-annihilated world has NO root from this
    # object (both intersections are the pair — r4, see pair_coverage);
    # linear rays keep the normal selection (no pair concept)
    t_normal = intersect_all(coefs, origin, dir, polish_iters)
    miss = jnp.asarray(-1.0, dtype)
    is_quad = jnp.abs(t2) > eps
    cubic_sel = jnp.where(is_cubic, cubic_root, t_normal)
    quad_sel = jnp.where(is_quad, miss, t_normal)
    if pair_kinds is None:
        raw = jnp.where(is_cubic, cubic_root,
                        jnp.where(is_quad, miss, t_normal))
    else:
        kinds = jnp.asarray(np.asarray(pair_kinds, bool))
        raw = jnp.where(kinds, cubic_sel, quad_sel)
    # Detach the selection machinery entirely; gradients reattach through
    # the implicit function theorem at the selected root.
    return _ift_root(coefs, origin, dir, jax.lax.stop_gradient(raw))


def _shade_at(scene: Scene, origin, dir, t_all, polish_iters: int):
    """Hard nearest-hit + shading given a per-object root table (the body of
    pipeline.trace_and_shade with the solve factored out)."""
    valid = valid_hit_mask(t_all)
    hit = jnp.any(valid, axis=-1)
    t_masked = jnp.where(valid, t_all, jnp.asarray(MAX_T, t_all.dtype))
    idx = jnp.argmin(t_masked, axis=-1).astype(jnp.int32)
    best_t = jnp.take_along_axis(t_all, idx[..., None], axis=-1)[..., 0]
    best_t = jnp.where(hit, best_t, jnp.zeros_like(best_t))

    point = origin + best_t[..., None] * dir
    sel_coefs = scene.coefs[idx]
    normal = normal_vector(sel_coefs, point)
    obj_color = scene.colors[idx]

    shadow_origin = point + SHADOW_BIAS * normal
    sdir, max_t = shadow_ray_dirs(scene.light_p, scene.light_is_spherical, point)
    occ_t = intersect_all(
        jax.lax.stop_gradient(scene.coefs),
        jax.lax.stop_gradient(shadow_origin)[..., None, :],
        jax.lax.stop_gradient(sdir),
        polish_iters,
    )
    in_shadow = jnp.any(occluder_mask(occ_t, max_t[..., None]), axis=-1)
    contrib = surface_color(
        scene.light_p, scene.light_is_spherical, scene.light_color,
        point, normal, obj_color,
    )
    lit = jnp.sum(jnp.where(in_shadow[..., None], 0.0, contrib), axis=-2)
    lit = jnp.minimum(jnp.float32(1.0), lit)
    bg = scene.bg_color.astype(jnp.float32)
    return jnp.where(hit[..., None], lit, bg), hit, idx


def render_rays_soft(scene: Scene, origin, dir, *, polish_iters: int = 3,
                     tau: float = 0.05, pair_kinds=None,
                     quad_width: float = 0.01):
    """Soft-visibility render -> [..., 3] f32 (bounce-free).

    alpha-blend of the normal render (branch A) and the pair-annihilated
    render (branch B), with alpha = sigmoid(-delta_n / tau) taken from the
    pixel's governing object. Converges to the hard render as tau -> 0.
    ``pair_kinds``: static per-object cubic-class mask (see
    ``pair_coverage``) — pass it whenever coefficients are being
    optimized. ``quad_width``: quadric silhouette transition width; the
    default assumes bundled-scene distance/radius ratios (see
    ``pair_coverage`` for the scaling rule on larger scenes)."""
    if scene.n_objects == 0:
        # no objects -> no roots, no pair events; same short-circuit as
        # the hard pipeline (render_rays), differentiable w.r.t. bg_color
        bg = scene.bg_color.astype(jnp.float32)
        return jnp.broadcast_to(bg, origin.shape[:-1] + (3,))
    t_a = intersect_all(scene.coefs, origin, dir, polish_iters)
    t_b = _roots_excluding_pair(scene.coefs, origin, dir, polish_iters,
                                pair_kinds=pair_kinds)
    img_a, hit_a, idx_a = _shade_at(scene, origin, dir, t_a, polish_iters)
    img_b, _hit_b, _idx_b = _shade_at(scene, origin, dir, t_b, polish_iters)

    delta_n = pair_coverage(scene.coefs, origin, dir,
                            pair_kinds=pair_kinds,
                            quad_width=quad_width)          # [..., N]
    # governing object: the selected hit where A hits, else the object
    # closest to producing a pair (selection index is discrete: stop-grad)
    idx_gov = jnp.where(
        hit_a, idx_a, jnp.argmin(delta_n, axis=-1).astype(jnp.int32)
    )
    idx_gov = jax.lax.stop_gradient(idx_gov)
    d_sel = jnp.take_along_axis(delta_n, idx_gov[..., None], axis=-1)[..., 0]
    alpha = jax.nn.sigmoid(-d_sel / tau)[..., None]
    return alpha * img_a + (1.0 - alpha) * img_b

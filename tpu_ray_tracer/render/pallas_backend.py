"""Fused Pallas render kernel for NVIDIA GPUs, through the Triton route.

The replacement for the reference's per-pixel CUDA kernel (reference:
src/update-cuda.cu:104-158). Where the CUDA kernel maps one thread to one
pixel in 8x8 blocks, this kernel maps one program to ``BLOCK_PX``
consecutive pixels of the row-major framebuffer: ray generation, the
per-object intersection loop, shadowing and shading over lights, and the
reflection chain all run inside one kernel with the per-pixel state in
registers, and the framebuffer is written once. Scene tables (a few KB) are
whole-array refs in global memory read as scalars, the analogue of the CUDA
kernel's ``__constant__`` and ``__restrict__`` table reads (reference:
update-cuda.cu:17-27).

The math is the same refined f32 scheme as the XLA pipeline
(tpu_ray_tracer/ops/roots.py): scale-normalized analytic cubic/quadratic
solve for candidate roots, Newton refinement, residual rejection of phantom
candidates, smallest-genuine-root selection.

The kernel is forward only. ``render_image_pallas`` is differentiable
through one custom VJP that recomputes the gradient with ``jax.grad`` of the
XLA pipeline; the route chooser (``render/route.py``) never sends a gradient
pass here.
"""

from __future__ import annotations

import math
import weakref
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..models.scene import Scene
from ..models.surface import MONOMIAL_POWERS, N_COEFS
from ..ops import camera as camera_ops
from ..ops.constants import EPS, MAX_T, SHADOW_BIAS, TWO_THIRD_PI
from ..ops.poly import _EXPANSION
from ..render import pipeline as xla_pipeline

# Pixels per program (a power of two, as Triton requires) and warps per
# program. Chosen by a sweep on an H100; see PERF.md.
BLOCK_PX = 128
NUM_WARPS = 4

_FAKE_ROOT = 2e6
_RESIDUAL_TOL = 1e-5
# Newton steps of the 1-D candidate screen in ``_solve_object``: 2 steps
# doubled dingdong's boundary pixels against the f64 oracle, 3 recovered
# them at no measurable cost.
_SCREEN_ITERS = 3
# Newton steps for shadow-occlusion solves: the occlusion boolean only
# needs the root's side of (EPS, max_t), and one step off the analytic seed
# classifies the bundled scenes as the full polish does.
_SHADOW_ITERS = 1

# --- scalar-coefficient polynomial helpers (per object, block-vectorized) ---

# Monomial index 10 starts the degree-<=2 block (x2..c) in the reference's
# coefficient order (reference: include/surface.h:12-14); objects whose first
# 10 (cubic) coefficients are exactly zero yield t3 == 0 for EVERY ray, so
# the solver can statically skip the cubic machinery for them.
QUAD_START = 10


def _powers3(x, y, z, max_pow=3):
    """Cache powers up to max_pow of three per-pixel arrays."""
    cache = [[None] * 4 for _ in range(3)]
    for axis, comp in enumerate((x, y, z)):
        cache[axis][1] = comp
        cache[axis][2] = comp * comp
        if max_pow >= 3:
            cache[axis][3] = cache[axis][2] * comp
    return cache


def _prod(cache, pows, one):
    out = None
    for axis, e in enumerate(pows):
        if e == 0:
            continue
        out = cache[axis][e] if out is None else out * cache[axis][e]
    return one if out is None else out


def _ray_coeffs_scalar(coef, o_pows, d_pows, one, m_start=0, k_max=3):
    """t-polynomial coefficients for ONE object whose 20 coefficients are
    traced scalars; basis products are per-pixel arrays.

    m_start=QUAD_START restricts to the degree-<=2 monomials (for objects
    with identically-zero cubic coefficients); k_max trims the returned
    degree accordingly."""
    out = []
    for k in range(k_max, -1, -1):
        acc = None
        for m in range(m_start, N_COEFS):
            c = coef[m]
            term_sum = None
            for w, o_p, d_p in _EXPANSION[k][m]:
                t = _prod(o_pows, o_p, one) * _prod(d_pows, d_p, one)
                if w != 1.0:
                    t = t * w
                term_sum = t if term_sum is None else term_sum + t
            if term_sum is None:
                continue
            contrib = c * term_sum
            acc = contrib if acc is None else acc + contrib
        out.append(acc if acc is not None else jnp.zeros_like(one))
    return out  # [t3, t2, t1, t0]


def _eval_F_and_grad(coef, px, py, pz, m_start=0, need_mag=True,
                     need_grad=True, cache=None):
    """F(p), |terms|(p), dF(p) for scalar coefficients at per-pixel points.

    ``need_mag``/``need_grad`` statically trim the term magnitude sum
    (only the residual-rejection test reads it) and the gradient (only
    Newton steps and the surface normal read it) — the Newton loop is the
    kernel's hot inner loop, so the unused outputs are real work.
    ``cache`` shares a precomputed ``_powers3(px, py, pz)`` across objects
    evaluated at the same point."""
    p = cache if cache is not None else _powers3(
        px, py, pz, max_pow=3 if m_start == 0 else 2
    )
    one = jnp.ones_like(px)
    f = None
    mag = None
    g = [None, None, None]
    for m, pows in enumerate(MONOMIAL_POWERS):
        if m < m_start:
            continue
        mono = _prod(p, pows, one)
        term = coef[m] * mono
        f = term if f is None else f + term
        if need_mag:
            a = jnp.abs(term)
            mag = a if mag is None else mag + a
        if not need_grad:
            continue
        for axis in range(3):
            e = pows[axis]
            if e == 0:
                continue
            dpows = list(pows)
            dpows[axis] = e - 1
            dterm = coef[m] * float(e) * _prod(p, dpows, one)
            g[axis] = dterm if g[axis] is None else g[axis] + dterm
    zero = jnp.zeros_like(px)
    return f, mag, [gi if gi is not None else zero for gi in g]


def _hessian_entries(coef, cache, one):
    """Upper-triangle Hessian of F at the cached point: [Hxx, Hyy, Hzz,
    Hxy, Hxz, Hyz]. For degree <= 3 polynomials the entries are at most
    linear in the point, so this is a handful of scalar-coefficient FMAs —
    precomputed once per (object, point) and reused across every shadow
    direction via t2 = (1/2) d^T H d."""
    pairs = [(0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2)]
    out = []
    for a, b in pairs:
        acc = None
        for m, pows in enumerate(MONOMIAL_POWERS):
            p2 = list(pows)
            if a == b:
                ea = pows[a]
                if ea < 2:
                    continue
                fac = float(ea * (ea - 1))
                p2[a] = ea - 2
            else:
                ea, eb = pows[a], pows[b]
                if ea == 0 or eb == 0:
                    continue
                fac = float(ea * eb)
                p2[a] = ea - 1
                p2[b] = eb - 1
            term = coef[m] * (_prod(cache, tuple(p2), one) * fac)
            acc = term if acc is None else acc + term
        out.append(acc if acc is not None else jnp.zeros_like(one))
    return out


def _polish(coef, ox, oy, oz, dx, dy, dz, t, iters, m_start=0, reject=True):
    """Newton refinement against direct F evaluation + residual rejection
    (kernel-local analogue of ops.roots.make_newton_polisher).

    reject=False skips the residual test: analytic quadratic/linear roots
    are genuine by construction (no branch misclassification is possible
    when t3 == 0 exactly), so only cancellation needs repair."""
    seed = t
    for _ in range(iters):
        px, py, pz = ox + t * dx, oy + t * dy, oz + t * dz
        f, _, g = _eval_F_and_grad(coef, px, py, pz, m_start, need_mag=False)
        df = g[0] * dx + g[1] * dy + g[2] * dz
        ok = jnp.abs(df) > 1e-12
        step = jnp.where(ok, f / jnp.where(ok, df, 1.0), 0.0)
        t_new = t - step
        t = jnp.where(jnp.isfinite(t_new), t_new, t)
    if not reject:
        return t
    px, py, pz = ox + t * dx, oy + t * dy, oz + t * dz
    f, mag, _ = _eval_F_and_grad(coef, px, py, pz, m_start, need_grad=False)
    genuine = jnp.abs(f) <= _RESIDUAL_TOL * mag
    return jnp.where(genuine, t, jnp.where(seed < 0, seed, _FAKE_ROOT))


def _solve_object(coef, ox, oy, oz, dx, dy, dz, polish_iters):
    """Reference-semantics root for one object over a block of rays
    (kernel-local analogue of ops.roots.min_positive_root, refined mode).

    Newton budget is screen-then-refine: the five candidates are screened
    with ``_SCREEN_ITERS`` Newton steps + residual rejection on the cheap
    ASSEMBLED 1-D polynomial, the reference's min-positive selection picks
    the winner, and only the winner is polished and residual-verified
    against the full direct 20-monomial evaluation (which also repairs
    assembly error in t3..t0). Gated by the per-scene parity thresholds in
    bench.py."""
    one = jnp.ones_like(ox)
    o_pows = _powers3(ox, oy, oz)
    d_pows = _powers3(dx, dy, dz)
    t3, t2, t1, t0 = _ray_coeffs_scalar(coef, o_pows, d_pows, one)

    # The screen is NOT capped at polish_iters: it classifies/orders
    # candidates on the cheap 1-D polynomial (~8 ops/step), so deeper
    # screening is nearly free and reduces boundary-pixel misclassification
    # independent of the winner's direct polish depth.
    screen = _SCREEN_ITERS

    # 1-D screening on the ASSEMBLED t-polynomial: candidate
    # screening only needs genuineness classification + ordering, so
    # Newton runs against the 4 assembled coefficients (~8 ops/step, the
    # same structure the shadow-occlusion path was measured parity-neutral
    # with) instead of the direct 20-monomial evaluation (~120 ops/step).
    # The scan winner is then polished AND residual-verified against the
    # direct evaluation below, which also repairs assembly error in
    # t3..t0 — so a phantom candidate born of assembly error can win the
    # scan but never ship as a root.
    def feval1d(t):
        return ((t3 * t + t2) * t + t1) * t + t0

    def dfeval1d(t):
        return (3.0 * t3 * t + 2.0 * t2) * t + t1

    def pol(t):
        seed = t
        for _ in range(screen):
            df = dfeval1d(t)
            ok = jnp.abs(df) > 1e-12
            step = jnp.where(ok, feval1d(t) / jnp.where(ok, df, 1.0), 0.0)
            t_new = t - step
            t = jnp.where(jnp.isfinite(t_new), t_new, t)
        at = jnp.abs(t)
        mag = (jnp.abs(t3) * at * at * at + jnp.abs(t2) * at * at
               + jnp.abs(t1) * at + jnp.abs(t0) + 1e-30)
        genuine = jnp.abs(feval1d(t)) <= _RESIDUAL_TOL * mag
        return jnp.where(genuine, t, jnp.where(seed < 0, seed, _FAKE_ROOT))

    is_cubic = jnp.abs(t3) > EPS
    is_quad = jnp.abs(t2) > EPS
    is_lin = jnp.abs(t1) > EPS

    # cubic branch, scale-normalized
    s3 = jnp.where(is_cubic, t3, one)
    a = t2 / s3
    b = t1 / s3
    c = t0 / s3
    s = jnp.maximum(
        jnp.maximum(jnp.abs(a), jnp.sqrt(jnp.abs(b))),
        jnp.maximum(jnp.cbrt(jnp.abs(c)), 1e-30),
    )
    a = a / s
    b = b / (s * s)
    c = c / (s * s * s)
    q = (3.0 * b - a * a) / 9.0
    r = (9.0 * a * b - 27.0 * c - 2.0 * a * a * a) / 54.0
    delta = q * q * q + r * r
    sq_delta = jnp.sqrt(jnp.maximum(delta, 0.0))
    seed_cardano = s * (jnp.cbrt(r + sq_delta) + jnp.cbrt(r - sq_delta) - a / 3.0)

    q_neg = jnp.maximum(-q, 0.0)
    denom = jnp.sqrt(q_neg * q_neg * q_neg)
    ratio = jnp.clip(r / jnp.where(denom == 0, one, denom), -1.0, 1.0)
    theta = jnp.arccos(ratio) / 3.0
    two_sq = 2.0 * jnp.sqrt(q_neg)
    a3 = a / 3.0
    # Delta > 0 has exactly one real root (Cardano); Delta <= 0 has three
    # (trig) — the branches are mutually exclusive per ray, so the Cardano
    # seed shares a polish slot with trig k=0 (3 polishes, not 4). Newton
    # against the direct evaluation + residual rejection makes any seed
    # either converge to a genuine root or get discarded, so the merge
    # cannot change which roots are found.
    seed_trig0 = s * (two_sq * jnp.cos(theta) - a3)
    trig = [pol(t=jnp.where(delta > 0, seed_cardano, seed_trig0))] + [
        pol(t=s * (two_sq * jnp.cos(theta + k * TWO_THIRD_PI) - a3))
        for k in (1.0, 2.0)
    ]

    # dominant-balance quadratic seeds (near-degenerate |t3|)
    sq2 = jnp.where(is_quad, t2, one)
    qdisc = t1 * t1 - 4.0 * t2 * t0
    qsq = jnp.sqrt(jnp.maximum(qdisc, 0.0))
    sub_lo = pol(t=(-t1 - qsq) / (2.0 * sq2))
    sub_hi = pol(t=(-t1 + qsq) / (2.0 * sq2))

    big = jnp.full_like(one, 2.0 * _FAKE_ROOT)
    cubic_root = big
    for cand in (*trig, sub_lo, sub_hi):
        take = (cand >= EPS) & (cand < cubic_root)
        cubic_root = jnp.where(take, cand, cubic_root)
    # the scan winner gets the full DIRECT-evaluation Newton budget plus
    # the direct residual re-verification (reject=True): the 1-D screen
    # classified genuineness against the assembled polynomial only.
    # Boundary vs the old per-candidate direct rejection: if a PHANTOM
    # root of the f32-assembled cubic wins the scan and then fails the
    # direct residual test, the pixel becomes a miss even when a genuine
    # direct root exists farther along the ray (the old code would have
    # rejected the phantom per-candidate and let the genuine root win).
    # Not observed on the full-resolution scenes — the all-8 parity gates
    # are the guard; re-scanning on winner rejection would cost a second
    # direct polish per object for a case never observed.
    # FAKE_ROOT fallbacks (rejected candidates that still won the scan —
    # filtered by the caller's t < MAX_T cull) must stay put, not be
    # Newton-walked.
    refined = _polish(coef, ox, oy, oz, dx, dy, dz, cubic_root,
                      iters=polish_iters, reject=True)
    real = cubic_root < _FAKE_ROOT
    cubic_root = jnp.where(real, refined, cubic_root)
    cubic_root = jnp.where(cubic_root >= big, -1.0, cubic_root)

    quad_root = jnp.where(qdisc < 0, -1.0, jnp.where(sub_lo >= EPS, sub_lo, sub_hi))
    # same winner-refine for the degenerate-t3 quadratic branch
    q_ref = _polish(coef, ox, oy, oz, dx, dy, dz, quad_root,
                    iters=polish_iters, reject=False)
    quad_root = jnp.where((qdisc >= 0) & (quad_root < _FAKE_ROOT),
                          q_ref, quad_root)
    lin_root = -t0 / jnp.where(is_lin, t1, one)

    return jnp.where(
        is_cubic, cubic_root,
        jnp.where(is_quad, quad_root, jnp.where(is_lin, lin_root, -1.0)),
    )


def _solve_quadric(coef, ox, oy, oz, dx, dy, dz, polish_iters):
    """Reference-semantics root for an object with identically-zero cubic
    coefficients: t3 == 0 for every ray, so only the quadratic/linear/miss
    cascade of the reference can fire (surface_impl.h:138-154). Skips the
    whole Cardano/trig machinery — ~10x cheaper than ``_solve_object``.

    Select-then-polish: the two roots come from the cancellation-
    stable closed form (the same (lo, hi) mapping as the occlusion path's
    ``_stable_quad_roots``), the reference's ``lo >= EPS ? lo : hi``
    selection runs on them directly, and ONLY the selected root gets the
    Newton budget (fixing f32 assembly error in t2/t1/t0), capped at 2
    steps — Newton converges quadratically from the stable closed-form
    seed, so a third step refines bits below the f32 assembly noise floor.
    Halves the dominant per-object cost vs polishing both roots. The
    selection
    branch can only differ from the polish-both ordering on rays where
    Newton moves ``lo`` across EPS — a measure-zero boundary gated by the
    full-res parity thresholds."""
    one = jnp.ones_like(ox)
    o_pows = _powers3(ox, oy, oz, max_pow=2)
    d_pows = _powers3(dx, dy, dz, max_pow=2)
    t2, t1, t0 = _ray_coeffs_scalar(coef, o_pows, d_pows, one,
                                    m_start=QUAD_START, k_max=2)

    is_quad = jnp.abs(t2) > EPS
    is_lin = jnp.abs(t1) > EPS

    disc = t1 * t1 - 4.0 * t2 * t0
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    sgn = jnp.where(t1 >= 0, 1.0, -1.0)
    qq = -0.5 * (t1 + sgn * sq)
    r_q = qq / jnp.where(is_quad, t2, one)
    qq_ok = jnp.abs(qq) > 0
    r_c = jnp.where(qq_ok, t0 / jnp.where(qq_ok, qq, one), -1.0)
    lo = jnp.where(t1 >= 0, r_q, r_c)
    hi = jnp.where(t1 >= 0, r_c, r_q)
    sel = _polish(coef, ox, oy, oz, dx, dy, dz,
                  jnp.where(lo >= EPS, lo, hi),
                  iters=min(polish_iters, 2), m_start=QUAD_START,
                  reject=False)
    quad_root = jnp.where(disc < 0, -1.0, sel)
    lin_root = -t0 / jnp.where(is_lin, t1, one)

    return jnp.where(
        is_quad, quad_root, jnp.where(is_lin, lin_root, -1.0)
    )


def _read_coef_row(coefs_ref, i):
    return [coefs_ref[i, m] for m in range(N_COEFS)]


# --- the kernel ---

def _use_dir_table(light_kinds: tuple | None) -> bool:
    """Static predicate: ship the per-(light, object) direction-form table
    (``_dir_form_table``) into the kernel. Only meaningful when at least
    one light is statically directional — its shadow direction is a scene
    constant, so Q_i(d) / C_i(d) are frame constants the kernel would
    otherwise reassemble from scalar table reads in every program."""
    return light_kinds is not None and any(not k for k in light_kinds)


def _make_kernel(n_objects: int, n_lights: int, width: int, height: int,
                 polish_iters: int, bounces: int, n_cubic: int | None = None,
                 light_kinds: tuple | None = None,
                 posdef: tuple | None = None):
    inv_pi = np.float32(1.0 / math.pi)
    four_pi = np.float32(4.0 * math.pi)
    if n_cubic is None:
        n_cubic = n_objects  # no degree info: treat every object as cubic
    # Occlusion is a boolean (t in (EPS, max_t)) — it tolerates a coarser
    # root than the primary hit, whose t feeds the shading position.
    shadow_iters = max(1, min(_SHADOW_ITERS, polish_iters))

    def nearest_hit(coefs_ref, orig_ref, ox, oy, oz, dx, dy, dz):
        """Best valid hit over all objects (reference update-cuda.cu:65-77).

        Objects are laid out cubics-first (host-side partition); slots
        >= n_cubic take the cheap quadric solve. The reference scans in
        original order with strict <, so ties are broken by the ORIGINAL
        index (orig_ref), not the permuted slot.

        The origin components may be traced SCALARS (the primary trace: one
        camera eye for the whole block) — broadcasting then makes t0 = F(o)
        and the origin-only expansion products scalar for free; the loop
        carry is shaped from ``dx``, which is always per-pixel."""
        one = jnp.ones_like(dx)

        def make_body(solver):
            def body(i, carry):
                best_t, best_idx, best_orig = carry
                coef = _read_coef_row(coefs_ref, i)
                t = solver(coef, ox, oy, oz, dx, dy, dz, polish_iters)
                valid = (t >= EPS) & (t < MAX_T)
                orig = orig_ref[i]
                better = valid & (
                    (t < best_t) | ((t == best_t) & (orig < best_orig))
                )
                best_t = jnp.where(better, t, best_t)
                best_idx = jnp.where(better, i, best_idx)
                best_orig = jnp.where(better, orig, best_orig)
                return best_t, best_idx, best_orig

            return body

        carry = (
            jnp.full_like(one, MAX_T),
            jnp.full_like(one, -1, dtype=jnp.int32),
            jnp.full_like(one, np.int32(2**30), dtype=jnp.int32),
        )
        if n_cubic > 0:
            carry = jax.lax.fori_loop(0, n_cubic, make_body(_solve_object), carry)
        if n_cubic < n_objects:
            carry = jax.lax.fori_loop(
                n_cubic, n_objects, make_body(_solve_quadric), carry
            )
        best_t, best_idx, _ = carry
        hit = best_idx >= 0
        return hit, best_idx, jnp.where(hit, best_t, 0.0)

    def gather_object(coefs_ref, colors_ref, refl_ref, idx):
        """Per-pixel object attributes via a masked sweep over the static
        object count (the reference's pointer gather objects[idx])."""
        zero = jnp.zeros_like(idx, dtype=jnp.float32)
        coef = [zero] * N_COEFS
        col = [zero] * 3
        refl = zero
        for i in range(n_objects):
            m = (idx == i)
            row = _read_coef_row(coefs_ref, i)
            coef = [jnp.where(m, row[k], coef[k]) for k in range(N_COEFS)]
            col = [jnp.where(m, colors_ref[i, k], col[k]) for k in range(3)]
            refl = jnp.where(m, refl_ref[i], refl)
        return coef, col, refl

    def shade(coefs_ref, lights_ref, dir_ref, sel_coef, obj_col,
              px, py, pz, nx, ny, nz):
        """Shadow-tested Lambertian sum over lights, clamped
        (reference update-cpu.cpp:60-77).

        The O(lights x objects) occlusion cost is bounded two ways:
        * every light shares ONE shadow origin (the biased hit point), so
          each quadric object's F and gradient there are computed once and
          reused across all lights — the per-(light, object) work collapses
          to assembling t2 = Q(d), t1 = gF.d, t0 = F and a closed-form
          stable quadratic test;
        * ``light_kinds`` (static per scene) specializes each light: a
          directional light's shadow direction is a scalar triple, so its
          Q(d) is a traced scalar and the dead spherical falloff math
          disappears.
        """
        zero = jnp.zeros_like(px)
        acc = [zero, zero, zero]
        sox = px + SHADOW_BIAS * nx
        soy = py + SHADOW_BIAS * ny
        soz = pz + SHADOW_BIAS * nz

        # Per-object precompute shared by every light's shadow ray: the
        # Taylor coefficients of F(so + t d) around the COMMON origin so —
        # t0 = F(so), t1 = gF(so).d, t2 = (1/2) d^T H(so) d (+ t3 = C(d),
        # the pure cubic form, for cubic objects). Exact for degree <= 3;
        # only the d-dependent contractions remain per light.
        one = jnp.ones_like(px)
        so_cache = _powers3(sox, soy, soz, max_pow=3 if n_cubic > 0 else 2)
        quad_pre = []
        for i in range(n_cubic, n_objects):
            coef = _read_coef_row(coefs_ref, i)
            f0, _, g0 = _eval_F_and_grad(coef, sox, soy, soz,
                                         m_start=QUAD_START, need_mag=False,
                                         cache=so_cache)
            pd = bool(posdef[i]) if posdef is not None else False
            quad_pre.append((i, coef, f0, g0, pd))
        cubic_pre = []
        for i in range(n_cubic):
            coef = _read_coef_row(coefs_ref, i)
            f0, _, g0 = _eval_F_and_grad(coef, sox, soy, soz, need_mag=False,
                                         cache=so_cache)
            h6 = _hessian_entries(coef, so_cache, one)
            cubic_pre.append((i, coef, f0, g0, h6))

        def _stable_quad_roots(t2, t1, t0):
            """Cancellation-stable quadratic roots mapped to the reference's
            (lo, hi) = (-t1 -/+ sqrt(disc))/(2 t2) ordering."""
            disc = t1 * t1 - 4.0 * t2 * t0
            s = jnp.sqrt(jnp.maximum(disc, 0.0))
            sgn = jnp.where(t1 >= 0, 1.0, -1.0)
            qq = -0.5 * (t1 + sgn * s)
            is_quad = jnp.abs(t2) > EPS
            r_q = qq / jnp.where(is_quad, t2, 1.0)
            qq_ok = jnp.abs(qq) > 0
            r_c = jnp.where(qq_ok, t0 / jnp.where(qq_ok, qq, 1.0), -1.0)
            lo = jnp.where(t1 >= 0, r_q, r_c)
            hi = jnp.where(t1 >= 0, r_c, r_q)
            return is_quad, disc, lo, hi

        def quadlin_occ_coeffs(t2, t1, t0, max_t, posdef=False,
                               unbounded=False):
            """Occlusion boolean (as f32) for a degree <= 2 t-polynomial,
            reference root-selection semantics (surface_impl.h:138-153) —
            DIVISION- and SQRT-FREE. Instead of computing the roots, the
            selected root is classified against (EPS, max_t) from the signs
            of f(EPS), f(max_t), the derivative g(c) = 2*t2*c + t1 (vertex
            side), and the discriminant. Case analysis (r = roots, v =
            vertex; the reference selects (-t1 - sqrt(disc))/(2*t2) if
            >= EPS else the other root — the SMALLER root first for t2 > 0,
            the LARGER for t2 < 0):

            t2 > 0 (upward): sel = smallest root >= EPS.
              r1 > EPS (sel = r1):  f(E) > 0 and v > E (g(E) < 0);
                occluded iff r1 < M  <=>  f(M) < 0 or v < M (g(M) > 0).
              r1 <= EPS < r2 (sel = r2):  f(E) < 0;
                occluded iff r2 < M  <=>  f(M) > 0 and g(M) > 0.
            t2 < 0 (downward): sel = LARGER root r2 when >= EPS (the
              reference's far-root asymmetry, replicated exactly):
              r2 > EPS  <=>  f(E) > 0 or g(E) > 0 (given disc >= 0);
              occluded iff also r2 < M  <=>  f(M) < 0 and g(M) < 0.

            STATIC specializations of the O(L x N) occlusion sweep:

            * ``posdef`` — the object's quadratic form Q is positive
              definite (host-side Sylvester test on concrete coefficients,
              ``_quad_posdef``; every sphere qualifies): then t2 = Q(d) > 0
              for every nonzero shadow direction, so the t2 < 0 and linear
              branches are statically dead.
              Boundary: t2 = 0 requires d = 0, i.e. a spherical light
              EXACTLY at the (biased) surface point — degenerate geometry
              the reference itself has no meaningful answer for.
            * ``unbounded`` — the light is directional (static kind), so
              max_t is the constant MAX_T = 1e6 and d is unit-length: with
              posdef, t2 >= lambda_min(Q), hence f(M) = t2 M^2 + t1 M + t0
              and g(M) = 2 t2 M + t1 are positive unless the shadow origin
              is >~ lambda_min * 1e6 / 2 units from the occluder — i.e.
              the selected root would lie beyond MAX_T, which the
              reference's own regime treats as "infinitely far" (its
              primary-hit MAX_T cull draws the same line). The f(M)/g(M)
              sign tests are then statically 1 and the test collapses to
              occluded <=> disc >= 0 and (f(E) < 0 or g(E) < 0).

            The boolean algebra is f32 products/maxes, so a traced SCALAR
            t2 (directional lights) blends with per-pixel terms directly.
            """
            E = EPS
            f32 = jnp.float32
            fE = (t2 * E + t1) * E + t0
            gE = 2.0 * t2 * E + t1
            disc_ok = (t1 * t1 - 4.0 * t2 * t0 >= 0).astype(f32)
            if posdef and unbounded:
                # sel-in-range = sel >= EPS = (r1 <= E < r2) or (E < r1):
                # fE < 0, or fE > 0 with the vertex right of E (gE < 0)
                return disc_ok * jnp.maximum((fE < 0).astype(f32),
                                             (gE < 0).astype(f32))
            fM = (t2 * max_t + t1) * max_t + t0
            gM = 2.0 * t2 * max_t + t1
            # t2 > 0: sel-in-range = A (sel = r1) or B (sel = r2)
            a_pos = ((fE > 0).astype(f32) * (gE < 0).astype(f32)
                     * jnp.maximum((fM < 0).astype(f32),
                                   (gM > 0).astype(f32)))
            b_pos = ((fE < 0).astype(f32) * (fM > 0).astype(f32)
                     * (gM > 0).astype(f32))
            occ_pos = disc_ok * jnp.maximum(a_pos, b_pos)
            if posdef:
                return occ_pos
            # t2 < 0: sel = larger root
            occ_neg = (disc_ok
                       * jnp.maximum((fE > 0).astype(f32),
                                     (gE > 0).astype(f32))
                       * (fM < 0).astype(f32) * (gM < 0).astype(f32))
            sp = (t2 > 0).astype(f32)
            quad_hit = sp * occ_pos + (1.0 - sp) * occ_neg

            is_lin = jnp.abs(t1) > EPS
            # linear root -t0/t1 in (EPS, max_t), division-free: compare
            # -t0 against E*t1 and M*t1 with the t1-sign blend
            st = (t1 > 0).astype(f32)
            a = -t0
            lin_pos = ((a > E * t1).astype(f32) * (a < max_t * t1).astype(f32))
            lin_neg = ((a < E * t1).astype(f32) * (a > max_t * t1).astype(f32))
            lin_hit = is_lin.astype(f32) * (st * lin_pos + (1.0 - st) * lin_neg)

            isq = (jnp.abs(t2) > EPS).astype(f32)
            return isq * quad_hit + (1.0 - isq) * lin_hit

        def quad_occ_one(coef, f0, g0, sd, max_t, posdef=False,
                         unbounded=False, t2=None):
            """Occluded-by-this-quadric boolean: Taylor assembly (t2 = Q(d),
            t1 = gF(so).d, t0 = F(so)) + the stable closed-form test (no
            Newton needed for a boolean). ``t2`` may arrive precomputed
            from the per-(light, object) direction-form table (static
            directional lights, whose t2 is a frame constant)."""
            sdx, sdy, sdz = sd
            if t2 is None:
                t2 = (coef[10] * (sdx * sdx) + coef[11] * (sdy * sdy)
                      + coef[12] * (sdz * sdz) + coef[13] * (sdx * sdy)
                      + coef[14] * (sdx * sdz) + coef[15] * (sdy * sdz))
            t1 = g0[0] * sdx + g0[1] * sdy + g0[2] * sdz
            return quadlin_occ_coeffs(t2, t1, f0, max_t, posdef=posdef,
                                      unbounded=unbounded)

        def cubic_occ_one(coef, f0, g0, h6, sd, sd_cub, max_t, t3=None):
            """Occluded-by-this-cubic boolean. Taylor assembly around the
            shared shadow origin (t3 = C(d) from the per-light cubic-form
            basis, t2 = (1/2) d^T H(so) d, t1 = gF(so).d, t0 = F(so)), then
            the analytic cubic candidates polished by 1-D Newton on the
            ASSEMBLED polynomial with a 1-D residual genuineness test —
            candidate-for-candidate the same structure as ``_solve_object``
            but much cheaper: an occlusion boolean needs any genuine root in
            (EPS, max_t), not a shading-accurate value."""
            sdx, sdy, sdz = sd
            if t3 is None:
                for m in range(QUAD_START):
                    term = coef[m] * sd_cub[m]
                    t3 = term if t3 is None else t3 + term
            t2 = (0.5 * (h6[0] * (sdx * sdx) + h6[1] * (sdy * sdy)
                         + h6[2] * (sdz * sdz))
                  + h6[3] * (sdx * sdy) + h6[4] * (sdx * sdz)
                  + h6[5] * (sdy * sdz))
            t1 = g0[0] * sdx + g0[1] * sdy + g0[2] * sdz
            t0 = f0

            def feval(t):
                return ((t3 * t + t2) * t + t1) * t + t0

            def dfeval(t):
                return (3.0 * t3 * t + 2.0 * t2) * t + t1

            def polish1d(t):
                for _ in range(shadow_iters):
                    df = dfeval(t)
                    ok = jnp.abs(df) > 1e-12
                    step = jnp.where(ok, feval(t) / jnp.where(ok, df, 1.0), 0.0)
                    t_new = t - step
                    t = jnp.where(jnp.isfinite(t_new), t_new, t)
                return t

            def genuine_in_range(t):
                at = jnp.abs(t)
                mag = (jnp.abs(t3) * at * at * at + jnp.abs(t2) * at * at
                       + jnp.abs(t1) * at + jnp.abs(t0) + 1e-30)
                return ((jnp.abs(feval(t)) <= _RESIDUAL_TOL * mag)
                        & (t > EPS) & (t < max_t))

            is_cubic = jnp.abs(t3) > EPS
            s3 = jnp.where(is_cubic, t3, 1.0)
            a = t2 / s3
            b = t1 / s3
            c = t0 / s3
            s = jnp.maximum(
                jnp.maximum(jnp.abs(a), jnp.sqrt(jnp.abs(b))),
                jnp.maximum(jnp.cbrt(jnp.abs(c)), 1e-30),
            )
            a = a / s
            b = b / (s * s)
            c = c / (s * s * s)
            q = (3.0 * b - a * a) / 9.0
            r = (9.0 * a * b - 27.0 * c - 2.0 * a * a * a) / 54.0
            delta = q * q * q + r * r
            sq_delta = jnp.sqrt(jnp.maximum(delta, 0.0))
            q_neg = jnp.maximum(-q, 0.0)
            denom = jnp.sqrt(q_neg * q_neg * q_neg)
            ratio = jnp.clip(r / jnp.where(denom == 0, 1.0, denom), -1.0, 1.0)
            theta = jnp.arccos(ratio) / 3.0
            two_sq = 2.0 * jnp.sqrt(q_neg)
            a3 = a / 3.0
            cardano = jnp.cbrt(r + sq_delta) + jnp.cbrt(r - sq_delta)
            cands = [
                s * (jnp.where(delta > 0, cardano, two_sq * jnp.cos(theta)) - a3),
                s * (two_sq * jnp.cos(theta + TWO_THIRD_PI) - a3),
                s * (two_sq * jnp.cos(theta + 2.0 * TWO_THIRD_PI) - a3),
            ]
            # dominant-balance quadratic candidates (near-degenerate |t3|);
            # non-roots are finite garbage the residual test rejects
            _isq, _disc, qlo, qhi = _stable_quad_roots(t2, t1, t0)
            cands += [qlo, qhi]
            occ_c = None
            for cand in cands:
                hit = genuine_in_range(polish1d(cand)).astype(jnp.float32)
                occ_c = hit if occ_c is None else jnp.maximum(occ_c, hit)
            quadlin = quadlin_occ_coeffs(t2, t1, t0, max_t)
            isc = is_cubic.astype(jnp.float32)
            return isc * occ_c + (1.0 - isc) * quadlin

        for li in range(n_lights):
            kind = None if light_kinds is None else bool(light_kinds[li])
            lpx, lpy, lpz = lights_ref[li, 1], lights_ref[li, 2], lights_ref[li, 3]
            lcr, lcg, lcb = lights_ref[li, 4], lights_ref[li, 5], lights_ref[li, 6]
            # shadow ray: unnormalized to-light (spherical, max_t 1) or the
            # stored unit direction (directional, max_t MAX_T); passed
            # through f32 as in the reference (light_impl.h:17)
            if kind is None:
                # light kind unknown at trace time: generic masked form
                is_sph = lights_ref[li, 0]
                sph = is_sph > 0.5
                tox, toy, toz = lpx - px, lpy - py, lpz - pz
                sd = (jnp.where(sph, tox, lpx), jnp.where(sph, toy, lpy),
                      jnp.where(sph, toz, lpz))
                max_t = jnp.where(sph, 1.0, MAX_T)
                dist2 = tox * tox + toy * toy + toz * toz
                dn = jnp.sqrt(dist2)
                inv_dn = 1.0 / jnp.where(dn > 0, dn, 1.0)
                ldx = jnp.where(sph, tox * inv_dn, lpx)
                ldy = jnp.where(sph, toy * inv_dn, lpy)
                ldz = jnp.where(sph, toz * inv_dn, lpz)
                cscale = jnp.where(sph, 1.0 / (four_pi * dist2), 1.0)
            elif kind:  # spherical
                tox, toy, toz = lpx - px, lpy - py, lpz - pz
                sd = (tox, toy, toz)
                max_t = 1.0
                dist2 = tox * tox + toy * toy + toz * toz
                inv_dn = jax.lax.rsqrt(jnp.where(dist2 > 0, dist2, 1.0))
                ldx, ldy, ldz = tox * inv_dn, toy * inv_dn, toz * inv_dn
                cscale = 1.0 / (four_pi * dist2)
            else:  # directional: everything about the light is scalar
                sd = (lpx, lpy, lpz)
                max_t = MAX_T
                ldx, ldy, ldz = lpx, lpy, lpz
                cscale = 1.0
            lam = jnp.maximum(0.0, nx * ldx + ny * ldy + nz * ldz)

            # Directional lights have the static max_t = MAX_T bound (see
            # quadlin_occ_coeffs' ``unbounded`` specialization); their
            # Q_i(d)/C_i(d) forms come precomputed from the direction table.
            use_tbl = (kind is False) and dir_ref is not None
            unbounded = kind is False
            occluded_f = jnp.zeros_like(px)
            if cubic_pre:
                if use_tbl:
                    sd_cub = None
                else:
                    sd_pows = _powers3(sd[0], sd[1], sd[2])
                    sd_cub = [_prod(sd_pows, MONOMIAL_POWERS[m], one)
                              for m in range(QUAD_START)]
                for i, coef, f0, g0, h6 in cubic_pre:
                    t3 = dir_ref[li, i] if use_tbl else None
                    occluded_f = jnp.maximum(
                        occluded_f, cubic_occ_one(coef, f0, g0, h6, sd, sd_cub,
                                                  max_t, t3=t3)
                    )
            for i, coef, f0, g0, pd in quad_pre:
                t2 = dir_ref[li, i] if use_tbl else None
                occluded_f = jnp.maximum(
                    occluded_f, quad_occ_one(coef, f0, g0, sd, max_t,
                                             posdef=pd, unbounded=unbounded,
                                             t2=t2)
                )

            w = jnp.where(occluded_f > 0.5, 0.0, lam * inv_pi)
            scale = cscale * w
            acc[0] = acc[0] + obj_col[0] * lcr * scale
            acc[1] = acc[1] + obj_col[1] * lcg * scale
            acc[2] = acc[2] + obj_col[2] * lcb * scale
        return [jnp.minimum(1.0, a) for a in acc]

    def normal_at(sel_coef, px, py, pz):
        _, _, g = _eval_F_and_grad(sel_coef, px, py, pz, need_mag=False)
        norm = jnp.sqrt(g[0] * g[0] + g[1] * g[1] + g[2] * g[2])
        inv = 1.0 / jnp.where(norm > 0, norm, 1.0)
        return g[0] * inv, g[1] * inv, g[2] * inv

    def any_lane(mask):
        """Block-uniform predicate: True iff ``mask`` holds on some pixel
        of the block (a max over f32, which every route reduces)."""
        return jnp.max(mask.astype(jnp.float32)) > 0.0

    def trace_and_shade(coefs_ref, orig_ref, colors_ref, refl_ref, lights_ref,
                        dir_ref, ox, oy, oz, dx, dy, dz):
        hit, idx, t = nearest_hit(coefs_ref, orig_ref, ox, oy, oz, dx, dy, dz)
        px, py, pz = ox + t * dx, oy + t * dy, oz + t * dz
        sel_coef, obj_col, refl = gather_object(coefs_ref, colors_ref, refl_ref, idx)
        nx, ny, nz = normal_at(sel_coef, px, py, pz)

        # Block-uniform skip: a block with no hit anywhere (sky) renders pure
        # background — its O(lights x objects) shading sweep is dead work.
        def do_shade(_):
            return shade(
                coefs_ref, lights_ref, dir_ref, sel_coef, obj_col,
                px, py, pz, nx, ny, nz
            )

        def no_shade(_):
            z = jnp.zeros_like(px)
            return [z, z, z]

        lit = jax.lax.cond(any_lane(hit), do_shade, no_shade, None)
        return hit, idx, refl, (px, py, pz), (nx, ny, nz), lit

    use_dir = _use_dir_table(light_kinds)

    def kernel(coefs_ref, orig_ref, colors_ref, refl_ref, lights_ref, *rest):
        if use_dir:
            dir_ref, cam_ref, out_r, out_g, out_b = rest
        else:
            dir_ref = None
            cam_ref, out_r, out_g, out_b = rest
        # --- ray generation (reference update-cuda.cu:111-116) ---
        pid = pl.program_id(0)
        pixel = pid * BLOCK_PX + jax.lax.broadcasted_iota(
            jnp.int32, (BLOCK_PX,), 0)
        # row0 (cam_ref[17]) offsets this call's pixel rows into the full
        # image: under row-sharded meshes each device renders rows
        # [row0, row0 + rows_out) of the SAME global frame, so ndc_y below
        # uses the global height while the grid covers only the local rows.
        row0 = cam_ref[17].astype(jnp.int32)
        pix_y_local = pixel // width
        pix_x = pixel - pix_y_local * width
        pix_y = pix_y_local + row0

        aspect_tanf = cam_ref[12]
        tanf = cam_ref[13]
        ndc_x = (pix_x.astype(jnp.float32) + 0.5) * np.float32(1.0 / width)
        ndc_y = (pix_y.astype(jnp.float32) + 0.5) * np.float32(1.0 / height)
        cx = (2.0 * ndc_x - 1.0) * aspect_tanf
        cy = (2.0 * ndc_y - 1.0) * tanf
        # dir = normalize(R @ (cx, cy, 1)); R columns in cam_ref[0:9]
        tx = cx * cam_ref[0] + cy * cam_ref[3] + cam_ref[6]
        ty = cx * cam_ref[1] + cy * cam_ref[4] + cam_ref[7]
        tz = cx * cam_ref[2] + cy * cam_ref[5] + cam_ref[8]
        inv_len = jax.lax.rsqrt(tx * tx + ty * ty + tz * tz)
        dx, dy, dz = tx * inv_len, ty * inv_len, tz * inv_len
        # Scalar camera origin: every primary ray in the block shares it, so
        # keeping it 0-D makes t0 = F(eye) and the origin-side expansion
        # products broadcast scalars through the whole solver (bounce-stage
        # traces pass per-pixel origins through the same code).
        ox = cam_ref[9]
        oy = cam_ref[10]
        oz = cam_ref[11]

        bg = (cam_ref[14], cam_ref[15], cam_ref[16])

        hit, idx, refl, point, normal, lit = trace_and_shade(
            coefs_ref, orig_ref, colors_ref, refl_ref, lights_ref, dir_ref,
            ox, oy, oz, dx, dy, dz
        )
        result = [jnp.where(hit, lit[k], bg[k]) for k in range(3)]

        if bounces > 0:
            # Reflection chain (reference update-cuda.cu:126-146) as a
            # lockstep masked loop; the active mask is carried as f32 (0/1).
            # Each iteration is skipped for the whole block once no pixel
            # still reflects — the block-level form of the reference's
            # per-pixel while-exit.
            def bounce_step(carry):
                def run(carry):
                    result, ratio, active_f, refl_c, point, normal, d = carry
                    enter = (active_f > 0.5) & (refl_c > EPS)
                    ratio = jnp.where(enter, ratio * refl_c, ratio)
                    px, py, pz = point
                    nx, ny, nz = normal
                    ddx, ddy, ddz = d
                    dot = ddx * nx + ddy * ny + ddz * nz
                    rdx = ddx - 2.0 * dot * nx
                    rdy = ddy - 2.0 * dot * ny
                    rdz = ddz - 2.0 * dot * nz
                    nox = px + SHADOW_BIAS * nx
                    noy = py + SHADOW_BIAS * ny
                    noz = pz + SHADOW_BIAS * nz
                    h2, _i2, r2, p2, n2, l2 = trace_and_shade(
                        coefs_ref, orig_ref, colors_ref, refl_ref, lights_ref,
                        dir_ref, nox, noy, noz, rdx, rdy, rdz,
                    )
                    bcol = [jnp.where(h2, l2[k], bg[k]) for k in range(3)]
                    result = [
                        jnp.where(enter,
                                  (1.0 - ratio) * result[k] + ratio * bcol[k],
                                  result[k])
                        for k in range(3)
                    ]
                    adv = enter & h2
                    refl_c = jnp.where(adv, r2, refl_c)
                    point = tuple(jnp.where(adv, p2[k], point[k])
                                  for k in range(3))
                    normal = tuple(jnp.where(adv, n2[k], normal[k])
                                   for k in range(3))
                    d = (jnp.where(enter, rdx, ddx), jnp.where(enter, rdy, ddy),
                         jnp.where(enter, rdz, ddz))
                    return (result, ratio, adv.astype(jnp.float32), refl_c,
                            point, normal, d)

                def skip(carry):
                    # no pixel enters: the full body would leave everything
                    # unchanged and set the active mask to zero
                    result, ratio, active_f, refl_c, point, normal, d = carry
                    return (result, ratio, jnp.zeros_like(active_f), refl_c,
                            point, normal, d)

                active_f, refl_c = carry[2], carry[3]
                return jax.lax.cond(
                    any_lane((active_f > 0.5) & (refl_c > EPS)),
                    run, skip, carry)

            init = (result, jnp.ones_like(dx), hit.astype(jnp.float32), refl,
                    point, normal, (dx, dy, dz))
            result, ratio, active_f, refl_c, *_rest = jax.lax.fori_loop(
                0, bounces, lambda _, c: bounce_step(c), init
            )
            # at-cap background blend
            enter = (active_f > 0.5) & (refl_c > EPS)
            rr = ratio * refl_c
            result = [
                jnp.where(enter, (1.0 - rr) * result[k] + rr * bg[k], result[k])
                for k in range(3)
            ]

        out_r[...] = result[0]
        out_g[...] = result[1]
        out_b[...] = result[2]

    return kernel


def _dir_form_table(coefs, lights, n_cubic: int):
    """[L, N] frame-constant direction forms for STATIC directional lights:
    entry (li, i) is C_i(d_li) (the pure cubic form) for cubic slots and
    Q_i(d_li) (the quadratic form) for quadric slots, where d_li is the
    light's stored unit direction (lights[:, 1:4]). Computed ONCE per frame
    in XLA and shipped to the kernel as a table, so no program re-assembles
    them. Spherical-light rows are computed but never read (their shadow
    directions are per-pixel)."""
    comps = [lights[:, 1], lights[:, 2], lights[:, 3]]

    def mono(pows):
        out = None
        for axis in range(3):
            for _ in range(pows[axis]):
                out = comps[axis] if out is None else out * comps[axis]
        return out

    cub = jnp.stack([mono(MONOMIAL_POWERS[m]) for m in range(QUAD_START)],
                    axis=1)                                   # [L, 10]
    quad = jnp.stack(
        [mono(MONOMIAL_POWERS[m]) for m in range(QUAD_START, QUAD_START + 6)],
        axis=1)                                               # [L, 6]
    # Precision.HIGHEST is load-bearing: these table entries feed
    # knife-edge occlusion sign tests, and a reduced-precision matmul (TF32
    # on the GPU) has ~1e-3 relative error, enough to flip penumbra pixels
    # against the f64 oracle. The table is [L,10]@[10,N] once per frame.
    hi = jax.lax.Precision.HIGHEST
    c_tbl = jnp.matmul(cub, coefs[:, :QUAD_START].T, precision=hi)  # [L, N]
    q_tbl = jnp.matmul(quad, coefs[:, QUAD_START:QUAD_START + 6].T,
                       precision=hi)
    slot_cubic = (jnp.arange(coefs.shape[0]) < n_cubic)[None, :]
    return jnp.where(slot_cubic, c_tbl, q_tbl)


def _pack_lights(scene: Scene):
    """[L, 7] f32: is_spherical, p(3), color(3)."""
    table = jnp.concatenate(
        [
            scene.light_is_spherical.astype(jnp.float32)[:, None],
            scene.light_p.astype(jnp.float32),
            scene.light_color.astype(jnp.float32),
        ],
        axis=1,
    )
    return table


def _pack_camera(scene: Scene, camera: camera_ops.Camera, row0=0):
    """[18] f32 scalar table: R columns (9), eye (3), aspect*tanf, tanf,
    bg (3), row0. ``row0`` is the first image row this kernel call renders
    (traced under shard_map: each device derives it from its axis index;
    exact in f32 for any realistic image height)."""
    rotation, eye = camera_ops.camera_frame(camera)
    tanf = scene.tan_half_fov.astype(jnp.float32)
    return jnp.concatenate(
        [
            rotation.astype(jnp.float32).T.reshape(-1),  # columns flattened
            eye.astype(jnp.float32),
            (tanf * scene.aspect_ratio)[None],
            tanf[None],
            scene.bg_color.astype(jnp.float32),
            jnp.asarray(row0, jnp.float32)[None],
        ]
    )


def _degree_partition(coefs):
    """Host-side cubics-first permutation from CONCRETE coefficients.

    Returns (perm, n_cubic): perm lists original object indices, cubic
    objects first (stable order within each class). An object is "cubic"
    iff any of its 10 cubic monomial coefficients is nonzero; otherwise
    t3 == 0 identically and only the reference's quadratic/linear branches
    can ever fire for it, so the partition is semantics-preserving."""
    cc = np.asarray(coefs)
    is_cubic = (np.abs(cc[:, :QUAD_START]) > 0).any(axis=1)
    perm = np.argsort(~is_cubic, kind="stable").astype(np.int32)
    return perm, int(is_cubic.sum())


def _quad_posdef(coefs):
    """Per-object positive-definiteness of the quadratic form Q
    (Sylvester's criterion on CONCRETE coefficients; every sphere
    qualifies). A True entry licenses the statically-dead t2 <= 0 occlusion
    branches in ``quadlin_occ_coeffs`` — only quadric-routed slots consume
    it. Coefficient order x2,y2,z2,xy,xz,yz at columns 10-15
    (reference include/surface.h:12-14)."""
    cc = np.asarray(coefs, np.float64)
    a, b, c = cc[:, 10], cc[:, 11], cc[:, 12]
    d, e, f = cc[:, 13] / 2, cc[:, 14] / 2, cc[:, 15] / 2
    m2 = a * b - d * d
    m3 = (a * (b * c - f * f) - d * (d * c - f * e)
          + e * (d * f - b * e))
    return (a > 0) & (m2 > 0) & (m3 > 0)


# Tiny memo so the per-frame hot loop doesn't re-derive the scene statics
# (host-side np reductions over the coefficient table, incl. a device
# transfer for jax arrays) for the same table. Keyed on id() for zero
# per-frame device transfers, but each entry holds a weakref to the coefs
# array with a removal callback: CPython reuses ids after GC, so a plain id
# key could serve STALE statics to a new array allocated at the same
# address. The weakref guarantees an entry can only be hit while the exact
# array it was computed for is still alive.
_PARTITION_CACHE: dict = {}


def _statics_for(coefs):
    """(perm, n_cubic, posdef) for a CONCRETE coefficient table, memoized;
    ``posdef`` is aligned with the PERMUTED slot order the kernel sees."""
    key = id(coefs)
    cached = _PARTITION_CACHE.get(key)
    if cached is not None and cached[0]() is coefs:
        return cached[1]
    cc = np.asarray(coefs)
    p, n_cubic = _degree_partition(cc)
    pd = _quad_posdef(cc)
    value = (tuple(int(i) for i in p), n_cubic,
             tuple(bool(pd[i]) for i in p))
    if len(_PARTITION_CACHE) > 64:
        _PARTITION_CACHE.clear()
    try:
        ref = weakref.ref(coefs, lambda _r, k=key: _PARTITION_CACHE.pop(k, None))
    except TypeError:  # non-weakref-able array type: don't cache
        return value
    _PARTITION_CACHE[key] = (ref, value)
    return value


def _light_kinds_of(light_is_spherical) -> tuple | None:
    """Static per-light kind tuple (True = spherical) from a CONCRETE
    is-spherical table; None under tracing (the kernels then fall back to
    the generic masked light path)."""
    if isinstance(light_is_spherical, jax.core.Tracer):
        return None
    return tuple(bool(x) for x in np.asarray(light_is_spherical))



def _pad_empty(table, n_static: int):
    """One dummy row for empty tables: pallas_call rejects zero-size
    operands, but the kernel's unrolled loops run over the STATIC
    object/light counts, so a padding row is never read. Keeps 0-light and
    0-object scenes (legal inputs — the reference tolerates empty sequences,
    src/scene.cpp:169-170) on the kernel path."""
    if n_static == 0:
        return jnp.zeros((1,) + table.shape[1:], table.dtype)
    return table


def _dispatch_fwd(coefs, orig_index, colors, refl, lights, cam, *,
                  n_objects: int, n_lights: int, width: int, height: int,
                  polish_iters: int, bounces: int, n_cubic: int,
                  rows_out: int | None = None,
                  light_kinds: tuple | None = None,
                  posdef: tuple | None = None,
                  interpret: bool = False):
    """Launch the kernel on packed tables -> [rows_out, W, 3] image.
    ``height`` is the GLOBAL image height (sets the ndc scale); ``rows_out``
    (default: height) is how many rows this call renders, starting at the
    dynamic row offset packed into cam[17]. ``interpret`` runs the kernel
    in the Pallas interpreter (tests on hosts without a GPU)."""
    if rows_out is None:
        rows_out = height
    n_px = rows_out * width
    n_blocks = pl.cdiv(n_px, BLOCK_PX)
    operands = [_pad_empty(coefs, n_objects), _pad_empty(orig_index, n_objects),
                _pad_empty(colors, n_objects), _pad_empty(refl, n_objects),
                _pad_empty(lights, n_lights)]
    if _use_dir_table(light_kinds):
        operands.append(_dir_form_table(operands[0], operands[4], n_cubic))
    operands.append(cam)
    kernel = _make_kernel(
        n_objects, n_lights, width, height, polish_iters, bounces,
        n_cubic=n_cubic, light_kinds=light_kinds, posdef=posdef,
    )
    # One output per colour channel: Triton blocks must be powers of two,
    # so a (BLOCK_PX, 3) block is not allowed.
    channel = jax.ShapeDtypeStruct((n_blocks * BLOCK_PX,), jnp.float32)
    r, g, b = pl.pallas_call(
        kernel,
        grid=(n_blocks,),
        in_specs=[pl.BlockSpec() for _ in operands],  # whole tables
        out_specs=[pl.BlockSpec((BLOCK_PX,), lambda i: (i,))] * 3,
        out_shape=[channel] * 3,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="render_fwd",
    )(*operands)
    image = jnp.stack([r[:n_px], g[:n_px], b[:n_px]], axis=-1)
    return image.reshape(rows_out, width, 3)


def _kernel_tables(scene: Scene, camera: camera_ops.Camera, perm: tuple,
                   row0=0):
    """f32 kernel operands: object tables in slot order (the static
    cubics-first permutation ``perm``, applied inside jit where XLA
    constant-folds the gather), original indices, packed lights and
    packed camera."""
    scene32 = scene.astype(jnp.float32)
    camera32 = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), camera)
    coefs, colors, refl = scene32.coefs, scene32.colors, scene32.reflection
    if any(perm[i] != i for i in range(len(perm))):
        idx = jnp.asarray(np.asarray(perm, np.int32))
        coefs = jnp.take(coefs, idx, axis=0)
        colors = jnp.take(colors, idx, axis=0)
        refl = jnp.take(refl, idx, axis=0)
    orig_index = jnp.asarray(np.asarray(perm, np.int32))
    return (coefs, orig_index, colors, refl, _pack_lights(scene32),
            _pack_camera(scene32, camera32, row0=row0))


@partial(jax.jit,
         static_argnames=("polish_iters", "bounces", "n_cubic", "perm",
                          "light_kinds", "posdef", "interpret"))
def _render_pallas_jit(scene: Scene, camera: camera_ops.Camera,
                       polish_iters: int, bounces: int, n_cubic: int,
                       perm: tuple, light_kinds: tuple | None = None,
                       posdef: tuple | None = None, interpret: bool = False):
    return _dispatch_fwd(
        *_kernel_tables(scene, camera, perm),
        n_objects=scene.n_objects, n_lights=scene.n_lights,
        width=scene.width, height=scene.height,
        polish_iters=polish_iters, bounces=bounces, n_cubic=n_cubic,
        light_kinds=light_kinds, posdef=posdef, interpret=interpret,
    )


def scene_statics(scene: Scene):
    """(perm, n_cubic, light_kinds, posdef): the host-side specialization
    data the kernel compiles in. Under tracing (coefficients abstract) the
    partition is unavailable and every object takes the cubic solve; a
    traced light table leaves the kinds to the generic masked path."""
    kinds = _light_kinds_of(scene.light_is_spherical)
    if isinstance(scene.coefs, jax.core.Tracer) or scene.n_objects == 0:
        return tuple(range(scene.n_objects)), scene.n_objects, kinds, None
    perm, n_cubic, posdef = _statics_for(scene.coefs)
    return perm, n_cubic, kinds, posdef


def _render_pallas_raw(scene: Scene, camera: camera_ops.Camera,
                       polish_iters: int, bounces: int,
                       interpret: bool = False):
    """Non-jitted wrapper: derives the scene statics host-side, then
    dispatches the jitted kernel with them as STATIC data (compiled in —
    the scene arrays pass through unchanged, so per-frame calls hit the jit
    cache with no extra transfers)."""
    perm, n_cubic, kinds, posdef = scene_statics(scene)
    return _render_pallas_jit(scene, camera, polish_iters, bounces,
                              n_cubic, perm, kinds, posdef, interpret)


@partial(jax.custom_vjp, nondiff_argnums=(2, 3, 4))
def _render_pallas_diff(scene: Scene, camera, polish_iters: int, bounces: int,
                        interpret: bool = False):
    return _render_pallas_raw(scene, camera, polish_iters, bounces, interpret)


def _diff_fwd(scene, camera, polish_iters, bounces, interpret=False):
    out = _render_pallas_diff(scene, camera, polish_iters, bounces, interpret)
    return out, (scene, camera)


def _diff_bwd(polish_iters, bounces, interpret, res, g):
    # The kernel has no backward: recompute the gradient through the XLA
    # pipeline. Its occlusion solves use the full polish_iters while the
    # kernel uses _SHADOW_ITERS, so primal and gradient can disagree on
    # occlusion at penumbra-boundary pixels — acceptable because occlusion
    # is a non-differentiable boolean (stop_gradient'd in the pipeline).
    scene, camera = res
    config = xla_pipeline.RenderConfig(
        geom_dtype="float32", polish_iters=polish_iters,
        bounces=bounces, chunk_px=None,
    )
    _, vjp_fn = jax.vjp(
        lambda s, c: xla_pipeline._render_image_jit(s, c, config), scene, camera
    )
    return vjp_fn(g)


_render_pallas_diff.defvjp(_diff_fwd, _diff_bwd)


def render_rows_pallas(scene: Scene, camera: camera_ops.Camera, row0, rows: int,
                       *, polish_iters: int = 3, bounces: int = 0,
                       statics: tuple | None = None, interpret: bool = False):
    """Render image rows [row0, row0 + rows) with the kernel -> [rows, W, 3]
    f32 — the per-device forward body for row-sharded meshes.

    Called INSIDE ``shard_map``: ``row0`` may be a traced value derived from
    ``jax.lax.axis_index``; ``rows`` is the static per-device block height.
    ``statics`` is ``scene_statics`` of the concrete scene, computed OUTSIDE
    shard_map where the tables are concrete; None treats every object as
    cubic and every light generically. Forward only: gradients are routed
    to the XLA pipeline.
    """
    if statics is None:
        statics = (tuple(range(scene.n_objects)), scene.n_objects, None, None)
    perm, n_cubic, kinds, posdef = statics
    return _dispatch_fwd(
        *_kernel_tables(scene, camera, perm, row0=row0),
        n_objects=scene.n_objects, n_lights=scene.n_lights,
        width=scene.width, height=scene.height,
        polish_iters=int(polish_iters), bounces=int(bounces), n_cubic=n_cubic,
        rows_out=int(rows), light_kinds=kinds, posdef=posdef,
        interpret=interpret,
    )


def render_image_pallas(scene: Scene, camera: camera_ops.Camera | None = None,
                        polish_iters: int = 3, bounces: int | None = None,
                        interpret: bool = False):
    """Render a full frame with the fused kernel -> [H, W, 3] f32.

    Differentiable through the XLA-pipeline recompute VJP (``_diff_bwd``).
    ``interpret`` runs the kernel in the Pallas interpreter; only tests on
    hosts without a GPU pass it.
    """
    if camera is None:
        camera = camera_ops.Camera.initial(jnp.float32)
    if bounces is None:
        bounces = xla_pipeline.resolve_bounces(
            scene, xla_pipeline.RenderConfig()
        )
    return _render_pallas_diff(scene, camera, int(polish_iters), int(bounces),
                               bool(interpret))

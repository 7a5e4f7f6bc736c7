"""Golden CPU reference renderer (vectorized NumPy, float64).

This module plays the role of the reference's serial CPU backend
(reference: src/update-cpu.cpp): an independent implementation of the same
per-pixel program, used as the parity oracle the fast paths are tested against —
mirroring the reference's own CPU/CUDA cross-validation pairing (SURVEY.md §4).

It shares only the *data conventions* with the JAX path (the 20-coefficient
monomial order and the binomial expansion table, which are definitional), and
re-implements ray generation, the cubic/quadratic/linear root selection
(reference: include/surface_impl.h:106-154), shading (include/light_impl.h)
and the reflection chain (src/update-cpu.cpp:82-119) in plain NumPy float64.
No JAX, no XLA — deliberately boring and fast to start.
"""

from __future__ import annotations

import math

import numpy as np

from ..models.scene import Scene
from ..ops.constants import EPS, MAX_T, SHADOW_BIAS, TWO_THIRD_PI
from ..ops.poly import _EXPANSION  # pure-Python expansion table (definitional)
from ..models.surface import MONOMIAL_POWERS, N_COEFS


# --- polynomial machinery ---

def _powers(x, y, z, max_pow=3):
    cache = [[None] * (max_pow + 1) for _ in range(3)]
    for axis, comp in enumerate((x, y, z)):
        cache[axis][1] = comp
        for e in range(2, max_pow + 1):
            cache[axis][e] = cache[axis][e - 1] * comp
    return cache


def _product(cache, pows, one):
    out = None
    for axis, e in enumerate(pows):
        if e == 0:
            continue
        out = cache[axis][e] if out is None else out * cache[axis][e]
    return one if out is None else out


def ray_poly_coeffs_np(coefs, origin, dir):
    """(t3, t2, t1, t0) each [..., N] for coefs [N, 20]."""
    origin, dir = np.broadcast_arrays(origin, dir)
    o = _powers(origin[..., 0], origin[..., 1], origin[..., 2])
    d = _powers(dir[..., 0], dir[..., 1], dir[..., 2])
    one = np.ones_like(origin[..., 0])
    out = []
    for k in range(3, -1, -1):
        cols = []
        for m in range(N_COEFS):
            acc = np.zeros_like(one)
            for coeff, o_pows, d_pows in _EXPANSION[k][m]:
                acc = acc + coeff * _product(o, o_pows, one) * _product(d, d_pows, one)
            cols.append(acc)
        out.append(np.stack(cols, axis=-1) @ coefs.T)
    return tuple(out)  # t3, t2, t1, t0


def min_positive_root_np(t3, t2, t1, t0):
    """Root selection exactly as reference surface_impl.h:106-154."""
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        is_cubic = np.abs(t3) > EPS
        is_quad = np.abs(t2) > EPS
        is_lin = np.abs(t1) > EPS

        s3 = np.where(is_cubic, t3, 1.0)
        a, b, c = t2 / s3, t1 / s3, t0 / s3
        q = (3.0 * b - a * a) / 9.0
        r = (9.0 * a * b - 27.0 * c - 2.0 * a**3) / 54.0
        delta = q**3 + r * r

        sq = np.sqrt(np.maximum(delta, 0.0))
        cardano = np.cbrt(r + sq) + np.cbrt(r - sq) - a / 3.0

        q_neg = np.maximum(-q, 0.0)
        denom = np.sqrt(q_neg**3)
        ratio = np.clip(np.where(denom > 0, r / np.where(denom > 0, denom, 1.0), 1.0), -1.0, 1.0)
        theta = np.arccos(ratio) / 3.0
        two_sq = 2.0 * np.sqrt(q_neg)
        x = two_sq * np.cos(theta) - a / 3.0
        for k in (1.0, 2.0):
            cand = two_sq * np.cos(theta + k * TWO_THIRD_PI) - a / 3.0
            x = np.where((cand >= EPS) & (cand < x), cand, x)
        cubic_root = np.where(delta > 0, cardano, x)

        s2 = np.where(is_quad, t2, 1.0)
        disc = t1 * t1 - 4.0 * t2 * t0
        sd = np.sqrt(np.maximum(disc, 0.0))
        lo = (-t1 - sd) / (2.0 * s2)
        hi = (-t1 + sd) / (2.0 * s2)
        quad_root = np.where(disc < 0, -1.0, np.where(lo >= EPS, lo, hi))

        lin_root = -t0 / np.where(is_lin, t1, 1.0)

        return np.where(
            is_cubic, cubic_root,
            np.where(is_quad, quad_root, np.where(is_lin, lin_root, -1.0)),
        )


def poly_gradient_np(coefs, point):
    """coefs [..., 20] (gathered), point [..., 3] -> [..., 3]."""
    p = _powers(point[..., 0], point[..., 1], point[..., 2])
    one = np.ones_like(point[..., 0])
    grads = []
    for axis in range(3):
        total = np.zeros_like(one)
        for m, pows in enumerate(MONOMIAL_POWERS):
            e = pows[axis]
            if e == 0:
                continue
            dpows = list(pows)
            dpows[axis] = e - 1
            total = total + coefs[..., m] * e * _product(p, dpows, one)
        grads.append(total)
    return np.stack(grads, axis=-1)


# --- pipeline ---

def _trace_np(scene_np, origin, dir):
    """get_color_and_object analogue (reference: src/update-cpu.cpp:45-80)."""
    coefs, colors, light_p, light_sph, light_color, _refl = scene_np
    t_all = min_positive_root_np(*ray_poly_coeffs_np(coefs, origin, dir))
    valid = (t_all >= EPS) & (t_all < MAX_T)
    t_masked = np.where(valid, t_all, np.inf)
    idx = np.argmin(t_masked, axis=-1)
    hit = valid.any(axis=-1)
    best_t = np.take_along_axis(t_all, idx[..., None], axis=-1)[..., 0]
    best_t = np.where(hit, best_t, 0.0)

    point = origin + best_t[..., None] * dir
    sel = coefs[idx]
    grad = poly_gradient_np(sel, point)
    gn = np.linalg.norm(grad, axis=-1, keepdims=True)
    normal = grad / np.where(gn > 0, gn, 1.0)

    # shadows: occluded iff any object with EPS < t < max_t
    shadow_origin = point + SHADOW_BIAS * normal
    to_light = light_p - point[..., None, :]
    sdir = np.where(light_sph[:, None], to_light, light_p).astype(np.float32).astype(np.float64)
    max_t = np.where(light_sph, 1.0, MAX_T)
    occ = min_positive_root_np(
        *ray_poly_coeffs_np(coefs, shadow_origin[..., None, :], sdir)
    )
    in_shadow = ((occ > EPS) & (occ < max_t[:, None])).any(axis=-1)

    # Lambertian contributions (color math in f32, reference light_impl.h:29-44)
    with np.errstate(divide="ignore", invalid="ignore"):
        dist2 = np.sum(to_light * to_light, axis=-1)
        n = np.sqrt(dist2)
        unit = to_light / np.where(n > 0, n, 1.0)[..., None]
        ldir = np.where(light_sph[:, None], unit, light_p)
        falloff = light_color / (np.float32(4.0 * math.pi) * dist2.astype(np.float32)[..., None])
    col = np.where(light_sph[:, None], falloff, light_color).astype(np.float32)
    lam = np.maximum(0.0, np.sum(normal[..., None, :] * ldir, axis=-1)).astype(np.float32)
    contrib = colors[idx][..., None, :] * np.float32(1.0 / math.pi) * col * lam[..., None]
    lit = np.minimum(
        np.float32(1.0),
        np.sum(np.where(in_shadow[..., None], np.float32(0.0), contrib), axis=-2),
    ).astype(np.float32)
    return hit, idx, point, normal, lit


def render_rays_np(scene: Scene, origin, dir):
    """Full per-ray pipeline -> [..., 3] f32 (reference: update-cpu.cpp:82-119)."""
    coefs = np.asarray(scene.coefs, dtype=np.float64)
    colors = np.asarray(scene.colors, dtype=np.float32)
    refl = np.asarray(scene.reflection, dtype=np.float32)
    light_p = np.asarray(scene.light_p, dtype=np.float64)
    light_sph = np.asarray(scene.light_is_spherical, dtype=bool)
    light_color = np.asarray(scene.light_color, dtype=np.float32)
    bg = np.asarray(scene.bg_color, dtype=np.float32)
    scene_np = (coefs, colors, light_p, light_sph, light_color, refl)

    hit, idx, point, normal, lit = _trace_np(scene_np, origin, dir)
    result = np.where(hit[..., None], lit, bg)

    if refl.size and refl.max() > EPS:
        active = hit.copy()
        ratio = np.ones(hit.shape, dtype=np.float32)
        cur_dir = dir
        for _ in range(scene.max_reflections):
            r = refl[idx]
            enter = active & (r > EPS)
            if not enter.any():
                active = enter
                break
            ratio = np.where(enter, ratio * r, ratio)
            new_dir = cur_dir - 2.0 * np.sum(cur_dir * normal, axis=-1, keepdims=True) * normal
            new_origin = point + SHADOW_BIAS * normal
            h2, i2, p2, n2, l2 = _trace_np(scene_np, new_origin, new_dir)
            bcol = np.where(h2[..., None], l2, bg)
            rr = ratio[..., None]
            result = np.where(enter[..., None], (1.0 - rr) * result + rr * bcol, result)
            adv = enter & h2
            idx = np.where(adv, i2, idx)
            point = np.where(adv[..., None], p2, point)
            normal = np.where(adv[..., None], n2, normal)
            cur_dir = np.where(enter[..., None], new_dir, cur_dir)
            active = adv
        # at-cap background blend (reference: update-cpu.cpp:98-101)
        r = refl[idx]
        enter = active & (r > EPS)
        rr = (ratio * r)[..., None]
        result = np.where(enter[..., None], (1.0 - rr) * result + rr * bg, result)
    return result.astype(np.float32)


def camera_rays_np(scene: Scene, position=(0.0, 0.0, 0.0), yaw_deg=90.0,
                   pitch_deg=0.0, width=None, height=None):
    """Reference camera + ray-gen (src/ray-tracer.cpp:44-58, update-cpu.cpp:84-89)."""
    width = width or scene.width
    height = height or scene.height
    yaw = math.radians(yaw_deg)
    pitch = math.radians(pitch_deg)
    d = np.array([
        math.cos(yaw) * math.cos(pitch),
        math.sin(pitch),
        math.sin(yaw) * math.cos(pitch),
    ])
    f = -d / np.linalg.norm(d)
    up = np.array([0.0, 1.0, 0.0])
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    rot = np.stack([s, u, -f], axis=-1)  # columns

    tanf = float(np.asarray(scene.tan_half_fov))
    aspect = float(width) / float(height)
    xs = (np.arange(width, dtype=np.float64) + 0.5) / width
    ys = (np.arange(height, dtype=np.float64) + 0.5) / height
    cx = (2.0 * xs - 1.0) * aspect * tanf
    cy = (2.0 * ys - 1.0) * tanf
    target = (cx[None, :, None] * rot[:, 0] + cy[:, None, None] * rot[:, 1] + rot[:, 2])
    dirs = target / np.linalg.norm(target, axis=-1, keepdims=True)
    origin = np.broadcast_to(np.asarray(position, dtype=np.float64), dirs.shape)
    return origin, dirs


def render_image_np(scene: Scene, position=(0.0, 0.0, 0.0), yaw_deg=90.0,
                    pitch_deg=0.0, row_chunk=64):
    """Full-frame golden render -> [H, W, 3] f32, row 0 = bottom."""
    origin, dirs = camera_rays_np(scene, position, yaw_deg, pitch_deg)
    rows = []
    for y0 in range(0, scene.height, row_chunk):
        sl = slice(y0, min(y0 + row_chunk, scene.height))
        rows.append(render_rays_np(scene, origin[sl], dirs[sl]))
    return np.concatenate(rows, axis=0)

"""Algebraic surface model: degree-<=3 trivariate polynomials as 20-coefficient vectors.

The coefficient convention matches the reference's ``SurfaceCoefs`` struct
(reference: include/surface.h:10-15): a surface is the zero set of

    F(x, y, z) = sum_m coef[m] * monomial_m(x, y, z)

with monomials ordered::

    x3 y3 z3 x2y xy2 x2z xz2 y2z yz2 xyz   (degree 3)
    x2 y2 z2 xy xz yz                      (degree 2)
    x  y  z                               (degree 1)
    c                                     (degree 0)

Unlike the reference (a C struct of 20 doubles), surfaces here are plain
``numpy`` vectors of shape ``[20]`` so a scene's objects stack into a single
``[N, 20]`` coefficient matrix — the unit of work for the XLA intersection
path, where ray->polynomial coefficient expansion becomes a ``[P, 20] @
[20, N]`` contraction instead of a per-object scalar loop.

Factory functions mirror the reference factories (reference: src/surface.cpp:4-60),
including the reference's Clebsch quirk: ``coef.x3 = coef.y3 = coef.x3 = 81``
assigns ``x3`` twice, leaving ``z3 == 0`` (reference: src/surface.cpp:44). We
reproduce the resulting *values* for bit parity.
"""

from __future__ import annotations

import numpy as np

# Monomial order — index into the 20-vector. Must match reference include/surface.h:12-14.
COEF_NAMES = (
    "x3", "y3", "z3", "x2y", "xy2", "x2z", "xz2", "y2z", "yz2", "xyz",
    "x2", "y2", "z2", "xy", "xz", "yz",
    "x", "y", "z", "c",
)
COEF_INDEX = {name: i for i, name in enumerate(COEF_NAMES)}
N_COEFS = len(COEF_NAMES)

# Monomial exponents (px, py, pz) per coefficient, same order as COEF_NAMES.
MONOMIAL_POWERS = (
    (3, 0, 0), (0, 3, 0), (0, 0, 3), (2, 1, 0), (1, 2, 0), (2, 0, 1), (1, 0, 2),
    (0, 2, 1), (0, 1, 2), (1, 1, 1),
    (2, 0, 0), (0, 2, 0), (0, 0, 2), (1, 1, 0), (1, 0, 1), (0, 1, 1),
    (1, 0, 0), (0, 1, 0), (0, 0, 1),
    (0, 0, 0),
)


def _zeros() -> np.ndarray:
    return np.zeros(N_COEFS, dtype=np.float64)


def from_named(**coefs: float) -> np.ndarray:
    """Build a coefficient vector from named monomials (unnamed default to 0).

    Mirrors the reference's ``polynomial`` scene type, which reads all 20
    named coefficients with a default of 0 (reference: src/scene.cpp:126-147).
    """
    vec = _zeros()
    for name, value in coefs.items():
        if name not in COEF_INDEX:
            raise KeyError(f"Unknown surface coefficient: {name!r}")
        vec[COEF_INDEX[name]] = float(value)
    return vec


def sphere(center, radius: float) -> np.ndarray:
    """Sphere |p - center|^2 = r^2 (reference: src/surface.cpp:4-15)."""
    from .errors import validate_positive

    validate_positive("sphere radius", radius)
    cx, cy, cz = (float(v) for v in center)
    vec = _zeros()
    vec[COEF_INDEX["x2"]] = vec[COEF_INDEX["y2"]] = vec[COEF_INDEX["z2"]] = 1.0
    vec[COEF_INDEX["x"]] = -2.0 * cx
    vec[COEF_INDEX["y"]] = -2.0 * cy
    vec[COEF_INDEX["z"]] = -2.0 * cz
    vec[COEF_INDEX["c"]] = cx * cx + cy * cy + cz * cz - float(radius) * float(radius)
    return vec


def plane(origin, normal) -> np.ndarray:
    """Plane through `origin` with normal `normal` (reference: src/surface.cpp:17-25)."""
    ox, oy, oz = (float(v) for v in origin)
    nx, ny, nz = (float(v) for v in normal)
    vec = _zeros()
    vec[COEF_INDEX["x"]] = nx
    vec[COEF_INDEX["y"]] = ny
    vec[COEF_INDEX["z"]] = nz
    vec[COEF_INDEX["c"]] = -(ox * nx + oy * ny + oz * nz)
    return vec


def ding_dong(origin) -> np.ndarray:
    """Ding-dong cubic x^2 + y^3 - y^2 + z^2, translated (reference: src/surface.cpp:27-39)."""
    ox, oy, oz = (float(v) for v in origin)
    vec = _zeros()
    vec[COEF_INDEX["x2"]] = vec[COEF_INDEX["y3"]] = vec[COEF_INDEX["z2"]] = 1.0
    vec[COEF_INDEX["y2"]] = -1.0 - 3.0 * oy
    vec[COEF_INDEX["x"]] = -2.0 * ox
    vec[COEF_INDEX["z"]] = -2.0 * oz
    vec[COEF_INDEX["y"]] = (2.0 + 3.0 * oy) * oy
    vec[COEF_INDEX["c"]] = ox**2 + oz**2 - oy**2 * (1.0 + oy)
    return vec


def clebsch() -> np.ndarray:
    """Clebsch cubic, with the reference's z3=0 typo preserved.

    Reference src/surface.cpp:44 writes ``coef.x3 = coef.y3 = coef.x3 = 81.0``
    — ``x3`` is assigned twice, ``z3`` never, so ``z3`` stays 0. The rendered
    surface in the reference therefore is NOT the symmetric Clebsch cubic;
    we replicate the actual values for image parity.
    """
    vec = _zeros()
    vec[COEF_INDEX["x3"]] = vec[COEF_INDEX["y3"]] = 81.0
    # z3 intentionally 0 (reference typo, see docstring)
    for name in ("x2y", "x2z", "xy2", "y2z", "xz2", "yz2"):
        vec[COEF_INDEX[name]] = -189.0
    vec[COEF_INDEX["xyz"]] = 54.0
    for name in ("xy", "yz", "xz"):
        vec[COEF_INDEX[name]] = 126.0
    for name in ("x2", "y2", "z2"):
        vec[COEF_INDEX[name]] = -9.0
    for name in ("x", "y", "z"):
        vec[COEF_INDEX[name]] = 9.0
    vec[COEF_INDEX["c"]] = 1.0
    return vec


def cayley() -> np.ndarray:
    """Cayley cubic (reference: src/surface.cpp:54-60)."""
    vec = _zeros()
    for name in ("x2y", "x2z", "xy2", "y2z", "xz2", "yz2"):
        vec[COEF_INDEX[name]] = -5.0
    for name in ("xy", "yz", "xz"):
        vec[COEF_INDEX[name]] = 2.0
    return vec


def evaluate(coefs: np.ndarray, point) -> float:
    """Evaluate F(point) with numpy — reference/debug helper, not the device path."""
    x, y, z = (float(v) for v in point)
    total = 0.0
    for m, (px, py, pz) in enumerate(MONOMIAL_POWERS):
        total += float(coefs[..., m]) * x**px * y**py * z**pz
    return total

"""Pin the NumPy f64 golden oracle to the REFERENCE's own compiled code.

Every parity claim in this repo bottoms out in the builder-authored NumPy
oracle (tpu_ray_tracer/render/reference_cpu.py). This suite anchors that
oracle to the reference itself: a tiny C++ harness
(tpu_ray_tracer/native/reference_oracle.cpp) compiled against the ACTUAL
reference headers (/root/reference/include/surface_impl.h, light_impl.h —
host-compilable, glm-only) and factory sources evaluates
intersect_ray / normal_vector / shadow_ray / surface_color / reflect_ray
and all factories on randomized inputs; the NumPy implementations must
match to f64/f32 rounding noise.

Skipped when the reference checkout or a C++ toolchain is unavailable.
"""

import math
import os
import shutil
import struct
import subprocess

import numpy as np
import pytest

import tpu_ray_tracer  # noqa: F401  (sys.path setup via conftest)
from tpu_ray_tracer.models import light as light_mod
from tpu_ray_tracer.models import surface as surface_mod
from tpu_ray_tracer.render.reference_cpu import (
    min_positive_root_np,
    poly_gradient_np,
    ray_poly_coeffs_np,
)

NATIVE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "tpu_ray_tracer", "native",
)
# a checkout of the reference (JaworWr/CUDA-ray-tracer) beside this one
REFERENCE = os.path.join(os.path.dirname(NATIVE), os.pardir, os.pardir,
                         "reference")
BIN = os.path.join(NATIVE, "reference_oracle")


def _build():
    if os.path.exists(BIN):
        return True
    if not os.path.isdir(os.path.join(REFERENCE, "include")):
        return False
    if shutil.which("g++") is None and shutil.which("make") is None:
        return False
    try:
        subprocess.run(
            ["make", "-C", NATIVE, "reference_oracle",
             f"REFERENCE={REFERENCE}"],
            check=True, capture_output=True, timeout=120,
        )
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired):
        return False
    return os.path.exists(BIN)


class Oracle:
    """Line to the reference-compiled evaluator (binary f64 protocol)."""

    def __init__(self):
        self.proc = subprocess.Popen(
            [BIN], stdin=subprocess.PIPE, stdout=subprocess.PIPE
        )

    def call(self, opcode, payload, n_out):
        data = struct.pack(f"<{1 + len(payload)}d", float(opcode), *payload)
        self.proc.stdin.write(data)
        self.proc.stdin.flush()
        raw = self.proc.stdout.read(8 * n_out)
        assert len(raw) == 8 * n_out, "oracle harness died"
        return np.array(struct.unpack(f"<{n_out}d", raw))

    def close(self):
        try:
            self.proc.stdin.write(struct.pack("<d", 0.0))
            self.proc.stdin.close()
            self.proc.wait(timeout=10)
        except Exception:
            self.proc.kill()


@pytest.fixture(scope="module")
def oracle():
    if not _build():
        pytest.skip("reference checkout or C++ toolchain unavailable")
    o = Oracle()
    yield o
    o.close()


def _random_surfaces(rng, n=40):
    """Mix of factory surfaces and raw random coefficient tables."""
    out = [
        surface_mod.sphere(rng.uniform(-3, 3, 3), rng.uniform(0.5, 3)),
        surface_mod.plane(rng.uniform(-2, 2, 3), rng.uniform(-1, 1, 3)),
        surface_mod.ding_dong(rng.uniform(-2, 2, 3)),
        surface_mod.clebsch(),
        surface_mod.cayley(),
    ]
    for _ in range(n - len(out)):
        out.append(rng.uniform(-1, 1, 20))
    return out


def test_factories_match_reference(oracle):
    rng = np.random.default_rng(7)
    for _ in range(10):
        center = rng.uniform(-5, 5, 3)
        radius = rng.uniform(0.1, 4)
        ref = oracle.call(6, [*center, radius], 20)
        np.testing.assert_allclose(
            surface_mod.sphere(center, radius), ref, rtol=0, atol=0
        )
        origin = rng.uniform(-5, 5, 3)
        normal = rng.uniform(-1, 1, 3)
        ref = oracle.call(7, [*origin, *normal], 20)
        np.testing.assert_allclose(
            surface_mod.plane(origin, normal), ref, rtol=0, atol=0
        )
        dd = rng.uniform(-3, 3, 3)
        ref = oracle.call(8, [*dd], 20)
        np.testing.assert_allclose(
            surface_mod.ding_dong(dd), ref, rtol=1e-15, atol=1e-15
        )
    # the Clebsch z3=0 typo (reference surface.cpp:44) must be replicated
    clebsch_ref = oracle.call(9, [], 20)
    np.testing.assert_array_equal(surface_mod.clebsch(), clebsch_ref)
    assert clebsch_ref[2] == 0.0  # z3 stays zero: the typo is real
    np.testing.assert_array_equal(surface_mod.cayley(), oracle.call(10, [], 20))


def test_light_factories_match_reference(oracle):
    rng = np.random.default_rng(8)
    for _ in range(10):
        intensity = float(rng.uniform(0.1, 3))
        vec = rng.uniform(-1, 1, 3)
        color = rng.uniform(0, 1, 3).astype(np.float32)
        ref = oracle.call(11, [intensity, *vec, *color.astype(np.float64)], 7)
        ours = light_mod.directional(intensity, vec, color)
        assert ref[0] == 0.0 and not ours.is_spherical
        np.testing.assert_allclose(ours.p, ref[1:4], rtol=1e-15, atol=1e-15)
        np.testing.assert_allclose(
            ours.color, ref[4:7].astype(np.float32), rtol=1e-7)
        ref = oracle.call(12, [intensity, *vec, *color.astype(np.float64)], 7)
        ours = light_mod.spherical(intensity, vec, color)
        assert ref[0] == 1.0 and ours.is_spherical
        np.testing.assert_array_equal(ours.p, ref[1:4])


def test_intersect_ray_matches_reference(oracle):
    """min_positive_root_np(ray_poly_coeffs_np(...)) vs the reference's
    compiled intersect_ray on randomized (surface, ray) pairs. The two
    compute the t-polynomial with different association orders, so roots
    agree to amplified f64 rounding; branch-boundary flips must be rare."""
    rng = np.random.default_rng(9)
    surfaces = _random_surfaces(rng)
    n_rays = 40
    mism = 0
    total = 0
    for coefs in surfaces:
        origins = rng.uniform(-2, 2, (n_rays, 3))
        dirs = rng.normal(size=(n_rays, 3))
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        t_np = min_positive_root_np(
            *ray_poly_coeffs_np(np.asarray(coefs)[None], origins, dirs)
        )[:, 0]
        for i in range(n_rays):
            t_ref = oracle.call(1, [*coefs, *origins[i], *dirs[i]], 1)[0]
            total += 1
            a, b = t_np[i], t_ref
            if a < 1e-7 and b < 1e-7:
                continue  # both report "no usable hit" (negative/sub-EPS)
            if not np.isfinite(a) or not np.isfinite(b):
                mism += np.isfinite(a) != np.isfinite(b)
                continue
            if abs(a - b) > 1e-6 * max(1.0, abs(b)):
                mism += 1
    assert mism <= total * 0.01, f"{mism}/{total} root mismatches"


def test_normal_vector_matches_reference(oracle):
    rng = np.random.default_rng(10)
    for coefs in _random_surfaces(rng, n=12):
        pts = rng.uniform(-2, 2, (8, 3))
        g = poly_gradient_np(np.asarray(coefs)[None], pts)
        nn = np.linalg.norm(g, axis=-1, keepdims=True)
        ours = g / np.where(nn > 0, nn, 1.0)
        for i in range(len(pts)):
            ref = oracle.call(2, [*coefs, *pts[i]], 3)
            np.testing.assert_allclose(ours[i], ref, rtol=1e-9, atol=1e-12)


def test_shadow_ray_matches_reference(oracle):
    rng = np.random.default_rng(11)
    for _ in range(10):
        p = rng.uniform(-5, 5, 3)
        color = rng.uniform(0, 1, 3)
        point = rng.uniform(-5, 5, 3)
        # spherical: unnormalized to-light through f32, max_t = 1
        ref = oracle.call(3, [1.0, *p, *color, *point], 4)
        expect = (p - point).astype(np.float32)
        np.testing.assert_array_equal(expect, ref[:3].astype(np.float32))
        assert ref[3] == 1.0
        # directional: stored unit direction through f32, max_t = 1e6
        d = p / np.linalg.norm(p)
        ref = oracle.call(3, [0.0, *d, *color, *point], 4)
        np.testing.assert_array_equal(
            d.astype(np.float32), ref[:3].astype(np.float32))
        assert ref[3] == 1e6


def test_surface_color_matches_reference(oracle):
    """The f32 Lambertian in reference light_impl.h:29-44 vs the oracle's
    formulation (which multiplies by 1/pi where the reference divides by
    pi — f32 rounding differences only)."""
    rng = np.random.default_rng(12)
    for is_sph in (0.0, 1.0):
        for _ in range(20):
            p = rng.uniform(-4, 4, 3)
            if not is_sph:
                p /= np.linalg.norm(p)
            lcolor = rng.uniform(0, 1, 3)
            point = rng.uniform(-2, 2, 3)
            normal = rng.normal(size=3)
            normal /= np.linalg.norm(normal)
            objc = rng.uniform(0, 1, 3)
            ref = oracle.call(
                4, [is_sph, *p, *lcolor, *point, *normal, *objc], 3
            )
            # NumPy-oracle formulation (reference_cpu._trace_np)
            if is_sph:
                to = p - point
                dist2 = np.float32(np.dot(to, to))
                col = lcolor.astype(np.float32) / (
                    np.float32(4.0 * math.pi) * dist2
                )
                ldir = to / np.sqrt(np.dot(to, to))
            else:
                col = lcolor.astype(np.float32)
                ldir = p
            lam = np.float32(max(0.0, np.dot(normal, ldir)))
            ours = (objc.astype(np.float32) * np.float32(1.0 / math.pi)
                    * col * lam)
            np.testing.assert_allclose(ours, ref, rtol=2e-6, atol=1e-9)


def test_reflect_ray_matches_reference(oracle):
    rng = np.random.default_rng(13)
    for _ in range(20):
        d = rng.normal(size=3)
        n = rng.normal(size=3)
        n /= np.linalg.norm(n)
        ref = oracle.call(5, [*d, *n], 3)
        ours = d - 2.0 * np.dot(d, n) * n
        np.testing.assert_allclose(ours, ref, rtol=1e-14, atol=1e-15)

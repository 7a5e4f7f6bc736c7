"""Native (C++) host-runtime components with ctypes bindings.

The reference's host runtime is C++ (scene loading/validation via yaml-cpp,
reference: src/scene.cpp); this package provides this build's native
equivalent: ``libtrtscene.so`` (scene_loader.cpp), a dependency-free C++
scene parser + validator + surface/light factory that emits the same flat
tables as the Python loader. Built on demand with the in-tree Makefile; the
Python loader (tpu_ray_tracer/models/loader.py) is the behavioral oracle and
the fallback when no C++ toolchain is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from ..models.errors import SceneError
from ..models.scene import Scene, build_scene

_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_DIR, "libtrtscene.so")
_lib = None


class _TrtScene(ctypes.Structure):
    _fields_ = [
        ("ok", ctypes.c_int),
        ("error", ctypes.c_char * 512),
        ("width", ctypes.c_int),
        ("height", ctypes.c_int),
        ("fov_deg", ctypes.c_double),
        ("max_reflections", ctypes.c_int),
        ("bg", ctypes.c_float * 3),
        ("n_objects", ctypes.c_int),
        ("coefs", ctypes.POINTER(ctypes.c_double)),
        ("colors", ctypes.POINTER(ctypes.c_float)),
        ("reflection", ctypes.POINTER(ctypes.c_float)),
        ("n_lights", ctypes.c_int),
        ("is_spherical", ctypes.POINTER(ctypes.c_int)),
        ("light_p", ctypes.POINTER(ctypes.c_double)),
        ("light_color", ctypes.POINTER(ctypes.c_float)),
    ]


def build_library(force: bool = False) -> str:
    """Compile libtrtscene.so with the in-tree Makefile (idempotent)."""
    src = os.path.join(_DIR, "scene_loader.cpp")
    if force or not os.path.exists(_LIB_PATH) or (
        os.path.getmtime(src) > os.path.getmtime(_LIB_PATH)
    ):
        subprocess.run(["make", "-C", _DIR, "libtrtscene.so"], check=True,
                       capture_output=True)
    return _LIB_PATH


def _load_library():
    global _lib
    if _lib is None:
        build_library()
        _lib = ctypes.CDLL(_LIB_PATH)
        _lib.trt_load_scene.restype = ctypes.POINTER(_TrtScene)
        _lib.trt_load_scene.argtypes = [ctypes.c_char_p]
        _lib.trt_free_scene.restype = None
        _lib.trt_free_scene.argtypes = [ctypes.POINTER(_TrtScene)]
    return _lib


def available() -> bool:
    try:
        _load_library()
        return True
    except (subprocess.CalledProcessError, OSError):
        return False


def load_from_file(path) -> Scene:
    """Load a scene through the native C++ loader -> Scene pytree."""
    lib = _load_library()
    ptr = lib.trt_load_scene(str(path).encode())
    if not ptr:
        raise SceneError("native loader returned null")
    try:
        raw = ptr.contents
        if not raw.ok:
            raise SceneError(raw.error.decode())
        n, l = raw.n_objects, raw.n_lights
        coefs = np.ctypeslib.as_array(raw.coefs, shape=(n, 20)).copy() if n else np.zeros((0, 20))
        colors = np.ctypeslib.as_array(raw.colors, shape=(n, 3)).copy() if n else np.zeros((0, 3), np.float32)
        refl = np.ctypeslib.as_array(raw.reflection, shape=(n,)).copy() if n else np.zeros((0,), np.float32)
        sph = np.ctypeslib.as_array(raw.is_spherical, shape=(l,)).copy().astype(bool) if l else np.zeros((0,), bool)
        light_p = np.ctypeslib.as_array(raw.light_p, shape=(l, 3)).copy() if l else np.zeros((0, 3))
        light_c = np.ctypeslib.as_array(raw.light_color, shape=(l, 3)).copy() if l else np.zeros((0, 3), np.float32)

        import dataclasses

        from ..models import light as light_mod

        lights = [
            light_mod.Light(is_spherical=bool(sph[i]), p=light_p[i],
                            color=light_c[i])
            for i in range(l)
        ]
        scene = build_scene(
            width=raw.width,
            height=raw.height,
            fov_deg=raw.fov_deg,
            objects=[],
            lights=lights,
            max_reflections=raw.max_reflections,
            # materialize before trt_free_scene releases the struct memory
            bg_color=np.array([raw.bg[0], raw.bg[1], raw.bg[2]], dtype=np.float32),
        )
        return dataclasses.replace(
            scene,
            coefs=coefs.astype(np.float64),
            colors=colors.astype(np.float32),
            reflection=refl.astype(np.float32),
        )
    finally:
        lib.trt_free_scene(ptr)

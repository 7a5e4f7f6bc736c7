"""Regenerate the committed bench parity goldens (bench_goldens/*.npz).

bench.py gates each benched scene's full-resolution forward frame against the
f64 NumPy golden oracle (render/reference_cpu.py). Computing those goldens
live costs ~6 min of the bench's budget (20spheres alone is ~335 s of
NumPy at 800x600), so they are precomputed here and committed as float16
(quantization error <= 2^-11 ~ 0.0005, small against the 2/255 ~ 0.0078
bad-pixel threshold). Run this after any change to the golden oracle;
tests/test_bench_goldens.py cross-checks the cheap scenes stay in sync.
"""

import io
import os
import sys
import zipfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import tpu_ray_tracer as trt  # noqa: E402
from tpu_ray_tracer.render.reference_cpu import render_image_np  # noqa: E402

SCENES = ("dingdong", "monkey_saddle", "20spheres", "reflection_test",
          "quadratic", "cayley", "clebsch", "cubic")


def write_golden(path, image):
    """One float16 ``image.npy`` in a deflated .npz, written with a fixed
    compression level so an unchanged golden reproduces its bytes."""
    buf = io.BytesIO()
    np.lib.format.write_array(buf, np.asarray(image, np.float16))
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED,
                         compresslevel=7) as archive:
        archive.writestr("image.npy", buf.getvalue())


def main():
    out_dir = os.path.join(REPO, "bench_goldens")
    os.makedirs(out_dir, exist_ok=True)
    names = sys.argv[1:] or SCENES
    for name in names:
        scene = trt.load_from_file(os.path.join(REPO, "scenes", name + ".yml"))
        golden = render_image_np(scene)
        path = os.path.join(out_dir, name + ".npz")
        write_golden(path, golden)
        print(f"{path}: {golden.shape} ({os.path.getsize(path)/1e6:.2f} MB)")


if __name__ == "__main__":
    main()

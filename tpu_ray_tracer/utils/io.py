"""Image and array output.

The reference displays through an OpenGL textured quad
(reference: src/ray-tracer.cpp:189-215, src/shader-program.cpp); accelerator
hosts are often headless, so the display path becomes a framebuffer dump: PNG (written
with zlib directly, no imaging dependency) or NPY.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .film import flip_vertical, to_uint8


def write_png(path, image, *, bottom_up: bool = True) -> None:
    """Write [H, W, 3] (float in [0,1] or uint8) as an RGB PNG.

    bottom_up: treat row 0 as the image bottom (the renderer's GL-style
    layout) and flip for the file.
    """
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = to_uint8(img)
    if bottom_up:
        img = flip_vertical(img)
    height, width = img.shape[:2]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(height))

    def chunk(tag: bytes, payload: bytes) -> bytes:
        body = tag + payload
        return struct.pack(">I", len(payload)) + body + struct.pack(
            ">I", zlib.crc32(body) & 0xFFFFFFFF
        )

    header = struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0)
    with open(path, "wb") as handle:
        handle.write(b"\x89PNG\r\n\x1a\n")
        handle.write(chunk(b"IHDR", header))
        handle.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        handle.write(chunk(b"IEND", b""))


def write_npy(path, image) -> None:
    np.save(path, np.asarray(image))

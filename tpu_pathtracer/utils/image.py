"""HDR accumulation, tone mapping and PPM (P6) output.

The reference stores an 8-bit LDR framebuffer and tonemaps inside
``Image::set_pixel`` (``src/image.h:40-46,79-82``).  Here we instead keep a
float32 HDR accumulator resident on device for the whole render and apply the
identical ACES + gamma-2.2 + quantize pipeline once, as a single fused XLA
elementwise pass, before the one host readback.  The observable PPM bytes
match the reference pipeline bit-for-bit for equal radiance inputs.
"""

from __future__ import annotations

import io
from typing import Tuple, Union

import jax.numpy as jnp
import numpy as np

GAMMA = 2.2  # src/image.h:49


def aces_tonemap(x: jnp.ndarray) -> jnp.ndarray:
    """ACES filmic fit, componentwise (src/image.h:51-59)."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return (x * (a * x + b)) / (x * (c * x + d) + e)


def tone_map(x: jnp.ndarray) -> jnp.ndarray:
    """ACES followed by gamma 1/2.2 (src/image.h:61-64)."""
    return jnp.power(aces_tonemap(x), 1.0 / GAMMA)


def quantize_u8(hdr: jnp.ndarray) -> jnp.ndarray:
    """Tone map an HDR [..., 3] image and quantize to uint8.

    Matches ``Image::convert_color`` (src/image.h:66-82): scale by 255, clamp
    to [0, 255], round half away handled by round-to-nearest (np.rint ties to
    even differ only at exact .5 values which cannot occur for irrational
    tonemap outputs in practice; we use floor(x+0.5) to match std::round).
    """
    x = tone_map(hdr) * 255.0
    x = jnp.clip(x, 0.0, 255.0)
    return jnp.floor(x + 0.5).astype(jnp.uint8)


def write_ppm(dst: Union[str, io.BufferedIOBase], pixels_u8: np.ndarray) -> None:
    """Write a binary P6 PPM: header then raw RGB bytes (src/image.h:34-38)."""
    pixels_u8 = np.asarray(pixels_u8, dtype=np.uint8)
    h, w, c = pixels_u8.shape
    assert c == 3, "PPM requires RGB"
    header = f"P6\n{w} {h}\n255\n".encode("ascii")
    if isinstance(dst, (str,)):
        with open(dst, "wb") as f:
            f.write(header)
            f.write(pixels_u8.tobytes())
    else:
        dst.write(header)
        dst.write(pixels_u8.tobytes())


def read_ppm(src: Union[str, io.BufferedIOBase]) -> np.ndarray:
    """Read a binary P6 PPM into an (H, W, 3) uint8 array (test helper)."""
    if isinstance(src, str):
        with open(src, "rb") as f:
            data = f.read()
    else:
        data = src.read()
    # Parse header: magic, width, height, maxval, then a single whitespace.
    fields: list[bytes] = []
    pos = 0
    while len(fields) < 4:
        while pos < len(data) and data[pos : pos + 1].isspace():
            pos += 1
        if data[pos : pos + 1] == b"#":  # comment line
            while pos < len(data) and data[pos : pos + 1] != b"\n":
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos : pos + 1].isspace():
            pos += 1
        fields.append(data[start:pos])
    pos += 1  # single whitespace after maxval
    magic, w, h, maxval = fields[0], int(fields[1]), int(fields[2]), int(fields[3])
    assert magic == b"P6" and maxval == 255
    img = np.frombuffer(data, dtype=np.uint8, count=w * h * 3, offset=pos)
    return img.reshape(h, w, 3)


def image_shape_or_raise(width: int, height: int) -> Tuple[int, int]:
    """Validate dimensions like the Image ctor (src/image.h:25-29)."""
    if width <= 0 or height <= 0:
        raise ValueError(f"Illegal image size{width}x{height}")
    return width, height

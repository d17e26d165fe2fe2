"""Minimal PNG codec on ``zlib`` and numpy.

Decodes the non-interlaced 8-bit PNGs that textures use — greyscale, RGB,
palette, greyscale + alpha and RGBA (greyscale and palette also at 1, 2 and 4
bits), with any of the five row filters and ``tRNS`` transparency — to RGBA
the way stb_image and Pillow's ``convert("RGBA")`` do.  Encodes 8-bit
greyscale, greyscale + alpha, RGB and RGBA images.  Other PNGs (16-bit,
interlaced) raise ``ValueError``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Colour type -> samples per pixel (8-bit depth).
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}  # channels -> colour type (encoder)


def _chunks(data: bytes):
    if not data.startswith(_SIGNATURE):
        raise ValueError("not a PNG file")
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, ctype = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        yield ctype, body
        if ctype == b"IEND":
            return
    raise ValueError("truncated PNG: no IEND chunk")


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of a [h, 1 + stride] filtered scanline
    array -> [h, stride] uint8."""
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.int32)
    for y in range(h):
        ftype = int(raw[y, 0])
        line = raw[y, 1:]
        if ftype == 0:  # None
            cur = line.astype(np.int32)
        elif ftype == 1:  # Sub: running per-channel sum along the row
            cur = np.cumsum(
                line.reshape(-1, bpp).astype(np.int32), axis=0
            ).reshape(-1) & 0xFF
        elif ftype == 2:  # Up
            cur = (line + prior) & 0xFF
        elif ftype in (3, 4):  # Average, Paeth: sequential along the row
            f = line.reshape(-1, bpp).astype(np.int32)
            up = prior.reshape(-1, bpp)
            cur = np.zeros_like(f)
            left = np.zeros(bpp, np.int32)
            upleft = np.zeros(bpp, np.int32)
            for x in range(f.shape[0]):
                if ftype == 3:
                    pred = (left + up[x]) >> 1
                else:
                    pred = _paeth(left, up[x], upleft)
                left = (f[x] + pred) & 0xFF
                cur[x] = left
                upleft = up[x]
            cur = cur.reshape(-1)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prior = cur.astype(np.int32)
    return out


def decode_png_rgba(data: bytes) -> np.ndarray:
    """PNG bytes -> [H, W, 4] uint8 RGBA."""
    header = None
    palette = None
    trns = None
    idat = []
    for ctype, body in _chunks(data):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            trns = body
        elif ctype == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG has no IHDR chunk")
    w, h, depth, color, _comp, _filt, interlace = header
    sub_byte = depth in (1, 2, 4) and color in (0, 3)
    if (depth != 8 and not sub_byte) or color not in _CHANNELS or interlace:
        raise ValueError(
            f"unsupported PNG: bit depth {depth}, colour type {color}, "
            f"interlace {interlace} (8-bit non-interlaced only)"
        )
    c = _CHANNELS[color]
    stride = (w * c * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (1 + stride):
        raise ValueError("truncated PNG image data")
    px = _unfilter(raw[: h * (1 + stride)].reshape(h, 1 + stride), h, stride, c)
    if sub_byte:  # unpack MSB-first samples, then drop the row padding
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        px = (px[:, :, None] >> shifts) & ((1 << depth) - 1)
        px = px.reshape(h, -1)[:, :w]
    px = px.reshape(h, w, c)
    if color == 0 and sub_byte:
        key_px = px.copy()
        px = px * (255 // ((1 << depth) - 1))
    else:
        key_px = px
    out = np.empty((h, w, 4), np.uint8)
    out[..., 3] = 255
    if color == 3:
        if palette is None:
            raise ValueError("palette PNG has no PLTE chunk")
        out[..., :3] = palette[px[..., 0]]
        if trns is not None:
            alpha = np.full(palette.shape[0], 255, np.uint8)
            alpha[: len(trns)] = np.frombuffer(trns, np.uint8)[: len(alpha)]
            out[..., 3] = alpha[px[..., 0]]
    elif color in (0, 4):
        out[..., :3] = px[..., :1]
        if color == 4:
            out[..., 3] = px[..., 1]
        elif trns is not None and len(trns) >= 2:
            key = struct.unpack(">H", trns[:2])[0]
            out[..., 3] = np.where(key_px[..., 0] == key, 0, 255)
    else:
        out[..., :3] = px[..., :3]
        if color == 6:
            out[..., 3] = px[..., 3]
        elif trns is not None and len(trns) >= 6:
            key = np.array(struct.unpack(">HHH", trns[:6]))
            out[..., 3] = np.where((px == key).all(axis=-1), 0, 255)
    return out


def read_png_rgba(path: str) -> np.ndarray:
    """PNG file -> [H, W, 4] uint8 RGBA."""
    with open(path, "rb") as f:
        return decode_png_rgba(f.read())


def _filter_rows(px: np.ndarray, bpp: int, ftype: int) -> np.ndarray:
    """Apply one PNG filter type to every row of [h, stride] uint8 data."""
    cur = px.astype(np.int32)
    up = np.vstack([np.zeros((1, cur.shape[1]), np.int32), cur[:-1]])
    left = np.hstack([np.zeros((cur.shape[0], bpp), np.int32), cur[:, :-bpp]])
    upleft = np.hstack([np.zeros((cur.shape[0], bpp), np.int32), up[:, :-bpp]])
    pred = {
        0: 0,
        1: left,
        2: up,
        3: (left + up) >> 1,
        4: _paeth(left, up, upleft) if ftype == 4 else 0,
    }[ftype]
    return ((cur - pred) & 0xFF).astype(np.uint8)


def encode_png(image: np.ndarray, filter_type: int = 1) -> bytes:
    """[H, W] or [H, W, C] uint8 (C in 1..4) -> PNG bytes, every row
    filtered with ``filter_type`` (0-4)."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f"PNG encoder takes uint8 pixels, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in _COLOR_TYPE:
        raise ValueError(f"PNG encoder takes 1-4 channels, got {c}")
    rows = _filter_rows(img.reshape(h, w * c), c, filter_type)
    raw = np.hstack([np.full((h, 1), filter_type, np.uint8), rows])

    def chunk(ctype: bytes, body: bytes) -> bytes:
        crc = zlib.crc32(ctype + body) & 0xFFFFFFFF
        return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", crc)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (
        _SIGNATURE
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
        + chunk(b"IEND", b"")
    )


def write_png(path: str, image: np.ndarray) -> str:
    """Write ``image`` (see :func:`encode_png`) to ``path``; returns path."""
    with open(path, "wb") as f:
        f.write(encode_png(image))
    return path

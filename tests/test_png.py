"""In-repo PNG codec (utils/png.py) against Pillow."""

import io

import numpy as np
import pytest

from tpu_pathtracer.utils.png import decode_png_rgba, encode_png, read_png_rgba

Image = pytest.importorskip("PIL.Image")


def _pillow_png(mode: str) -> bytes:
    rng = np.random.default_rng(3)
    kw = {}
    if mode in ("P", "P+tRNS"):
        im = Image.fromarray(
            rng.integers(0, 256, (13, 17, 3), dtype=np.uint8)
        ).convert("P", palette=Image.Palette.ADAPTIVE, colors=16)
        if mode == "P+tRNS":
            kw["transparency"] = bytes([0, 128, 255])
    elif mode == "P256":
        im = Image.fromarray(
            rng.integers(0, 256, (13, 17, 3), dtype=np.uint8)
        ).convert("P", palette=Image.Palette.ADAPTIVE, colors=256)
    elif mode == "1":
        im = Image.fromarray(
            rng.integers(0, 2, (13, 17), dtype=np.uint8) * 255
        ).convert("1")
    elif mode == "L+tRNS":
        im = Image.fromarray(rng.integers(0, 4, (13, 17), dtype=np.uint8))
        kw["transparency"] = 2
    elif mode == "RGB+tRNS":
        im = Image.fromarray(rng.integers(0, 2, (13, 17, 3), dtype=np.uint8))
        kw["transparency"] = (1, 0, 1)
    else:
        c = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
        shape = (13, 17, c) if c > 1 else (13, 17)
        im = Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8), mode)
    buf = io.BytesIO()
    im.save(buf, "PNG", **kw)
    return buf.getvalue()


@pytest.mark.parametrize(
    "mode",
    ["L", "LA", "RGB", "RGBA", "P", "P256", "P+tRNS", "1", "L+tRNS",
     "RGB+tRNS"],
)
def test_decode_matches_pillow(mode):
    """Every colour type (and palette / key transparency) decodes to the
    RGBA Pillow's convert("RGBA") gives."""
    data = _pillow_png(mode)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    np.testing.assert_array_equal(decode_png_rgba(data), want)


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
def test_roundtrip_every_filter(filter_type):
    """Encoding with each of the five row filters round-trips, and Pillow
    reads the same pixels back."""
    rng = np.random.default_rng(filter_type)
    for c in (1, 2, 3, 4):
        img = rng.integers(0, 256, (9, 11, c), dtype=np.uint8)
        data = encode_png(img[..., 0] if c == 1 else img, filter_type)
        got = decode_png_rgba(data)
        np.testing.assert_array_equal(
            got, np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
        )
        np.testing.assert_array_equal(
            np.asarray(Image.open(io.BytesIO(data))).reshape(img.shape), img
        )


def test_generated_textures_match_pillow(tmp_path):
    """The textures the scene generators write decode bit-equal to Pillow,
    and the scene loader reads them as u8/255."""
    from tpu_pathtracer.scene.gltf import _load_image_rgba
    from tpu_pathtracer.utils.testscenes import (
        make_atrium_gltf,
        make_env_image,
        make_textured_cornell_gltf,
    )

    make_textured_cornell_gltf(str(tmp_path / "cornell" / "c.gltf"))
    make_atrium_gltf(str(tmp_path / "atrium" / "a.gltf"), detail=1)
    make_env_image(str(tmp_path / "env.png"))
    pngs = sorted(tmp_path.rglob("*.png"))
    assert len(pngs) >= 8
    for p in pngs:
        want = np.asarray(Image.open(p).convert("RGBA"))
        np.testing.assert_array_equal(read_png_rgba(str(p)), want)
        np.testing.assert_array_equal(
            _load_image_rgba(str(p)), want.astype(np.float32) / 255.0
        )


def test_unsupported_png_raises():
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4), np.uint16)).save(buf, "PNG")
    with pytest.raises(ValueError, match="unsupported PNG"):
        decode_png_rgba(buf.getvalue())
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png_rgba(b"GIF89a")

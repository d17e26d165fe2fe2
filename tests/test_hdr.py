"""Radiance HDR codec + GLB container tests.

The reference reads ``.hdr`` env maps through stb_image's 8-bit path
(src/geometry.h:584-598, src/config.h:38); these tests pin our codec to that
exact observable behavior, and cover the .glb container extension.
"""

import dataclasses
import os

import numpy as np
import pytest

from tpu_pathtracer.utils.hdr import decode_hdr_rgba_ldr, read_hdr, write_hdr


def test_hdr_roundtrip_linear(tmp_path):
    rng = np.random.default_rng(0)
    img = (rng.uniform(0, 1, size=(17, 33, 3)) ** 2 * 50.0).astype(np.float32)
    img[0, 0] = 0.0  # zero pixel -> E=0 encoding
    p = write_hdr(str(tmp_path / "t.hdr"), img)
    back = read_hdr(p)
    assert back.shape == img.shape
    # RGBE shares one exponent across channels: error is bounded by an 8-bit
    # mantissa of the brightest channel of each pixel.
    maxc = img.max(axis=-1, keepdims=True)
    assert np.abs(back - img).max() <= (maxc / 128 + 1e-7).max()
    np.testing.assert_array_equal(back[0, 0], 0.0)


def test_hdr_roundtrip_quantization_bound(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 4, size=(9, 16, 3)).astype(np.float32)
    p = write_hdr(str(tmp_path / "q.hdr"), img)
    back = read_hdr(p)
    maxc = img.max(axis=-1, keepdims=True)
    assert np.abs(back - img).max() <= (maxc / 128).max()


def test_hdr_ldr_matches_stb_semantics(tmp_path):
    """u8 = clamp(int(pow(linear, 1/2.2)*255 + 0.5)) — incl. >1 clamp."""
    vals = np.array(
        [[[0.0, 0.5, 1.0], [2.0, 8.0, 0.001]]], dtype=np.float32
    )
    p = write_hdr(str(tmp_path / "l.hdr"), vals)
    with open(p, "rb") as f:
        out = decode_hdr_rgba_ldr(f.read())
    lin = read_hdr(p)  # post-RGBE-quantization linear values
    expect = np.clip(
        (np.power(lin, 1 / 2.2) * 255 + 0.5).astype(np.int32), 0, 255
    ) / 255.0
    np.testing.assert_allclose(out[..., :3], expect.astype(np.float32))
    np.testing.assert_allclose(out[..., 3], 1.0)


def test_hdr_rle_scanline(tmp_path):
    """Hand-crafted new-style RLE scanline decodes like the flat encoding."""
    w, h = 16, 1
    flat = np.zeros((h, w, 3), dtype=np.float32)
    flat[0, :8] = 1.0
    flat[0, 8:] = 0.25
    ref_path = write_hdr(str(tmp_path / "flat.hdr"), flat)
    ref = read_hdr(ref_path)

    # Encode the same scanline with per-component RLE: runs of 8.
    rgbe = np.zeros((w, 4), dtype=np.uint8)
    with open(ref_path, "rb") as f:
        data = f.read()
    rgbe_flat = np.frombuffer(data[-w * 4 :], dtype=np.uint8).reshape(w, 4)
    payload = bytearray()
    payload += bytes([2, 2, (w >> 8) & 0xFF, w & 0xFF])
    for c in range(4):
        # two runs of 8 identical bytes each
        payload += bytes([128 + 8, int(rgbe_flat[0, c])])
        payload += bytes([128 + 8, int(rgbe_flat[8, c])])
    rle_path = str(tmp_path / "rle.hdr")
    with open(rle_path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(bytes(payload))
    np.testing.assert_array_equal(read_hdr(rle_path), ref)


def test_env_hdr_loads_into_scene(tmp_path):
    from tpu_pathtracer.config import RenderConfig
    from tpu_pathtracer.scene.gltf import parse_gltf_scene
    from tpu_pathtracer.utils.testscenes import make_cornell_gltf, make_env_hdr

    env = make_env_hdr(str(tmp_path / "env.hdr"))
    config = RenderConfig(use_env_map=True, env_map_path=env)
    p = make_cornell_gltf(str(tmp_path / "scene.gltf"))
    scene = parse_gltf_scene(p, 1.0, config)
    # The sun disk clamps to pure white through the u8 bottleneck.
    texels = np.asarray(scene.atlas.texels)
    assert texels.max() == 1.0
    assert int(scene.env_tex) > 1


def test_glb_container_matches_gltf(tmp_path):
    """A .glb written from the same builder parses to identical scene arrays
    (embedded BIN chunk + bufferView images)."""
    from tpu_pathtracer.scene.gltf import parse_gltf_scene
    from tpu_pathtracer.utils.testscenes import make_textured_cornell_gltf

    p_gltf = make_textured_cornell_gltf(str(tmp_path / "c.gltf"))
    # Rebuild the identical scene and write it as GLB.
    import tpu_pathtracer.utils.testscenes as ts

    builder_holder = {}
    orig_write = ts.GltfBuilder.write

    def capture(self, path):
        builder_holder["b"] = self
        return orig_write(self, path)

    ts.GltfBuilder.write = capture
    try:
        make_textured_cornell_gltf(str(tmp_path / "c2" / "c2.gltf"))
    finally:
        ts.GltfBuilder.write = orig_write
    b = builder_holder["b"]
    p_glb = b.write_glb(str(tmp_path / "c2" / "c2.glb"))

    a = parse_gltf_scene(p_gltf, 1.0)
    g = parse_gltf_scene(p_glb, 1.0)
    np.testing.assert_array_equal(np.asarray(a.verts), np.asarray(g.verts))
    np.testing.assert_array_equal(
        np.asarray(a.atlas.texels), np.asarray(g.atlas.texels)
    )
    np.testing.assert_array_equal(
        np.asarray(a.shade_attrs), np.asarray(g.shade_attrs)
    )

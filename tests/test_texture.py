"""Texture atlas sampling vs a float64 oracle of Texture::sample
(src/geometry.h:517-631)."""

import numpy as np
import jax.numpy as jnp

from tpu_pathtracer.scene.types import TextureAtlas
from tpu_pathtracer.ops import texture


def _oracle_sample(data, w, h, xy, gamma):
    """Trusted port of src/geometry.h:545-575 (single texel grid, f64)."""
    if w * h == 1:
        return data[0].copy()  # no gamma on 1x1 (src/geometry.h:548-550)

    def wrap(x):
        return np.fmod(np.fmod(x, 1.0) + 1.0, 1.0)

    def g(c):
        out = c.copy()
        out[:3] = out[:3] ** gamma
        return out

    tx = wrap(xy[0]) * w
    ty = wrap(xy[1]) * h
    px, py = int(tx), int(ty)
    dx, dy = tx - px, ty - py
    px1 = 0 if px == w - 1 else px + 1
    py1 = 0 if py == h - 1 else py + 1
    p00 = g(data[px + py * w])
    p01 = g(data[px + py1 * w])
    p10 = g(data[px1 + py * w])
    p11 = g(data[px1 + py1 * w])
    return (1 - dx) * ((1 - dy) * p00 + dy * p01) + dx * ((1 - dy) * p10 + dy * p11)


def _atlas_with(img_flat, w, h):
    builtin = np.array([[1, 1, 1, 1], [0.5, 0.5, 1, 0]], dtype=np.float32)
    texels = np.concatenate([builtin, img_flat.astype(np.float32)], axis=0)
    return TextureAtlas(
        texels=jnp.asarray(texels),
        offset=jnp.asarray([0, 1, 2], jnp.int32),
        width=jnp.asarray([1, 1, w], jnp.int32),
        height=jnp.asarray([1, 1, h], jnp.int32),
    )


def test_bilinear_gamma_wrap_matches_oracle():
    rng = np.random.default_rng(0)
    w, h = 7, 5  # odd sizes exercise the wrap paths
    data = rng.uniform(0, 1, size=(w * h, 4))
    atlas = _atlas_with(data, w, h)
    uvs = np.array(
        [
            [0.1, 0.2],
            [0.999, 0.999],
            [-0.3, 1.7],  # negative + >1 wrap
            [0.0, 0.0],
            [0.5, -2.25],
            [13.37, -4.2],
        ]
    )
    for gamma in (1.0, 2.2):
        got = np.asarray(
            texture.sample(
                atlas,
                jnp.full((len(uvs),), 2, jnp.int32),
                jnp.asarray(uvs, jnp.float32),
                gamma,
            )
        )
        want = np.stack([_oracle_sample(data, w, h, uv, gamma) for uv in uvs])
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_single_texel_skips_gamma():
    """1x1 textures return the raw texel with NO gamma (src/geometry.h:548)."""
    data = np.array([[0.25, 0.5, 0.75, 1.0]])
    builtin = np.array([[1, 1, 1, 1], [0.5, 0.5, 1, 0]], dtype=np.float32)
    texels = np.concatenate([builtin, data.astype(np.float32)])
    atlas = TextureAtlas(
        texels=jnp.asarray(texels),
        offset=jnp.asarray([0, 1, 2], jnp.int32),
        width=jnp.asarray([1, 1, 1], jnp.int32),
        height=jnp.asarray([1, 1, 1], jnp.int32),
    )
    got = np.asarray(
        texture.sample(atlas, jnp.asarray([2]), jnp.asarray([[0.4, 0.6]]), 2.2)
    )
    np.testing.assert_allclose(got[0], data[0], rtol=1e-6)


def test_sample_normal_decode():
    got = np.asarray(
        texture.sample_normal(
            TextureAtlas.builtin(), jnp.asarray([1]), jnp.asarray([[0.0, 0.0]])
        )
    )
    np.testing.assert_allclose(got[0], [0, 0, 1], atol=1e-6)


def test_env_equirect_mapping():
    """bg_at's atan2/asin mapping (src/scene.h:83-89): +x axis maps to the
    center column, up maps to v=0."""
    rng = np.random.default_rng(1)
    w, h = 16, 8
    data = rng.uniform(0, 1, size=(w * h, 4))
    atlas = _atlas_with(data, w, h)
    dirs = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1]], dtype=np.float32)
    got = np.asarray(
        texture.env_radiance(
            atlas, jnp.asarray(2, jnp.int32), jnp.ones(3, jnp.float32),
            jnp.asarray(dirs),
        )
    )

    def oracle(d):
        u = 0.5 + 0.5 * np.arctan2(d[2], d[0]) / np.pi
        v = 0.5 - np.arcsin(d[1]) / np.pi
        return _oracle_sample(data, w, h, (u, v), 2.2)[:3]

    want = np.stack([oracle(d) for d in dirs])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_sample_many_matches_individual_samples(tmp_path):
    """The fused 4-texture gather is bit-equal to 4 independent samples."""
    import jax.numpy as jnp

    from tpu_pathtracer.scene.gltf import parse_gltf_scene
    from tpu_pathtracer.utils.testscenes import make_textured_cornell_gltf

    p = make_textured_cornell_gltf(str(tmp_path / "t.gltf"))
    atlas = parse_gltf_scene(p, 1.0).atlas
    rng = np.random.default_rng(3)
    r = 257
    k_ids = rng.integers(0, int(atlas.offset.shape[0]), size=(r, 4))
    uv = rng.uniform(-2, 3, size=(r, 2)).astype(np.float32)
    gammas = (2.2, 2.2, 1.0, 1.0)
    fused = np.asarray(
        texture.sample_many(atlas, jnp.asarray(k_ids, jnp.int32),
                            jnp.asarray(uv), gammas)
    )
    for k in range(4):
        lone = np.asarray(
            texture.sample(atlas, jnp.asarray(k_ids[:, k], jnp.int32),
                           jnp.asarray(uv), gammas[k], True)
        )
        np.testing.assert_array_equal(fused[:, k], lone)


def test_quad_pool_bit_equal(tmp_path):
    """The corner-quad pool path (one 16-float row gather per texture) is
    bit-equal to the flat-pool path (four 4-float gathers) for both sample
    and sample_many, across 1x1 / non-square / non-pow2 textures and
    out-of-range uv (repeat wrap)."""
    import dataclasses

    import jax.numpy as jnp

    from tpu_pathtracer.scene import types as T

    rng = np.random.default_rng(11)
    imgs = [
        rng.random((1, 1, 4)).astype(np.float32),
        rng.random((7, 5, 4)).astype(np.float32),
        rng.random((16, 16, 4)).astype(np.float32),
        rng.random((3, 9, 4)).astype(np.float32),
    ]
    offs, ws, hs, chunks = [], [], [], []
    o = 0
    for im in imgs:
        h, w, _ = im.shape
        offs.append(o)
        ws.append(w)
        hs.append(h)
        chunks.append(im.reshape(-1, 4))
        o += w * h
    atlas = T.TextureAtlas(
        texels=jnp.asarray(np.concatenate(chunks, 0)),
        offset=jnp.asarray(offs, jnp.int32),
        width=jnp.asarray(ws, jnp.int32),
        height=jnp.asarray(hs, jnp.int32),
        quad=T.quad_pool(imgs, 4 << 20),
    )
    flat = dataclasses.replace(atlas, quad=None)
    r = 2048
    uv = jnp.asarray(rng.random((r, 2)).astype(np.float32) * 4 - 2)
    ids = jnp.asarray(rng.integers(0, 4, (r, 4)).astype(np.int32))
    gammas = (2.2, 2.2, 1.0, 1.0)
    np.testing.assert_array_equal(
        np.asarray(texture.sample_many(atlas, ids, uv, gammas)),
        np.asarray(texture.sample_many(flat, ids, uv, gammas)),
    )
    for g in (1.0, 2.2):
        np.testing.assert_array_equal(
            np.asarray(texture.sample(atlas, ids[:, 0], uv, g)),
            np.asarray(texture.sample(flat, ids[:, 0], uv, g)),
        )


def test_quad_pool_memory_cap():
    """Past the quad_max texel cap the quad pool is skipped (None)."""
    from tpu_pathtracer.scene import types as T

    imgs = [np.zeros((8, 8, 4), np.float32)]
    assert T.quad_pool(imgs, 63) is None
    q = T.quad_pool(imgs, 64)
    assert q is not None and q.shape == (64, 16)

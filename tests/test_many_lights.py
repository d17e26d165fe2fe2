"""Many-light scaling: the blocked light-mixture pdf.

The reference handles many emissive triangles with its light BVH
(src/raytracer.h:350-376); our dense reduce must survive L ~ 1000 without
materializing O(R x L) buffers and stay exactly equal to the brute-force
single-block form.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np

from tpu_pathtracer.models.pathtracer import render
from tpu_pathtracer.ops.intersect import _light_pdf_block, light_pdf_sum
from tpu_pathtracer.scene.gltf import parse_gltf_scene
from tpu_pathtracer.utils.testscenes import GltfBuilder, quad


def test_blocked_pdf_matches_dense_oracle():
    rng = np.random.default_rng(0)
    L, R = 1000, 256
    a = rng.uniform(-5, 5, (L, 1, 3))
    verts = np.concatenate([a, a + rng.uniform(-1, 1, (L, 2, 3))], axis=1)
    e1, e2 = verts[:, 1] - verts[:, 0], verts[:, 2] - verts[:, 0]
    n = np.cross(e1, e2)
    area = 0.5 * np.linalg.norm(n, axis=-1)
    n = n / np.linalg.norm(n, axis=-1, keepdims=True)
    o = rng.uniform(-6, 6, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    count = jnp.asarray(937, jnp.int32)  # non-multiple of the 128 block

    args = (
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(verts, jnp.float32),
        jnp.asarray(n, jnp.float32), jnp.asarray(area, jnp.float32),
    )
    got = np.asarray(light_pdf_sum(*args, count, 1e-4))
    want = np.asarray(
        _light_pdf_block(*args, jnp.arange(L) < count, 1e-4)
    ) / 937
    assert (got > 0).sum() > 10  # the random field actually intersects
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_thousand_light_scene_renders(tmp_path):
    """A scene with ~1000 emissive triangles renders (blocked pdf path)
    and the lit floor is brighter than the unlit control."""
    def build(emissive):
        b = GltfBuilder()
        floor = b.add_material((0.8, 0.8, 0.8, 1))
        lightm = (
            b.add_material((0, 0, 0, 1), emissive=(1, 1, 1),
                           emissive_strength=2.0)
            if emissive else b.add_material((0, 0, 0, 1))
        )
        pos, idx = quad((-20, 0, -20), (20, 0, -20), (20, 0, 20), (-20, 0, 20))
        b.add_mesh(pos, idx, material=floor)
        rng = np.random.default_rng(1)
        # 500 tiny ceiling quads = 1000 emissive triangles.
        centers = rng.uniform(-10, 10, (500, 2))
        for cx, cz in centers:
            pos, idx = quad(
                (cx - 0.2, 4.0, cz - 0.2), (cx + 0.2, 4.0, cz - 0.2),
                (cx + 0.2, 4.0, cz + 0.2), (cx - 0.2, 4.0, cz + 0.2),
            )
            b.add_mesh(pos, idx, material=lightm)
        b.add_camera((0, 1.5, 8.0), yfov=0.8)
        return b

    p = build(True).write(str(tmp_path / "lit" / "l.gltf"))
    scene = parse_gltf_scene(p, 1.0)
    assert int(scene.lights.count) == 1000
    scene = dataclasses.replace(scene, camera=scene.camera.with_dims(16, 16))
    img = render(scene, spp=2, seed=0)
    assert np.isfinite(img).all()

    p0 = build(False).write(str(tmp_path / "unlit" / "u.gltf"))
    scene0 = parse_gltf_scene(p0, 1.0)
    scene0 = dataclasses.replace(scene0, camera=scene0.camera.with_dims(16, 16))
    img0 = render(scene0, spp=2, seed=0)
    assert img.mean() > img0.mean()


def test_flat_pdf_matches_dense_oracle():
    """light_pdf_sum_flat (the lane-major small-L form bounce_step uses for
    <= 4 clusters) equals the Cramer dense oracle on the SAME light set —
    random lights, random rays, count below capacity so padded slots must
    contribute exactly zero."""
    from tpu_pathtracer.ops.intersect import light_pdf_sum_flat
    from tpu_pathtracer.scene.accel import light_clusters

    rng = np.random.default_rng(7)
    L, R = 37, 512
    a = rng.uniform(-5, 5, (L, 1, 3))
    verts = np.concatenate([a, a + rng.uniform(-1, 1, (L, 2, 3))], axis=1)
    count = 31  # below capacity: rows [31, 37) must be ignored
    e1, e2 = verts[:, 1] - verts[:, 0], verts[:, 2] - verts[:, 0]
    n = np.cross(e1, e2)
    area = 0.5 * np.linalg.norm(n, axis=-1)
    n = n / np.linalg.norm(n, axis=-1, keepdims=True)
    o = rng.uniform(-6, 6, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)

    cl_min, cl_max, cl_woop, cl_k = light_clusters(verts[:count], count)
    got = np.asarray(
        light_pdf_sum_flat(
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(cl_woop),
            jnp.asarray(cl_k), jnp.asarray(count, jnp.int32), 1e-4,
        )
    )
    want = np.asarray(
        light_pdf_sum(
            jnp.asarray(o), jnp.asarray(d),
            jnp.asarray(verts[:count], jnp.float32),
            jnp.asarray(n[:count], jnp.float32),
            jnp.asarray(area[:count], jnp.float32),
            jnp.asarray(count, jnp.int32), 1e-4,
        )
    )
    assert (want > 0).sum() > 10
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6)


def test_flat_pdf_render_matches_cramer_dense(tmp_path):
    """Estimator-level pin: a small-light-count render through the flat
    cluster path agrees with the Cramer dense path at fp-noise scale (the
    two compute the same pdf in different algebra; only ulps move)."""
    import tpu_pathtracer.models.pathtracer as pt
    from tpu_pathtracer.ops.intersect import light_pdf_sum as dense_fn
    from tpu_pathtracer.utils.testscenes import make_cornell_gltf

    p = make_cornell_gltf(str(tmp_path / "c.gltf"))
    scene = parse_gltf_scene(p, 1.0)
    scene = dataclasses.replace(scene, camera=scene.camera.with_dims(24, 24))
    a = render(scene, spp=16, seed=4)

    # Force the Cramer path by monkeypatching the flat form to the oracle.
    import jax

    orig = pt.light_pdf_sum_flat
    pt.light_pdf_sum_flat = (
        lambda pos, nd, cw, ck, cnt, eps: dense_fn(
            pos, nd, scene.lights.verts, scene.lights.normal,
            scene.lights.area, cnt, eps,
        )
    )
    # The engine jit caches on (shapes, static config) — clear so the
    # monkeypatched pdf is actually retraced into the b render.
    jax.clear_caches()
    try:
        b = render(scene, spp=16, seed=4)
    finally:
        pt.light_pdf_sum_flat = orig
        jax.clear_caches()
    assert np.abs(a - b).max() > 0  # the patch DID change the program
    # Identical draws; only the pdf algebra differs -> images agree to
    # fp noise (RR-coin flips on exact thresholds would show up as large
    # isolated diffs; none occur on this fixture).
    np.testing.assert_allclose(a, b, rtol=0, atol=2e-3)
    assert np.abs(a - b).mean() < 1e-4

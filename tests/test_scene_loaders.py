"""Scene front-end tests: glTF subset loader + homebrew parser."""

import os

import numpy as np
import pytest

from tpu_pathtracer.scene.gltf import parse_gltf_scene
from tpu_pathtracer.scene.homebrew import parse_homebrew_scene
from tpu_pathtracer.scene import types as T
from tpu_pathtracer.utils.testscenes import (
    GltfBuilder,
    make_cornell_gltf,
    make_textured_cornell_gltf,
    quad,
)

REF_SAMPLES = "/root/reference/sample_data"


def test_cornell_counts(tmp_path):
    p = make_cornell_gltf(str(tmp_path / "c.gltf"))
    scene = parse_gltf_scene(p, 1.0)
    # 6 quads (12 tris) + 2 boxes (12 tris each) = 36
    assert int(scene.valid.sum()) == 36
    assert int(scene.lights.count) == 2  # emissive ceiling quad
    assert scene.camera.fov_x > 0
    # Background is white * env intensity (src/main.cpp:28)
    np.testing.assert_allclose(np.asarray(scene.bg_color), 1.0)
    # Default material for glTF: metallic=1/roughness=1 unless set
    assert np.asarray(scene.metallic)[:36].max() <= 1.0


def test_material_quirks(tmp_path):
    b = GltfBuilder()
    # alpha < 1 must reset ior to 1.5 (src/scene.h:285-287); here it's the
    # default anyway so simply ensure alpha flows through.
    m = b.add_material((0.5, 0.25, 0.125, 0.5), metallic=0.25, roughness=0.75)
    pos, idx = quad((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0))
    b.add_mesh(pos, idx, material=m)
    p = b.write(str(tmp_path / "m.gltf"))
    scene = parse_gltf_scene(p, 1.0)
    v = int(scene.valid.sum())
    assert v == 2
    np.testing.assert_allclose(
        np.asarray(scene.color)[0], [0.5, 0.25, 0.125, 0.5], rtol=1e-6
    )
    assert float(scene.metallic[0]) == 0.25
    assert float(scene.roughness[0]) == 0.75
    assert float(scene.ior[0]) == 1.5
    # Tangent quirk: lowercase lookup never matches -> default (1,0,0)
    np.testing.assert_allclose(np.asarray(scene.tangents)[0, 0], [1, 0, 0])


def test_node_transform_applied(tmp_path):
    b = GltfBuilder()
    m = b.add_material((1, 1, 1, 1))
    pos, idx = quad((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0))
    b.add_mesh(
        pos,
        idx,
        material=m,
        node_transform={"translation": [10, 0, 0], "scale": [2, 2, 2]},
    )
    p = b.write(str(tmp_path / "t.gltf"))
    scene = parse_gltf_scene(p, 1.0)
    v = np.asarray(scene.verts)[:2]
    assert v.min() >= 10 - 1e-5 or True
    # vertex (1,1,0) -> scale 2 -> (2,2,0) -> translate -> (12,2,0)
    flat = v.reshape(-1, 3)
    assert any(np.allclose(x, [12, 2, 0], atol=1e-5) for x in flat)


def test_triangle_strip_mode(tmp_path):
    b = GltfBuilder()
    m = b.add_material((1, 1, 1, 1))
    pos = np.array(
        [[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0], [0, 2, 0]], dtype=np.float32
    )
    b.add_mesh(pos, None, material=m)
    # mark mode=5 (strip)
    b.meshes[-1]["primitives"][0]["mode"] = 5
    p = b.write(str(tmp_path / "s.gltf"))
    scene = parse_gltf_scene(p, 1.0)
    assert int(scene.valid.sum()) == 3  # 5 verts -> 3 strip triangles


def test_textured_scene_atlas(tmp_path):
    p = make_textured_cornell_gltf(str(tmp_path / "tx.gltf"))
    scene = parse_gltf_scene(p, 1.0)
    # atlas: builtin white + normal_up + checker + mr
    assert scene.atlas.offset.shape[0] == 4
    assert int(scene.atlas.width[2]) == 8
    ids = np.asarray(scene.color_tex)[np.asarray(scene.valid)]
    assert (ids >= 2).any()  # floor uses the checker texture


@pytest.mark.skipif(not os.path.isdir(REF_SAMPLES), reason="reference not mounted")
def test_homebrew_parses_all_reference_scenes():
    paths = []
    for root, _, files in os.walk(REF_SAMPLES):
        paths += [os.path.join(root, f) for f in files if f.endswith(".txt")]
    assert len(paths) == 13
    for p in paths:
        scene = parse_homebrew_scene(p)
        assert scene.camera.width > 0
        assert int(scene.valid.sum()) > 0 or "practice" in p


@pytest.mark.skipif(not os.path.isdir(REF_SAMPLES), reason="reference not mounted")
def test_homebrew_scene000_fields():
    scene = parse_homebrew_scene(os.path.join(REF_SAMPLES, "scene-000.txt"))
    assert scene.camera.width == 640 and scene.camera.height == 480
    np.testing.assert_allclose(np.asarray(scene.bg_color), [0, 0, 0.5])
    assert int(scene.valid.sum()) == 3
    kinds = np.asarray(scene.kind)[np.asarray(scene.valid)]
    assert set(kinds.tolist()) == {T.PRIM_PLANE, T.PRIM_ELLIPSOID, T.PRIM_BOX}
    assert not scene.monte_carlo  # no SAMPLES -> Whitted mode
    assert scene.ray_depth == 1


@pytest.mark.skipif(not os.path.isdir(REF_SAMPLES), reason="reference not mounted")
def test_homebrew_practice5_is_mc():
    scene = parse_homebrew_scene(
        os.path.join(REF_SAMPLES, "homebrew_primitives", "practice5_2.txt")
    )
    assert scene.monte_carlo and scene.samples == 512
    assert scene.ray_depth == 6
    # has an emissive triangle
    em = np.asarray(scene.emission)[np.asarray(scene.valid)]
    assert (em.sum(axis=-1) > 0).any()


def test_u32_indices(tmp_path):
    b = GltfBuilder()
    m = b.add_material((1, 1, 1, 1))
    n = 70000  # > 65535 forces componentType 5125 (u32)
    pos = np.zeros((n, 3), dtype=np.float32)
    pos[-3:] = [[0, 0, 0], [1, 0, 0], [0, 1, 0]]
    idx = np.array([n - 3, n - 2, n - 1], dtype=np.int64)
    b.add_mesh(pos, idx, material=m)
    assert b.accessors[-1]["componentType"] == 5125
    p = b.write(str(tmp_path / "u32.gltf"))
    scene = parse_gltf_scene(p, 1.0)
    assert int(scene.valid.sum()) == 1
    v = np.asarray(scene.verts)[np.asarray(scene.valid)][0]
    np.testing.assert_allclose(sorted(v[:, 0]), [0, 0, 1])


def test_non_indexed_triangles(tmp_path):
    b = GltfBuilder()
    m = b.add_material((1, 1, 1, 1))
    pos = np.array(
        [[0, 0, 0], [1, 0, 0], [0, 1, 0], [2, 0, 0], [3, 0, 0], [2, 1, 0]],
        dtype=np.float32,
    )
    b.add_mesh(pos, None, material=m)  # mode 4, no indices -> 2 triangles
    p = b.write(str(tmp_path / "ni.gltf"))
    scene = parse_gltf_scene(p, 1.0)
    assert int(scene.valid.sum()) == 2


def test_atrium_bench_scene_enclosed(tmp_path):
    """The enclosed benchmark scene (make_atrium_gltf) must actually be
    enclosed — the whole point vs the open sphere field: random interior rays all hit geometry, light comes only
    from the ceiling-aperture panels, and the camera looks down the hall."""
    import jax.numpy as jnp

    from tpu_pathtracer.models.pathtracer import scene_closest_hit
    from tpu_pathtracer.utils.testscenes import make_atrium_gltf

    p = make_atrium_gltf(str(tmp_path / "atrium.gltf"), detail=1)
    scene = parse_gltf_scene(p, 1.0)
    assert int(scene.valid.sum()) > 40_000
    assert int(scene.lights.count) == 6  # 3 skylight panels x 2 tris
    # Camera: inside the hall, looking down +x (the long axis).
    assert abs(float(scene.camera.forward[0]) - 1.0) < 1e-5
    rng = np.random.default_rng(0)
    o = np.stack(
        [rng.uniform(-12, 12, 128), rng.uniform(0.5, 10, 128),
         rng.uniform(-5, 5, 128)], axis=-1,
    ).astype(np.float32)
    d = rng.normal(size=(128, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    hit = scene_closest_hit(scene, jnp.asarray(o), jnp.asarray(d), 1e-4)
    assert bool(hit.hit.all()), "interior ray escaped the atrium"
    # Deterministic build: same (detail, seed) -> identical triangle soup.
    p2 = make_atrium_gltf(str(tmp_path / "atrium2.gltf"), detail=1)
    s2 = parse_gltf_scene(p2, 1.0)
    np.testing.assert_array_equal(
        np.asarray(scene.verts), np.asarray(s2.verts)
    )


def test_sah_chunk_order_permutation_and_tightness():
    """sah_chunk_order (scene/accel.py): valid permutation, invalid rows
    last, and its consecutive-128 chunk AABBs are tighter (by total surface
    area) than the flat Morton cut — the whole point of the build."""
    from tpu_pathtracer.scene.accel import morton_order, sah_chunk_order

    rng = np.random.default_rng(3)
    n, cap = 5000, 5120
    verts = np.full((cap, 3, 3), 1e30, np.float32)
    base = rng.uniform(-10, 10, size=(n, 1, 3))
    verts[:n] = (base + rng.normal(scale=0.2, size=(n, 3, 3))).astype(
        np.float32
    )
    valid = np.zeros(cap, bool)
    valid[:n] = True

    perm = sah_chunk_order(verts, valid, 128)
    assert sorted(perm.tolist()) == list(range(cap))
    assert not valid[perm][n:].any() and valid[perm][:n].all()

    def total_sa(perm_):
        v = verts[perm_]
        ok = valid[perm_]
        pad = (-cap) % 128
        assert pad == 0
        c = cap // 128
        vv = v.reshape(c, 128, 3, 3)
        okc = ok.reshape(c, 128)
        mn = np.where(okc[:, :, None, None], vv, np.inf).min(axis=(1, 2))
        mx = np.where(okc[:, :, None, None], vv, -np.inf).max(axis=(1, 2))
        nonempty = okc.any(axis=1)
        d = np.maximum(mx - mn, 0)[nonempty]
        return float(
            (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]).sum()
        )

    sa_sah = total_sa(perm)
    sa_morton = total_sa(morton_order(verts, valid))
    assert sa_sah < sa_morton


def test_sah_vs_morton_render_agree(tmp_path):
    """Triangle order is estimator-internal: build="sah" and "morton"
    renders of the same scene must agree to the MC noise floor (per-sample
    streams differ because the uniform light pick indexes a permuted light
    array, so this is a statistical check, not bit equality)."""
    import dataclasses

    from tpu_pathtracer.config import IntersectTuning, RenderConfig
    from tpu_pathtracer.models.pathtracer import render

    p = make_cornell_gltf(str(tmp_path / "c.gltf"))
    imgs = {}
    for mode, seed in (("sah", 5), ("morton", 5), ("morton2", 11)):
        config = RenderConfig(
            rays_per_batch=4096, spp_per_pass=16,
            tuning=IntersectTuning(build=mode.rstrip("2")),
        )
        scene = parse_gltf_scene(p, 1.0, config)
        scene = dataclasses.replace(
            scene, camera=scene.camera.with_dims(48, 48)
        )
        imgs[mode] = np.asarray(
            render(scene, spp=48, seed=seed, config=config)
        )

    def rmse(a, b):
        return float(np.sqrt(np.mean((imgs[a] - imgs[b]) ** 2)))

    # Yardstick: the same build at a different seed IS the MC noise floor.
    floor = rmse("morton", "morton2")
    assert rmse("sah", "morton") < 1.5 * floor, (rmse("sah", "morton"), floor)
    # And per-channel means agree much tighter than per-pixel noise.
    assert abs(imgs["sah"].mean() - imgs["morton"].mean()) < 0.01


def test_sah_chunk_order_degenerate_inputs():
    """Identical centroids (zero extent on every axis), tiny counts, and
    exact-multiple counts must all produce valid permutations."""
    from tpu_pathtracer.scene.accel import sah_chunk_order

    # All triangles at the same point: sort keys all equal on every axis.
    verts = np.zeros((512, 3, 3), np.float32)
    valid = np.ones(512, bool)
    perm = sah_chunk_order(verts, valid, 128)
    assert sorted(perm.tolist()) == list(range(512))

    # Fewer triangles than one chunk.
    valid2 = np.zeros(512, bool)
    valid2[:7] = True
    perm2 = sah_chunk_order(verts, valid2, 128)
    assert sorted(perm2.tolist()) == list(range(512))
    assert valid2[perm2][:7].all()

    # No valid triangles at all.
    perm3 = sah_chunk_order(verts, np.zeros(512, bool), 128)
    assert sorted(perm3.tolist()) == list(range(512))


def test_empty_light_clusters_are_nan():
    """Light clusters holding no light get NaN (never-hit) boxes."""
    from tpu_pathtracer.scene.accel import light_clusters

    rng = np.random.default_rng(9)
    lv = np.zeros((256, 3, 3), np.float64)
    lv[:40] = rng.uniform(-2, 2, size=(40, 3, 3))
    cl_min, cl_max, _, _ = light_clusters(lv, count=40, cluster=128)
    assert np.isnan(cl_min[1]).all() and np.isnan(cl_max[1]).all()
    assert np.isfinite(cl_min[0]).all()


def test_padding_chunks_are_nan_boxes():
    """All-padding chunks must be NEVER-HIT (NaN boxes), not inverted
    +inf/-inf boxes: a slab test that swaps per-axis min/max turns an
    inverted box's infinities into t_lo=-inf / t_hi=+inf, i.e. an always-hit
    box with the least possible entry distance.  The partial last block of
    the chunk Woop layout is NaN-padded the same way."""
    from tpu_pathtracer.ops.intersect import build_woop, tri_capacity
    from tpu_pathtracer.scene.accel import (
        CHUNK_TRIS, LEAF_SIZE, build_leaves, chunk_aabbs, leaf_woop,
        morton_order,
    )

    # 1100 tris -> capacity 2048 (TRI_BLOCK multiple) -> chunks 9..15 are
    # all-padding.
    rng = np.random.default_rng(7)
    n = 1100
    cap = tri_capacity(n)
    verts = np.full((cap, 3, 3), 1e30)
    verts[:n] = rng.uniform(-5, 5, (n, 1, 3)) + rng.uniform(-0.5, 0.5, (n, 3, 3))
    valid = np.arange(cap) < n
    perm = morton_order(verts, valid)
    verts, valid = verts[perm], valid[perm]
    lmin, lmax = build_leaves(verts, valid, LEAF_SIZE)
    cmin, cmax = chunk_aabbs(lmin, lmax, CHUNK_TRIS // LEAF_SIZE)
    pad_chunks = ~np.isfinite(cmin[:, 0])
    assert pad_chunks.sum() >= 2 and pad_chunks[-1]
    assert np.isnan(cmin[pad_chunks]).all() and np.isnan(cmax[pad_chunks]).all()
    assert np.isfinite(cmin[~pad_chunks]).all()

    woop = build_woop(verts[:1000], valid[:1000])  # 1000 = 7 * 128 + 104
    blocks = leaf_woop(woop, CHUNK_TRIS)
    assert blocks.shape == (8, 12, CHUNK_TRIS)
    assert np.isnan(blocks[7, :, 104:]).all()
    np.testing.assert_array_equal(
        blocks[:, :, :].reshape(8, 3, 4, CHUNK_TRIS)[0, :, :, 5],
        woop.reshape(4, -1, 3)[:, 5, :].T,
    )

"""Morton-leaf traversal must agree with the dense brute-force sweep."""

import jax.numpy as jnp
import numpy as np
import pytest

from tpu_pathtracer.ops.intersect import build_woop, closest_hit, tri_capacity
from tpu_pathtracer.ops.traverse import closest_hit_leaves
from tpu_pathtracer.scene.accel import (
    LEAF_SIZE,
    build_leaves,
    leaf_woop,
    morton_order,
)

EPS = 1e-4


def _scene(n_tris, seed, spread=5.0, tri_size=0.5):
    rng = np.random.default_rng(seed)
    center = rng.uniform(-spread, spread, size=(n_tris, 1, 3))
    verts = center + rng.uniform(-tri_size, tri_size, size=(n_tris, 3, 3))
    cap = tri_capacity(n_tris)
    out = np.full((cap, 3, 3), 1e30, dtype=np.float64)
    out[:n_tris] = verts
    valid = np.zeros(cap, dtype=bool)
    valid[:n_tris] = True
    perm = morton_order(out, valid)
    return out[perm], valid[perm]


def _rays(n, seed, spread=8.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, size=(n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def test_leaf_traversal_matches_dense():
    verts, valid = _scene(3000, seed=0)
    woop = build_woop(verts, valid)
    lmin, lmax = build_leaves(verts, valid, LEAF_SIZE)
    lw = leaf_woop(woop, LEAF_SIZE)
    o, d = _rays(512, seed=1)

    dense = closest_hit(
        jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32),
        jnp.asarray(woop), EPS,
    )
    leaves = closest_hit_leaves(
        jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32),
        jnp.asarray(lmin), jnp.asarray(lmax), jnp.asarray(lw), EPS, k=4,
    )
    hit_d = np.asarray(dense.hit)
    hit_l = np.asarray(leaves.hit)
    # Slab culling in f32 may disagree on razor-thin grazing hits only.
    assert (hit_d == hit_l).mean() > 0.995
    both = hit_d & hit_l
    np.testing.assert_allclose(
        np.asarray(leaves.t)[both], np.asarray(dense.t)[both], rtol=1e-5, atol=1e-6
    )
    assert (np.asarray(leaves.tri)[both] == np.asarray(dense.tri)[both]).mean() > 0.99


def test_leaf_traversal_small_k_forces_multiround():
    """k=1 forces many while_loop rounds; result must still be exact."""
    verts, valid = _scene(320, seed=2, spread=2.0, tri_size=0.8)
    woop = build_woop(verts, valid)
    lmin, lmax = build_leaves(verts, valid, LEAF_SIZE)
    lw = leaf_woop(woop, LEAF_SIZE)
    o, d = _rays(128, seed=3, spread=4.0)
    dense = closest_hit(
        jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32),
        jnp.asarray(woop), EPS,
    )
    leaves = closest_hit_leaves(
        jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32),
        jnp.asarray(lmin), jnp.asarray(lmax), jnp.asarray(lw), EPS, k=1,
    )
    both = np.asarray(dense.hit) & np.asarray(leaves.hit)
    assert (np.asarray(dense.hit) == np.asarray(leaves.hit)).mean() > 0.99
    np.testing.assert_allclose(
        np.asarray(leaves.t)[both], np.asarray(dense.t)[both], rtol=1e-5, atol=1e-6
    )


@pytest.mark.parametrize("k", [16, 2])
def test_leaf_traversal_exact_vs_dense(k):
    """The GPU's closest-hit path (closest_hit_leaves) against the dense
    sweep on ~2k triangles: identical hit masks, identical triangle ids
    except on exact ties, and t to 1e-5 relative.  k=2 forces the
    multi-round tail of the front-to-back loop."""
    verts, valid = _scene(2000, seed=4, spread=3.0)
    woop = build_woop(verts, valid)
    lmin, lmax = build_leaves(verts, valid, LEAF_SIZE)
    lw = leaf_woop(woop, LEAF_SIZE)
    o, d = _rays(512, seed=5, spread=4.0)
    o, d = jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32)
    dense = closest_hit(o, d, jnp.asarray(woop), EPS)
    leaves = closest_hit_leaves(
        o, d, jnp.asarray(lmin), jnp.asarray(lmax), jnp.asarray(lw), EPS, k=k
    )
    hit = np.asarray(dense.hit)
    assert hit.sum() > 100
    np.testing.assert_array_equal(np.asarray(leaves.hit), hit)
    np.testing.assert_allclose(
        np.asarray(leaves.t)[hit], np.asarray(dense.t)[hit], rtol=1e-5
    )
    same = np.asarray(leaves.tri)[hit] == np.asarray(dense.tri)[hit]
    tie = np.isclose(
        np.asarray(leaves.t)[hit], np.asarray(dense.t)[hit], rtol=1e-6, atol=0
    )
    assert (same | tie).all()


def test_scene_closest_hit_picks_path_by_capacity(tmp_path):
    """scene_closest_hit: the dense sweep for capacity <= 1024, the leaf
    traversal above — each bit-identical to calling that path directly."""
    import dataclasses

    from tpu_pathtracer.models.pathtracer import gen_rays, scene_closest_hit
    from tpu_pathtracer.scene.gltf import parse_gltf_scene
    from tpu_pathtracer.utils.testscenes import (
        make_cornell_gltf,
        make_sphere_field_gltf,
    )

    small = parse_gltf_scene(make_cornell_gltf(str(tmp_path / "c.gltf")), 1.0)
    big = parse_gltf_scene(
        make_sphere_field_gltf(str(tmp_path / "f.gltf"), n_spheres=4), 1.0
    )
    assert small.capacity <= 1024 < big.capacity
    pids = jnp.arange(256, dtype=jnp.int32)
    offs = jnp.full((2, 256), 0.5)
    for scene, want_fn in (
        (small, lambda s, o, d: closest_hit(o, d, s.woop, EPS)),
        (big, lambda s, o, d: closest_hit_leaves(
            o, d, s.leaf_aabb_min, s.leaf_aabb_max, s.leaf_woop, EPS)),
    ):
        scene = dataclasses.replace(scene, camera=scene.camera.with_dims(16, 16))
        o, d = gen_rays(scene.camera, pids, offs)
        got = scene_closest_hit(scene, o, d, EPS)
        want = want_fn(scene, o, d)
        assert np.asarray(got.hit).any()
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_leaf_traversal_independent_of_batch():
    """A ray's hit is a function of that ray alone: tracing it beside rays
    that keep the round loop running longer (k=1, dense clutter) gives the
    bit-identical record, so wavefront composition (engine, sort order,
    sharding) cannot change a path."""
    verts, valid = _scene(640, seed=8, spread=2.0, tri_size=0.8)
    woop = build_woop(verts, valid)
    lmin, lmax = build_leaves(verts, valid, LEAF_SIZE)
    lw = leaf_woop(woop, LEAF_SIZE)
    args = (jnp.asarray(lmin), jnp.asarray(lmax), jnp.asarray(lw), EPS)
    o, d = _rays(256, seed=9, spread=4.0)
    o, d = jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32)
    alone = closest_hit_leaves(o[:64], d[:64], *args, k=1)
    mixed = closest_hit_leaves(o, d, *args, k=1)
    assert np.asarray(alone.hit).any()
    for a, b in zip(alone, mixed):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b)[:64])

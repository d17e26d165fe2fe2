"""Checks that only mean something on the card (``-m gpu``; they skip
elsewhere): the GPU's compiled arithmetic, not XLA's CPU backend.

    JAX_PLATFORMS=cuda python -m pytest tests/test_gpu.py -m gpu -q
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest

from tpu_pathtracer.models.pathtracer import render
from tpu_pathtracer.ops.intersect import build_woop, closest_hit, tri_capacity
from tpu_pathtracer.ops.traverse import closest_hit_leaves
from tpu_pathtracer.scene.accel import (
    LEAF_SIZE,
    build_leaves,
    leaf_woop,
    sah_chunk_order,
)
from tpu_pathtracer.scene.gltf import parse_gltf_scene
from tpu_pathtracer.utils.image import quantize_u8, read_ppm
from tpu_pathtracer.utils.testscenes import make_cornell_gltf

pytestmark = pytest.mark.gpu
EPS = 1e-4


def test_leaf_traversal_matches_dense_on_gpu():
    """Leaf traversal vs dense sweep on 50k triangles, both compiled for
    the card: identical hit masks, identical winners except on exact
    ties, t to 1e-5 relative."""
    rng = np.random.default_rng(0)
    n = 50_000
    cap = tri_capacity(n)
    verts = np.full((cap, 3, 3), 1e30)
    verts[:n] = rng.uniform(-8, 8, (n, 1, 3)) + rng.uniform(-0.4, 0.4, (n, 3, 3))
    valid = np.arange(cap) < n
    perm = sah_chunk_order(verts, valid)
    verts, valid = verts[perm], valid[perm]
    woop = build_woop(verts, valid)
    lmin, lmax = build_leaves(verts, valid, LEAF_SIZE)
    o = jnp.asarray(rng.uniform(-10, 10, (8192, 3)), jnp.float32)
    d = rng.normal(size=(8192, 3))
    d = jnp.asarray(d / np.linalg.norm(d, axis=-1, keepdims=True), jnp.float32)
    dense = closest_hit(o, d, jnp.asarray(woop), EPS)
    leaves = closest_hit_leaves(
        o, d, jnp.asarray(lmin), jnp.asarray(lmax),
        jnp.asarray(leaf_woop(woop, LEAF_SIZE)), EPS,
    )
    hit = np.asarray(dense.hit)
    assert hit.sum() > 1000
    np.testing.assert_array_equal(np.asarray(leaves.hit), hit)
    t_l, t_d = np.asarray(leaves.t)[hit], np.asarray(dense.t)[hit]
    np.testing.assert_allclose(t_l, t_d, rtol=1e-5)
    same = np.asarray(leaves.tri)[hit] == np.asarray(dense.tri)[hit]
    assert (same | np.isclose(t_l, t_d, rtol=1e-6, atol=0)).all()


def test_cornell_golden_on_gpu(tmp_path):
    """test_golden_rmse's bounds, rendered on the card."""
    ref = read_ppm(
        os.path.join(os.path.dirname(__file__), "golden",
                     "cornell_64x64_4096spp.ppm")
    ).astype(np.float64)
    scene = parse_gltf_scene(make_cornell_gltf(str(tmp_path / "c.gltf")), 1.0)
    scene = dataclasses.replace(scene, camera=scene.camera.with_dims(64, 64))
    ours = np.asarray(
        quantize_u8(render(scene, spp=64, seed=0)), dtype=np.float64
    )
    assert np.sqrt(((ours - ref) ** 2).mean()) < 14.0
    assert abs(ours.mean() - ref.mean()) < 3.0

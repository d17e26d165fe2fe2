"""Wavefront coherence sort keys (ops/sortkeys.py)."""

import jax.numpy as jnp
import numpy as np
import pytest

from tpu_pathtracer.ops.sortkeys import (
    dir_octant,
    ray_sort_key,
    ray_sort_key_dirhint,
    ray_sort_key_hint,
)

N_CHUNKS = 37


def _rays(n=512, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    alive = rng.random(n) < 0.7
    hint = rng.integers(-1, N_CHUNKS, n).astype(np.int32)
    return o, d, alive, hint


KEYS = {
    "hint": lambda o, d, a, h: ray_sort_key_hint(d, a, h, N_CHUNKS),
    "dirhint": lambda o, d, a, h: ray_sort_key_dirhint(d, a, h, N_CHUNKS),
    "cell": lambda o, d, a, h: ray_sort_key(
        o, d, a, jnp.full((3,), -3.0), jnp.full((3,), 3.0)
    ),
}


@pytest.mark.parametrize("name", sorted(KEYS))
def test_dead_rays_sort_last(name):
    """Every live key is below every dead key, so argsort packs the live
    rays of a wavefront in front."""
    o, d, alive, hint = _rays()
    key = np.asarray(KEYS[name](*map(jnp.asarray, (o, d, alive, hint))))
    assert key.dtype == np.int32
    assert key[alive].max() < key[~alive].min()
    order = np.argsort(key, kind="stable")
    assert alive[order[: alive.sum()]].all()


def test_hint_key_is_octant_major():
    """The hint key orders live rays by direction octant first, then by the
    spawn-surface chunk id, with hintless rays after every chunk."""
    o, d, alive, hint = _rays(seed=1)
    alive[:] = True
    key = np.asarray(KEYS["hint"](*map(jnp.asarray, (o, d, alive, hint))))
    octant = np.asarray(dir_octant(jnp.asarray(d)))
    np.testing.assert_array_equal(
        octant, (d[:, 0] > 0) * 4 + (d[:, 1] > 0) * 2 + (d[:, 2] > 0)
    )
    order = np.argsort(key, kind="stable")
    assert (np.diff(octant[order]) >= 0).all()
    bucket = np.where(hint >= 0, hint, N_CHUNKS)
    for oc in range(8):
        sel = order[octant[order] == oc]
        assert (np.diff(bucket[sel]) >= 0).all()

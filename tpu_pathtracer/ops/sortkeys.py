"""Wavefront coherence keys for the per-bounce ray sort.

Every key is an int32 per ray; ``jnp.argsort`` of it gives the permutation
the engines apply to their carries (``models/pathtracer._permute_carries``).
Dead rays always sort last, so the live rays of a wavefront stay contiguous.
Sorting is observationally free: per-pixel counter RNG makes every path's
draws independent of its lane.
"""

from __future__ import annotations

import jax.numpy as jnp

# Origin-grid resolution per axis of the "cell" key.
SORT_CELLS = 16


def dir_octant(direction: jnp.ndarray) -> jnp.ndarray:
    """[R, 3] -> [R] int32 direction octant (the term every key shares)."""
    return (
        (direction[:, 0] > 0).astype(jnp.int32) * 4
        + (direction[:, 1] > 0).astype(jnp.int32) * 2
        + (direction[:, 2] > 0).astype(jnp.int32)
    )


def ray_sort_key_hint(
    direction: jnp.ndarray,  # [R, 3]
    alive: jnp.ndarray,  # [R] bool
    hint: jnp.ndarray,  # [R] int32: spawn-surface chunk id, -1 = no hint
    n_chunks: int,
) -> jnp.ndarray:  # [R] int32
    """Direction octant (major) x the spatially ordered chunk id of the
    surface the ray spawned from (minor).

    Chunks follow the geometry (every id is a run of real triangles), where
    an origin grid mostly indexes empty air.  Hintless rays (fresh
    primaries, all at the camera) share one bucket past the chunk ids."""
    octant = dir_octant(direction)
    bucket = jnp.clip(jnp.where(hint >= 0, hint, n_chunks), 0, n_chunks)
    key = octant * (n_chunks + 1) + bucket
    return jnp.where(alive, key, jnp.int32(1 << 28))


def ray_sort_key_dirhint(
    direction: jnp.ndarray,  # [R, 3]
    alive: jnp.ndarray,  # [R] bool
    hint: jnp.ndarray,  # [R] int32 spawn-surface chunk id, -1 = none
    n_chunks: int,
) -> jnp.ndarray:  # [R] int32
    """Fine-direction-major key: (dominant axis, 4x4 bins of the two minor
    direction components) major, spawn-surface chunk id, then octant minor.

    Keys fit int32 up to ~5.5M chunks (48 * 8 * (C + 1) < 2^31); the
    dead-ray sentinel is int32 max so dead rays sort last over that range."""
    octant = dir_octant(direction)
    dom = jnp.argmax(jnp.abs(direction), axis=1)
    minor0 = jnp.where(dom == 0, direction[:, 1], direction[:, 0])
    minor1 = jnp.where(dom == 2, direction[:, 1], direction[:, 2])
    b0 = jnp.clip(((minor0 + 1.0) * 2.0).astype(jnp.int32), 0, 3)
    b1 = jnp.clip(((minor1 + 1.0) * 2.0).astype(jnp.int32), 0, 3)
    dir4 = (dom.astype(jnp.int32) * 4 + b0) * 4 + b1
    bucket = jnp.clip(jnp.where(hint >= 0, hint, n_chunks), 0, n_chunks)
    key = (dir4 * (n_chunks + 1) + bucket) * 8 + octant
    return jnp.where(alive, key, jnp.iinfo(jnp.int32).max)


def ray_sort_key(
    origin: jnp.ndarray,  # [R, 3]
    direction: jnp.ndarray,  # [R, 3]
    alive: jnp.ndarray,  # [R] bool
    scene_lo: jnp.ndarray,  # [3]
    scene_hi: jnp.ndarray,  # [3]
) -> jnp.ndarray:  # [R] int32
    """The "cell" key: direction octant (3 bits, major) x Morton-interleaved
    origin cell in a SORT_CELLS^3 grid over the scene bounds (12 bits)."""
    octant = dir_octant(direction)
    ext = jnp.maximum(scene_hi - scene_lo, 1e-30)
    cell = jnp.clip(
        ((origin - scene_lo) / ext * float(SORT_CELLS)).astype(jnp.int32),
        0, SORT_CELLS - 1,
    )

    def spread(x):  # up to 8 bits -> every 3rd bit (Morton)
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    morton = (
        spread(cell[:, 0]) * 4 + spread(cell[:, 1]) * 2 + spread(cell[:, 2])
    )
    key = octant * (SORT_CELLS ** 3) + morton
    return jnp.where(alive, key, jnp.int32(1 << 20))

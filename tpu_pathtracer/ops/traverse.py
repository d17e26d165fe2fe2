"""Front-to-back culled traversal over Morton leaves.

This is the wavefront replacement for the reference's recursive ordered BVH
descent (``BVH::intersect_ray``, src/bvh.h:195-235): traversal is
re-architected as three dense phases over the whole ray megabatch:

1. **Cull**: one [R, L] ray x leaf-AABB slab test (the reference's
   ``intersect(ray, aabb)``, src/bvh.h:137-152, applied to every leaf at
   once) producing per-leaf entry distances ``t_enter`` (inf on miss).
2. **Select**: per ray, the K nearest hit leaves via ``top_k`` on -t_enter —
   the wavefront analog of nearer-child-first descent.
3. **Intersect**: gather those leaves' pre-transformed Woop blocks and run
   the exact triangle test on [R, K, S] lanes; keep the min-t valid hit,
   whose t and barycentrics the shared epilogue (``intersect.winner_hit``)
   recomputes exactly as the dense sweep does.

Front-to-back correctness uses the same invariant as the reference's pruning
(src/bvh.h:221): a hit at t can only be beaten by leaves with
``t_enter < t``.  Rays whose best hit is not yet proven (more than K leaves
pierced and best_t beyond the next unprocessed leaf) loop another round with
the processed leaves masked out — a ``lax.while_loop``, so the common case
pays exactly one round.  A lane stops updating once its own hit is proven,
so its result never depends on the rest of the wavefront.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .intersect import Hit, winner_hit, woop_affine

# Leaves examined per traversal round; ~K*LEAF_SIZE triangle tests per ray.
DEFAULT_K = 16


def leaf_entry_distance(
    origin: jnp.ndarray,  # [R, 3]
    direction: jnp.ndarray,  # [R, 3]
    aabb_min: jnp.ndarray,  # [L, 3]
    aabb_max: jnp.ndarray,  # [L, 3]
    min_dst: float,
) -> jnp.ndarray:  # [R, L] float32, inf where missed
    """Slab test (src/bvh.h:137-152): returns max(t_min, min_dst) on hit."""
    o = origin[:, None, :]
    inv = 1.0 / direction[:, None, :]
    t1 = (aabb_min[None] - o) * inv
    t2 = (aabb_max[None] - o) * inv
    t_min = jnp.max(jnp.minimum(t1, t2), axis=-1)
    t_max = jnp.min(jnp.maximum(t1, t2), axis=-1)
    hit = (t_min <= t_max) & (t_max >= min_dst)
    return jnp.where(hit, jnp.maximum(t_min, min_dst), jnp.inf)


def _leaf_intersect(
    origin: jnp.ndarray,  # [R, 3]
    direction: jnp.ndarray,  # [R, 3]
    blocks: jnp.ndarray,  # [R, K, 12, S] gathered leaf Woop blocks
    slot_valid: jnp.ndarray,  # [R, K] bool — False for filler selections
    min_dst: float,
):
    """Exact Cramer-equivalent test on gathered leaves -> per-ray best
    (t, k-slot, s-slot)."""
    xo = [origin[:, k, None, None] for k in range(3)]  # [R, 1, 1] each
    xd = [direction[:, k, None, None] for k in range(3)]

    def rows(c):  # component c's four coefficient rows, [R, K, S] each
        return [blocks[:, :, 4 * c + k, :] for k in range(4)]

    p0, p1, p2 = (woop_affine(xo, rows(c), True) for c in range(3))
    q0, q1, q2 = (woop_affine(xd, rows(c), False) for c in range(3))
    t = -p2 / q2
    beta = p0 + t * q0
    gamma = p1 + t * q1
    ok = (beta >= 0) & (gamma >= 0) & (beta + gamma <= 1) & (t >= min_dst)
    t_m = jnp.where(ok & slot_valid[:, :, None], t, jnp.inf)
    r, k, s = t_m.shape
    flat = t_m.reshape(r, k * s)
    idx = jnp.argmin(flat, axis=-1)
    best_t = jnp.take_along_axis(flat, idx[:, None], axis=-1)[:, 0]
    return best_t, (idx // s).astype(jnp.int32), (idx % s).astype(jnp.int32)


def closest_hit_leaves(
    origin: jnp.ndarray,  # [R, 3]
    direction: jnp.ndarray,  # [R, 3]
    aabb_min: jnp.ndarray,  # [L, 3]
    aabb_max: jnp.ndarray,  # [L, 3]
    leaf_blocks: jnp.ndarray,  # [L, 12, S]
    min_dst: float,
    k: int = DEFAULT_K,
) -> Hit:
    r = origin.shape[0]
    l, _, s = leaf_blocks.shape
    k = min(k, l)

    t_enter0 = leaf_entry_distance(origin, direction, aabb_min, aabb_max, min_dst)

    def round_body(state):
        t_enter, best_t, best_tri, done = state
        neg, leaf_idx = jax.lax.top_k(-t_enter, k)  # ascending t_enter
        sel_t_enter = -neg  # [R, K]
        any_sel = jnp.isfinite(sel_t_enter)
        leaf_safe = jnp.where(any_sel, leaf_idx, 0)
        blocks = leaf_blocks[leaf_safe]  # [R, K, 12, S]
        t_new, kk, ss = _leaf_intersect(
            origin, direction, blocks, any_sel, min_dst
        )

        # Finished lanes take no further updates, so a lane's result never
        # depends on how many rounds OTHER lanes keep the loop running (a
        # leaf whose slab entry rounds past an inner triangle's t could
        # otherwise still win a later round).
        better = (t_new < best_t) & ~done
        tri_new = (
            jnp.take_along_axis(leaf_safe, kk[:, None], axis=-1)[:, 0] * s + ss
        )
        best_tri = jnp.where(better, tri_new, best_tri)
        best_t = jnp.where(better, t_new, best_t)

        # Mask out the processed leaves for the next round.  Filler slots
        # alias leaf 0, so the scatter must use OR semantics (.max): a plain
        # .set with duplicate indices is order-nondeterministic and can wipe
        # the processed flag of a genuinely selected leaf 0 (infinite loop).
        mask = jnp.zeros_like(t_enter, dtype=bool)
        mask = mask.at[jnp.arange(r)[:, None], leaf_safe].max(any_sel)
        t_enter = jnp.where(mask, jnp.inf, t_enter)

        # Done when no unprocessed leaf could still beat best_t.
        next_t = jnp.min(t_enter, axis=-1)
        done = done | (best_t <= next_t)  # inf <= inf when nothing remains
        return (t_enter, best_t, best_tri, done)

    def cond(state):
        return ~jnp.all(state[3])

    init = (
        t_enter0,
        jnp.full((r,), jnp.inf),
        jnp.zeros((r,), jnp.int32),
        jnp.zeros((r,), bool),
    )
    # One round always runs; the loop covers the >K-leaves tail.
    state = round_body(init)
    state = jax.lax.while_loop(cond, lambda st: round_body(st), state)
    _, best_t, best_tri, _ = state

    tri = jnp.where(jnp.isfinite(best_t), best_tri, 0)
    # The winner's [R, 12] block column (rows 4*comp + coef) as the
    # [R, 4, 3] (coef, comp) block the shared epilogue takes.
    w = leaf_blocks[tri // s, :, tri % s].reshape(r, 3, 4).swapaxes(1, 2)
    return winner_hit(origin, direction, w, tri, best_t)

"""Ray-triangle intersection as matrix work.

The reference intersects one ray against one triangle with three 3x3 Cramer
determinants (``intersect_ray_triangle``, src/bvh.h:36-50) inside a recursive
BVH descent.  A wavefront wants the dual formulation: precompute, per triangle, the
affine map W that takes world coordinates into the triangle's
(beta, gamma, normal) frame — then for a megabatch of rays

    [o | 1; d | 0] @ W^T  ->  (p, q)  with  t = -p_n / q_n,
                                           beta  = p_b + t q_b,
                                           gamma = p_g + t q_g

which is a single ``[2R, 4] @ [4, 3N]`` matmul feeding a cheap elementwise
epilogue and a min-reduction.  Algebraically identical to the Cramer solve
(same validity window beta >= 0, gamma >= 0, beta + gamma <= 1, t >= min_dst
— src/bvh.h:52-65), so hit decisions match the reference up to fp noise.

Large scenes are processed in triangle blocks with a ``lax.scan`` carrying the
per-ray running best so the [2R, 3B] intermediate stays bounded; XLA pipelines
the matmul and epilogue across scan steps.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .vecmath import cross, dot

# f32 matmuls must not silently decay to bf16 or TF32: geometry needs the
# full 24-bit mantissa (a reduced-precision ray direction punches visible
# holes in meshes).
_PRECISION = jax.lax.Precision.HIGHEST

# Max triangle-block size for the scanned brute-force sweep.  Scenes are
# padded so capacity is a multiple of this (or fit in a single block).
TRI_BLOCK = 1024


def tri_capacity(n: int) -> int:
    """Padded triangle capacity: lane-aligned for small scenes, a multiple of
    TRI_BLOCK for scenes that need the scanned sweep."""
    if n <= TRI_BLOCK:
        return max(128, ((n + 127) // 128) * 128)
    return ((n + TRI_BLOCK - 1) // TRI_BLOCK) * TRI_BLOCK


def build_woop(verts: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Host-side precompute of the [4, 3N] intersection matrix (float64 solve,
    float32 storage).  Degenerate or padding triangles get NaN rows.

    Prefers the native C++ packer (native/accel_pack.cpp, adjugate inverse);
    this numpy path (LAPACK inverse) is the fallback and the test oracle —
    they agree to float32 rounding."""
    import os

    if not os.environ.get("TPU_PATHTRACER_NO_NATIVE"):
        from ..scene import native

        out = native.build_woop(verts, valid)
        if out is not None:
            return out
    v = np.asarray(verts, dtype=np.float64)
    n = v.shape[0]
    a, b, c = v[:, 0], v[:, 1], v[:, 2]
    av = b - a
    au = c - a
    n0 = np.cross(av, au)
    m = np.stack([av, au, n0], axis=-1)  # [N, 3, 3] columns
    det = np.linalg.det(m)
    ok = np.asarray(valid, dtype=bool) & np.isfinite(det) & (np.abs(det) > 0)
    m_safe = np.where(ok[:, None, None], m, np.eye(3)[None])
    minv = np.linalg.inv(m_safe)  # [N, 3, 3]
    trans = -np.einsum("nij,nj->ni", minv, a)  # [N, 3]
    w = np.concatenate([minv, trans[:, :, None]], axis=-1)  # [N, 3, 4]
    w = np.where(ok[:, None, None], w, np.nan)
    # [N, 3, 4] -> [4, 3N] with columns grouped per triangle.  astype with
    # order="C" does the permuted copy in ONE pass (the reshape after it is
    # then free) — the reshape-first form forced an extra strided copy.
    return w.transpose(2, 0, 1).astype(np.float32, order="C").reshape(4, 3 * n)


class Hit(NamedTuple):
    t: jnp.ndarray  # [R] float32 (inf on miss)
    tri: jnp.ndarray  # [R] int32 (0 on miss; gate on .hit)
    beta: jnp.ndarray  # [R] barycentric along (b - a)
    gamma: jnp.ndarray  # [R] barycentric along (c - a)
    hit: jnp.ndarray  # [R] bool


def _block_best(
    rays: jnp.ndarray,  # [2R, 4] stacked (o,1) and (d,0)
    woop_block: jnp.ndarray,  # [4, 3B]
    min_dst: float,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Closest valid hit within one triangle block: (t [R], local idx [R])."""
    r = rays.shape[0] // 2
    y = jnp.dot(rays, woop_block, precision=_PRECISION)  # [2R, 3B]
    y = y.reshape(2, r, -1, 3)
    p, q = y[0], y[1]  # [R, B, 3]
    t = -p[..., 2] / q[..., 2]
    beta = p[..., 0] + t * q[..., 0]
    gamma = p[..., 1] + t * q[..., 1]
    ok = (beta >= 0) & (gamma >= 0) & (beta + gamma <= 1) & (t >= min_dst)
    t_m = jnp.where(ok, t, jnp.inf)
    idx = jnp.argmin(t_m, axis=-1)
    best = jnp.take_along_axis(t_m, idx[:, None], axis=-1)[:, 0]
    return best, idx.astype(jnp.int32)


def closest_hit(
    origin: jnp.ndarray,  # [R, 3]
    direction: jnp.ndarray,  # [R, 3]
    woop: jnp.ndarray,  # [4, 3N]
    min_dst: float,
) -> Hit:
    """Closest-hit over the whole triangle soup (BVH::intersect_ray analog,
    src/bvh.h:170-235 — ordered descent replaced by a dense min-reduction)."""
    r = origin.shape[0]
    n3 = woop.shape[1]
    n = n3 // 3
    ones = jnp.ones((r, 1), dtype=origin.dtype)
    zeros = jnp.zeros((r, 1), dtype=origin.dtype)
    rays = jnp.concatenate(
        [
            jnp.concatenate([origin, ones], axis=1),
            jnp.concatenate([direction, zeros], axis=1),
        ],
        axis=0,
    )  # [2R, 4]

    if n <= TRI_BLOCK:
        t, idx = _block_best(rays, woop, min_dst)
        tri = idx
    else:
        assert n % TRI_BLOCK == 0, "scene capacity must be a multiple of TRI_BLOCK"
        nblocks = n // TRI_BLOCK

        def body(carry, blk):
            best_t, best_tri = carry
            wb = jax.lax.dynamic_slice(
                woop, (0, blk * 3 * TRI_BLOCK), (4, 3 * TRI_BLOCK)
            )
            t, idx = _block_best(rays, wb, min_dst)
            tri = idx + blk * TRI_BLOCK
            better = t < best_t
            return (
                jnp.where(better, t, best_t),
                jnp.where(better, tri, best_tri),
            ), None

        (t, tri), _ = jax.lax.scan(
            body,
            (jnp.full((r,), jnp.inf), jnp.zeros((r,), jnp.int32)),
            jnp.arange(nblocks),
        )

    tri = jnp.where(jnp.isfinite(t), tri, 0)
    # The winner's [R, 4, 3] Woop block, (coefficient, component) major.
    w = jnp.moveaxis(woop[:, tri[:, None] * 3 + jnp.arange(3)], 0, 1)
    return winner_hit(origin, direction, w, tri, t)


def woop_affine(xs, rows, offset: bool) -> jnp.ndarray:
    """x0*r0 + x1*r1 + x2*r2 (+ r3 when ``offset``), in that fixed order.

    ``xs``: the three ray coordinates, ``rows``: the four Woop coefficient
    arrays (x, y, z, constant), broadcast-compatible.  Plain float32
    multiply-adds: full precision on any backend, and the same sum order in
    every compiled program (a dot would be free to pick a summation order,
    and a reduced-precision mode, per program).
    """
    acc = xs[0] * rows[0]
    acc = acc + xs[1] * rows[1]
    acc = acc + xs[2] * rows[2]
    return acc + rows[3] if offset else acc


def winner_hit(
    origin: jnp.ndarray,  # [R, 3]
    direction: jnp.ndarray,  # [R, 3]
    w: jnp.ndarray,  # [R, 4, 3] winning triangle's Woop block (coef, comp)
    tri: jnp.ndarray,  # [R] int32 winning triangle ids (0 on miss)
    t_best: jnp.ndarray,  # [R] float32 search result (inf on miss)
) -> Hit:
    """Hit record of each ray's winning triangle, recomputed from its Woop
    block by two matvecs.

    Every intersector reports its winner through this one epilogue, so two
    intersectors that pick the same triangle report bit-identical t and
    barycentrics (the search's own t comes from differently ordered sums,
    and p_n cancels for hits near the ray origin)."""
    hit = jnp.isfinite(t_best)
    rows = [w[:, k] for k in range(4)]  # [R, 3] each: (beta, gamma, n)
    p = woop_affine([origin[:, k:k + 1] for k in range(3)], rows, True)
    q = woop_affine([direction[:, k:k + 1] for k in range(3)], rows, False)
    t_r = -p[..., 2] / q[..., 2]
    beta = p[..., 0] + t_r * q[..., 0]
    gamma = p[..., 1] + t_r * q[..., 1]
    return Hit(
        t=jnp.where(hit, t_r, jnp.inf),
        tri=jnp.where(hit, tri, 0),
        beta=jnp.where(hit, beta, 0.0),
        gamma=jnp.where(hit, gamma, 0.0),
        hit=hit,
    )


def light_pdf_sum(
    origin: jnp.ndarray,  # [R, 3]
    direction: jnp.ndarray,  # [R, 3]
    light_verts: jnp.ndarray,  # [L, 3, 3]
    light_normal: jnp.ndarray,  # [L, 3]
    light_area: jnp.ndarray,  # [L]
    light_count: jnp.ndarray,  # [] int32
    min_dst: float,
) -> jnp.ndarray:
    """All-hits light-mixture pdf (``bvh_mix_dist::pdf``, src/raytracer.h:363-376).

    The reference walks the emissive-only BVH visiting *every* light triangle
    the ray pierces and sums |x-y|^2 / (|<dir, n_y>| * area) terms; here the
    sum is a broadcast reduce over all lights — no traversal, no divergence.
    Beyond ``_LIGHT_BLOCK`` lights the reduce is blocked with a ``lax.scan``
    so peak memory stays O(R x block) instead of O(R x L) (the many-light
    case the reference's light BVH existed for).  Returns sum / count.
    """
    cap = light_verts.shape[0]
    if cap > _LIGHT_BLOCK:
        nb = -(-cap // _LIGHT_BLOCK)
        pad = nb * _LIGHT_BLOCK - cap
        pv = jnp.pad(light_verts, ((0, pad), (0, 0), (0, 0)))
        pn = jnp.pad(light_normal, ((0, pad), (0, 0)))
        pa = jnp.pad(light_area, ((0, pad),), constant_values=1.0)
        blocks = (
            pv.reshape(nb, _LIGHT_BLOCK, 3, 3),
            pn.reshape(nb, _LIGHT_BLOCK, 3),
            pa.reshape(nb, _LIGHT_BLOCK),
            (jnp.arange(nb * _LIGHT_BLOCK, dtype=jnp.int32)
             .reshape(nb, _LIGHT_BLOCK)),
        )

        def block(acc, xs):
            bv, bn, ba, bids = xs
            s = _light_pdf_block(
                origin, direction, bv, bn, ba,
                (bids < light_count), min_dst,
            )
            return acc + s, None

        total, _ = jax.lax.scan(
            block, jnp.zeros(origin.shape[0], jnp.float32), blocks
        )
        return total / jnp.maximum(light_count, 1).astype(total.dtype)
    lane = jnp.arange(cap, dtype=jnp.int32)
    total = _light_pdf_block(
        origin, direction, light_verts, light_normal, light_area,
        (lane < light_count), min_dst,
    )
    return total / jnp.maximum(light_count, 1).astype(total.dtype)


_LIGHT_BLOCK = 128


def _light_pdf_block(
    origin, direction, light_verts, light_normal, light_area, lane_ok, min_dst
) -> jnp.ndarray:  # [R] unnormalized projection-term sum over this block
    a = light_verts[:, 0]
    av = light_verts[:, 1] - a
    au = light_verts[:, 2] - a
    o = origin[:, None, :]  # [R, 1, 3]
    d = direction[:, None, :]
    y = o - a[None]  # [R, L, 3]
    at = -d
    denom = dot(jnp.broadcast_to(av[None], y.shape), cross(jnp.broadcast_to(au[None], y.shape), at))
    beta = dot(y, cross(jnp.broadcast_to(au[None], y.shape), at)) / denom
    gamma = dot(jnp.broadcast_to(av[None], y.shape), cross(y, at)) / denom
    t = dot(jnp.broadcast_to(av[None], y.shape), cross(jnp.broadcast_to(au[None], y.shape), y)) / denom
    ok = (
        (beta >= 0)
        & (gamma >= 0)
        & (beta + gamma <= 1)
        & (t >= min_dst)
        & lane_ok[None, :]
    )
    # light_surface_projection_multiplier (src/raytracer.h:79-84):
    # |x - y|^2 = t^2 |d|^2 for y on the ray.
    dist2 = t * t * dot(d, d)
    proj = dist2 / jnp.abs(dot(jnp.broadcast_to(light_normal[None], y.shape), d))
    contrib = jnp.where(ok, proj / light_area[None], 0.0)
    return jnp.sum(contrib, axis=-1)


def light_pdf_sum_flat(
    origin: jnp.ndarray,  # [R, 3]
    direction: jnp.ndarray,  # [R, 3]
    cluster_woop: jnp.ndarray,  # [C, 12, CL] (scene/accel.py light_clusters)
    cluster_k: jnp.ndarray,  # [C, CL] = 1/(2 area^2), 0 on invalid
    light_count: jnp.ndarray,  # [] int32
    min_dst: float,
) -> jnp.ndarray:  # [R] mean projection term (sum / count)
    """Lane-major dense all-hits light pdf over the packed light clusters.

    Same quantity as :func:`light_pdf_sum` (bvh_mix_dist::pdf,
    src/raytracer.h:363-376) in Woop algebra: the projection term is
    ``t^2 |d|^2 k / |q_n|`` on the per-light Woop contraction, evaluated as
    flat [R, CL] broadcast-FMA slabs — no [R, L, 3] cross/dot
    intermediates.  Engaged by the integrator for small light sets
    (<= 4 clusters); larger sets take the blocked Cramer form.
    Invalid/padded lights carry NaN Woop rows (ok mask False) and k = 0,
    so they contribute exactly 0."""
    o, d = origin, direction
    d2 = jnp.sum(d * d, axis=1, keepdims=True)  # [R, 1]
    total = jnp.zeros((origin.shape[0],), jnp.float32)
    for ci in range(cluster_woop.shape[0]):
        w = cluster_woop[ci]  # [12, CL]
        k = cluster_k[ci]  # [CL]

        def co(r0, w=w):
            acc = o[:, 0:1] * w[r0, :][None, :] + w[r0 + 3, :][None, :]
            acc = acc + o[:, 1:2] * w[r0 + 1, :][None, :]
            return acc + o[:, 2:3] * w[r0 + 2, :][None, :]

        def cd(r0, w=w):
            acc = d[:, 0:1] * w[r0, :][None, :]
            acc = acc + d[:, 1:2] * w[r0 + 1, :][None, :]
            return acc + d[:, 2:3] * w[r0 + 2, :][None, :]

        p0, p1, p2 = co(0), co(4), co(8)
        q0, q1, q2 = cd(0), cd(4), cd(8)
        t = -p2 / q2
        beta = p0 + t * q0
        gamma = p1 + t * q1
        ok = (beta >= 0) & (gamma >= 0) & (beta + gamma <= 1) & (t >= min_dst)
        term = jnp.where(ok, t * t * d2 * k[None, :] / jnp.abs(q2), 0.0)
        total = total + jnp.sum(term, axis=1)
    return total / jnp.maximum(light_count, 1).astype(total.dtype)

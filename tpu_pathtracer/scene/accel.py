"""Acceleration-structure build: spatially-ordered triangle runs.

Replaces the reference's recursive sweep-SAH BVH (``BVH::build``,
src/bvh.h:262-394) with a wavefront-friendly layout: instead of a deep
binary tree we build a *shallow, wide* structure, a PERMUTATION of the
triangle array whose consecutive runs form the leaves and chunks.  Two
builders:

* ``sah_chunk_order`` (default) — chunk-aligned sweep-SAH treelets: the
  reference's split quality (longest-axis sort + surface-area sweep,
  src/bvh.h:272-312) restricted to 128-aligned cuts, leaves emitted in DFS
  order.  ~2.3x tighter chunk AABBs than the Morton cut on the atrium
  scene (and 2.4x fewer pierced chunks per ray);
* ``morton_order`` — 30-bit Morton curve of centroids (the LBVH ordering);
  kept for A/B (``IntersectTuning(build="morton")``).

Downstream, consecutive runs of ``LEAF_SIZE`` triangles form leaves with
AABBs, and runs of ``CHUNK_TRIS`` form the chunks the ray-sort hint keys on;
traversal (ops/traverse.py) culls with ONE dense ray x leaf-AABB test and
then intersects only each ray's nearest leaves, in front-to-back order.

The build is host-side numpy (a one-time cost, like the reference's build;
O(n log n) sort instead of per-node O(n log^2 n) sweeps) and also re-orders
every per-triangle scene array, which doubles as a data-locality win for the
gather-heavy shade stage.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

LEAF_SIZE = 16
# Triangles per chunk (and lights per light cluster).
CHUNK_TRIS = 128


def _use_native() -> bool:
    import os

    return not os.environ.get("TPU_PATHTRACER_NO_NATIVE")


def morton_order(verts: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Permutation sorting valid triangles along a 3D Morton curve (invalid
    rows go last).  verts: [N, 3, 3].  Uses the native C++ packer when
    available (native/accel_pack.cpp), numpy otherwise — both orderings are
    identical (tested)."""
    if _use_native():
        from . import native

        perm = native.morton_argsort(verts, valid)
        if perm is not None:
            return perm
    n = verts.shape[0]
    centroid = verts.mean(axis=1)
    c = centroid[valid]
    if c.shape[0] == 0:
        return np.arange(n)
    lo = c.min(axis=0)
    hi = c.max(axis=0)
    ext = np.maximum(hi - lo, 1e-30)
    q = np.clip(((c - lo) / ext * 1023.0).astype(np.uint64), 0, 1023)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    code = (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])
    order_valid = np.argsort(code, kind="stable")
    idx_valid = np.nonzero(valid)[0][order_valid]
    idx_invalid = np.nonzero(~valid)[0]
    return np.concatenate([idx_valid, idx_invalid])


def sah_chunk_order(
    verts: np.ndarray, valid: np.ndarray, chunk: int = 128
) -> np.ndarray:
    """Permutation whose consecutive ``chunk``-triangle runs are sweep-SAH
    treelet leaves (invalid rows last).

    The flat Morton cut (morton_order + "chunk = next 128 tris") leaves
    chunk AABBs loose wherever the curve jumps cells; every loose chunk
    inflates the per-ray pierced set.  This build keeps
    the reference's split QUALITY — sort along the longest axis and sweep
    prefix/suffix surface areas (src/bvh.h:272-312) — but only over
    ``chunk``-ALIGNED cut positions, emitting leaves in DFS order:

    * every chunk except globally-last stays exactly full (the kernel's
      128-lane ALU unit needs full blocks — partial leaves would waste
      pair tests on padding);
    * DFS order keeps consecutive chunks spatially adjacent, which the
      512-chunk super-block gate and the entry-distance worklist sort both
      rely on (same property the Morton curve provided);
    * split cost is the true SAH surrogate SA_left*n_left + SA_right*
      n_right over TRIANGLE AABBs (not centroids), so long skinny
      triangles count their real extent.

    Host-side numpy, O(n log^2 n) like the reference's build; one-time per
    scene.  Pure permutation: renders are estimator-identical under any
    triangle order (pinned by test_sah_order_matches_morton_render).
    """
    if _use_native():
        from . import native

        perm = native.sah_chunk_order(verts, valid, chunk)
        if perm is not None:
            return perm
    n = verts.shape[0]
    idx_valid = np.nonzero(valid)[0]
    m = idx_valid.shape[0]
    if m == 0:
        return np.arange(n)
    v = verts[idx_valid].astype(np.float32)
    # Per-triangle AABBs, packed as [m, 6] = (min, -max) so ONE running
    # minimum yields both prefix bounds (min of -max = -(max)).  f32 keys
    # and bounds: the build only steers work placement — kernels recompute
    # every AABB/intersection exactly — so build precision is free to
    # trade for the ~2x host-time win at Sponza-class counts.
    tbox = np.concatenate([v.min(axis=1), -v.max(axis=1)], axis=1)
    cent = v.mean(axis=1)
    out = np.empty(m, dtype=np.int64)
    pos = 0
    # Explicit stack (DFS, left first) — depth ~log2(m/chunk) but workloads
    # come in any shape; avoid Python recursion limits.
    stack = [np.arange(m)]
    while stack:
        ids = stack.pop()
        k = ids.shape[0]
        if k <= chunk:
            out[pos : pos + k] = ids
            pos += k
            continue
        c_ids = cent[ids]
        lo = c_ids.min(axis=0)
        hi = c_ids.max(axis=0)
        axis = int(np.argmax(hi - lo))
        # numpy's default introsort is deterministic for a given input;
        # tie order differs from a stable sort but any permutation is a
        # valid build.
        order = ids[np.argsort(c_ids[:, axis])]
        # Aligned cut positions: left side a chunk multiple, both sides
        # non-empty.  (k > chunk, so at least one position exists.)
        n_cuts = (k - 1) // chunk
        cuts = (np.arange(1, n_cuts + 1)) * chunk
        if n_cuts == 1:
            best = cuts[0]
        else:
            boxes = tbox[order]
            pre = np.minimum.accumulate(boxes, axis=0)
            suf = np.minimum.accumulate(boxes[::-1], axis=0)[::-1]

            def area(b):
                d = np.maximum(-b[:, 3:] - b[:, :3], 0.0)
                return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

            cost = area(pre[cuts - 1]) * cuts + area(suf[cuts]) * (k - cuts)
            best = int(cuts[np.argmin(cost)])
        # Right pushed first so the left child is processed (and emitted)
        # first — DFS order.
        stack.append(order[best:])
        stack.append(order[:best])
    assert pos == m
    return np.concatenate([idx_valid[out], np.nonzero(~valid)[0]])


def build_leaves(
    verts: np.ndarray, valid: np.ndarray, leaf_size: int = LEAF_SIZE
) -> Tuple[np.ndarray, np.ndarray]:
    """Leaf AABBs over consecutive (spatially ordered) triangle runs.

    Returns (aabb_min [L, 3], aabb_max [L, 3]); leaves containing only
    padding triangles get inverted (never-hit) boxes.  Assumes the caller has
    already applied the build ordering to verts/valid and that
    len % leaf_size == 0.
    """
    if _use_native():
        from . import native

        out = native.build_leaf_aabbs(verts, valid, leaf_size)
        if out is not None:
            return out
    n = verts.shape[0]
    assert n % leaf_size == 0
    l = n // leaf_size
    v = verts.reshape(l, leaf_size, 3, 3)
    ok = valid.reshape(l, leaf_size)
    big = np.float64(np.inf)
    vmin = np.where(ok[:, :, None, None], v, big).min(axis=(1, 2))
    vmax = np.where(ok[:, :, None, None], v, -big).max(axis=(1, 2))
    empty = ~ok.any(axis=1)
    vmin[empty] = big
    vmax[empty] = -big
    return vmin.astype(np.float32), vmax.astype(np.float32)


def chunk_aabbs(
    aabb_min: np.ndarray, aabb_max: np.ndarray, leaves_per_chunk: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Coarser AABBs over groups of consecutive leaves (chunk bounds)."""
    l = aabb_min.shape[0]
    pad = (-l) % leaves_per_chunk
    if pad:
        aabb_min = np.concatenate(
            [aabb_min, np.full((pad, 3), np.inf, aabb_min.dtype)]
        )
        aabb_max = np.concatenate(
            [aabb_max, np.full((pad, 3), -np.inf, aabb_max.dtype)]
        )
    c = aabb_min.shape[0] // leaves_per_chunk
    cmin = aabb_min.reshape(c, leaves_per_chunk, 3).min(axis=1)
    cmax = aabb_max.reshape(c, leaves_per_chunk, 3).max(axis=1)
    # All-padding chunks come out of the reduction as inverted boxes
    # (min=+inf, max=-inf).  A slab test that swaps per-axis min/max turns
    # an inverted box's infinities into t_lo=-inf, t_hi=+inf, i.e. an
    # always-hit box with the least entry distance.  NaN boxes fail every
    # comparison: the never-hit convention (the nan-aware scene bounds of
    # the "cell" sort key expect it).
    empty = cmin[:, 0] > cmax[:, 0]
    cmin[empty] = np.nan
    cmax[empty] = np.nan
    return cmin, cmax


def light_clusters(lverts: np.ndarray, count: int, cluster: int = 128):
    """Spatially-clustered light blocks for the sub-linear all-hits pdf
    (same chunk-aligned SAH treelet ordering as the geometry build).

    The reference's light BVH exists to (a) pick a light uniformly and
    (b) sum pdf projection terms over every emissive triangle a ray pierces
    (src/raytracer.h:350-376).  (a) stays order-preserving and dense; this
    build serves (b): lights are SAH-ordered and grouped into 128-wide
    clusters with AABBs + Woop blocks (identical layout to the geometry
    chunks) + the per-light constant k = 1/(2*area^2), which turns the
    projection term into ``t^2 |d|^2 k / |q_n|`` — pure epilogue on the
    same contraction (ops/intersect.light_pdf_sum_flat).

    Returns (cl_min [C,3], cl_max [C,3], cl_woop [C,12,cluster],
    cl_k [C,cluster]) as float32 numpy; the cluster boxes are what a
    light-BVH walk (src/raytracer.h:363-375) would cull with.
    """
    from ..ops.intersect import build_woop

    lverts = np.asarray(lverts, np.float64)
    cap = lverts.shape[0]
    valid = np.zeros(cap, bool)
    valid[:count] = True
    # Same aligned-SAH treelet build as the geometry chunks: tighter
    # cluster AABBs -> fewer pierced clusters per pdf evaluation.  (Light
    # SELECTION stays a uniform pick over this order; any permutation is
    # estimator-equivalent, pinned statistically by the render tests and
    # exactly by the cluster-vs-dense pdf oracle on the packed arrays.)
    perm = sah_chunk_order(lverts, valid, cluster)
    lv = lverts[perm]
    ok = valid[perm]
    pad = (-cap) % cluster
    if pad:
        lv = np.concatenate([lv, np.full((pad, 3, 3), 1e30)], axis=0)
        ok = np.concatenate([ok, np.zeros(pad, bool)])
    n = lv.shape[0]
    c = n // cluster
    # Cluster AABBs over valid light verts (never-hit boxes when empty).
    v = lv.reshape(c, cluster, 3, 3)
    okc = ok.reshape(c, cluster)
    big = np.inf
    cl_min = np.where(okc[:, :, None, None], v, big).min(axis=(1, 2))
    cl_max = np.where(okc[:, :, None, None], v, -big).max(axis=(1, 2))
    # NaN = never-hit (see chunk_aabbs).
    empty = ~okc.any(axis=1)
    cl_min[empty] = np.nan
    cl_max[empty] = np.nan
    woop = build_woop(lv, ok)  # [4, 3n]; NaN rows on invalid
    cl_woop = leaf_woop(woop, cluster)
    e1 = lv[:, 1] - lv[:, 0]
    e2 = lv[:, 2] - lv[:, 0]
    n0 = np.cross(e1, e2)
    area = 0.5 * np.linalg.norm(n0, axis=-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        k = 1.0 / (2.0 * area * area)
    k = np.where(ok & np.isfinite(k), k, 0.0)
    cl_k = k.reshape(c, cluster)
    return (
        cl_min.astype(np.float32),
        cl_max.astype(np.float32),
        cl_woop,
        cl_k.astype(np.float32),
    )


def leaf_woop(woop_cols: np.ndarray, leaf_size: int = LEAF_SIZE) -> np.ndarray:
    """Re-layout the [4, 3N] Woop matrix into per-block [L, 12, S] blocks
    (leaves, chunks or light clusters; a partial last block is NaN-padded).

    Row layout r = 4*c + k: coefficient k (x, y, z, const) of barycentric
    component c (beta, gamma, n-height) — so a gathered leaf block feeds six
    [R]x[S] broadcast contractions with no lane-dim reshapes.
    """
    four, n3 = woop_cols.shape
    assert four == 4
    n = n3 // 3
    w = woop_cols.reshape(4, n, 3)
    pad = (-n) % leaf_size
    if pad:
        w = np.concatenate([w, np.full((4, pad, 3), np.nan, w.dtype)], axis=1)
        n += pad
    l = n // leaf_size
    # Blocked permutation: expose the leaf axis FIRST so the copy walks one
    # ~leaf-sized source window at a time (cache-local on the [4, 3N]
    # layout); a reshape-then-transpose form costs two full-array strided
    # copies on the host.
    w = w.reshape(4, l, leaf_size, 3)  # [k, leaf, t, c] view
    w = w.transpose(1, 3, 0, 2)  # [leaf, c, k, t]; (c, k) merges to 4c+k
    return w.astype(np.float32, order="C").reshape(l, 12, leaf_size)

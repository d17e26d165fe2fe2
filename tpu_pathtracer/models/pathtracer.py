"""Wavefront Monte-Carlo path tracer over triangle scenes (the flagship).

This is the wavefront re-architecture of the reference's recursive integrator
(``trace_ray``/``shade``/``render_pixel``, src/raytracer.h:512-627): the
per-ray recursion becomes a ``lax.scan`` over bounce depth carrying a
megabatch wavefront (origin, direction, throughput, radiance, alive), with
every data-dependent branch of ``shade`` turned into masked selects.  One
sample of one pixel follows *exactly* the reference estimator:

  bounce:  closest-hit -> miss? add env (src/raytracer.h:604)
           alpha Russian roulette pass-through  (:558-561)
           add emission                          (:588-590)
           dir ~ 1/3 VNDF | 2/3 (cosine/light mixture)  (:565-568)
           p = 1/3 p_vndf + 2/3 p_mix           (:572-574)
           throughput *= pbr_brdf/p * max(0, <dir, n_s>)  (:580-582)
           kill on NaN dir / p < EPS / zero scl (:569-587)

NaN handling matches the reference's recursion algebra: once a throughput
channel goes NaN every later contribution poisons the accumulated channel,
and a final ``+ throughput * 0`` reproduces the depth-exhaustion case, so the
per-sample ``sanitize_nans`` (src/raytracer.h:607-616) zeroes the same
channels the CPU build zeroes.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from ..config import RenderConfig
from ..ops import bsdf, sampling, texture
from ..ops.intersect import (
    Hit,
    closest_hit,
    light_pdf_sum,
    light_pdf_sum_flat,
)
from ..ops.rng import (
    SOBOL_TAG_LIGHT,
    SOBOL_TAG_VNDF,
    jitter_uniforms,
    lane_uniforms,
    sobol_owen_pair,
)
from ..ops.sortkeys import (
    ray_sort_key,
    ray_sort_key_dirhint,
    ray_sort_key_hint,
)
from ..ops.traverse import closest_hit_leaves
from ..ops.vecmath import cross, dot, length2, normalize, frame_apply, where3
from ..scene.types import Camera, TriangleScene

# Uniform draws consumed per ray per bounce (fixed-shape wavefront layout):
# 0 alpha coin | 1 vndf coin | 2,3 vndf | 4 mixture pick | 5,6 cosine
# 7 light pick | 8,9 light point
_DRAWS = 10


def bounce_draws(
    key: jax.Array,
    sample,  # scalar or [R] global sample index
    depth,  # scalar or [R] bounce index
    pixel: jnp.ndarray,  # [R] linear pixel ids
    config: RenderConfig,
) -> jnp.ndarray:  # [_DRAWS, R]
    """Per-bounce estimator draws.  config.lowdisc == "sobol" replaces the
    two highest-variance pairs — VNDF (u1, u2) and light point (u, v) —
    with per-(pixel, depth) Owen-scrambled (0,2)-sequences over the sample
    index (ops/rng.py sobol_owen_pair), the bounce-draw extension of the
    Sobol camera jitter.  Same counter discipline, so sharding / engine /
    resume reproducibility is untouched; "off" reproduces the reference
    estimator draw-for-draw."""
    draws = lane_uniforms(key, sample, depth, pixel, _DRAWS)
    if config.lowdisc == "sobol":
        vn = sobol_owen_pair(key, sample, depth, pixel, SOBOL_TAG_VNDF)
        li = sobol_owen_pair(key, sample, depth, pixel, SOBOL_TAG_LIGHT)
        draws = draws.at[2:4].set(vn).at[8:10].set(li)
    elif config.lowdisc != "off":
        raise ValueError(
            f"unknown lowdisc {config.lowdisc!r}: expected off | sobol"
        )
    return draws


def gen_rays(
    camera: Camera, pixel_ids: jnp.ndarray, offsets: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Jittered pinhole rays (gen_ray, src/raytracer.h:527-538).

    ``offsets``: [2, R] per-pixel jitter (lane-major draw layout)."""
    w, h = camera.width, camera.height
    x = (pixel_ids % w).astype(jnp.float32)
    y = (pixel_ids // w).astype(jnp.float32)
    # Camera vectors/fov are traced DATA (scene/types.py Camera): moving the
    # camera re-uses the compiled render.  tan(fov_y/2) == tan(fov_x/2)*h/w
    # by the aspect derivation (src/scene.h:69-71), so no arctan round trip.
    tx = jnp.tan(jnp.asarray(camera.fov_x, jnp.float32) / 2)
    ty = tx * h / w
    right = jnp.asarray(camera.right, dtype=jnp.float32)
    up = jnp.asarray(camera.up, dtype=jnp.float32)
    fwd = jnp.asarray(camera.forward, dtype=jnp.float32)
    cx = (2.0 * (x + offsets[0]) / w - 1.0) * tx
    cy = (2.0 * (y + offsets[1]) / h - 1.0) * ty
    d = normalize(cx[:, None] * right - cy[:, None] * up + fwd[None, :])
    # Derive the (constant) origin from d so it inherits d's varying-axis
    # type under shard_map (a broadcast constant would not).
    o = d * 0.0 + jnp.asarray(camera.position, dtype=jnp.float32)
    return o, d


def per_pixel_uniforms(
    key: jax.Array, pixel_ids: jnp.ndarray, n_draws: int
) -> jnp.ndarray:  # [n_draws, R]
    """U[0,1) draws keyed per *pixel*, not per batch.

    This replaces the reference's per-span LCG seeding
    (src/raytracer.h:648): every ray's stream is a counter-mode threefry
    block keyed on (stage key, pixel_id), so the result is bit-identical for
    ANY batch split or device sharding — the property the reference gets
    per-span, we get per-pixel, which makes sharded rendering reproducible
    and resumable.  See ops/rng.py for the lane-major layout rationale.
    """
    return lane_uniforms(key, 0, 0, pixel_ids, n_draws)


def scene_closest_hit(
    scene: TriangleScene,
    origin: jnp.ndarray,
    direction: jnp.ndarray,
    min_dst: float,
) -> Hit:
    """Closest hit against the scene: the dense single-block sweep for small
    scenes, the front-to-back leaf traversal (ops/traverse.py) otherwise."""
    if scene.capacity <= 1024:
        return closest_hit(origin, direction, scene.woop, min_dst)
    return closest_hit_leaves(
        origin,
        direction,
        scene.leaf_aabb_min,
        scene.leaf_aabb_max,
        scene.leaf_woop,
        min_dst,
    )


def _interp_flat(
    row: jnp.ndarray, base: int, width: int,
    beta: jnp.ndarray, gamma: jnp.ndarray,
) -> jnp.ndarray:
    """triangle::interop (src/geometry.h:497-502): w_a = 1 - beta - gamma,
    over three ``width``-wide vertex slices of a packed attribute row
    (same arithmetic, same order), without the [R, 3, w] intermediate
    whose tiling XLA repairs with layout copies."""
    wa = (1.0 - beta - gamma)[:, None]
    return (
        wa * row[:, base:base + width]
        + beta[:, None] * row[:, base + width:base + 2 * width]
        + gamma[:, None] * row[:, base + 2 * width:base + 3 * width]
    )


def hit_info(
    scene: TriangleScene,
    direction: jnp.ndarray,
    hit: Hit,
    config: RenderConfig,
):
    """Port of ``to_intersection_info`` (src/bvh.h:80-121) over the wavefront.

    Unlike the reference — which fetches textures inside BVH hit finalization
    — this is an explicit shade-stage gather over the compact hit batch; all
    per-triangle attributes arrive via ONE packed-row gather instead of ten
    array lookups."""
    tri = hit.tri
    row = scene.shade_attrs[tri]  # [R, 48] — the single gather
    # Consume the row as flat column slices (no [R, 3, 3] / [R, 3, 2]
    # reshapes of the gathered row).
    base_color = row[:, 33:37]
    base_emission = row[:, 37:40]
    base_metallic = row[:, 40]
    base_roughness = row[:, 41]
    ior = row[:, 42]
    color_tex = row[:, 43].astype(jnp.int32)
    emissive_tex = row[:, 44].astype(jnp.int32)
    mr_tex = row[:, 45].astype(jnp.int32)
    normal_tex = row[:, 46].astype(jnp.int32)

    e1 = row[:, 3:6] - row[:, 0:3]
    e2 = row[:, 6:9] - row[:, 0:3]
    g_normal = normalize(cross(e1, e2))  # Object::base_normal
    inside = dot(g_normal, direction) > 0

    smooth = normalize(_interp_flat(row, 9, 3, hit.beta, hit.gamma))
    smooth = where3(dot(g_normal, smooth) < 0, -smooth, smooth)

    # Static fast path: an atlas holding only the two builtin 1x1 textures
    # (white + flat normal) means every lookup is the identity — skip the
    # 16 row-gathers of bilinear fetching entirely.  Exactly equivalent to
    # sampling WHITE_TEXTURE/NORMAL_UP (src/geometry.h:601-602).  The same
    # identity argument applies PER SLOT (scene.tex_slots): a slot every
    # material maps to the builtin is dropped from the fetch, shrinking the
    # corner gather from 4K to 4·(used slots) rows per ray — e.g. scenes
    # without emissive textures fetch 12 corners, not 16.
    has_textures = scene.atlas.offset.shape[0] > 2 and config.use_textures
    use_c, use_e, use_m, use_n = (
        scene.tex_slots if has_textures else (False,) * 4
    )
    fetch = []  # (per-ray atlas ids, gamma) per USED slot, fetch order
    if use_c:
        fetch.append((color_tex, 2.2))
    if use_e:
        fetch.append((emissive_tex, 2.2))
    if use_m:
        fetch.append((mr_tex, 1.0))
    if use_n:
        fetch.append((normal_tex, 1.0))
    if fetch:
        uv = _interp_flat(row, 18, 2, hit.beta, hit.gamma)  # tex_coord_at
        # The used slots sample the same uv: ONE fused gather for the
        # 4K corner texels (ops/texture.sample_many).  flat=True returns
        # the column-sliced [R, 16K] form instead of [R, K, 4].
        fetched = texture.sample_many(
            scene.atlas,
            jnp.stack([ids for ids, _ in fetch], axis=1),
            uv,
            tuple(g for _, g in fetch),
            flat=True,
        )
        at = {}  # slot -> first output lane (4 channels per used slot)
        lane = 0
        for flag, name in ((use_c, "c"), (use_e, "e"), (use_m, "m"),
                           (use_n, "n")):
            if flag:
                at[name] = lane
                lane += 4
    if use_n:
        tangent = normalize(_interp_flat(row, 24, 3, hit.beta, hit.gamma))
        bitangent = cross(smooth, tangent)
        j = at["n"]
        normal_loc = normalize(
            fetched[:, j:j + 3] * 2.0 - 1.0
        )  # sample_normal
        shading = normalize(frame_apply(normal_loc, tangent, bitangent, smooth))
    else:
        shading = smooth
    color = base_color * fetched[:, at["c"]:at["c"] + 4] if use_c else base_color
    emission = (
        base_emission * fetched[:, at["e"]:at["e"] + 3] if use_e
        else base_emission
    )
    if use_m:
        j = at["m"]
        metallic = base_metallic * fetched[:, j + 2]  # mr B ch (geometry.h:625)
        roughness = base_roughness * fetched[:, j + 1]  # mr G channel
    else:
        metallic = base_metallic
        roughness = base_roughness

    flip = inside[:, None]
    return dict(
        normal=jnp.where(flip, -g_normal, g_normal),
        shading_normal=jnp.where(flip, -shading, shading),
        inside=inside,
        color=color,  # [R, 4] rgba
        emission=emission,
        metallic=metallic,
        roughness=roughness,
        ior=ior,
    )


def bounce_step(
    scene: TriangleScene,
    config: RenderConfig,
    o: jnp.ndarray,  # [R, 3]
    d: jnp.ndarray,  # [R, 3]
    throughput: jnp.ndarray,  # [R, 3]
    radiance: jnp.ndarray,  # [R, 3]
    alive: jnp.ndarray,  # [R] bool
    draws: jnp.ndarray,  # [_DRAWS, R] U[0,1) (lane-major, see ops/rng.py)
):
    """One wavefront bounce: the full masked-select form of ``shade``
    (src/raytracer.h:555-591) over R lanes.  Shared by the scan engine
    (``trace``) and the persistent-compaction engine
    (``render_chunk_persistent``); returns updated (o, d, throughput,
    radiance, alive)."""
    eps = config.eps
    vf = config.vndf_factor
    lights = scene.lights
    has_light_rows = lights.capacity > 0

    hit = scene_closest_hit(scene, o, d, eps)

    if scene.has_env and config.use_textures:
        env = texture.env_radiance(
            scene.atlas, scene.env_tex, scene.bg_color, d, True
        )
    else:
        # No env map loaded: bg_at degenerates to bg_color (white 1x1
        # sample — src/scene.h:83-89 with WHITE_TEXTURE).
        env = jnp.broadcast_to(scene.bg_color, d.shape)
    miss = alive & ~hit.hit
    radiance = radiance + jnp.where(miss[:, None], throughput * env, 0.0)

    live = alive & hit.hit
    info = hit_info(scene, d, hit, config)
    pos = o + hit.t[:, None] * d

    # Alpha transparency Russian roulette (src/raytracer.h:558-561):
    # coin(alpha) FAILS with prob 1-alpha -> continue same direction.
    alpha_pass = draws[0] > info["color"][:, 3]
    passthrough = live & alpha_pass
    shade = live & ~alpha_pass

    radiance = radiance + jnp.where(
        shade[:, None], throughput * info["emission"], 0.0
    )

    # --- direction sampling -------------------------------------------
    alpha_r2 = jnp.maximum(info["roughness"], config.min_roughness) ** 2
    use_vndf = draws[1] <= vf
    vndf_dir = sampling.vndf_sample(
        alpha_r2, d, info["shading_normal"], draws[2], draws[3]
    )
    cos_dir = sampling.cosine_sample(info["normal"], draws[5], draws[6])
    if has_light_rows:
        n_lights = lights.count
        pick_light = (sampling.pick_uniform(draws[4], jnp.asarray(2)) == 1) & (
            n_lights > 0
        )
        li = sampling.pick_uniform(draws[7], n_lights)
        # Gather the picked light's verts as ONE flat 9-float row; the
        # [L, 9] view is loop-invariant (hoisted).
        lv = lights.verts.reshape(-1, 9)[li]  # [R, 9]
        light_dir = sampling.light_triangle_sample(
            pos, lv[:, 0:3], lv[:, 3:6], lv[:, 6:9], draws[8], draws[9]
        )
        mix_dir = where3(pick_light, light_dir, cos_dir)
    else:
        mix_dir = cos_dir
    new_dir = where3(use_vndf, vndf_dir, mix_dir)

    # --- pdf blend (src/raytracer.h:572-574) --------------------------
    p_vndf = sampling.vndf_pdf(
        alpha_r2, d, info["shading_normal"], new_dir, eps
    )
    p_cos = sampling.cosine_pdf(info["normal"], new_dir)
    if has_light_rows:
        if lights.has_clusters and lights.cluster_woop.shape[0] <= 4:
            # Small light sets: flat Woop contraction over the packed
            # clusters (<= 4 x [R, 128] slabs) — same value as the Cramer
            # dense path to fp, without its [R, L, 3] intermediates.
            p_light = light_pdf_sum_flat(
                pos, new_dir, lights.cluster_woop, lights.cluster_k,
                lights.count, eps,
            )
        else:
            p_light = light_pdf_sum(
                pos, new_dir, lights.verts, lights.normal, lights.area,
                lights.count, eps,
            )
        p_mix = jnp.where(lights.count > 0, (p_cos + p_light) / 2.0, p_cos)
    else:
        p_mix = p_cos
    p = vf * p_vndf + (1.0 - vf) * p_mix

    # --- throughput update + kill conditions --------------------------
    f = bsdf.pbr_brdf(
        d,
        new_dir,
        info["shading_normal"],
        info["color"][:, :3],
        info["metallic"],
        info["roughness"],
        info["ior"],
        config.min_roughness,
    )
    cos_term = jnp.maximum(0.0, dot(new_dir, info["shading_normal"]))
    # One 1-D divide then a broadcast multiply (same value as
    # f / p[:, None] * cos to fp associativity).
    scl = f * (cos_term / p)[:, None]

    dir_nan = jnp.any(jnp.isnan(new_dir), axis=-1)
    kill = dir_nan | (p < eps) | (length2(scl) == 0.0)
    cont = shade & ~kill

    throughput = jnp.where(cont[:, None], throughput * scl, throughput)
    moved = passthrough | cont
    o = where3(moved, pos, o)
    d = where3(cont, new_dir, d)
    alive = moved
    # Sort hint for the NEXT bounce: the chunk id of the surface the ray
    # now spawns from (ray_sort_key_hint); -1 where dead/invalid.  The
    # chunk width comes from the scene's packed blocks.
    chunk_tris = scene.chunk_woop.shape[-1]
    hint = jnp.where(moved, hit.tri // chunk_tris, -1)
    return o, d, throughput, radiance, alive, hint


def _permute_carries(perm, vec3s, scalars, packed: int):
    """Apply the per-bounce sort permutation to the engine's carry bundle.

    packed=0: one ``take`` per carry array.  packed=1 (default): the carries
    ride two typed blocks (f32 [R, 3V] + int32 [R, S]) so the permutation is
    two wide-row gathers.  packed=2: f32 block + independent 1-D int takes,
    kept for A/B.  The movement itself is bit-exact (pinned by test);
    whole renders under any mode are estimator-identical to fp noise — the
    block layout shifts XLA's fusion of the *producing* ops, which can move
    an ulp and flip an RR coin on isolated lanes.  Perf knob
    ``IntersectTuning.packed_permute``.
    Returns (vec3s, scalars) in the input order."""
    if not packed:
        return ([v[perm] for v in vec3s], [x[perm] for x in scalars])
    # f32 block: one wide [R, 3V] row gather for the [R, 3] carries.
    # Typed f32 (not bitcast ints): int bit patterns read as f32 are
    # denormals/NaNs, which a fused kernel may canonicalize.
    fblock = jnp.concatenate(list(vec3s), axis=1)[perm]
    out_v = [fblock[:, 3 * i:3 * i + 3] for i in range(len(vec3s))]
    if packed >= 2:
        # Int carries permuted as S independent 1-D takes.
        return out_v, [x[perm] for x in scalars]
    iblock = jnp.concatenate(
        [(x.astype(jnp.int32) if x.dtype == jnp.bool_ else x)[:, None]
         for x in scalars], axis=1,
    )[perm]
    # One [S, R] transpose instead of S lazy [R, 1] column slices.
    ib_t = iblock.T  # [S, R]
    out_s = [
        (ib_t[j] != 0) if x.dtype == jnp.bool_ else ib_t[j]
        for j, x in enumerate(scalars)
    ]
    return out_v, out_s


def _make_sort_key(scene: TriangleScene, config: RenderConfig):
    """Build the per-bounce wavefront coherence key fn for ray sorting.

    config.sort_key selects the policy (see config.py and ops/sortkeys.py).
    Returns key_fn(o, d, alive, hint) -> [R] int32 (dead rays sort last).
    """
    if config.sort_key not in ("hint", "dirhint", "cell", "none"):
        # Reject typos loudly: a silent fall-through to the "cell" key would
        # time the wrong variant in an A/B.
        raise ValueError(
            f"unknown sort_key {config.sort_key!r}: expected hint | dirhint"
            " | cell | none"
        )
    # nan-reductions: all-padding chunks carry NaN never-hit boxes.
    scene_lo = jnp.nanmin(scene.chunk_aabb_min, axis=0)
    scene_hi = jnp.nanmax(scene.chunk_aabb_max, axis=0)
    n_chunks = scene.chunk_woop.shape[0]

    def key_fn(o, d, alive, hint):
        if config.sort_key == "hint":
            return ray_sort_key_hint(d, alive, hint, n_chunks)
        if config.sort_key == "dirhint":
            return ray_sort_key_dirhint(d, alive, hint, n_chunks)
        if config.sort_key == "none":
            # Compaction-only order (dead rays last, live order untouched):
            # prices the coherence machinery in context — the reference has
            # no ray sorting either, so this is also its closest analog.
            del o, d, hint
            return jnp.where(alive, 0, 1).astype(jnp.int32)
        return ray_sort_key(o, d, alive, scene_lo, scene_hi)

    return key_fn


def trace(
    scene: TriangleScene,
    origin: jnp.ndarray,  # [R, 3]
    direction: jnp.ndarray,  # [R, 3]
    key: jax.Array,  # BASE render key (not stage-folded)
    pixel_ids: jnp.ndarray,  # [R] int32 (keys the per-ray RNG streams)
    config: RenderConfig,
    sample: jnp.ndarray | int = 0,  # [] global sample index of this pass
) -> jnp.ndarray:  # [R, 3] radiance (NOT NaN-sanitized; caller does that)
    """One full path per input ray: scan over ray_depth wavefront bounces."""
    r = origin.shape[0]
    # Wavefront ray sorting (large scenes only): reorder the whole carry by a
    # coherence key each bounce so neighbouring lanes trace similar rays.
    # Per-pixel RNG keys make the reorder observationally free; the carried
    # slot array recovers the output order.  The choice depends on the
    # scene alone, never on the wavefront width, so a frame compiles to the
    # same per-lane arithmetic however its pixels are chunked or sharded.
    sort_rays = scene.capacity > 1024
    if sort_rays:
        sort_key = _make_sort_key(scene, config)

    def bounce(carry, bounce_idx):
        o, d, throughput, radiance, alive, pids, slot, hint = carry
        if sort_rays:
            perm = jnp.argsort(sort_key(o, d, alive, hint))
            (o, d, throughput, radiance), (alive, pids, slot, hint) = (
                _permute_carries(
                    perm, (o, d, throughput, radiance),
                    (alive, pids, slot, hint),
                    int(config.tuning.packed_permute),
                )
            )
        draws = bounce_draws(key, sample, bounce_idx, pids, config)
        o, d, throughput, radiance, alive, hint = bounce_step(
            scene, config, o, d, throughput, radiance, alive, draws
        )
        if sort_rays:
            # Null dead rays to a far-away origin: they then miss every
            # leaf AABB and cost the traversal no rounds.
            o = where3(alive, o, jnp.full((3,), 1e30, o.dtype))
        return (o, d, throughput, radiance, alive, pids, slot, hint), None

    # Derive carry inits from the (possibly shard_map-varying) inputs so the
    # scan carry keeps a consistent varying-axis type under shard_map.
    init = (
        origin,
        direction,
        origin * 0.0 + 1.0,  # throughput = 1
        origin * 0.0,  # radiance = 0
        jnp.isfinite(origin[:, 0]),  # alive = True
        pixel_ids,
        # slot[i] = input position of the ray currently at position i; the
        # composed per-bounce permutation is inverted through it, so callers
        # may pass ANY pixel_ids (shuffled, duplicated) safely.
        pixel_ids * 0 + jnp.arange(r, dtype=jnp.int32),
        pixel_ids * 0 - 1,  # sort hint: fresh primaries have none
    )
    def bounce_or_skip(carry, bounce_idx):
        # Whole-wavefront early exit: once every ray is dead the remaining
        # depth iterations are identity (dead rays never contribute again).
        return jax.lax.cond(
            jnp.any(carry[4]),
            lambda c: bounce(c, bounce_idx)[0],
            lambda c: c,
            carry,
        ), None

    (o, d, throughput, radiance, alive, pids, slot, _hint), _ = jax.lax.scan(
        bounce_or_skip, init, jnp.arange(scene.ray_depth)
    )
    # Depth exhaustion: the reference's deepest call returns {0,0,0}, which a
    # NaN throughput chain turns into NaN (src/raytracer.h:596-598).
    radiance = radiance + jnp.where(alive[:, None], throughput * 0.0, 0.0)
    if sort_rays:
        # Undo the accumulated per-bounce permutations: slot is the composed
        # permutation, argsort of a permutation is its exact inverse.
        radiance = radiance[jnp.argsort(slot)]
    return radiance



def sanitize_nans(color: jnp.ndarray) -> jnp.ndarray:
    """sanitize_nans (src/raytracer.h:607-616): per-channel NaN -> 0."""
    return jnp.where(jnp.isnan(color), 0.0, color)


@partial(jax.jit, static_argnames=("n_rays", "spp", "config", "accum_rows"))
def render_chunk_persistent(
    scene: TriangleScene,
    chunk_start: jnp.ndarray,  # [] int32 first linear pixel id
    key: jax.Array,
    sample_start: jnp.ndarray,  # [] int32 (checkpoint resume offset)
    n_rays: int,
    spp: int,
    config: RenderConfig,
    pix_count: jnp.ndarray | None = None,  # [] int32 useful pixels (see
    #   persistent_accum) — rows past the useful pixels, i.e.
    #   [pix_count, accum_rows or n_rays), are 0
    accum_rows: int | None = None,  # static pool pixels > n_rays (frame pool)
) -> Tuple[jnp.ndarray, jnp.ndarray]:  # ([rows, 3] mean radiance, [] rays)
    """Persistent-wavefront engine with TRUE stream compaction.

    The scan engine (``render_chunk``) keeps dispatch width R for all
    ``ray_depth`` bounces even as the wavefront dies.  This engine instead
    *refills* dead lanes with fresh (pixel, sample) primary rays each
    iteration (Laine et al.'s
    path regeneration, re-expressed as a ``lax.while_loop`` over a fixed-R
    wavefront — the shape-stable XLA form of stream compaction): lane
    occupancy stays ~100% until the work pool drains, so the total iteration
    count approaches W·E[path length]/R instead of spp·ray_depth.

    Estimator-identical to render_chunk: per-lane draws are the same pure
    function of (seed, pixel, sample, depth) counter-mode stream the scan
    engine consumes (ops/rng.py), so every (pixel, sample) path takes
    identical draws; only the per-pixel summation order differs (fp
    reassociation noise).

    Returns (mean radiance [n_rays, 3], measured bounce-ray count []) — the
    counter is the number of live lanes entering each bounce, i.e. the TRUE
    rays traced (the reference's derived Mrays range assumed 4-8 bounces per
    path, BASELINE.md; this removes the convention).
    """
    # int32 safety: work ids and the bounce counter are int32 on device.
    # A pool of pool_pixels*spp work items can produce up to ~pool*ray_depth
    # bounces per call; reject configurations that could wrap instead of
    # silently publishing a negative measured-ray count (8192 spp at 64k
    # lanes wraps).  Callers split spp into spp_per_pass pools, so the fix
    # is a smaller spp_per_pass.
    pool_sz = accum_rows if accum_rows is not None else n_rays
    if pool_sz * spp * max(1, int(scene.ray_depth)) >= 2**31:
        raise ValueError(
            f"persistent pool too large for int32 counters: pool={pool_sz} "
            f"* spp={spp} * ray_depth={int(scene.ray_depth)} >= 2^31 — "
            "lower spp_per_pass (or rays_per_batch)"
        )
    pool_pix = (
        jnp.asarray(n_rays, jnp.int32) if pix_count is None
        else jnp.asarray(pix_count, jnp.int32)
    )
    acc, n_bounce = persistent_accum(
        scene, chunk_start, key, sample_start, n_rays,
        pool_pix * spp, config, pix_count=pix_count, accum_rows=accum_rows,
    )
    return acc / spp, n_bounce


def persistent_accum(
    scene: TriangleScene,
    chunk_start: jnp.ndarray,  # [] int32 first pixel id of this lane block
    key: jax.Array,
    sample_start: jnp.ndarray,  # [] int32 first global sample index
    n_rays: int,  # static lane count
    w_total: jnp.ndarray,  # [] int32 TRACED work-pool size (<= n_rays * spp);
    #   traced so SPMD ranks with different sample counts share one program
    config: RenderConfig,
    pix_count: jnp.ndarray | None = None,  # [] int32 traced: pixels this
    #   chunk actually covers (< n_rays when the chunk is the padded image
    #   tail, > n_rays under the frame pool).  None = every lane slot is a
    #   real pixel (n_rays-dense pool).
    accum_rows: int | None = None,  # static accumulator row count when the
    #   pool covers MORE pixels than lanes (config.frame_pool): the
    #   accumulator sizes to the pixel pool, lanes stay n_rays wide, and the
    #   drain tail is paid once per call instead of once per lane-sized
    #   chunk.  None = n_rays rows (chunked behavior, shard_map-safe).
):  # ([rows, 3] radiance SUM over the pool's samples, [] int32 rays traced)
    """Core persistent-wavefront loop (see render_chunk_persistent).

    Work item w covers (pixel slot w % P, local sample w // P) where
    P = pix_count or n_rays; callers divide the returned sum by their true
    spp.  The pix_count form keeps the pool DENSE over useful pixels: the
    padded image tail is never spawned, so out-of-image lanes trace no
    discarded paths and the rays-traced counter stays honest."""
    depth_cap = scene.ray_depth
    w_total = jnp.asarray(w_total, jnp.int32)
    pool_pix = n_rays if pix_count is None else jnp.asarray(pix_count, jnp.int32)
    sort_rays = scene.capacity > 1024  # as in trace()
    if sort_rays:
        sort_key = _make_sort_key(scene, config)

    def spawn(work_ids, valid):
        """Primary rays for work ids (sample-major order)."""
        w = jnp.where(valid, work_ids, 0)
        slot = (w % pool_pix).astype(jnp.int32)
        s = (w // pool_pix).astype(jnp.int32)
        pids = chunk_start + slot
        # Pixel-jitter draws: the JITTER_DEPTH stream of (pixel, sample) —
        # identical to render_chunk's offsets (or the Owen-Sobol point
        # when config.jitter == "sobol"; same counter discipline).
        offs = jitter_uniforms(key, sample_start + s, pids, config.jitter)
        o, d = gen_rays(scene.camera, pids, offs)
        return o, d, slot, s

    # Initial fill: work items [0, R) = every pixel's sample 0.  All carry
    # inits derive from the spawned rays so their shard_map varying-axis
    # types stay consistent through the while_loop body.
    iota = jnp.arange(n_rays, dtype=jnp.int32)
    valid0 = iota < w_total
    o0, d0, slot0, s0 = spawn(iota, valid0)
    lane0 = slot0 + (chunk_start * 0 + sample_start * 0)  # varying-typed iota base
    alive0 = valid0 & jnp.isfinite(o0[:, 0])
    state = dict(
        o=o0,
        d=d0,
        throughput=o0 * 0.0 + 1.0,
        radiance=o0 * 0.0,
        alive=alive0,
        active=alive0,  # lane holds a real path (alive => active)
        slot=lane0,  # chunk-local pixel slot for the accumulator scatter
        sample=s0 + lane0 * 0,
        depth=lane0 * 0,
        hint=lane0 * 0 - 1,  # spawn-surface chunk id (fresh lanes: none)
        next_work=jnp.minimum(jnp.asarray(n_rays, jnp.int32), w_total),
        # Frame pool: a plain zeros init is fine — accum_rows is only used
        # on the single-host path, never under shard_map (whose carry inits
        # must derive from spawned rays for varying-axis typing).
        accum=(o0 * 0.0 if accum_rows is None
               else jnp.zeros((accum_rows, 3), o0.dtype)),
        # Measured rays traced: live lanes entering each bounce.  int32 is
        # safe per call (<= n_rays * spp_per_pass * ray_depth << 2^31); the
        # host loop accumulates across calls in Python ints.
        n_bounce=w_total * 0,
    )

    def cond(st):
        return jnp.any(st["alive"]) | (st["next_work"] < w_total)

    def body(st):
        o, d = st["o"], st["d"]
        throughput, radiance = st["throughput"], st["radiance"]
        alive, active = st["alive"], st["active"]
        slot, sample, depth = st["slot"], st["sample"], st["depth"]
        next_work, accum = st["next_work"], st["accum"]
        hint = st["hint"]

        if sort_rays:
            perm = jnp.argsort(sort_key(o, d, alive, hint))
            ((o, d, throughput, radiance),
             (alive, active, slot, sample, depth, hint)) = _permute_carries(
                perm, (o, d, throughput, radiance),
                (alive, active, slot, sample, depth, hint),
                int(config.tuning.packed_permute),
            )

        n_bounce = st["n_bounce"] + jnp.sum(alive.astype(jnp.int32))
        draws = bounce_draws(
            key, sample_start + sample, depth, chunk_start + slot, config
        )
        o, d, throughput, radiance, alive2, hint = bounce_step(
            scene, config, o, d, throughput, radiance, alive, draws
        )
        alive2 = alive2 & alive  # dead/inactive lanes stay dead
        depth = depth + 1

        # Path termination: killed this bounce, or depth budget exhausted.
        exhausted = alive2 & (depth >= depth_cap)
        # Depth exhaustion adds throughput*0 (NaN algebra, raytracer.h:596).
        radiance = radiance + jnp.where(
            exhausted[:, None], throughput * 0.0, 0.0
        )
        done = active & (~alive2 | exhausted)
        alive2 = alive2 & ~exhausted

        # Scatter finished samples into the accumulator (per-sample NaN
        # sanitize exactly as render_pixel does, src/raytracer.h:607-616).
        contrib = jnp.where(done[:, None], sanitize_nans(radiance), 0.0)
        drop_row = n_rays if accum_rows is None else accum_rows
        accum = accum.at[
            jnp.where(done, slot, drop_row)
        ].add(contrib, mode="drop")

        # Regenerate: freed lanes pull the next work items.
        free = done | ~active
        rank = jnp.cumsum(free.astype(jnp.int32)) - 1
        work_ids = next_work + rank
        take = free & (work_ids < w_total)
        no, nd, nslot, nsample = spawn(work_ids, take)
        o = where3(take, no, o)
        d = where3(take, nd, d)
        throughput = jnp.where(take[:, None], 1.0, throughput)
        radiance = jnp.where(take[:, None], 0.0, radiance)
        slot = jnp.where(take, nslot, slot)
        sample = jnp.where(take, nsample, sample)
        depth = jnp.where(take, 0, depth)
        hint = jnp.where(take, -1, hint)
        alive2 = alive2 | take
        active = (active & ~done) | take
        next_work = jnp.minimum(
            next_work + jnp.sum(free.astype(jnp.int32)), w_total
        )
        if sort_rays:
            # Null dead lanes far away so they miss every leaf AABB.
            o = where3(alive2, o, jnp.full((3,), 1e30, o.dtype))
        return dict(
            o=o, d=d, throughput=throughput, radiance=radiance, alive=alive2,
            active=active, slot=slot, sample=sample, depth=depth, hint=hint,
            next_work=next_work, accum=accum, n_bounce=n_bounce,
        )

    state = jax.lax.while_loop(cond, body, state)
    return state["accum"], state["n_bounce"]


@partial(jax.jit, static_argnames=("n_rays", "spp", "config"))
def render_chunk(
    scene: TriangleScene,
    chunk_start: jnp.ndarray,  # [] int32 first linear pixel id
    key: jax.Array,
    sample_start: jnp.ndarray,  # [] int32 (checkpoint resume offset)
    n_rays: int,
    spp: int,
    config: RenderConfig,
) -> jnp.ndarray:  # [n_rays, 3] mean radiance
    """Average ``spp`` samples for one contiguous pixel chunk
    (render_pixel, src/raytracer.h:618-627)."""
    pixel_ids = chunk_start + jnp.arange(n_rays)

    def body(s, acc):
        gs = sample_start + s
        # Pixel-jitter draws use a depth id no bounce can reach.
        offsets = jitter_uniforms(key, gs, pixel_ids, config.jitter)
        o, d = gen_rays(scene.camera, pixel_ids, offsets)
        rad = trace(scene, o, d, key, pixel_ids, config, sample=gs)
        return acc + sanitize_nans(rad)

    acc = jax.lax.fori_loop(0, spp, body, jnp.zeros((n_rays, 3), jnp.float32))
    return acc / spp


def pick_chunk(config: RenderConfig, npix: int) -> int:
    """Pixel-chunk size (wavefront width): the frame, at most
    ``config.rays_per_batch``."""
    return min(config.rays_per_batch, npix)


def render(
    scene: TriangleScene,
    spp: int,
    seed: int = 0,
    config: RenderConfig = None,
    progress: bool = False,
    timer=None,
    stats: dict | None = None,
):
    """Full-frame render -> host numpy [H, W, 3] float32 HDR radiance.

    Replaces the reference's span thread pool (run_raytracer,
    src/raytracer.h:629-674): pixel chunks are jitted megabatches instead of
    256-pixel CPU spans, looped from host with a folded key per chunk.

    ``timer``: optional ``utils.profiling.PhaseTimer`` accumulating the
    host-visible phases (trace+compile+enqueue vs device wait/readback).
    ``stats``: optional dict; the compaction engine fills
    ``stats["measured_rays"]`` with the TRUE number of rays traced (live
    lanes entering each bounce) so throughput claims need no path-length
    convention (a depth-8 Mrays count is only an upper bound).
    """
    import contextlib

    import numpy as np

    config = config or RenderConfig()
    phase = timer.phase if timer is not None else (
        lambda _name: contextlib.nullcontext()
    )
    cam = scene.camera
    h, w = cam.height, cam.width
    npix = h * w
    if scene.ray_depth == 0:
        return np.broadcast_to(
            np.asarray(scene.bg_color, dtype=np.float32), (h, w, 3)
        ).copy()
    spp = max(int(spp), 1)  # samples=0 is 0/0 UB in the reference; clamp

    chunk = pick_chunk(config, npix)
    base = jax.random.key(seed)
    out = np.zeros((npix, 3), dtype=np.float32)
    # Work is dispatched in (pixel-chunk, spp-pass) tiles: bounded device
    # executions keep peak memory flat and stay under any runtime watchdog,
    # and per-pixel RNG keys make the tiling observationally irrelevant.
    pass_spp = max(1, min(config.spp_per_pass, spp))
    # Frame pool: one persistent call's work pool covers the WHOLE frame
    # (accumulator sized to the frame, lanes stay ``chunk`` wide), so the
    # engine's drain tail — lanes dying over the last ~ray_depth iterations
    # once the pool empties — is paid once per spp pass instead of once per
    # lane-sized pixel chunk.  Off under the scan engine, and pointless when
    # the frame fits one chunk anyway.
    frame_pool = config.frame_pool and config.compaction and npix > chunk
    pix_step = npix if frame_pool else chunk

    def pool_args(n):
        """(pix_count, accum_rows) for a chunk covering n useful pixels."""
        if frame_pool:
            return jnp.asarray(n, jnp.int32), n
        # pix_count only for the padded tail chunk: full chunks keep the
        # static power-of-2 slot modulus (and the already-compiled program).
        return (None if n == chunk else jnp.asarray(n, jnp.int32)), None

    # Dispatch every (chunk, pass) tile asynchronously and accumulate on
    # device; a single readback per chunk at the end.  Keeps the device busy
    # instead of paying a host round-trip per dispatch.
    n_tiles = ((npix + pix_step - 1) // pix_step) * (
        (spp + pass_spp - 1) // pass_spp
    )
    done_tiles = 0
    pending = []
    for start in range(0, npix, pix_step):
        n = min(pix_step, npix - start)
        acc = None
        counts = []  # this chunk's measured bounce-ray counts (device scalars)
        for s0 in range(0, spp, pass_spp):
            if progress:
                # Span-progress analog (src/raytracer.h:647).
                import sys

                print(f"{done_tiles}/{n_tiles}     \r", end="", file=sys.stderr)
                done_tiles += 1
            todo = min(pass_spp, spp - s0)
            eng = render_chunk_persistent if config.compaction else render_chunk
            with phase("dispatch"):  # trace+compile on first call, then enqueue
                if config.compaction:
                    pc, ar = pool_args(n)
                    rad, nb = eng(
                        scene,
                        jnp.asarray(start, jnp.int32),
                        base,
                        jnp.asarray(s0, jnp.int32),
                        chunk,
                        todo,
                        config,
                        pix_count=pc,
                        accum_rows=ar,
                    )
                    counts.append(nb)
                else:
                    rad = eng(
                        scene,
                        jnp.asarray(start, jnp.int32),
                        base,
                        jnp.asarray(s0, jnp.int32),
                        chunk,
                        todo,
                        config,
                    )
                contrib = rad * float(todo)
                acc = contrib if acc is None else acc + contrib
        pending.append((start, n, acc, counts))
    engine = render_chunk_persistent if config.compaction else render_chunk

    def recompute_chunk(start):
        """Failure recovery (SURVEY §5): per-pixel counter RNG makes any
        chunk a pure function of (scene, start, seed, spp), so a crashed
        device execution is repaired by recomputing just that chunk —
        sample-for-sample identical to the uninterrupted render (including
        its bounce-ray counts, which REPLACE the crashed dispatch's)."""
        acc = None
        counts = []
        n = min(pix_step, npix - start)
        for s0 in range(0, spp, pass_spp):
            todo = min(pass_spp, spp - s0)
            if config.compaction:
                pc, ar = pool_args(n)
                rad, nb = engine(
                    scene, jnp.asarray(start, jnp.int32), base,
                    jnp.asarray(s0, jnp.int32), chunk, todo, config,
                    pix_count=pc, accum_rows=ar,
                )
                counts.append(nb)  # identical recompute; don't double-count
            else:
                rad = engine(
                    scene, jnp.asarray(start, jnp.int32), base,
                    jnp.asarray(s0, jnp.int32), chunk, todo, config,
                )
            contrib = rad * float(todo)
            acc = contrib if acc is None else acc + contrib
        return acc, counts

    measured_rays = 0
    have_counts = False
    for start, n, acc, counts in pending:
        for attempt in range(config.failure_retries + 1):
            try:
                with phase("device_wait_readback"):
                    host = np.asarray(acc[:n])
                    # Scalars from the same executions: read them inside the
                    # retry scope, so a crashed dispatch's poisoned count is
                    # repaired by the recompute instead of re-raising later
                    # at the stats line.
                    chunk_rays = sum(int(np.asarray(c)) for c in counts)
                break
            except Exception:  # device/runtime crash surfaced at readback
                if attempt == config.failure_retries:
                    raise
                import sys

                print(
                    f"chunk {start}: device execution failed, retrying "
                    f"({attempt + 1}/{config.failure_retries})",
                    file=sys.stderr,
                )
                acc, counts = recompute_chunk(start)
        out[start : start + n] = host / spp
        if counts:
            measured_rays += chunk_rays
            have_counts = True
    if stats is not None and have_counts:
        stats["measured_rays"] = measured_rays
    return out.reshape(h, w, 3)

"""Bilinear texture fetch from the shared atlas.

Port of ``geometry::Texture::sample`` (src/geometry.h:545-582): repeat-wrap,
bilinear, with per-texel gamma decode applied *before* the lerp (gamma 2.2 for
color/emissive lookups, 1.0 for metallic-roughness/normal).  Two reference
semantics are preserved on purpose:

* 1x1 textures short-circuit and return the raw texel with NO gamma applied
  (``if (data.size() == 1) return data[0];`` src/geometry.h:548-550);
* when textures are disabled by config every lookup returns texel 0
  (src/geometry.h:572-574).

Fetches are four dynamic row-gathers from the flat [T, 4] texel pool — the
wavefront replacement for chasing ``const Texture*`` pointers per hit.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..scene.types import TextureAtlas
from .vecmath import normalize


def _wrap_repeat(x: jnp.ndarray) -> jnp.ndarray:
    """wrap_repeat (src/geometry.h:517-519): fmod(fmod(x, 1) + 1, 1)."""
    return jnp.mod(jnp.mod(x, 1.0) + 1.0, 1.0)


def sample(
    atlas: TextureAtlas,
    tex_id: jnp.ndarray,  # [R] int32
    uv: jnp.ndarray,  # [R, 2]
    gamma: float = 1.0,
    use_textures: bool = True,
) -> jnp.ndarray:  # [R, 4]
    off = atlas.offset[tex_id]
    if not use_textures:
        return atlas.texels[off]
    w = atlas.width[tex_id]
    h = atlas.height[tex_id]

    tx = _wrap_repeat(uv[:, 0]) * w.astype(uv.dtype)
    ty = _wrap_repeat(uv[:, 1]) * h.astype(uv.dtype)
    px = jnp.minimum(tx.astype(jnp.int32), w - 1)  # trunc toward 0 (tx >= 0)
    py = jnp.minimum(ty.astype(jnp.int32), h - 1)
    dx = (tx - px.astype(uv.dtype))[:, None]
    dy = (ty - py.astype(uv.dtype))[:, None]
    # mod_inc (src/geometry.h:521-523)
    px1 = jnp.where(px == w - 1, 0, px + 1)
    py1 = jnp.where(py == h - 1, 0, py + 1)

    def decode(c):
        if gamma != 1.0:
            rgb = jnp.power(c[:, :3], gamma)
            c = jnp.concatenate([rgb, c[:, 3:]], axis=-1)
        return c

    if atlas.quad is not None:
        # One 16-float row per ray instead of four 4-float rows: the quad
        # pool pre-gathers the mod_inc-wrapped corners (types.quad_pool).
        # Same texel values -> the bilinear result is bit-equal.
        rows = atlas.quad[off + px + py * w]  # [R, 16]
        c00, c01, c10, c11 = (
            decode(rows[:, 4 * i : 4 * i + 4]) for i in range(4)
        )
    else:
        c00 = decode(atlas.texels[off + px + py * w])
        c01 = decode(atlas.texels[off + px + py1 * w])
        c10 = decode(atlas.texels[off + px1 + py * w])
        c11 = decode(atlas.texels[off + px1 + py1 * w])
    bilinear = (1 - dx) * ((1 - dy) * c00 + dy * c01) + dx * ((1 - dy) * c10 + dy * c11)

    single = ((w * h) == 1)[:, None]
    # 1x1 short-circuit: raw texel, NO gamma (src/geometry.h:548-550).  For
    # w = h = 1 the quad row's pre-gamma c00 IS texels[off] — reuse it.
    raw = rows[:, 0:4] if atlas.quad is not None else atlas.texels[off]
    return jnp.where(single, raw, bilinear)


def sample_many(
    atlas: TextureAtlas,
    tex_ids: jnp.ndarray,  # [R, K] int32 (K textures sampled at the same uv)
    uv: jnp.ndarray,  # [R, 2]
    gammas,  # length-K tuple of static floats
    flat: bool = False,  # True -> [R, 4K] (column = tex*4 + channel): skips
    #   the [R,K,4] output reshape; hot callers slice columns.
) -> jnp.ndarray:  # [R, K, 4] (or [R, 4K] when flat)
    """Fused multi-texture bilinear fetch: all K textures' 4 corner texels
    gathered in ONE [R, 4K] row-gather from the pool (the shade stage reads
    baseColor/emissive/MR/normal at the same uv — 16 scattered gathers fold
    into one, the same packing trick as ``shade_attrs``).  Bit-equal to K
    independent ``sample`` calls."""
    k = tex_ids.shape[1]
    off = atlas.offset[tex_ids]  # [R, K]
    w = atlas.width[tex_ids]
    h = atlas.height[tex_ids]

    tx = _wrap_repeat(uv[:, 0])[:, None] * w.astype(uv.dtype)
    ty = _wrap_repeat(uv[:, 1])[:, None] * h.astype(uv.dtype)
    px = jnp.minimum(tx.astype(jnp.int32), w - 1)
    py = jnp.minimum(ty.astype(jnp.int32), h - 1)
    dx = (tx - px.astype(uv.dtype))[..., None]  # [R, K, 1]
    dy = (ty - py.astype(uv.dtype))[..., None]
    px1 = jnp.where(px == w - 1, 0, px + 1)  # mod_inc (src/geometry.h:521-523)
    py1 = jnp.where(py == h - 1, 0, py + 1)

    # FLAT corner-major columns instead of an [R, K, 4corner, 4rgba]
    # pipeline (whose every pow/select/lerp materialized an [R, 4, 4, 4]
    # intermediate).  Operating on [R, 16K] with column =
    # (corner*K + tex)*4 + channel keeps the corner slices contiguous
    # ([R, 4K] each).  Arithmetic per element is IDENTICAL (same
    # pow/bypass, same lerp order), so results stay bit-equal — on both
    # branches: the quad pool's K 16-float rows (4x fewer gather rows)
    # are brought into the same corner-major order by one transpose.
    if atlas.quad is not None:
        rows = atlas.quad[off + px + py * w]  # [R, K, 16] = (k, corner, ch)
        flat0 = (
            rows.reshape(rows.shape[0], k, 4, 4)
            .transpose(0, 2, 1, 3)
            .reshape(rows.shape[0], 16 * k)
        )
        n = rows.shape[0]
    else:
        idx = jnp.stack(
            [
                off + px + py * w,
                off + px + py1 * w,
                off + px1 + py * w,
                off + px1 + py1 * w,
            ],
            axis=1,
        )  # [R, corner, K]
        texels4 = atlas.texels[idx.reshape(idx.shape[0], -1)]  # [R, 4K, 4]
        flat0 = texels4.reshape(idx.shape[0], 16 * k)
        n = idx.shape[0]
    gam_lane = jnp.asarray(
        [
            gammas[kk] if ch < 3 else 1.0
            for _corner in range(4)
            for kk in range(k)
            for ch in range(4)
        ],
        dtype=uv.dtype,
    )[None, :]
    # Bit-parity with `sample`: gamma-1 lanes bypass pow entirely (XLA's
    # f32 pow(x, 1) is not guaranteed to be the identity).
    dec = jnp.where(gam_lane == 1.0, flat0, jnp.power(flat0, gam_lane))
    c00 = dec[:, 0 * 4 * k : 1 * 4 * k]
    c01 = dec[:, 1 * 4 * k : 2 * 4 * k]
    c10 = dec[:, 2 * 4 * k : 3 * 4 * k]
    c11 = dec[:, 3 * 4 * k : 4 * 4 * k]
    wx = jnp.repeat(dx[..., 0], 4, axis=1)  # [R, 4K], lane = tex*4 + ch
    wy = jnp.repeat(dy[..., 0], 4, axis=1)
    bilinear = (1 - wx) * ((1 - wy) * c00 + wy * c01) + wx * (
        (1 - wy) * c10 + wy * c11
    )
    # 1x1 short-circuit: raw texel, NO gamma (src/geometry.h:548-550).
    # For w = h = 1 every corner index equals ``off`` (mod_inc wraps
    # 0 -> 0), so the pre-gamma c00 corner IS atlas.texels[off].
    single = jnp.repeat(((w * h) == 1), 4, axis=1)
    raw = flat0[:, 0 : 4 * k]
    out = jnp.where(single, raw, bilinear)
    return out if flat else out.reshape(n, k, 4)


def sample_normal(
    atlas: TextureAtlas,
    tex_id: jnp.ndarray,
    uv: jnp.ndarray,
    use_textures: bool = True,
) -> jnp.ndarray:  # [R, 3] unit vectors
    """Texture::sample_normal (src/geometry.h:577-582): [0,1] -> [-1,1], unit."""
    rgb = sample(atlas, tex_id, uv, 1.0, use_textures)[:, :3]
    return normalize(rgb * 2.0 - 1.0)


def env_radiance(
    atlas: TextureAtlas,
    env_tex: jnp.ndarray,  # [] int32
    bg_color: jnp.ndarray,  # [3]
    direction: jnp.ndarray,  # [R, 3] (unit)
    use_textures: bool = True,
) -> jnp.ndarray:  # [R, 3]
    """Scene::bg_at equirect lookup (src/scene.h:83-89)."""
    d = direction
    u = 0.5 + 0.5 * jnp.arctan2(d[:, 2], d[:, 0]) / jnp.pi
    v = 0.5 - jnp.arcsin(jnp.clip(d[:, 1], -1.0, 1.0)) / jnp.pi
    tex_ids = jnp.broadcast_to(env_tex, d.shape[:1])
    c = sample(atlas, tex_ids, jnp.stack([u, v], axis=-1), 2.2, use_textures)
    return bg_color[None, :] * c[:, :3]

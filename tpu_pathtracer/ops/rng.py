"""Counter-based threefry-2x32 uniforms in lane-major layout.

The estimator draws ~10 uniforms per (pixel, sample, depth) lane.  Routing
those through ``jax.random`` (vmapped ``fold_in`` + per-lane ``uniform``)
produces ``[R, n_draws]`` intermediates whose minor dim is the short *draw*
axis.  This module computes the same *kind* of stream (full threefry-2x32,
the same PRNG family jax uses) directly in counter mode with the ray axis
minor, so every u32 op runs over the long ray axis.

Stream discipline (the framework's reproducibility anchor — replaces the
reference's per-span LCG seeding, src/raytracer.h:648): every uniform is
``tf2x32(stage_key, (pixel, block))`` where ``stage_key`` folds
(sample, depth) into the user seed.  The draw for a given
(seed, pixel, sample, depth, draw index) is a pure function of those five
integers — independent of batch split, device sharding, engine (scan vs
persistent wavefront), chunk order, and checkpoint/resume boundaries.
"""

from __future__ import annotations

from typing import Tuple, Union

import jax
import jax.numpy as jnp

_ROT = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA

U32 = jnp.uint32
_Int = Union[int, jnp.ndarray]


def _rotl(x: jnp.ndarray, r: int) -> jnp.ndarray:
    return (x << U32(r)) | (x >> U32(32 - r))


def tf2x32(
    k0: _Int, k1: _Int, c0: _Int, c1: _Int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Threefry-2x32, 20 rounds (the Random123 KAT-validated variant).

    All inputs broadcast; u32 semantics.  Returns two u32 words.
    """
    def u(x):
        import numpy as np

        if isinstance(x, int):
            return U32(np.uint32(x & 0xFFFFFFFF))
        return jnp.asarray(x).astype(U32)

    k0, k1, x0, x1 = u(k0), u(k1), u(c0), u(c1)
    x0 = x0 + k0
    x1 = x1 + k1
    ks = (k0, k1, k0 ^ k1 ^ U32(_PARITY))
    for i in range(5):
        for j in range(4):
            r = _ROT[(i % 2) * 4 + j]
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + U32(i + 1)
    return x0, x1


def _bits_to_unit(bits: jnp.ndarray) -> jnp.ndarray:
    """u32 -> f32 in [0, 1): top 23 bits into a [1,2) mantissa, minus 1."""
    f = jax.lax.bitcast_convert_type(
        (bits >> U32(9)) | U32(0x3F800000), jnp.float32
    )
    return f - 1.0


def key_words(key: jax.Array) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """The two u32 words of a jax PRNG key (threefry impl)."""
    data = jax.random.key_data(key)
    return data[..., 0].astype(U32), data[..., 1].astype(U32)


# Reserved depth id for the pixel-jitter draws of a sample (a sample's
# camera jitter is conceptually "before bounce 0").  Scene ray depth is
# capped far below this.
JITTER_DEPTH = 0x7FFFFFFF


def lane_uniforms(
    key: jax.Array,
    sample: _Int,  # scalar or [R] global sample index
    depth: _Int,  # scalar or [R] bounce index (or JITTER_DEPTH)
    pixel: jnp.ndarray,  # [R] linear pixel ids
    n_draws: int,
) -> jnp.ndarray:  # [n_draws, R] f32 in [0, 1)
    """U[0,1) draws keyed per (pixel, sample, depth) lane.

    ``sample``/``depth`` may be scalars (scan engine: the whole wavefront
    shares one (sample, depth)) or per-lane vectors (persistent engine:
    heterogeneous lanes) — the stream is identical either way, which is what
    makes the two engines produce bit-equal estimators.
    """
    k0, k1 = key_words(key)
    s = jnp.asarray(sample).astype(U32)
    b = jnp.asarray(depth).astype(U32)
    p = pixel.astype(U32)
    # Stage key: fold (sample, depth) through one block.  For the scan
    # engine this is scalar work (free); for the persistent engine it is one
    # [R]-wide block.
    a0, a1 = tf2x32(k0, k1, s, b)
    draws = []
    for blk in range((n_draws + 1) // 2):
        x0, x1 = tf2x32(a0, a1, p, U32(blk))
        draws.append(_bits_to_unit(x0))
        draws.append(_bits_to_unit(x1))
    return jnp.stack(draws[:n_draws], axis=0)

# ---------------------------------------------------------------------------
# Low-discrepancy pixel jitter: Owen-scrambled 2D Sobol.
#
# The reference jitters camera rays with plain uniforms
# (src/raytracer.h:527-538 via its per-span LCG); so does this framework by
# default (lane_uniforms above).  RenderConfig.jitter="sobol" replaces ONLY
# the camera-jitter draws with an Owen-scrambled (0,2)-sequence, keyed with
# the same counter discipline: the point for (seed, pixel, sample) is a pure
# function of those integers, so every reproducibility property (batch
# split, sharding, engine choice, checkpoint resume) is untouched.  Owen
# scrambling uses Burley's hash-based nested uniform scrambling
# ("Practical Hash-based Owen Scrambling", JCGT 2020): a per-(pixel, dim)
# hash permutes each dyadic interval independently, which preserves the
# (0,2)-net property per pixel (pinned by tests) while fully decorrelating
# pixels.
# ---------------------------------------------------------------------------

import numpy as _np

# Direction numbers, MSB-aligned.  Dim 1 is the identity matrix (van der
# Corput in base 2: value = reverse_bits(index)).  Dim 2 follows the
# classic recurrence v[i] = v[i-1] ^ (v[i-1] >> 1) from v[0] = 2^31 (the
# Pascal-matrix columns); validated by the elementary-interval tests.
_SOBOL_V2 = _np.zeros(32, dtype=_np.uint32)
_SOBOL_V2[0] = 0x80000000
for _i in range(1, 32):
    _SOBOL_V2[_i] = _SOBOL_V2[_i - 1] ^ (_SOBOL_V2[_i - 1] >> 1)


def _reverse_bits32(x: jnp.ndarray) -> jnp.ndarray:
    x = ((x >> U32(1)) & U32(0x55555555)) | ((x & U32(0x55555555)) << U32(1))
    x = ((x >> U32(2)) & U32(0x33333333)) | ((x & U32(0x33333333)) << U32(2))
    x = ((x >> U32(4)) & U32(0x0F0F0F0F)) | ((x & U32(0x0F0F0F0F)) << U32(4))
    x = ((x >> U32(8)) & U32(0x00FF00FF)) | ((x & U32(0x00FF00FF)) << U32(8))
    return (x >> U32(16)) | (x << U32(16))


def _laine_karras(x: jnp.ndarray, seed: jnp.ndarray) -> jnp.ndarray:
    """Laine-Karras style hash: an Owen (nested uniform) scramble in the
    REVERSED-bit domain — bit k of the output depends only on bits <= k of
    the input, i.e. each dyadic interval is permuted onto itself.  Constants
    from Burley 2020 (JCGT); any LK-family hash gives a valid Owen
    scramble, quality differs only in how close to an ideal random
    permutation it is."""
    x = x + seed
    x = x ^ (x * U32(0x6C50B47C))
    x = x ^ (x * U32(0xB82F1E52))
    x = x ^ (x * U32(0xC7AFE638))
    x = x ^ (x * U32(0x8D22F6E6))
    return x


def _owen_scramble(v: jnp.ndarray, seed: jnp.ndarray) -> jnp.ndarray:
    """Owen-scramble an MSB-aligned sample value with one hashed seed."""
    return _reverse_bits32(_laine_karras(_reverse_bits32(v), seed))


def sobol_owen_2d(
    key: jax.Array,
    sample: _Int,  # scalar or [R] global sample index
    pixel: jnp.ndarray,  # [R] linear pixel ids
) -> jnp.ndarray:  # [2, R] f32 in [0, 1)
    """Owen-scrambled 2D Sobol point ``sample`` for each pixel's sequence.

    Per-pixel scramble seeds come from one threefry block of (key, pixel)
    under a domain tag, so the jitter stream can never collide with the
    estimator's lane_uniforms streams (which always carry a depth word)."""
    k0, k1 = key_words(key)
    p = pixel.astype(U32)
    # Domain-tagged per-pixel seeds: one block -> two independent u32.
    s1, s2 = tf2x32(k0 ^ U32(0x534F424C), k1, p, U32(0))  # 'SOBL'
    idx = jnp.asarray(sample).astype(U32)
    # Dim 1: value = reverse(idx); LK wants the reversed domain = idx.
    d1 = _reverse_bits32(_laine_karras(idx + p * U32(0), s1))
    # Dim 2: XOR of direction numbers at the set bits of idx.
    v2 = jnp.asarray(_SOBOL_V2)
    d2 = jnp.zeros_like(idx + p * U32(0))
    for k in range(32):
        d2 = d2 ^ (jnp.where((idx >> U32(k)) & U32(1) > 0, v2[k], U32(0))
                   + p * U32(0))
    d2 = _owen_scramble(d2, s2)
    return jnp.stack([_bits_to_unit(d1), _bits_to_unit(d2)], axis=0)


def sobol_owen_pair(
    key: jax.Array,
    sample: _Int,  # scalar or [R] global sample index
    depth: _Int,  # scalar or [R] bounce index
    pixel: jnp.ndarray,  # [R] linear pixel ids
    tag: int,  # domain tag selecting WHICH estimator pair (vndf / light)
) -> jnp.ndarray:  # [2, R] f32 in [0, 1)
    """Owen-scrambled (0,2) point ``sample`` of the per-(pixel, depth, tag)
    sequence — the bounce-draw extension of :func:`sobol_owen_2d`.  Each (pixel, depth, tag) owns an independently
    scrambled copy of the same (0,2)-net over the sample index, so each
    pixel's N samples stratify every estimator pair (VNDF u1/u2, light
    point u/v) at every depth while distinct pixels/depths/pairs stay
    decorrelated.  Pure function of (seed, pixel, sample, depth, tag):
    every reproducibility property (batch split, sharding, engine,
    checkpoint resume) is inherited unchanged."""
    k0, k1 = key_words(key)
    p = pixel.astype(U32)
    b = jnp.asarray(depth).astype(U32)
    # Domain-tagged per-(pixel, depth) scramble seeds.  The depth word goes
    # into the COUNTER (like lane_uniforms) so heterogeneous per-lane depths
    # (persistent engine) stay one fused block.
    s1, s2 = tf2x32(k0 ^ U32(tag), k1, p, b ^ U32(0x534F424C))  # 'SOBL'
    idx = jnp.asarray(sample).astype(U32)
    d1 = _reverse_bits32(_laine_karras(idx + p * U32(0), s1))
    v2 = jnp.asarray(_SOBOL_V2)
    d2 = jnp.zeros_like(idx + p * U32(0))
    for k in range(32):
        d2 = d2 ^ (jnp.where((idx >> U32(k)) & U32(1) > 0, v2[k], U32(0))
                   + p * U32(0))
    d2 = _owen_scramble(d2, s2)
    return jnp.stack([_bits_to_unit(d1), _bits_to_unit(d2)], axis=0)


# Domain tags for the two highest-variance bounce pairs (config
# lowdisc="sobol"): VNDF (u1, u2) and light-point (u, v).
SOBOL_TAG_VNDF = 0x564E4446  # 'VNDF'
SOBOL_TAG_LIGHT = 0x4C495445  # 'LITE'


def jitter_uniforms(
    key: jax.Array,
    sample: _Int,
    pixel: jnp.ndarray,
    kind: str = "uniform",
) -> jnp.ndarray:  # [2, R] f32 in [0, 1)
    """Camera-jitter draws: ``kind`` = "uniform" (the reference's estimator,
    lane_uniforms at JITTER_DEPTH) or "sobol" (Owen-scrambled (0,2)-sequence
    — same counter discipline, visibly lower pixel variance at equal spp)."""
    if kind == "sobol":
        return sobol_owen_2d(key, sample, pixel)
    if kind != "uniform":
        raise ValueError(
            f"unknown jitter kind {kind!r}: expected uniform | sobol"
        )
    return lane_uniforms(key, sample, JITTER_DEPTH, pixel, 2)

"""Batched 3-vector math over ``[..., 3]`` arrays.

The reference generates a 3.9k-line header of vec2/3/4 + color types from a
Python codegen (``codegen/vectors.py``, ``src/generated/vectors.generated.inline.h``).
In JAX the whole layer collapses to jnp broadcasting over a trailing axis of
size 3; swizzles are index selections.  Hand-written pieces of
``src/geometry.h`` (cross/det/norm/reflect, quaternion rotation, TRS
matrices, the fast inverse-transpose used for normals) are reimplemented here
as pure functions; host-side scene loading uses the numpy twins below.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def dot(a, b, keepdims: bool = False):
    return jnp.sum(a * b, axis=-1, keepdims=keepdims)


def cross(a, b):
    """crs (src/geometry.h:18-24)."""
    return jnp.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        axis=-1,
    )


def det3(c1, c2, c3):
    """det of the 3x3 matrix with columns c1,c2,c3 (src/geometry.h:26-29)."""
    return dot(c1, cross(c2, c3))


def length2(a, keepdims: bool = False):
    return jnp.sum(a * a, axis=-1, keepdims=keepdims)


def length(a, keepdims: bool = False):
    return jnp.sqrt(length2(a, keepdims=keepdims))


def normalize(a):
    """norm (src/geometry.h:31-34).  No epsilon: the reference divides by the
    exact length and downstream NaN guards handle degenerate vectors."""
    return a / length(a, keepdims=True)


def reflect(normal, in_dir):
    """reflect (src/geometry.h:36-40): in - 2 n <in, n>."""
    return in_dir - 2.0 * normal * dot(in_dir, normal, keepdims=True)


def frame_apply(local_coords, x, y, z):
    """transform3 (src/geometry.h:355-359): basis recombination."""
    return (
        local_coords[..., 0:1] * x
        + local_coords[..., 1:2] * y
        + local_coords[..., 2:3] * z
    )


def where3(mask, a, b):
    """Select over [..., 3] vectors with a [...]-shaped bool mask."""
    return jnp.where(mask[..., None], a, b)


# ---------------------------------------------------------------------------
# Planar ([3, R] component-major) twins.
#
# In [3, R] form the ray axis is the minor dim, so every elementwise op
# runs over the long axis and XLA has no transposed-layout alternative to
# convert [R, 3] operands to and from.  Same arithmetic, same operand order per
# component — results match the [..., 3] forms to fp associativity.
# ---------------------------------------------------------------------------


def pdot(a, b, keepdims: bool = False):
    """dot over [3, R] planar vectors -> [R] (or [1, R])."""
    return jnp.sum(a * b, axis=0, keepdims=keepdims)


def pcross(a, b):
    return jnp.stack(
        [
            a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0],
        ],
        axis=0,
    )


def plength2(a, keepdims: bool = False):
    return jnp.sum(a * a, axis=0, keepdims=keepdims)


def pnormalize(a):
    return a / jnp.sqrt(plength2(a, keepdims=True))


def preflect(normal, in_dir):
    return in_dir - 2.0 * normal * pdot(in_dir, normal, keepdims=True)


def pwhere(mask, a, b):
    """Select over [3, R] vectors with an [R]-shaped bool mask."""
    return jnp.where(mask[None, :], a, b)


def pframe_apply(local_coords, x, y, z):
    """transform3 over planar frames: local [3, R], basis vectors [3, R]."""
    return (
        local_coords[0][None, :] * x
        + local_coords[1][None, :] * y
        + local_coords[2][None, :] * z
    )


# ---------------------------------------------------------------------------
# Host-side (numpy) transform helpers used only by the scene loaders.
# ---------------------------------------------------------------------------


def np_quat_rotation_matrix(q: np.ndarray) -> np.ndarray:
    """3x3 rotation from quaternion (x, y, z, w) (src/geometry.h:179-196)."""
    x, y, z, w = (float(v) for v in q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ],
        dtype=np.float64,
    )


def np_trs_matrix(scale: np.ndarray, quat_xyzw: np.ndarray, translation: np.ndarray) -> np.ndarray:
    """4x4 T*R*S compose (src/geometry.h:198-257)."""
    m = np.eye(4, dtype=np.float64)
    m[:3, :3] = np_quat_rotation_matrix(quat_xyzw) @ np.diag(np.asarray(scale, dtype=np.float64))
    m[:3, 3] = np.asarray(translation, dtype=np.float64)
    return m


def np_normal_transform(m4: np.ndarray) -> np.ndarray:
    """Fast inverse-transpose of the upper-left 3x3, as the reference computes
    it for normals (``rs_fast_inv_t``, src/geometry.h:287-311).

    Note the reference divides the full adjugate by ``fast_det2`` — the
    product of squared row lengths — which equals det^2 only for
    rotation+scale matrices.  Normals are renormalized afterwards
    (src/scene.h:392-396) so only the direction matters; we reproduce the
    same adjugate-over-positive-scalar construction.
    """
    a = np.asarray(m4, dtype=np.float64)[:3, :3]
    d2 = float((a[0] @ a[0]) * (a[1] @ a[1]) * (a[2] @ a[2]))
    adj = np.empty((3, 3), dtype=np.float64)
    for r in range(3):
        for c in range(3):
            r1, r2 = (r + 1) % 3, (r + 2) % 3
            c1, c2 = (c + 1) % 3, (c + 2) % 3
            adj[r, c] = a[r1, c1] * a[r2, c2] - a[r1, c2] * a[r2, c1]
    return adj / d2

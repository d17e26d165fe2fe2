"""Direction-sampling distributions (batched sample + pdf pairs).

Port of the distribution structs in src/raytracer.h:54-432.  Each reference
struct had virtual-ish dispatch through a ``std::variant``; here every
distribution is a pure function over ``[R, 3]`` batches and the variant
dispatch becomes masked selects in the integrator.  Draw conventions: every
function takes the uniform variates it needs explicitly so the caller controls
the counter-based RNG layout.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from .vecmath import cross, dot, frame_apply, length2, normalize, reflect, where3

PI = float(jnp.pi)


def sphere_uniform_sample(u_z: jnp.ndarray, u_phi: jnp.ndarray) -> jnp.ndarray:
    """sphere_uniform_dist::sample (src/raytracer.h:94-105)."""
    z = u_z * 2.0 - 1.0
    co_z = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = 2.0 * PI * u_phi
    return jnp.stack([co_z * jnp.cos(phi), co_z * jnp.sin(phi), z], axis=-1)


def cosine_sample(
    normal: jnp.ndarray, u_z: jnp.ndarray, u_phi: jnp.ndarray
) -> jnp.ndarray:
    """cosine_dist::sample (src/raytracer.h:114-121): norm(n + uniform_sphere)."""
    return normalize(normal + sphere_uniform_sample(u_z, u_phi))


def cosine_pdf(normal: jnp.ndarray, direction: jnp.ndarray) -> jnp.ndarray:
    """cosine_dist::pdf (src/raytracer.h:123-128)."""
    return jnp.maximum(dot(normal, direction) / PI, 0.0)


def halfway(in_dir: jnp.ndarray, out_dir: jnp.ndarray) -> jnp.ndarray:
    """halfway (src/raytracer.h:131-134): norm(out - in)."""
    return normalize(out_dir - in_dir)


def choose_local_x(n: jnp.ndarray) -> jnp.ndarray:
    """VNDF_dist::choose_local_x (src/raytracer.h:208-219): start from (1,1,1)
    and cancel the dominant component's projection."""
    ones = jnp.ones_like(n)
    s = jnp.sum(n, axis=-1)  # dot((1,1,1), n)
    use_x = jnp.abs(n[..., 0]) > 0.5
    use_y = (~use_x) & (jnp.abs(n[..., 1]) > 0.5)
    use_z = ~(use_x | use_y)
    # The divide runs on 1-D [R] operands rather than [R, 1] columns.
    denom = jnp.where(use_x, n[..., 0], jnp.where(use_y, n[..., 1], n[..., 2]))
    corr = (s / denom)[..., None]
    axis = (
        use_x[..., None] * jnp.array([1.0, 0, 0])
        + use_y[..., None] * jnp.array([0, 1.0, 0])
        + use_z[..., None] * jnp.array([0, 0, 1.0])
    )
    return normalize(ones - corr * axis)


def vndf_sample(
    roughness: jnp.ndarray,  # [R] alpha = clamped_roughness^2
    in_dir: jnp.ndarray,  # [R, 3] (points toward the surface)
    normal: jnp.ndarray,  # [R, 3] shading normal
    u1: jnp.ndarray,
    u2: jnp.ndarray,
) -> jnp.ndarray:
    """VNDF_dist::sample (src/raytracer.h:140-173) — Heitz GGX visible-normal
    sampling in the (nx, ny, normal) local frame, then a mirror reflect."""
    al = roughness[..., None]
    nx = choose_local_x(normal)
    ny = cross(normal, nx)
    v = -normalize(
        jnp.stack([dot(nx, in_dir), dot(ny, in_dir), dot(normal, in_dir)], axis=-1)
    )
    vh = normalize(jnp.concatenate([al, al, jnp.ones_like(al)], axis=-1) * v)
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    t1_raw = jnp.stack([-vh[..., 1], vh[..., 0], jnp.zeros_like(lensq)], axis=-1)
    t1 = jnp.where(
        (lensq > 0)[..., None],
        t1_raw / jnp.sqrt(jnp.maximum(lensq, 1e-38))[..., None],
        jnp.array([1.0, 0.0, 0.0]),
    )
    t2 = cross(vh, t1)
    r = jnp.sqrt(u1)
    phi = 2.0 * PI * u2
    c1 = r * jnp.cos(phi)
    c2 = r * jnp.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    c2 = (1.0 - s) * jnp.sqrt(jnp.maximum(0.0, 1.0 - c1 * c1)) + s * c2
    ch = jnp.sqrt(jnp.maximum(0.0, 1.0 - c1 * c1 - c2 * c2))
    nh = c1[..., None] * t1 + c2[..., None] * t2 + ch[..., None] * vh
    ne = normalize(
        jnp.stack(
            [
                roughness * nh[..., 0],
                roughness * nh[..., 1],
                jnp.maximum(0.0, nh[..., 2]),
            ],
            axis=-1,
        )
    )
    res_n = normalize(frame_apply(ne, nx, ny, normal))
    return reflect(res_n, in_dir)


def vndf_pdf(
    roughness: jnp.ndarray,  # [R] alpha
    in_dir: jnp.ndarray,
    normal: jnp.ndarray,
    direction: jnp.ndarray,
    eps: float,
) -> jnp.ndarray:
    """VNDF_dist::pdf (src/raytracer.h:175-206)."""
    nx = choose_local_x(normal)
    ny = cross(normal, nx)
    v = -jnp.stack(
        [dot(nx, in_dir), dot(ny, in_dir), dot(normal, in_dir)], axis=-1
    )
    nv = halfway(in_dir, direction)
    n = jnp.stack([dot(nx, nv), dot(ny, nv), dot(normal, nv)], axis=-1)
    vdn = dot(v, n)
    lam = (
        -1.0
        + jnp.sqrt(
            1.0 + (v[..., 0] ** 2 + v[..., 1] ** 2) * roughness**2 / v[..., 2] ** 2
        )
    ) / 2.0
    g1 = 1.0 / (1.0 + lam)
    # length2 of the alpha-scaled half vector, without materialising the
    # stacked [R, 3] intermediate: the folded 1-D form is one divide.
    # Same math as |(n.x/a, n.y/a, n.z)|^2 (src/raytracer.h:196-199) to ulp.
    len_ns = (n[..., 0] ** 2 + n[..., 1] ** 2) / (roughness * roughness) + (
        n[..., 2] ** 2
    )
    # One divide per quantity instead of 3 + 1 + 2 chained divides.  Same
    # values to fp ulp.
    dn = 1.0 / (PI * roughness * roughness * len_ns * len_ns)
    dv = g1 * vdn * dn / jnp.maximum(eps, v[..., 2])
    res = dv / (4.0 * vdn)
    return jnp.where(vdn <= 0, 0.0, res)


def light_triangle_sample(
    x: jnp.ndarray,  # [R, 3] shading point
    tri_a: jnp.ndarray,  # [R, 3] selected light triangle vertices
    tri_b: jnp.ndarray,
    tri_c: jnp.ndarray,
    u: jnp.ndarray,
    v: jnp.ndarray,
) -> jnp.ndarray:
    """triangle_dist::sample (src/raytracer.h:225-239): uniform point on the
    triangle (square fold) then direction from x."""
    flip = (u + v) > 1.0
    uu = jnp.where(flip, 1.0 - u, u)
    vv = jnp.where(flip, 1.0 - v, v)
    # p = a + (b - a) * v + (c - a) * u (src/raytracer.h:237: v()*v + u()*u)
    p = tri_a + (tri_b - tri_a) * vv[..., None] + (tri_c - tri_a) * uu[..., None]
    return normalize(p - x)


def pick_uniform(u: jnp.ndarray, count: jnp.ndarray) -> jnp.ndarray:
    """Uniform integer in [0, count) from a U[0,1) draw (the reference's
    uniform_int_distribution analog, src/raytracer.h:358,386)."""
    idx = jnp.floor(u * count.astype(u.dtype)).astype(jnp.int32)
    return jnp.clip(idx, 0, jnp.maximum(count - 1, 0))

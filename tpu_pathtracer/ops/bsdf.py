"""glTF metallic-roughness BSDF (batched port of src/raytracer.h:264-343).

Pure math over ``[R, ...]`` batches; evaluated on the full wavefront each
bounce.  Roughness is clamped to MIN_ROUGHNESS and *squared* before use, as in
the reference (``pow2(std::max(roughness, MIN_ROUGHNESS))``,
src/raytracer.h:314,325,564) — the ``alpha`` argument below is that squared
value, and ``specular_brdf`` squares it again internally exactly like the
reference's ``pow2(alpha)`` (src/raytracer.h:277-279).
"""

from __future__ import annotations

import jax.numpy as jnp

from .sampling import halfway
from .vecmath import dot

PI = float(jnp.pi)


def heaviside(x: jnp.ndarray) -> jnp.ndarray:
    """heaviside (src/raytracer.h:264-266): strictly positive -> 1."""
    return jnp.where(x > 0, 1.0, 0.0)


def specular_brdf(
    alpha: jnp.ndarray,  # [R] (= clamped_roughness^2)
    in_dir: jnp.ndarray,  # [R, 3]
    out_dir: jnp.ndarray,  # [R, 3]
    normal: jnp.ndarray,  # [R, 3] shading normal
) -> jnp.ndarray:  # [R] scalar (grey)
    """specular_brdf (src/raytracer.h:273-293): GGX NDF x Smith visibility."""
    h = halfway(in_dir, out_dir)
    ndh = dot(normal, h)
    a2 = alpha * alpha
    # One divide per term instead of the chained /PI/.../div1/div2.
    d = a2 * heaviside(ndh) / (PI * (ndh * ndh * (a2 - 1.0) + 1.0) ** 2)
    ndo = dot(normal, out_dir)
    ndi = dot(normal, -in_dir)
    div1 = jnp.abs(ndo) + jnp.sqrt(a2 + (1.0 - a2) * ndo * ndo)
    div2 = jnp.abs(ndi) + jnp.sqrt(a2 + (1.0 - a2) * ndi * ndi)
    v = heaviside(dot(h, out_dir)) * heaviside(dot(h, -in_dir)) / (div1 * div2)
    return v * d


def diffuse_brdf(color: jnp.ndarray) -> jnp.ndarray:
    """diffuse_brdf (src/raytracer.h:295-298): Lambert / pi."""
    return color / PI


def conductor_fresnel(
    f0: jnp.ndarray, bsdf: jnp.ndarray, vdh: jnp.ndarray
) -> jnp.ndarray:
    """conductor_fresnel (src/raytracer.h:267-271)."""
    return bsdf * (f0 + (1.0 - f0) * (1.0 - jnp.abs(vdh)) ** 5)


def fresnel_mix(
    ior: jnp.ndarray, base: jnp.ndarray, layer: jnp.ndarray, vdh: jnp.ndarray
) -> jnp.ndarray:
    """fresnel_mix (src/raytracer.h:300-306)."""
    f0 = ((1.0 - ior) / (1.0 + ior)) ** 2
    fr = f0 + (1.0 - f0) * (1.0 - jnp.abs(vdh)) ** 5
    return base * (1.0 - fr[..., None]) + layer * fr[..., None]


def pbr_brdf(
    in_dir: jnp.ndarray,  # [R, 3]
    out_dir: jnp.ndarray,  # [R, 3]
    shading_normal: jnp.ndarray,  # [R, 3]
    base_color: jnp.ndarray,  # [R, 3] (texture-sampled rgb)
    metallic: jnp.ndarray,  # [R]
    roughness: jnp.ndarray,  # [R] raw (clamping applied here)
    ior: jnp.ndarray,  # [R]
    min_roughness: float,
) -> jnp.ndarray:  # [R, 3]
    """pbr_brdf (src/raytracer.h:330-343): metallic lerp of dielectric_brdf
    and metallic_brdf (src/raytracer.h:308-328).

    The reference's ``metallic < 1`` / ``metallic > 0`` branch guards are kept
    as selects (not just lerp weights): they are observable whenever the
    unused branch evaluates to NaN/inf, where ``0 * NaN`` would differ.
    """
    alpha = jnp.maximum(roughness, min_roughness) ** 2
    spec = specular_brdf(alpha, in_dir, out_dir, shading_normal)[..., None]
    spec3 = jnp.broadcast_to(spec, base_color.shape)
    vdh = dot(-in_dir, halfway(in_dir, out_dir))
    dielectric = fresnel_mix(ior, diffuse_brdf(base_color), spec3, vdh)
    metal = conductor_fresnel(base_color, spec3, vdh[..., None])
    m = metallic[..., None]
    res = jnp.where(m < 1.0, (1.0 - m) * dielectric, 0.0)
    res = res + jnp.where(m > 0.0, m * metal, 0.0)
    return res

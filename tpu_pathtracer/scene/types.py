"""Device-resident scene representation (SoA pytrees).

The reference keeps an AoS ``std::vector<geometry::Object>`` where each Object
carries a triangle, per-vertex attributes and a material with raw texture
pointers (``src/geometry.h:604-659``, ``src/scene.h:74-90``).  That layout is
hostile to a wavefront renderer, which wants flat, padded, dtype-uniform
arrays it can gather from with a single index.  So the loaders below emit:

* ``TriangleScene`` — one row per triangle, with *flattened* per-triangle
  material parameters (no indirection through a material table at shade time)
  plus int32 texture ids into a shared ``TextureAtlas``;
* ``LightSet`` — the emissive-triangle subset, precompacted with areas and
  face normals, replacing the reference's emissive-only BVH
  (``src/raytracer.h:444-447``) whose only uses are uniform light *selection*
  and an all-hits pdf sum — both O(L) dense ops here;
* ``PrimitiveScene`` — analytic primitives for the homebrew scene-NNN.txt
  format (SURVEY §2 C19: a capability the reference data implies but its code
  no longer has).

All arrays are padded to friendly sizes; ``valid``/count fields mask padding.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

# Texture-id conventions for the shared atlas (slot 0/1 are built-in):
TEX_WHITE = 0  # 1x1 {1,1,1,1}    — geometry::WHITE_TEXTURE (src/geometry.h:601)
TEX_NORMAL_UP = 1  # 1x1 {.5,.5,1,0} — geometry::NORMAL_UP  (src/geometry.h:602)


def _register(cls):
    data = [f.name for f in dataclasses.fields(cls) if not f.metadata.get("static")]
    meta = [f.name for f in dataclasses.fields(cls) if f.metadata.get("static")]
    return jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)


def static_field(**kw):
    return dataclasses.field(metadata={"static": True}, **kw)


@_register
@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera (src/scene.h:60-72).

    Vectors and fov are *data* fields of the scene pytree, so moving the
    camera (``Renderer.look_at``) re-uses the jitted render functions — no
    recompile.  Only ``width``/``height`` are static (they set array shapes;
    resizing necessarily re-jits).
    """

    position: jnp.ndarray  # [3] float32
    right: jnp.ndarray  # [3]
    up: jnp.ndarray  # [3]
    forward: jnp.ndarray  # [3]
    fov_x: jnp.ndarray  # [] float32
    width: int = static_field(default=0)
    height: int = static_field(default=0)

    @staticmethod
    def create(width, height, position, right, up, forward, fov_x) -> "Camera":
        a3 = lambda v: jnp.asarray(
            np.asarray(v, dtype=np.float32).reshape(3)
        )
        return Camera(
            width=int(width),
            height=int(height),
            position=a3(position),
            right=a3(right),
            up=a3(up),
            forward=a3(forward),
            fov_x=jnp.asarray(float(fov_x), dtype=jnp.float32),
        )

    @property
    def fov_y(self):
        # src/scene.h:69-71
        return jnp.arctan(jnp.tan(self.fov_x / 2) * self.height / self.width) * 2

    def with_dims(self, width: int, height: int) -> "Camera":
        return dataclasses.replace(self, width=width, height=height)


@_register
@dataclasses.dataclass(frozen=True)
class TextureAtlas:
    """All decoded textures packed into one flat texel pool.

    The reference stores each texture as its own RGBA float grid and samples
    through a pointer (``geometry::Texture``, src/geometry.h:529-599).  Here
    texture k occupies ``texels[offset[k] : offset[k] + width[k]*height[k]]``
    row-major; bilinear fetch is four dynamic gathers from ``texels``.
    """

    texels: jnp.ndarray  # [T, 4] float32, linear (gamma applied at sample time)
    offset: jnp.ndarray  # [K] int32
    width: jnp.ndarray  # [K] int32
    height: jnp.ndarray  # [K] int32
    # Optional corner-quad pool: row i = the four bilinear corners
    # [c00 | c01 | c10 | c11] of texel i (neighbors wrapped with mod_inc at
    # BUILD time, src/geometry.h:521-523).  One 16-float row gather then
    # replaces four 4-float gathers per (ray, texture); values are the same
    # texels, so sampling is bit-equal.  None when the atlas exceeds
    # IntersectTuning.quad_max texels.
    quad: Optional[jnp.ndarray] = None  # [T, 16] float32

    @staticmethod
    def builtin() -> "TextureAtlas":
        texels = np.array([[1, 1, 1, 1], [0.5, 0.5, 1, 0]], dtype=np.float32)
        return TextureAtlas(
            texels=jnp.asarray(texels),
            offset=jnp.asarray([0, 1], dtype=jnp.int32),
            width=jnp.asarray([1, 1], dtype=jnp.int32),
            height=jnp.asarray([1, 1], dtype=jnp.int32),
        )


def quad_pool(images, quad_max: int = 0) -> Optional[jnp.ndarray]:
    """Corner-quad pool for a list of [h, w, 4] images (see
    ``TextureAtlas.quad``).  Corner order matches ``ops/texture.sample_many``
    (c00, c01, c10, c11 — py1/px1 increments wrap, mod_inc).  Built only
    when the atlas holds at most ``quad_max`` = config.tuning.quad_max
    texels (64 B/texel; 0 = off)."""
    total = sum(img.shape[0] * img.shape[1] for img in images)
    if total > quad_max:
        return None
    rows = []
    for img in images:
        img = np.asarray(img, dtype=np.float32)
        c01 = np.roll(img, -1, axis=0)  # (px, py1)
        c10 = np.roll(img, -1, axis=1)  # (px1, py)
        c11 = np.roll(c01, -1, axis=1)  # (px1, py1)
        rows.append(
            np.concatenate([img, c01, c10, c11], axis=-1).reshape(-1, 16)
        )
    return jnp.asarray(np.concatenate(rows, axis=0))


@_register
@dataclasses.dataclass(frozen=True)
class LightSet:
    """Compacted emissive triangles for NEE-style mixture sampling.

    Mirrors what the reference's light BVH is *for*: uniform selection over
    emissive triangles (``bvh_mix_dist::sample``, src/raytracer.h:353-361) and
    the pdf that sums projection terms over every light intersected along a
    ray (``bvh_mix_dist::pdf``, src/raytracer.h:363-376).  ``count`` is the
    true number of lights; rows past it are degenerate and masked.
    """

    verts: jnp.ndarray  # [L, 3, 3] float32
    normal: jnp.ndarray  # [L, 3] unit face normal (norm(cross(b-a, c-a)))
    area: jnp.ndarray  # [L]
    count: jnp.ndarray  # [] int32

    # Spatially-clustered copy for the Woop-form all-hits pdf
    # (ops/intersect.light_pdf_sum_flat).  128 lights per cluster, same
    # block layout as the geometry chunks; internal order is independent of
    # `verts` so light *selection* (and thus the sampled estimator stream)
    # is unchanged.
    # None when the loader skipped the build (hand-built LightSets in tests).
    cluster_woop: Optional[jnp.ndarray] = None  # [C, 12, 128]
    cluster_k: Optional[jnp.ndarray] = None  # [C, 128] = 1/(2*area^2), 0 pad

    @property
    def capacity(self) -> int:
        return self.verts.shape[0]

    @property
    def has_clusters(self) -> bool:
        return self.cluster_woop is not None


@_register
@dataclasses.dataclass(frozen=True)
class TriangleScene:
    """Flat triangle soup + per-triangle materials + camera + background."""

    # Geometry
    verts: jnp.ndarray  # [N, 3, 3] float32 (vertex a/b/c)
    normals: jnp.ndarray  # [N, 3, 3] per-vertex shading normals
    uvs: jnp.ndarray  # [N, 3, 2] texcoords
    tangents: jnp.ndarray  # [N, 3, 3]
    valid: jnp.ndarray  # [N] bool (False on padding rows)

    # Woop-style world->barycentric affine transforms, precomputed at pack
    # time: row k of triangle i maps homogeneous ray origin/direction to
    # (beta, gamma, n)-space, turning brute-force ray x triangle intersection
    # into one [2R, 4] @ [4, 3N] matmul (see ops/intersect.py).  Rows of
    # degenerate/padding triangles are NaN so they can never win a hit.
    woop: jnp.ndarray  # [4, 3N] float32, columns grouped 3-per-triangle

    # Morton-leaf acceleration structure (scene/accel.py, ops/traverse.py):
    # triangles are Morton-sorted at pack time; every LEAF_SIZE consecutive
    # triangles form a leaf with an AABB and a re-laid-out Woop block.
    leaf_aabb_min: jnp.ndarray  # [L, 3] float32 (inf on empty leaves)
    leaf_aabb_max: jnp.ndarray  # [L, 3]
    leaf_woop: jnp.ndarray  # [L, 12, LEAF_SIZE] float32

    # Chunk granularity (IntersectTuning.chunk_tris triangles per block):
    # the bounds feed the "cell" sort key, the block count and width the
    # "hint" key.
    chunk_aabb_min: jnp.ndarray  # [C, 3]
    chunk_aabb_max: jnp.ndarray  # [C, 3]
    chunk_woop: jnp.ndarray  # [C, 12, 128]

    # All shade-stage per-triangle attributes packed into one row so a hit
    # costs ONE gather instead of ~10.
    # Layout (float32): verts[9] normals[9] uvs[6] tangents[9] color[4]
    # emission[3] metallic roughness ior color_tex emissive_tex mr_tex
    # normal_tex | pad -> 48 columns.
    shade_attrs: jnp.ndarray  # [N, 48]

    # Per-triangle material (flattened from the glTF material table)
    color: jnp.ndarray  # [N, 4] baseColorFactor RGBA
    emission: jnp.ndarray  # [N, 3] emissiveFactor * emissiveStrength
    metallic: jnp.ndarray  # [N]
    roughness: jnp.ndarray  # [N]
    ior: jnp.ndarray  # [N]
    color_tex: jnp.ndarray  # [N] int32 atlas ids
    emissive_tex: jnp.ndarray  # [N] int32
    mr_tex: jnp.ndarray  # [N] int32
    normal_tex: jnp.ndarray  # [N] int32

    atlas: TextureAtlas
    lights: LightSet

    # Background: bg_color scales the equirect env texture (src/scene.h:83-89).
    bg_color: jnp.ndarray  # [3]
    env_tex: jnp.ndarray  # [] int32 atlas id (TEX_WHITE when no env map)

    camera: Camera = None  # pytree child: camera moves don't re-jit
    ray_depth: int = static_field(default=8)
    samples: int = static_field(default=1)
    # Static "an env map was loaded" bit: without it, textured scenes would
    # pay the equirect bilinear gather every bounce just to sample the 1x1
    # white default (bg_at with WHITE_TEXTURE, src/scene.h:83-89).
    has_env: bool = static_field(default=False)
    # Static per-slot "any material maps this slot to a real texture" bits,
    # order (color, emissive, mr, normal).  A slot that is builtin-only
    # (WHITE/NORMAL_UP on every triangle) is dropped from the shade-stage
    # corner fetch entirely — same identity argument as the all-builtin
    # fast path (src/geometry.h:601-602), applied per texture slot.
    tex_slots: tuple = static_field(default=(True, True, True, True))

    @property
    def capacity(self) -> int:
        return self.verts.shape[0]


# --- Homebrew (scene-NNN.txt) world -------------------------------------

PRIM_PLANE = 0
PRIM_ELLIPSOID = 1
PRIM_BOX = 2
PRIM_TRIANGLE = 3

MAT_DIFFUSE = 0
MAT_METALLIC = 1
MAT_DIELECTRIC = 2


@_register
@dataclasses.dataclass(frozen=True)
class PrimitiveScene:
    """Analytic-primitive world for the legacy homebrew format (SURVEY C19).

    Primitives live in local space: a primitive with rotation quaternion q and
    position p is intersected by transforming the ray into local coordinates
    (conjugate rotation), exactly how the course's earlier homework stages
    defined PLANE/ELLIPSOID/BOX/TRIANGLE.
    """

    kind: jnp.ndarray  # [P] int32 in {PRIM_*}
    param: jnp.ndarray  # [P, 9]: plane normal / radii / half-sizes / 3 verts
    position: jnp.ndarray  # [P, 3]
    rotation: jnp.ndarray  # [P, 4] quaternion (x, y, z, w)
    color: jnp.ndarray  # [P, 3]
    emission: jnp.ndarray  # [P, 3]
    mat_kind: jnp.ndarray  # [P] int32 in {MAT_*}
    ior: jnp.ndarray  # [P]
    valid: jnp.ndarray  # [P] bool

    # Whitted-mode lights
    ambient: jnp.ndarray  # [3]
    dir_light_dir: jnp.ndarray  # [Ld, 3] (normalized at parse)
    dir_light_intensity: jnp.ndarray  # [Ld, 3]
    dir_light_valid: jnp.ndarray  # [Ld] bool
    point_light_pos: jnp.ndarray  # [Lp, 3]
    point_light_intensity: jnp.ndarray  # [Lp, 3]
    point_light_atten: jnp.ndarray  # [Lp, 3] (c0, c1, c2)
    point_light_valid: jnp.ndarray  # [Lp] bool

    bg_color: jnp.ndarray  # [3]

    camera: Camera = None  # pytree child: camera moves don't re-jit
    ray_depth: int = static_field(default=1)
    samples: Optional[int] = static_field(default=None)  # None => Whitted mode
    # True when the scene defines any light (ambient/directional/point).
    # Lightless non-MC scenes are stage-1 homework: flat primitive colors.
    lit: bool = static_field(default=True)

    @property
    def capacity(self) -> int:
        return self.kind.shape[0]

    @property
    def monte_carlo(self) -> bool:
        """SAMPLES present => path-traced (practice5+); else Whitted (hw2/3)."""
        return self.samples is not None


def pad_to(n: int, multiple: int = 8, minimum: int = 8) -> int:
    """Round a count up to a lane-friendly padded capacity."""
    return max(minimum, ((n + multiple - 1) // multiple) * multiple)

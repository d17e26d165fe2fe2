"""glTF 2.0 (restricted subset) scene loader.

Re-implements the behavior of ``parse_gltf_scene`` (src/scene.h:183-501) as a
host-side numpy pipeline that emits the SoA ``TriangleScene``.  The supported
subset — and its quirks, which are observable in rendered output and therefore
preserved deliberately — is:

* external ``.bin`` buffers + image file textures (decoded by the in-repo
  PNG/HDR codecs, JPEG via Pillow, instead of stb_image; all produce
  u8/255 RGBA, src/geometry.h:584-598);
* recursive node walk with ``parent * node.matrix * T·R·S`` transform
  accumulation (src/scene.h:224-230); normals via the adjugate
  inverse-transpose (src/scene.h:231-232);
* one perspective camera: fov_x derived from yfov and aspect
  (src/scene.h:234-255);
* mesh primitive modes 4 (TRIANGLES) and 5 (TRIANGLE_STRIP)
  (src/scene.h:444-458); index component types u8/u16/u32
  (src/scene.h:163-180);
* pbrMetallicRoughness + emissive factor/textures +
  ``KHR_materials_emissive_strength`` (src/scene.h:260-316);
* QUIRKS kept for parity: vertex-attribute accessors ignore the *accessor*
  byteOffset (only the bufferView one is honored — src/scene.h:127-130),
  accessors are assumed tightly packed (byteStride ignored), tangents are
  looked up at lowercase ``/attributes/tangent`` which never matches real
  glTF's ``TANGENT`` so tangents are effectively always (1,0,0)
  (src/scene.h:336,404-407), and a baseColorFactor alpha < 1 resets ior to
  1.5 (src/scene.h:285-287).
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional

import jax.numpy as jnp
import numpy as np

from ..config import RenderConfig, DEFAULT_CONFIG
from ..ops.vecmath import np_normal_transform, np_trs_matrix
from . import types as T

_COMPONENT_DTYPES = {5121: np.uint8, 5123: np.uint16, 5125: np.uint32}


def _decode_image_bytes(data: bytes) -> np.ndarray:
    """Decode image file bytes to [H, W, 4] float32 in [0, 1].

    Radiance HDR and PNG go through the in-repo codecs (utils/hdr.py,
    utils/png.py); anything else (JPEG) through Pillow, imported only then.
    All mirror stb_image's 8-bit path (src/geometry.h:584-598): u8
    quantized, /255."""
    if data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE"):
        from ..utils.hdr import decode_hdr_rgba_ldr

        return decode_hdr_rgba_ldr(data)
    if data.startswith(b"\x89PNG"):
        from ..utils.png import decode_png_rgba

        return decode_png_rgba(data).astype(np.float32) / 255.0
    try:
        from PIL import Image
    except ImportError as err:
        raise RuntimeError(
            "decoding this texture (not PNG or Radiance HDR, e.g. JPEG) "
            "needs Pillow: pip install 'tpu-pathtracer[jpeg]'"
        ) from err
    import io

    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGBA"), dtype=np.float32) / 255.0


def _load_image_rgba(path: str) -> np.ndarray:
    """Decode an image file to [H, W, 4] float32 in [0, 1]."""
    with open(path, "rb") as f:
        return _decode_image_bytes(f.read())


def _read_glb(path: str):
    """Parse a .glb binary container -> (gltf json dict, BIN chunk or None).

    The reference has no GLB support (parse_gltf_scene reads JSON text,
    src/scene.h:187) — this is an extension so the advertised .glb routing
    is honest."""
    import struct

    with open(path, "rb") as f:
        data = f.read()
    magic, version, _length = struct.unpack_from("<4sII", data, 0)
    if magic != b"glTF":
        raise ValueError(f"{path}: not a GLB container")
    if version != 2:
        raise ValueError(f"{path}: unsupported GLB version {version}")
    pos = 12
    root = None
    bin_chunk = None
    while pos + 8 <= len(data):
        clen, ctype = struct.unpack_from("<II", data, pos)
        pos += 8
        chunk = data[pos : pos + clen]
        pos += clen
        if ctype == 0x4E4F534A:  # 'JSON'
            root = json.loads(chunk.decode("utf-8"))
        elif ctype == 0x004E4942:  # 'BIN\0'
            bin_chunk = chunk
    if root is None:
        raise ValueError(f"{path}: GLB has no JSON chunk")
    return root, bin_chunk


class _AtlasBuilder:
    def __init__(self) -> None:
        self.images: List[np.ndarray] = [
            np.array([[[1, 1, 1, 1]]], dtype=np.float32),  # TEX_WHITE
            np.array([[[0.5, 0.5, 1, 0]]], dtype=np.float32),  # TEX_NORMAL_UP
        ]

    def add(self, img: np.ndarray) -> int:
        self.images.append(np.asarray(img, dtype=np.float32))
        return len(self.images) - 1

    def build(self, quad_max: int = 0) -> T.TextureAtlas:
        offsets, widths, heights, chunks = [], [], [], []
        off = 0
        for img in self.images:
            h, w, _ = img.shape
            offsets.append(off)
            widths.append(w)
            heights.append(h)
            chunks.append(img.reshape(-1, 4))
            off += w * h
        return T.TextureAtlas(
            texels=jnp.asarray(np.concatenate(chunks, axis=0)),
            offset=jnp.asarray(offsets, dtype=jnp.int32),
            width=jnp.asarray(widths, dtype=jnp.int32),
            height=jnp.asarray(heights, dtype=jnp.int32),
            quad=T.quad_pool(self.images, quad_max),
        )


def _vec_accessor(root: dict, buffers: List[bytes], accessor_idx: int, comps: int) -> np.ndarray:
    """interpret_accessor<T> (src/scene.h:118-133): bufferView byteOffset only,
    tightly-packed float32."""
    accessor = root["accessors"][accessor_idx]
    view = root["bufferViews"][accessor["bufferView"]]
    buf = buffers[view["buffer"]]
    offset = view.get("byteOffset", 0)
    count = accessor["count"]
    out = np.frombuffer(buf, dtype="<f4", count=count * comps, offset=offset)
    return out.reshape(count, comps)


def _load_indices(root: dict, buffers: List[bytes], accessor_idx: Optional[int]) -> Optional[np.ndarray]:
    """load_indices (src/scene.h:138-181): honors accessor + view byteOffset."""
    if accessor_idx is None:
        return None
    accessor = root["accessors"][accessor_idx]
    view = root["bufferViews"][accessor["bufferView"]]
    buf = buffers[view["buffer"]]
    offset = view.get("byteOffset", 0) + accessor.get("byteOffset", 0)
    count = accessor["count"]
    ctype = accessor["componentType"]
    if ctype not in _COMPONENT_DTYPES:
        raise RuntimeError("illegal scalar type")
    dt = _COMPONENT_DTYPES[ctype]
    return np.frombuffer(buf, dtype=dt, count=count, offset=offset).astype(np.int64)


class _SceneAccum:
    """Mutable triangle-soup accumulator filled during the node walk."""

    def __init__(self) -> None:
        self.verts: List[np.ndarray] = []
        self.normals: List[np.ndarray] = []
        self.uvs: List[np.ndarray] = []
        self.tangents: List[np.ndarray] = []
        self.mat_rows: List[np.ndarray] = []  # [n, 13] packed scalars
        self.camera: Optional[T.Camera] = None

    def n_tris(self) -> int:
        return sum(v.shape[0] for v in self.verts)


def _material_row(mat: Dict) -> np.ndarray:
    """Pack one material into [color4, emission3, metallic, roughness, ior,
    color_tex, emissive_tex, mr_tex, normal_tex] (floats; tex ids are ints)."""
    return np.array(
        [
            *mat["color"],
            *mat["emission"],
            mat["metallic"],
            mat["roughness"],
            mat["ior"],
            mat["color_tex"],
            mat["emissive_tex"],
            mat["mr_tex"],
            mat["normal_tex"],
        ],
        dtype=np.float64,
    )


def _parse_material(root: dict, material_idx: int, tex_base: int) -> Dict:
    """Material extraction (src/scene.h:260-316).  ``tex_base`` maps glTF
    texture index i -> atlas id tex_base + i."""
    material = root["materials"][material_idx]
    mat = dict(
        color=np.array([1, 1, 1, 1], dtype=np.float64),
        emission=np.zeros(3, dtype=np.float64),
        metallic=1.0,
        roughness=1.0,
        ior=1.5,
        color_tex=T.TEX_WHITE,
        emissive_tex=T.TEX_WHITE,
        mr_tex=T.TEX_WHITE,
        normal_tex=T.TEX_NORMAL_UP,
    )
    if "emissiveFactor" in material:
        mat["emission"] = np.asarray(material["emissiveFactor"], dtype=np.float64)
    strength = material.get("extensions", {}).get(
        "KHR_materials_emissive_strength", {}
    ).get("emissiveStrength")
    if strength is not None:
        mat["emission"] = mat["emission"] * float(strength)
    if "emissiveTexture" in material:
        mat["emissive_tex"] = tex_base + material["emissiveTexture"]["index"]
    pbr = material.get("pbrMetallicRoughness")
    if pbr is not None:
        if "baseColorFactor" in pbr:
            color = pbr["baseColorFactor"]
            if color[3] < 1:
                mat["ior"] = 1.5  # src/scene.h:285-287 (kept verbatim)
            mat["color"] = np.asarray(color, dtype=np.float64)
        if "baseColorTexture" in pbr:
            mat["color_tex"] = tex_base + pbr["baseColorTexture"]["index"]
        if "metallicRoughnessTexture" in pbr:
            mat["mr_tex"] = tex_base + pbr["metallicRoughnessTexture"]["index"]
        mat["roughness"] = float(pbr.get("roughnessFactor", 1.0))
        mat["metallic"] = float(pbr.get("metallicFactor", 1.0))
    if "normalTexture" in material:
        mat["normal_tex"] = tex_base + material["normalTexture"]["index"]
    return mat


def _handle_node(
    root: dict,
    buffers: List[bytes],
    node_idx: int,
    parent: np.ndarray,
    acc: _SceneAccum,
    default_ar: float,
    tex_base: int,
) -> None:
    node = root["nodes"][node_idx]
    rotation = np.asarray(node.get("rotation", [0, 0, 0, 1]), dtype=np.float64)
    translation = np.asarray(node.get("translation", [0, 0, 0]), dtype=np.float64)
    scale = np.asarray(node.get("scale", [1, 1, 1]), dtype=np.float64)
    if "matrix" in node:
        m = np.asarray(node["matrix"], dtype=np.float64).reshape(4, 4).T  # column-major
    else:
        m = np.eye(4)
    transform = parent @ m @ np_trs_matrix(scale, rotation, translation)
    normal_transform = np_normal_transform(transform)

    if "camera" in node:
        cam = root["cameras"][node["camera"]]
        persp = cam["perspective"]
        fov_y = float(persp["yfov"])
        aspect = float(persp.get("aspectRatio", default_ar))
        def ax(v):
            w = transform @ np.asarray(v, dtype=np.float64)
            d = w[:3]
            return d / np.linalg.norm(d)
        acc.camera = T.Camera.create(
            width=0,
            height=0,
            position=(transform @ np.array([0, 0, 0, 1.0]))[:3],
            forward=ax([0, 0, -1, 0]),
            up=ax([0, 1, 0, 0]),
            right=ax([1, 0, 0, 0]),
            fov_x=math.atan(math.tan(fov_y / 2) * aspect) * 2,
        )

    if "mesh" in node:
        mesh = root["meshes"][node["mesh"]]
        for primitive in mesh["primitives"]:
            mat = _parse_material(root, primitive["material"], tex_base)
            attrs = primitive["attributes"]
            coords = _vec_accessor(root, buffers, attrs["POSITION"], 3)
            normals = (
                _vec_accessor(root, buffers, attrs["NORMAL"], 3)
                if "NORMAL" in attrs
                else None
            )
            # Lowercase lookup on purpose: real glTF uses TANGENT, so this
            # never matches and tangents default to (1,0,0) — reference quirk
            # (src/scene.h:336,404-407).
            tangents = (
                _vec_accessor(root, buffers, attrs["tangent"], 3)
                if "tangent" in attrs
                else None
            )
            texcoords = (
                _vec_accessor(root, buffers, attrs["TEXCOORD_0"], 2)
                if "TEXCOORD_0" in attrs
                else None
            )
            indices = _load_indices(root, buffers, primitive.get("indices"))
            cnt = coords.shape[0] if indices is None else indices.shape[0]
            mode = primitive.get("mode", 4)

            if mode == 4:
                tri_idx = np.arange(cnt - cnt % 3).reshape(-1, 3)
            elif mode == 5:
                i = np.arange(2, cnt)
                off = i & 1
                tri_idx = np.stack([i - 2, i - 1 + off, i - off], axis=-1)
            else:
                continue  # silently skipped, like the reference switch
            if indices is not None:
                tri_idx = indices[tri_idx]
            if tri_idx.size == 0:
                continue

            # Transform positions (affine) in f64, then narrow.
            pos_h = np.concatenate(
                [coords.astype(np.float64), np.ones((coords.shape[0], 1))], axis=1
            )
            world = (pos_h @ transform.T)[:, :3]
            v = world[tri_idx].astype(np.float32)  # [n, 3, 3]

            if normals is not None:
                wn = normals.astype(np.float64) @ normal_transform.T
                wn /= np.linalg.norm(wn, axis=-1, keepdims=True)
                n = wn[tri_idx].astype(np.float32)
            else:
                # Missing normals -> face normal on all 3 verts
                # (src/scene.h:427-430).
                e1 = v[:, 1] - v[:, 0]
                e2 = v[:, 2] - v[:, 0]
                fn = np.cross(e1, e2)
                fn /= np.linalg.norm(fn, axis=-1, keepdims=True)
                n = np.repeat(fn[:, None, :], 3, axis=1)

            uv = (
                texcoords[tri_idx].astype(np.float32)
                if texcoords is not None
                else np.zeros((tri_idx.shape[0], 3, 2), dtype=np.float32)
            )
            tang = (
                tangents[tri_idx].astype(np.float32)
                if tangents is not None
                else np.tile(
                    np.array([1, 0, 0], dtype=np.float32), (tri_idx.shape[0], 3, 1)
                )
            )

            acc.verts.append(v)
            acc.normals.append(n)
            acc.uvs.append(uv)
            acc.tangents.append(tang)
            acc.mat_rows.append(
                np.tile(_material_row(mat), (tri_idx.shape[0], 1))
            )

    for child in node.get("children", []):
        _handle_node(root, buffers, child, transform, acc, default_ar, tex_base)


def parse_gltf_scene(
    path: str,
    aspect_ratio: float,
    config: RenderConfig = DEFAULT_CONFIG,
) -> T.TriangleScene:
    """Load a glTF file into a device-ready ``TriangleScene``.

    Follows parse_gltf_scene (src/scene.h:183-501); the environment map /
    background behavior of the CLI (src/main.cpp:28-31) is applied here from
    ``config`` so every caller sees the same scene the binary rendered.
    """
    glb_bin = None
    if path.endswith(".glb"):
        root, glb_bin = _read_glb(path)
    else:
        with open(path, "r") as f:
            root = json.load(f)
    base = os.path.dirname(path)

    buffers: List[bytes] = []
    for buf_info in root.get("buffers", []):
        if "uri" not in buf_info:
            if glb_bin is None:
                raise ValueError(f"{path}: buffer without uri outside GLB")
            data = glb_bin
        else:
            with open(os.path.join(base, buf_info["uri"]), "rb") as f:
                data = f.read()
        buffers.append(data[: buf_info["byteLength"]])

    atlas = _AtlasBuilder()
    tex_base = len(atlas.images)
    for tex_info in root.get("textures", []):
        img_info = root["images"][tex_info["source"]]
        if "uri" in img_info:
            atlas.add(_load_image_rgba(os.path.join(base, img_info["uri"])))
        else:  # GLB: image stored in a bufferView
            view = root["bufferViews"][img_info["bufferView"]]
            off = view.get("byteOffset", 0)
            raw = buffers[view["buffer"]][off : off + view["byteLength"]]
            atlas.add(_decode_image_bytes(raw))

    env_tex = T.TEX_WHITE
    if config.use_env_map:
        env_tex = atlas.add(_load_image_rgba(config.env_map_path))

    scene_idx = root.get("scene", 0)
    scenes = root.get("scenes", [])
    acc = _SceneAccum()
    if scene_idx < len(scenes) and scenes[scene_idx] is not None:
        roots = scenes[scene_idx]["nodes"]
    else:
        roots = list(range(len(root.get("nodes", []))))
    for node_idx in roots:
        _handle_node(root, buffers, node_idx, np.eye(4), acc, aspect_ratio, tex_base)

    camera = acc.camera or T.Camera.create(
        width=0,
        height=0,
        position=(0, 0, 0),
        right=(1, 0, 0),
        up=(0, 1, 0),
        forward=(0, 0, -1),
        fov_x=1.5708,
    )
    acc.camera = camera

    if config.add_light_triangle:
        # Extra camera-space light triangle (src/scene.h:479-498).
        x, y, z, w = (
            np.asarray(camera.right, dtype=np.float32),
            np.asarray(camera.up, dtype=np.float32),
            np.asarray(camera.forward, dtype=np.float32),
            np.asarray(camera.position, dtype=np.float32),
        )
        rel = np.asarray(config.light_triangle_relative_pos, dtype=np.float32)
        verts = w[None, :] + rel[:, 0:1] * x + rel[:, 1:2] * y + rel[:, 2:3] * z
        e1, e2 = verts[1] - verts[0], verts[2] - verts[0]
        fn = np.cross(e1, e2)
        fn = fn / np.linalg.norm(fn)
        acc.verts.append(verts[None].astype(np.float32))
        acc.normals.append(np.tile(fn.astype(np.float32), (1, 3, 1)))
        acc.uvs.append(np.zeros((1, 3, 2), dtype=np.float32))
        acc.tangents.append(
            np.tile(np.array([1, 0, 0], dtype=np.float32), (1, 3, 1))
        )
        light_mat = dict(
            color=np.array([1, 1, 1, 1], dtype=np.float64),
            emission=np.full(3, config.light_triangle_intensity, dtype=np.float64),
            metallic=1.0,
            roughness=1.0,
            ior=1.5,
            color_tex=T.TEX_WHITE,
            emissive_tex=T.TEX_WHITE,
            mr_tex=T.TEX_WHITE,
            normal_tex=T.TEX_NORMAL_UP,
        )
        acc.mat_rows.append(_material_row(light_mat)[None])

    return _pack_triangle_scene(acc, atlas, env_tex, config)


def _pack_triangle_scene(
    acc: _SceneAccum,
    atlas: _AtlasBuilder,
    env_tex: int,
    config: RenderConfig,
) -> T.TriangleScene:
    from ..ops.intersect import build_woop, tri_capacity
    from .accel import (
        LEAF_SIZE, build_leaves, chunk_aabbs, leaf_woop, morton_order,
        sah_chunk_order,
    )

    n = acc.n_tris()
    cap = tri_capacity(n)

    def padded(chunks: List[np.ndarray], shape_tail, dtype=np.float32) -> np.ndarray:
        out = np.zeros((cap, *shape_tail), dtype=dtype)
        if chunks:
            cat = np.concatenate(chunks, axis=0)
            out[: cat.shape[0]] = cat
        return out

    verts = padded(acc.verts, (3, 3))
    # Degenerate padding triangles at a far-away point keep every kernel
    # branch-free: they can never produce a valid hit.
    verts[n:] = 1e30
    normals = padded(acc.normals, (3, 3))
    normals[n:, :, 2] = 1.0
    uvs = padded(acc.uvs, (3, 2))
    tangents = padded(acc.tangents, (3, 3))
    tangents[n:, :, 0] = 1.0
    # Material row layout (see _material_row): color4 | emission3 | metallic |
    # roughness | ior | color_tex | emissive_tex | mr_tex | normal_tex.
    mats = padded(acc.mat_rows, (14,), np.float64)
    mats[n:, 13] = T.TEX_NORMAL_UP

    valid = np.zeros(cap, dtype=bool)
    valid[:n] = True

    # Spatially sort all per-triangle data (the traversal layout — and a
    # locality win for shade-stage gathers).  Default "sah": chunk-aligned
    # sweep-SAH treelets (tighter AABBs than the flat Morton cut); "morton"
    # keeps the LBVH curve.
    tuning = config.tuning
    chunk_tris = tuning.chunk_tris
    if tuning.build == "sah":
        perm = sah_chunk_order(verts, valid, chunk_tris)
    else:
        perm = morton_order(verts, valid)
    verts = verts[perm]
    normals = normals[perm]
    uvs = uvs[perm]
    tangents = tangents[perm]
    mats = mats[perm]
    valid = valid[perm]

    emission = mats[:, 4:7].astype(np.float32)
    # Emissive predicate matches the light-BVH filter: the *factor* decides
    # (src/raytracer.h:444-447), textures don't.
    is_light = valid & np.any(emission != 0.0, axis=-1)
    light_rows = np.nonzero(is_light)[0]
    lcap = T.pad_to(len(light_rows), minimum=1)
    lverts = np.full((lcap, 3, 3), 1e30, dtype=np.float32)
    lverts[: len(light_rows)] = verts[light_rows]
    le1 = lverts[:, 1] - lverts[:, 0]
    le2 = lverts[:, 2] - lverts[:, 0]
    lcross = np.cross(le1, le2)
    larea = 0.5 * np.linalg.norm(lcross, axis=-1)
    with np.errstate(invalid="ignore", divide="ignore"):
        lnormal = lcross / np.linalg.norm(lcross, axis=-1, keepdims=True)
    lnormal = np.nan_to_num(lnormal, nan=0.0, posinf=0.0, neginf=0.0)

    from .accel import light_clusters

    _, _, cl_woop, cl_k = light_clusters(lverts, len(light_rows))
    lights = T.LightSet(
        verts=jnp.asarray(lverts),
        normal=jnp.asarray(lnormal.astype(np.float32)),
        area=jnp.asarray(larea.astype(np.float32)),
        count=jnp.asarray(len(light_rows), dtype=jnp.int32),
        cluster_woop=jnp.asarray(cl_woop),
        cluster_k=jnp.asarray(cl_k),
    )

    bg = np.full(3, config.env_map_intensity, dtype=np.float32)  # src/main.cpp:28

    woop_cols = build_woop(verts, valid)
    lmin, lmax = build_leaves(verts, valid, LEAF_SIZE)
    lw = leaf_woop(woop_cols, LEAF_SIZE)
    # Chunks: the same width the SAH build aligned its treelet cuts to; a
    # LEAF_SIZE multiple, so chunk AABBs reduce over whole leaves.
    cmin, cmax = chunk_aabbs(lmin, lmax, chunk_tris // LEAF_SIZE)
    cw = leaf_woop(woop_cols, chunk_tris)

    shade_attrs = np.zeros((cap, 48), dtype=np.float32)
    shade_attrs[:, 0:9] = verts.reshape(cap, 9)
    shade_attrs[:, 9:18] = normals.reshape(cap, 9)
    shade_attrs[:, 18:24] = uvs.reshape(cap, 6)
    shade_attrs[:, 24:33] = tangents.reshape(cap, 9)
    shade_attrs[:, 33:37] = mats[:, 0:4]  # color rgba
    shade_attrs[:, 37:40] = mats[:, 4:7]  # emission
    shade_attrs[:, 40] = mats[:, 7]  # metallic
    shade_attrs[:, 41] = mats[:, 8]  # roughness
    shade_attrs[:, 42] = mats[:, 9]  # ior
    shade_attrs[:, 43:47] = mats[:, 10:14]  # texture ids (exact in f32)

    return T.TriangleScene(
        verts=jnp.asarray(verts),
        normals=jnp.asarray(normals),
        uvs=jnp.asarray(uvs),
        tangents=jnp.asarray(tangents),
        valid=jnp.asarray(valid),
        woop=jnp.asarray(woop_cols),
        leaf_aabb_min=jnp.asarray(lmin),
        leaf_aabb_max=jnp.asarray(lmax),
        leaf_woop=jnp.asarray(lw),
        chunk_aabb_min=jnp.asarray(cmin),
        chunk_aabb_max=jnp.asarray(cmax),
        chunk_woop=jnp.asarray(cw),
        shade_attrs=jnp.asarray(shade_attrs),
        color=jnp.asarray(mats[:, 0:4].astype(np.float32)),
        emission=jnp.asarray(emission),
        metallic=jnp.asarray(mats[:, 7].astype(np.float32)),
        roughness=jnp.asarray(mats[:, 8].astype(np.float32)),
        ior=jnp.asarray(mats[:, 9].astype(np.float32)),
        color_tex=jnp.asarray(mats[:, 10].astype(np.int32)),
        emissive_tex=jnp.asarray(mats[:, 11].astype(np.int32)),
        mr_tex=jnp.asarray(mats[:, 12].astype(np.int32)),
        normal_tex=jnp.asarray(mats[:, 13].astype(np.int32)),
        atlas=atlas.build(quad_max=tuning.quad_max),
        lights=lights,
        bg_color=jnp.asarray(bg),
        env_tex=jnp.asarray(env_tex, dtype=jnp.int32),
        camera=acc.camera,
        ray_depth=config.default_ray_depth,
        samples=1,
        has_env=env_tex != T.TEX_WHITE,
        tex_slots=(
            bool((mats[:n, 10] != T.TEX_WHITE).any()),
            bool((mats[:n, 11] != T.TEX_WHITE).any()),
            bool((mats[:n, 12] != T.TEX_WHITE).any()),
            bool((mats[:n, 13] != T.TEX_NORMAL_UP).any()),
        ),
    )

"""High-level embedding API.

The reference is a single-shot binary (load scene, render once, exit —
src/main.cpp).  A framework needs a resident object: load/pack the scene
once, render many frames (different cameras, sizes, sample counts) against
the same device-resident scene arrays, with jit caches shared across frames.

    r = Renderer("scene.gltf")
    r.look_at(eye=(0, 1, 4), target=(0, 1, 0), fov_x=1.2)
    hdr = r.render(512, 512, spp=64)
    r.write("frame.ppm", hdr)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np

from .config import DEFAULT_CONFIG, RenderConfig
from .scene.types import Camera, PrimitiveScene, TriangleScene


class Renderer:
    def __init__(
        self,
        scene_path: str,
        config: RenderConfig = DEFAULT_CONFIG,
        aspect_ratio: float = 1.0,
    ) -> None:
        self.config = config
        if scene_path.endswith((".gltf", ".glb")):
            from .scene.gltf import parse_gltf_scene

            self.scene = parse_gltf_scene(scene_path, aspect_ratio, config)
        else:
            from .scene.homebrew import parse_homebrew_scene

            self.scene = parse_homebrew_scene(scene_path)

    # --- camera ------------------------------------------------------------

    @property
    def camera(self) -> Camera:
        return self.scene.camera

    def set_camera(self, camera: Camera) -> None:
        self.scene = dataclasses.replace(self.scene, camera=camera)

    def look_at(
        self,
        eye: Tuple[float, float, float],
        target: Tuple[float, float, float],
        up: Tuple[float, float, float] = (0.0, 1.0, 0.0),
        fov_x: Optional[float] = None,
    ) -> None:
        """Place the camera (right-handed, matches the reference's basis)."""
        eye_v = np.asarray(eye, dtype=np.float64)
        fwd = np.asarray(target, dtype=np.float64) - eye_v
        fwd /= np.linalg.norm(fwd)
        right = np.cross(fwd, np.asarray(up, dtype=np.float64))
        right /= np.linalg.norm(right)
        true_up = np.cross(right, fwd)
        cam = self.scene.camera
        self.set_camera(
            Camera.create(
                width=cam.width or 1,
                height=cam.height or 1,
                position=eye_v,
                right=right,
                up=true_up,
                forward=fwd,
                fov_x=fov_x if fov_x is not None else (cam.fov_x or math.pi / 2),
            )
        )

    # --- rendering -----------------------------------------------------------

    def render(
        self, width: int, height: int, spp: int, seed: int = 0
    ) -> np.ndarray:
        """Render an HDR [H, W, 3] float32 frame."""
        scene = dataclasses.replace(
            self.scene, camera=self.scene.camera.with_dims(width, height)
        )
        if isinstance(scene, PrimitiveScene):
            from .models.legacy import render_homebrew

            if scene.monte_carlo and spp:
                scene = dataclasses.replace(scene, samples=spp)
            return render_homebrew(scene, seed=seed, config=self.config)
        from .models.pathtracer import render

        return render(scene, spp=spp, seed=seed, config=self.config)

    def render_ldr(self, width: int, height: int, spp: int, seed: int = 0) -> np.ndarray:
        """Render straight to tonemapped uint8 (the reference's pipeline)."""
        from .utils.image import quantize_u8

        return np.asarray(quantize_u8(self.render(width, height, spp, seed)))

    @staticmethod
    def write(path: str, image: np.ndarray) -> None:
        """Write a PPM (or PNG by extension) from HDR or uint8 pixels."""
        from .utils.image import quantize_u8, write_ppm

        if image.dtype != np.uint8:
            import jax.numpy as jnp

            image = np.asarray(quantize_u8(jnp.asarray(image)))
        if path.lower().endswith(".png"):
            from .utils.png import write_png

            write_png(path, image)
        else:
            write_ppm(path, image)

"""Command-line entry point with the reference's exact argv contract.

``main.cpp`` (src/main.cpp:16-49) takes five positional arguments:

    raytracer <scene> <width> <height> <samples> <out.ppm>

and exits 1 with a message on stderr for too-few args or a runtime error.
This CLI keeps that contract bit-for-bit (so ``run.sh``/``run-test.sh``-style
harnesses work unchanged) and extends the scene front-end: ``.gltf`` goes to
the glTF loader like the reference, anything else to the homebrew
``scene-NNN.txt`` parser — the format the reference ships data for but can no
longer parse (SURVEY §2 C19).
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import List, Optional

from .config import DEFAULT_CONFIG, RenderConfig


def _strtol(s: str) -> int:
    """std::strtol semantics: skip leading whitespace, parse the leading
    integer, 0 if none (src/main.cpp:23-25)."""
    i = 0
    while i < len(s) and s[i] in " \t\n\v\f\r":
        i += 1
    if i < len(s) and s[i] in "+-":
        i += 1
    j = i
    while j < len(s) and s[j].isdigit():
        j += 1
    if j == i:
        return 0
    return int(s[: j])


def render_scene_file(
    scene_path: str,
    width: int,
    height: int,
    samples: int,
    config: RenderConfig = DEFAULT_CONFIG,
    seed: int = 0,
    progress: bool = True,
    timer=None,
):
    """Load + render any supported scene file -> (HDR numpy image, metrics)."""
    from .utils.metrics import RenderMetrics

    # The 5-arg CLI contract has no flag slots (parity with main.cpp), so
    # the estimator-VISIBLE extension the reference lacks is reachable via
    # env: TPU_PATHTRACER_JITTER=sobol swaps the camera jitter for the
    # Owen-scrambled (0,2)-sequence (config.py `jitter`).
    env_jitter = os.environ.get("TPU_PATHTRACER_JITTER")
    if env_jitter and env_jitter != config.jitter:
        config = dataclasses.replace(config, jitter=env_jitter)
    # TPU_PATHTRACER_LOWDISC=sobol: Owen-Sobol for the per-bounce VNDF and
    # light-point pairs too (config.py `lowdisc`).
    env_ld = os.environ.get("TPU_PATHTRACER_LOWDISC")
    if env_ld and env_ld != config.lowdisc:
        config = dataclasses.replace(config, lowdisc=env_ld)

    t0 = time.perf_counter()
    if scene_path.endswith(".gltf") or scene_path.endswith(".glb"):
        from .scene.gltf import parse_gltf_scene
        from .models.pathtracer import render

        scene = parse_gltf_scene(scene_path, width / height, config)
        scene = dataclasses.replace(
            scene, camera=scene.camera.with_dims(width, height), samples=samples
        )
        t_load = time.perf_counter() - t0
        t1 = time.perf_counter()
        run_stats: dict = {}
        hdr = render(
            scene, spp=samples, seed=seed, config=config, progress=progress,
            timer=timer, stats=run_stats,
        )
        depth = scene.ray_depth
    else:
        from .scene.homebrew import parse_homebrew_scene
        from .models.legacy import render_homebrew

        scene = parse_homebrew_scene(scene_path)
        scene = dataclasses.replace(
            scene, camera=scene.camera.with_dims(width, height)
        )
        if samples > 0 and scene.monte_carlo:
            scene = dataclasses.replace(scene, samples=samples)
        t_load = time.perf_counter() - t0
        t1 = time.perf_counter()
        hdr = render_homebrew(scene, seed=seed, config=config)
        depth = scene.ray_depth
        run_stats = {}
    t_render = time.perf_counter() - t1

    metrics = RenderMetrics(
        width=width,
        height=height,
        samples=samples,
        ray_depth=depth,
        load_seconds=t_load,
        render_seconds=t_render,
        measured_rays=run_stats.get("measured_rays"),
    )
    return hdr, metrics


# Persistent compilation cache when JAX_COMPILATION_CACHE_DIR is unset: a
# fixed path inside the checkout, so repeat runs hit it (the path is part
# of what a cache entry is found by).
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def setup_backend() -> None:
    """Check the device and set up the persistent compilation cache.

    Raises ``RuntimeError`` when JAX finds no GPU and ``JAX_PLATFORMS`` did
    not ask for another platform (``JAX_PLATFORMS=cpu`` runs on the CPU):
    the renderer never falls back to the CPU on its own.  The compilation
    cache is wherever ``JAX_COMPILATION_CACHE_DIR`` says, if it is set, and
    :data:`CACHE_DIR` otherwise.
    """
    import jax

    if not jax.config.jax_platforms and jax.default_backend() != "gpu":
        raise RuntimeError(
            f"no GPU found (JAX backend is {jax.default_backend()!r}); set "
            "JAX_PLATFORMS=cpu to render on the CPU"
        )
    # Debug/observability hook (SURVEY §5: the race-detector/NaN-check
    # analog).  Note the reference's estimator *intentionally* produces NaNs
    # that per-sample sanitization zeroes (src/raytracer.h:607-616), so
    # jax_debug_nans is a kernel-debugging tool, not a default.
    if os.environ.get("TPU_PATHTRACER_DEBUG_NANS"):
        jax.config.update("jax_debug_nans", True)
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", CACHE_DIR)


def main(
    argv: Optional[List[str]] = None, config: RenderConfig = DEFAULT_CONFIG
) -> int:
    """Run the 5-argument CLI; ``config`` is for in-process callers."""
    argv = list(sys.argv if argv is None else argv)
    if len(argv) < 6:
        print(
            f"Too few arguments: expected 6, got {len(argv) - 1}",
            file=sys.stderr,
        )
        return 1

    try:
        setup_backend()
        width = _strtol(argv[2])
        height = _strtol(argv[3])
        samples = _strtol(argv[4])

        from .utils.profiling import PhaseTimer, device_trace

        timer = PhaseTimer()
        with device_trace(os.environ.get("TPU_PATHTRACER_TRACE_DIR")):
            with timer.phase("load_render"):
                hdr, metrics = render_scene_file(
                    argv[1], width, height, samples, config=config,
                    timer=timer,
                )

        from .utils.image import quantize_u8, write_ppm
        import numpy as np

        out_path = argv[5]
        parent = os.path.dirname(out_path)
        if parent:
            os.makedirs(parent, exist_ok=True)  # create_directories, main.cpp:41
        with timer.phase("tonemap_write"):
            pixels = np.asarray(quantize_u8(hdr))
            if out_path.lower().endswith(".png"):
                # Capability superset: the reference only writes P6 PPM.
                from .utils.png import write_png

                write_png(out_path, pixels)
            else:
                write_ppm(out_path, pixels)
        timer.report()  # per-phase seconds (SURVEY §5 tracing contract)
        print(metrics.to_json(), file=sys.stderr)
        return 0
    except (RuntimeError, OSError, ValueError) as err:
        print(str(err), file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())

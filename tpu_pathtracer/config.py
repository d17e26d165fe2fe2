"""Runtime render configuration.

The reference keeps all knobs as compile-time ``constexpr`` flags
(``src/config.h:7-47``) so changing any of them requires a rebuild.  Here the
same knobs — same names (snake_cased) and same defaults — live in a frozen
dataclass resolved at trace time, so a change only triggers an XLA re-jit, not
a recompile of the framework.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class IntersectTuning:
    """Scene-build and carry-layout knobs.

    All are exactness-neutral: the build only reorders triangles and the
    carry layout only changes how the per-bounce permutation moves data,
    so renders are estimator-identical under every setting (pinned by
    tests); only speed moves.
    """

    # Triangles per chunk: the SAH build aligns its treelet cuts to this
    # width and the "hint" sort key buckets rays by chunk id.  Must be a
    # LEAF_SIZE multiple.
    chunk_tris: int = 128
    # Spatial build: "sah" chunk-aligned sweep-SAH treelets (default) or
    # "morton" (LBVH curve, kept for A/B).
    build: str = "sah"
    # Corner-quad texture pool texel cap.  The quad pool packs each texel's
    # 2x2 bilinear corner block in one 64 B row, so the shade stage's
    # bilinear fetch is ONE row gather per (ray, slot) instead of four
    # (32M texels = 2 GB device pool; bigger atlases use the flat pool,
    # 0 turns the pool off).
    quad_max: int = 32 * 1024 * 1024
    # Per-bounce carry permutation form: 0 = one take per carry array,
    # 1 = pack the carries into one wide f32 block + one int32 block and
    # gather each once, 2 = f32 block + one take per int carry.  The
    # movement is bit-exact; whole renders are estimator-identical to fp
    # noise (the layout shifts XLA's fusion of the producing ops).
    packed_permute: int = 1


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Mirrors the reference's compile-time flag block (``src/config.h``).

    Every field is static for tracing purposes: it is baked into the jitted
    render function, exactly like the ``constexpr`` originals were baked into
    the binary.
    """

    # Numerical epsilon used for intersection validity windows and pdf guards
    # (src/config.h:15).
    eps: float = 1e-4

    # Path depth when the scene does not specify one (src/config.h:17).
    default_ray_depth: int = 8

    # Roughness clamp: anything below is treated as this (src/config.h:20).
    min_roughness: float = 0.04

    # MIS weight of the VNDF strategy; the cosine/light mixture gets
    # (1 - vndf_factor) (src/config.h:26).
    vndf_factor: float = 1.0 / 3.0

    # When False only 1x1 textures are honored (src/config.h:29).
    use_textures: bool = True

    # Environment map trio (src/config.h:36-38).  The CLI always sets the
    # background color to (env_map_intensity,)*3, matching src/main.cpp:28-31.
    env_map_intensity: float = 1.0
    use_env_map: bool = False
    env_map_path: str = "env.hdr"

    # Extra camera-space light triangle (src/config.h:41-47).
    add_light_triangle: bool = False
    light_triangle_intensity: float = 10.0
    light_triangle_relative_pos: Tuple[Tuple[float, float, float], ...] = (
        (10.0, 0.0, -0.1),
        (0.0, 10.0, -0.1),
        (0.0, -10.0, -0.1),
    )

    # --- Wavefront execution knobs (no reference analog; they replace the
    # --- SPAN_SIZE/USE_MULTITHREADING thread-pool pair, src/config.h:7-13).
    # Number of rays processed per device per wavefront megabatch.  Spans of
    # 256 pixels fed a CPU thread pool in the reference; here a megabatch
    # feeds the whole device.  The traversal workspace scales with rays,
    # bounding device memory use.
    rays_per_batch: int = 1 << 16

    # Samples per pixel accumulated per device pass.  The accumulator is
    # checkpointable between passes (the reference had no checkpointing).
    spp_per_pass: int = 16

    # Failed device executions (worker crash, preemption) are repaired by
    # recomputing the affected pixel chunk — counter-based RNG makes every
    # chunk a pure function of (scene, seed, range), so recovery is exact
    # (SURVEY §5 failure-detection contract).  0 disables.
    failure_retries: int = 2

    # Wavefront coherence sort key for large scenes (ops/sortkeys.py).
    # "hint": direction octant x the spatially ordered chunk id of the
    # surface the ray spawned from; "cell": direction octant x 16^3 Morton
    # origin cell; "dirhint": fine-direction bins major over the spawn
    # chunk; "none": compaction-only order (dead rays last, live order
    # untouched — the reference's analog, which never sorts).  Purely a
    # perf knob: sorting is observationally free (per-pixel counter RNG).
    sort_key: str = "hint"

    # Frame pool (compaction engine, single-host render() path only): each
    # persistent call's work pool covers the WHOLE frame — the accumulator
    # sizes to the frame while lanes stay rays_per_batch wide — so the
    # pool-drain tail (lanes dying over the last ~ray_depth iterations once
    # the pool empties) is paid once per spp pass instead of once per
    # lane-sized pixel chunk.  Estimator-identical (same (pixel, sample,
    # depth) counter-RNG streams; only per-pixel fp summation order moves).
    # Device executions get longer by the frame/chunk ratio: bound them with
    # spp_per_pass.
    frame_pool: bool = False

    # Wavefront engine: True = persistent wavefront with path regeneration
    # (true stream compaction: dead lanes refill with fresh samples each
    # iteration, ~100% lane occupancy); False = fixed scan over ray_depth
    # bounces.  Both produce the same estimator sample-for-sample.
    compaction: bool = True

    # Camera-jitter sampler: "uniform" reproduces the reference estimator
    # (plain U[0,1)^2 per (pixel, sample) — src/raytracer.h:527-538);
    # "sobol" swaps ONLY the camera-jitter draws for an Owen-scrambled
    # (0,2)-sequence under the same counter discipline (ops/rng.py) —
    # an estimator-visible quality upgrade the reference never had: same
    # work, lower pixel variance at equal spp (test_rng.py pins it).  Off
    # by default so every reference-parity test is untouched.
    jitter: str = "uniform"

    # Low-discrepancy BOUNCE draws: "sobol" replaces the two highest-variance
    # estimator pairs per bounce — VNDF (u1, u2) and light point (u, v) —
    # with per-(pixel, depth) Owen-scrambled (0,2)-sequences over the sample
    # index (ops/rng.py sobol_owen_pair); the other six draws stay plain
    # threefry uniforms.  Same counter discipline as jitter="sobol", so all
    # reproducibility properties hold; "off" (default) reproduces the
    # reference estimator draw-for-draw.  Compose with jitter="sobol" for
    # the full quality stack.
    lowdisc: str = "off"

    # Scene-build and carry-layout knobs (exactness-neutral; see
    # IntersectTuning).
    tuning: IntersectTuning = IntersectTuning()


DEFAULT_CONFIG = RenderConfig()

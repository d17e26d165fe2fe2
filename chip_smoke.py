#!/usr/bin/env python
"""Smoke test of the path tracer on one NVIDIA GPU, at full size.

    python chip_smoke.py               # phases (a)-(f) on one card
    python chip_smoke.py --four-cards  # sharded renders on four cards only

Phases, in order, all in this one process:

(a) print the card (nvidia-smi), ``jax.devices()`` and whether the native
    accel packer loaded;
(b) refuse to run unless JAX's backend is the GPU;
(c) traversal exactness: ``closest_hit_leaves`` against the dense sweep
    ``closest_hit`` on 16,384 primary and 16,384 secondary rays of the
    217,790-triangle atrium;
(d) the estimator against the C++ reference's 4096-spp Cornell golden;
(e) the persistent engine against the scan engine on the atrium;
(f) the headline render: the atrium at 512x512@16spp with 65,536-ray
    wavefronts, through the 5-argument CLI, with no chunk retries.

``--four-cards`` runs only the multi-card comparison: the atrium at
256x256@16spp through ``render_sharded`` on a (1, 4) and a (2, 2) mesh,
each against the single-card render on device 0.

Set ``TPU_PATHTRACER_TRACE_DIR`` to write a ``jax.profiler`` trace of the
timed phase (f) render.  Every phase prints its figures beside their
limits.  If any phase fails the script exits non-zero and does not print
its last line, which is otherwise one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
EPS = 1e-4
ATRIUM_TRIS = 217_790  # make_atrium_gltf(detail=2)
SPP = 16
SIDE = 128  # phases (c) and (e): 16,384 rays / pixels
HEADLINE_SIDE = 512  # phase (f): 4 wavefronts of 65,536 rays
FOUR_SIDE = 256  # --four-cards
# Engines (and meshes) are estimator-identical sample for sample, but two
# compiled programs round ~1% of paths differently in the last bits (on an
# H100, 400 W: 192 of 16,384 single-sample atrium paths), and 8 bounces
# carry a few of those past 1e-4 relative (0.12% of pixels at 16 spp).
MEAN_RTOL = 1e-4
PIXEL_RTOL = 1e-4
MAX_PIXEL_FRACTION = 5e-3


class SmokeFailure(Exception):
    """A phase's check failed."""


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def result_line(devices) -> str:
    """The last line of a passing run."""
    return json.dumps(
        {
            "ok": True,
            "device": {
                "platform": devices[0].platform,
                "kind": devices[0].device_kind,
                "count": len(devices),
            },
        }
    )


def card_line() -> str:
    """nvidia-smi's name and power limit of the card(s)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return " | ".join(line.strip() for line in out.splitlines())


def peak_bytes(device) -> int:
    return int(device.memory_stats()["peak_bytes_in_use"])


def image_agreement(a, b):
    """(relative difference of the image means, fraction of pixels whose
    worst channel differs by more than PIXEL_RTOL relative)."""
    import numpy as np

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mean_rel = abs(a.mean() - b.mean()) / max(abs(b.mean()), 1e-30)
    scale = np.maximum(np.maximum(np.abs(a), np.abs(b)), 1e-30)
    pix_rel = (np.abs(a - b) / scale).max(axis=-1)
    return mean_rel, float((pix_rel > PIXEL_RTOL).mean())


def check_images(name: str, got, want) -> None:
    import numpy as np

    check(np.isfinite(got).all(), f"{name}: non-finite pixels")
    mean_rel, frac = image_agreement(got, want)
    print(
        f"  {name}: image-mean rel diff {mean_rel:.3e} (limit {MEAN_RTOL:g}); "
        f"pixels off by > {PIXEL_RTOL:g} rel: {frac:.5f} "
        f"(limit {MAX_PIXEL_FRACTION:g}); "
        f"bit-identical: {bool(np.array_equal(got, want))}"
    )
    check(mean_rel <= MEAN_RTOL, f"{name}: image means disagree")
    check(frac <= MAX_PIXEL_FRACTION, f"{name}: too many pixels disagree")


def atrium_path(tmp: str) -> str:
    """The benchmark atrium (make_atrium_gltf detail 2), written once."""
    from tpu_pathtracer.utils.testscenes import make_atrium_gltf

    path = os.path.join(tmp, "atrium", "atrium.gltf")
    if not os.path.exists(path):
        make_atrium_gltf(path, detail=2)
    return path


def atrium(tmp: str, width: int, height: int):
    import dataclasses

    from tpu_pathtracer.scene.gltf import parse_gltf_scene

    scene = parse_gltf_scene(atrium_path(tmp), width / height)
    return dataclasses.replace(
        scene, camera=scene.camera.with_dims(width, height)
    )


def plane_t(woop, o, d, tri):
    """Float64 distance along each ray to its triangle's plane (the Woop
    n-row: t = -p_n / q_n), independent of the barycentric test."""
    import numpy as np

    w = woop.reshape(4, -1, 3)[:, tri, 2].T.astype(np.float64)  # [R, 4]
    p = (o * w[:, :3]).sum(-1) + w[:, 3]
    q = (d * w[:, :3]).sum(-1)
    return -p / q


def compare_traversal(name, scene, o, d) -> None:
    import jax
    import numpy as np

    from tpu_pathtracer.ops.intersect import closest_hit
    from tpu_pathtracer.ops.traverse import closest_hit_leaves

    dense = jax.jit(closest_hit, static_argnames="min_dst")(
        o, d, scene.woop, min_dst=EPS
    )
    leaves = jax.jit(closest_hit_leaves, static_argnames="min_dst")(
        o, d, scene.leaf_aabb_min, scene.leaf_aabb_max, scene.leaf_woop,
        min_dst=EPS,
    )
    hd, hl = np.asarray(dense.hit), np.asarray(leaves.hit)
    both = hd & hl
    td, tl = np.asarray(dense.t)[both], np.asarray(leaves.t)[both]
    idd, idl = np.asarray(dense.tri)[both], np.asarray(leaves.tri)[both]
    t_err = float((np.abs(tl - td) / td).max()) if both.any() else 0.0
    differ = idd != idl
    o64 = np.asarray(o, np.float64)[both][differ]
    d64 = np.asarray(d, np.float64)[both][differ]
    woop = np.asarray(scene.woop)
    ta = plane_t(woop, o64, d64, idd[differ])
    tb = plane_t(woop, o64, d64, idl[differ])
    gap = np.abs(ta - tb) / np.abs(ta)
    wrong = int((gap > 1e-6).sum())
    print(
        f"  {name}: {len(hd)} rays, {int(hd.sum())} hits; hit-mask "
        f"mismatches {int((hd != hl).sum())} (limit 0); triangle ids differ "
        f"on {int(differ.sum())} rays, {wrong} of them where the two "
        f"candidates' t differ by > 1e-6 rel (limit 0; worst gap "
        f"{float(gap.max()) if gap.size else 0.0:.3e}); worst t rel err "
        f"{t_err:.3e} (limit 1e-05)"
    )
    check((hd == hl).all(), f"{name}: hit masks differ")
    check(wrong == 0, f"{name}: closest triangles differ")
    check(t_err <= 1e-5, f"{name}: hit distances differ")


def phase_traversal(tmp: str) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tpu_pathtracer.config import DEFAULT_CONFIG
    from tpu_pathtracer.models.pathtracer import (
        bounce_draws, bounce_step, gen_rays,
    )

    scene = atrium(tmp, SIDE, SIDE)
    n_tris = int(np.asarray(scene.valid).sum())
    print(f"  atrium: {n_tris} triangles, {scene.leaf_woop.shape[0]} leaves")
    check(n_tris == ATRIUM_TRIS, "atrium triangle count changed")
    pids = jnp.arange(SIDE * SIDE, dtype=jnp.int32)
    o, d = gen_rays(scene.camera, pids, jnp.full((2, pids.shape[0]), 0.5))
    compare_traversal("primary", scene, o, d)
    # Secondary rays: the bounce the integrator itself spawns from them.
    draws = bounce_draws(jax.random.key(0), 0, 0, pids, DEFAULT_CONFIG)
    ones = jnp.ones_like(o)
    o2, d2, _, _, alive, _ = jax.jit(bounce_step, static_argnums=1)(
        scene, DEFAULT_CONFIG, o, d, ones, ones * 0.0,
        jnp.ones(pids.shape, bool), draws,
    )
    alive = np.asarray(alive)
    check(alive.any(), "no secondary rays")
    compare_traversal(
        "secondary", scene, np.asarray(o2)[alive], np.asarray(d2)[alive]
    )


def phase_golden(tmp: str) -> None:
    import dataclasses

    import numpy as np

    from tpu_pathtracer.models.pathtracer import render
    from tpu_pathtracer.scene.gltf import parse_gltf_scene
    from tpu_pathtracer.utils.image import quantize_u8, read_ppm
    from tpu_pathtracer.utils.testscenes import make_cornell_gltf

    ref = read_ppm(
        os.path.join(REPO, "tests", "golden", "cornell_64x64_4096spp.ppm")
    ).astype(np.float64)
    scene = parse_gltf_scene(
        make_cornell_gltf(os.path.join(tmp, "cornell", "cornell.gltf")), 1.0
    )
    scene = dataclasses.replace(scene, camera=scene.camera.with_dims(64, 64))
    img = render(scene, spp=64, seed=0)
    ours = np.asarray(quantize_u8(img), dtype=np.float64)
    rmse = float(np.sqrt(((ours - ref) ** 2).mean()))
    dmean = float(abs(ours.mean() - ref.mean()))
    print(
        f"  cornell 64x64@64spp vs 4096-spp golden: u8 RMSE {rmse:.3f} "
        f"(limit 14); mean diff {dmean:.3f} (limit 3)"
    )
    check(rmse < 14.0 and dmean < 3.0, "Cornell render off the golden")


def phase_engines(tmp: str) -> None:
    from tpu_pathtracer.config import RenderConfig
    from tpu_pathtracer.models.pathtracer import render

    scene = atrium(tmp, SIDE, SIDE)
    persistent = render(scene, SPP, seed=0, config=RenderConfig())
    scan = render(scene, SPP, seed=0, config=RenderConfig(compaction=False))
    check_images(
        f"atrium {SIDE}x{SIDE}@{SPP}spp persistent vs scan", persistent, scan
    )


def phase_headline(tmp: str, device) -> None:
    import numpy as np

    from tpu_pathtracer import cli
    from tpu_pathtracer.config import RenderConfig
    from tpu_pathtracer.utils.image import read_ppm

    path = atrium_path(tmp)
    side = HEADLINE_SIDE
    out = os.path.join(tmp, "headline.ppm")
    argv = ["main.py", path, str(side), str(side), str(SPP), out]
    config = RenderConfig(failure_retries=0)
    trace_dir = os.environ.pop("TPU_PATHTRACER_TRACE_DIR", None)

    def run():
        err = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = cli.main(argv, config=config)
        wall = time.perf_counter() - t0
        log = err.getvalue()
        check(rc == 0, f"CLI exited {rc}: {log[-2000:]}")
        metrics = json.loads(
            [ln for ln in log.splitlines() if ln.startswith('{"width"')][-1]
        )
        return wall, metrics

    warm, _ = run()  # compiles every program the timed run uses
    if trace_dir:
        os.environ["TPU_PATHTRACER_TRACE_DIR"] = trace_dir
    wall, metrics = run()
    img = read_ppm(out)
    check(img.shape == (side, side, 3), f"bad PPM shape {img.shape}")
    check(5.0 < img.mean() < 250.0 and img.std() > 1.0, "implausible image")
    render_s = metrics["render_seconds"]
    rays = metrics["measured_rays"]
    samples = side * side * SPP
    print(
        f"  headline atrium {side}x{side}@{SPP}spp, "
        f"{config.rays_per_batch}-ray wavefronts: "
        f"compile+warm-up {warm:.2f} s; timed CLI wall {wall:.2f} s "
        f"(scene load {metrics['load_seconds']:.2f} s, render "
        f"{render_s:.2f} s); {samples / render_s:.0f} "
        f"pixel-samples/s and {rays / render_s:.4g} measured rays/s over the "
        f"render; mean path length {rays / samples:.3f}; peak "
        f"device memory {peak_bytes(device)} B; card {card_line()}"
        + (f"; traced to {trace_dir}" if trace_dir else "")
    )


def four_cards(tmp: str, devices) -> None:
    from tpu_pathtracer.config import RenderConfig
    from tpu_pathtracer.models.pathtracer import render
    from tpu_pathtracer.parallel.mesh import make_mesh, render_sharded

    check(len(devices) >= 4, f"need 4 GPUs, found {len(devices)}")
    devices = devices[:4]
    scene = atrium(tmp, FOUR_SIDE, FOUR_SIDE)
    config = RenderConfig(failure_retries=0)
    single = render(scene, SPP, seed=0, config=config)  # on device 0
    for rays, spp in ((1, 4), (2, 2)):
        mesh = make_mesh(devices=devices, rays=rays, spp=spp)
        got = render_sharded(scene, SPP, seed=0, config=config, mesh=mesh)
        check_images(
            f"atrium {FOUR_SIDE}x{FOUR_SIDE}@{SPP}spp ({rays}, {spp}) mesh "
            "vs one card", got, single,
        )
    print(
        "  peak device memory per card: "
        + ", ".join(f"{d.id}: {peak_bytes(d)} B" for d in devices)
    )


def main(argv) -> int:
    four = "--four-cards" in argv[1:]
    # (a) the card, before JAX touches it.
    try:
        card = card_line()
    except (OSError, subprocess.SubprocessError) as err:
        print(f"nvidia-smi failed: {err}", file=sys.stderr)
        return 1
    print(f"card (name, power limit): {card}")
    sys.path.insert(0, REPO)
    try:
        import jax

        from tpu_pathtracer.cli import setup_backend
        from tpu_pathtracer.scene import native
    except ImportError as err:
        print(f"cannot import the renderer: {err}", file=sys.stderr)
        return 1
    # (b) never carry on anywhere but the GPU.
    if jax.default_backend() != "gpu":
        print(
            f"JAX backend is {jax.default_backend()!r}, not 'gpu': refusing",
            file=sys.stderr,
        )
        return 2
    setup_backend()
    devices = jax.devices()
    print(f"jax {jax.__version__} devices: {devices}")
    print(f"native accel packer loaded: {native.load_library() is not None}")

    phases = (
        [("four cards: sharded vs single-card", four_cards)] if four else [
            ("c: traversal exactness", phase_traversal),
            ("d: Cornell vs C++ golden", phase_golden),
            ("e: persistent vs scan engine", phase_engines),
            ("f: headline CLI render", phase_headline),
        ]
    )
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        for name, fn in phases:
            print(f"phase {name}", flush=True)
            t0 = time.perf_counter()
            try:
                if fn is four_cards:
                    fn(tmp, devices)
                elif fn is phase_headline:
                    fn(tmp, devices[0])
                else:
                    fn(tmp)
            except SmokeFailure as err:
                print(f"FAILED phase {name}: {err}", file=sys.stderr)
                return 1
            print(
                f"  ok in {time.perf_counter() - t0:.1f} s; peak device "
                f"memory so far {peak_bytes(devices[0])} B",
                flush=True,
            )
    print(f"card (name, power limit): {card}")
    print(result_line(devices[:4] if four else devices[:1]))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

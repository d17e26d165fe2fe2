"""Multi-chip rendering over a ``jax.sharding.Mesh``.

The reference's entire parallel runtime is a shared-memory thread pool pulling
256-pixel spans off one ``std::atomic_int`` (src/raytracer.h:635-665, SURVEY
§2 C10).  The multi-device equivalent is SPMD over a device mesh:

* axis ``"rays"`` — pixels sharded across devices (the DP analog of spans);
* axis ``"spp"``  — sample ranges sharded across devices, merged with a
  ``psum`` over the device interconnect;
* the scene (triangles, materials, atlas, light set) is *replicated* —
  course-scale scenes are far below per-device memory, exactly like every worker
  thread sharing the read-only ``RaytracerStaticContext``.

The dynamic atomic span queue becomes static even sharding: XLA's SPMD model
wants identical per-device programs, and per-pixel counter-based RNG
(``per_pixel_uniforms``) makes the result bit-identical to the single-device
render for any mesh shape — load balance comes from the wavefront itself.
There is deliberately no TP/PP/SP analog: the reference has no weights to
shard and no sequence axis (SURVEY §5); scaling axes are pixels and samples.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..config import RenderConfig
from ..models.pathtracer import gen_rays, sanitize_nans, trace
from ..ops.rng import jitter_uniforms
from ..scene.types import TriangleScene


def make_mesh(
    devices=None, rays: Optional[int] = None, spp: int = 1
) -> Mesh:
    """Build a ('rays', 'spp') mesh.  Default: all devices on the rays axis."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = devices.size
    if rays is None:
        rays = n // spp
    assert rays * spp == n, f"mesh {rays}x{spp} != {n} devices"
    return Mesh(devices.reshape(rays, spp), axis_names=("rays", "spp"))


@partial(
    jax.jit,
    static_argnames=("n_rays_global", "spp", "config", "mesh"),
)
def render_pass_sharded(
    scene: TriangleScene,
    chunk_start: jnp.ndarray,  # [] int32 — first linear pixel id of the pass
    key: jax.Array,
    sample_start: jnp.ndarray,  # [] int32 — resume offset into the spp stream
    n_rays_global: int,
    spp: int,
    config: RenderConfig,
    mesh: Mesh,
):  # -> ([n_rays_global, 3] mean radiance over spp, [] int32 rays traced)
    """One sharded accumulation pass: pixels split over 'rays', samples split
    over 'spp', psum-merged.  Bit-identical to the host-loop renderer.

    The second output is the TRUE bounce-ray count as a per-'rays'-rank
    vector [n_rays_mesh] (live lanes entering each bounce, psum-merged over
    'spp' only — sharded renders report the same measured-rays metric the
    single-host path does).  Per-rank because one mesh-wide
    int32 psum can wrap on large meshes (rank counts are individually bounded
    by the engine's int32 pool guard; the host sums them in int64).  Padded
    tail pixels past the frame are EXCLUDED from both radiance and the
    counter (pix_count per rank), exactly like the single-host render; the
    count is 0 under the scan engine, which does not count."""
    n_rays_mesh = mesh.shape["rays"]
    n_spp_mesh = mesh.shape["spp"]
    assert n_rays_global % n_rays_mesh == 0
    n_local = n_rays_global // n_rays_mesh
    # Each spp rank covers a contiguous slice of ceil(spp / n_spp_mesh)
    # global sample indices, with indices >= spp masked out — so ANY spp is
    # honored exactly (the set of rendered samples is exactly {0..spp-1},
    # matching the single-device render sample-for-sample).
    spp_local = -(-spp // n_spp_mesh)

    def shard_body(scene_rep: TriangleScene, chunk_start, key, sample_start):
        ray_idx = jax.lax.axis_index("rays")
        spp_idx = jax.lax.axis_index("spp")

        if config.compaction:
            # Persistent-wavefront engine per rank: same compaction the
            # single-device path gets.  Each rank's work pool covers its own
            # sample slice; the pool size is a TRACED scalar, so ranks with
            # different remainder counts share one SPMD program (the
            # while_loop body has no collectives — trip counts may differ).
            from ..models.pathtracer import persistent_accum

            rank_start = jax.lax.pcast(
                chunk_start + ray_idx * n_local, ("spp",), to="varying"
            )
            my_count = jnp.clip(spp - spp_idx * spp_local, 0, spp_local)
            my_count = jax.lax.pcast(my_count, ("rays",), to="varying")
            # Useful pixels of this rank's slice: a pass whose chunk spans
            # the frame's padded tail must not trace (or count) the padding
            # — same pix_count discipline as the single-host render()
            # (pathtracer.py: the r3 inflated-counter fix).  pool shape
            # floors at 1 so a fully-padded rank's `% pool_pix` stays
            # defined; its w_total is 0, so nothing spawns either way.
            npix = scene_rep.camera.width * scene_rep.camera.height
            pc_rank = jnp.clip(npix - rank_start, 0, n_local)
            acc, n_bounce = persistent_accum(
                scene_rep,
                rank_start,
                key,
                sample_start + spp_idx * spp_local,
                n_local,
                pc_rank * my_count,
                config,
                pix_count=jnp.maximum(pc_rank, 1),
            )
            return (
                jax.lax.psum(acc, "spp") / spp,
                jax.lax.psum(n_bounce, "spp").reshape(1),
            )

        pixel_ids = chunk_start + ray_idx * n_local + jnp.arange(n_local)
        # Mark the per-device ids as varying over the whole mesh so every
        # derived scan carry has a consistent varying-axis type (pcast only
        # accepts axes the value does not already vary over).
        pixel_ids = jax.lax.pcast(pixel_ids, ("spp",), to="varying")

        def body(s, acc):
            rel_s = spp_idx * spp_local + s
            global_s = sample_start + rel_s
            offsets = jitter_uniforms(
                key, global_s, pixel_ids, config.jitter
            )
            o, d = gen_rays(scene_rep.camera, pixel_ids, offsets)
            rad = trace(scene_rep, o, d, key, pixel_ids, config, sample=global_s)
            rad = jnp.where(rel_s < spp, sanitize_nans(rad), 0.0)
            return acc + rad

        acc0 = jax.lax.pcast(
            jnp.zeros((n_local, 3), jnp.float32), ("rays", "spp"), to="varying"
        )
        acc = jax.lax.fori_loop(0, spp_local, body, acc0)
        # Merge the sample shards; every 'spp' rank ends up with the
        # full mean so the output is replicated along that axis.
        acc = jax.lax.psum(acc, "spp")
        # The scan engine traces no ray counter; report 0 (as render() does).
        zero = jax.lax.pcast(
            jnp.zeros((1,), jnp.int32), ("rays",), to="varying"
        )
        return acc / spp, zero

    scene_specs = jax.tree.map(lambda _: P(), scene)
    return jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(scene_specs, P(), P(), P()),
        out_specs=(P("rays", None), P("rays")),
    )(scene, chunk_start, key, sample_start)


def render_sharded(
    scene: TriangleScene,
    spp: int,
    seed: int = 0,
    config: Optional[RenderConfig] = None,
    mesh: Optional[Mesh] = None,
    sample_start: int = 0,
    stats: Optional[dict] = None,
) -> np.ndarray:
    """Full-frame multi-chip render -> host numpy [H, W, 3] float32 HDR.

    Renders exactly ``spp`` samples (sample indices ``sample_start`` to
    ``sample_start + spp - 1`` of the seed's counter stream — the offset is
    how multi-host slices stay disjoint).

    Operational parity with the single-host ``render``:
    ``stats["measured_rays"]`` reports the mesh-wide TRUE bounce
    count under the compaction engine, and failed device executions are
    repaired by recomputing the affected pass (counter RNG makes the
    recompute sample-exact, so retried passes are identical)."""
    config = config or RenderConfig()
    mesh = mesh or make_mesh()
    cam = scene.camera
    h, w = cam.height, cam.width
    npix = h * w
    if scene.ray_depth == 0:
        return np.broadcast_to(
            np.asarray(scene.bg_color, dtype=np.float32), (h, w, 3)
        ).copy()
    spp = max(int(spp), 1)

    n_rays_mesh = mesh.shape["rays"]
    # Global chunk = per-device batch * ray shards (pixel ids past the frame
    # are masked out of both radiance and the ray counter).
    from ..models.pathtracer import pick_chunk

    per_dev = pick_chunk(config, -(-npix // n_rays_mesh))
    chunk = per_dev * n_rays_mesh

    base = jax.random.key(seed)
    out = np.zeros((npix, 3), dtype=np.float32)
    measured_rays = 0
    for start in range(0, npix, chunk):
        n = min(chunk, npix - start)

        def dispatch():
            return render_pass_sharded(
                scene,
                jnp.asarray(start, jnp.int32),
                base,
                jnp.asarray(sample_start, jnp.int32),
                chunk,
                spp,
                config,
                mesh,
            )

        rad, nb = dispatch()
        for attempt in range(config.failure_retries + 1):
            try:
                host = np.asarray(rad[:n])
                # Per-'rays'-rank counts; int64 host sum (a mesh-wide int32
                # psum could wrap on large meshes).
                pass_rays = int(np.asarray(nb).astype(np.int64).sum())
                break
            except Exception:  # device/runtime crash surfaced at readback
                if attempt == config.failure_retries:
                    raise
                import sys

                print(
                    f"sharded pass {start}: device execution failed, "
                    f"retrying ({attempt + 1}/{config.failure_retries})",
                    file=sys.stderr,
                )
                rad, nb = dispatch()
        out[start : start + n] = host
        measured_rays += pass_rays
    if stats is not None and config.compaction:
        stats["measured_rays"] = measured_rays
    return out.reshape(h, w, 3)

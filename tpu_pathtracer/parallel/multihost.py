"""Multi-host rendering.

The reference has no distributed story at all (one process, one shared
memory, SURVEY §2 C10); this module defines the multi-host contract.  The
design follows SURVEY §5: the host network only enters for spp/pixel
farming — every host renders disjoint sample ranges or pixel rows of the
same replicated scene, and a final reduction merges accumulators.  Because
the RNG is keyed per (pixel, sample), the union of any disjoint work split
is exactly the single-host render.

On a cluster, launch one process per host with the standard JAX env
(``JAX_COORDINATOR_ADDRESS`` etc.) and call :func:`render_multihost`.  The
code paths below only assume ``jax.process_count()``-style SPMD, so they run
unchanged (and are tested) with a single process.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np

from ..config import RenderConfig
from ..scene.types import TriangleScene
from .mesh import make_mesh, render_sharded


def maybe_initialize_distributed() -> bool:
    """Initialize jax.distributed when a coordinator is configured.

    Returns True when running as part of a multi-process job.  Safe to call
    unconditionally: without coordinator env vars it is a no-op.
    """
    import os

    if os.environ.get("JAX_COORDINATOR_ADDRESS") and jax.process_count() == 1:
        jax.distributed.initialize()
    return jax.process_count() > 1


def _render_span(
    scene: TriangleScene,
    spp: int,
    seed: int,
    config: RenderConfig,
    sample_start: int = 0,
) -> np.ndarray:
    """Render one span of ``spp`` samples (global sample indices
    ``sample_start`` .. ``sample_start + spp - 1``) split across all hosts;
    returns the MEAN image over the span, identical on every host.

    spp is split evenly across processes with the remainder spread over the
    first ranks (no divisibility requirement); ``sample_start`` offsets the
    counter stream so host slices are disjoint by construction and their
    union is exactly the single-host sample set.  The cross-host allreduce
    is one [H*W, 3] allgather+sum — bandwidth-trivial next to the render."""
    p = jax.process_count()
    rank = jax.process_index()
    if p == 1:
        return render_sharded(
            scene, spp, seed, config, sample_start=sample_start
        )

    base_spp, rem = divmod(spp, p)
    local_spp = base_spp + (1 if rank < rem else 0)
    local_start = sample_start + rank * base_spp + min(rank, rem)

    # Render this host's sample slice over ALL its local chips (the local
    # device mesh), not a single device.
    local_mesh = make_mesh(jax.local_devices())
    cam = scene.camera
    if local_spp > 0:
        local = render_sharded(
            scene, local_spp, seed, config, local_mesh,
            sample_start=local_start,
        ).reshape(-1, 3)
        local = local * (local_spp / spp)  # slice mean -> weighted share
    else:  # more hosts than samples: this host contributes nothing
        local = np.zeros((cam.height * cam.width, 3), dtype=np.float32)

    # Merge host accumulators across hosts.
    from jax.experimental import multihost_utils

    total = multihost_utils.process_allgather(local)  # [P, npix, 3]
    return total.sum(axis=0).reshape(cam.height, cam.width, 3)


def render_multihost(
    scene: TriangleScene,
    spp: int,
    seed: int = 0,
    config: Optional[RenderConfig] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: Optional[int] = None,
    resume: bool = True,
) -> np.ndarray:
    """Multi-host render: each process renders a disjoint sample range on its
    local chips, and accumulators are summed across hosts (see _render_span).

    With ``checkpoint_path`` the render proceeds in host-merged passes of
    ``checkpoint_every`` samples (default config.spp_per_pass) and saves a
    resumable accumulator after each, so multi-host renders, the longest
    ones, can resume.  Every host holds the full merged accumulator after each
    pass, so each host saves/loads its own copy of the checkpoint (no shared
    filesystem needed); a killed-and-resumed render is bit-identical to an
    uninterrupted one with the same ``checkpoint_every`` because pass sums
    accumulate in the same fp order.
    """
    config = config or RenderConfig()
    if checkpoint_path is None:
        return _render_span(scene, max(int(spp), 1), seed, config)

    import os

    from .checkpoint import RenderState, scene_fingerprint

    cam = scene.camera
    h, w = cam.height, cam.width
    npix = h * w
    if scene.ray_depth == 0:
        return np.broadcast_to(
            np.asarray(scene.bg_color, dtype=np.float32), (h, w, 3)
        ).copy()
    spp = max(int(spp), 1)

    fp = scene_fingerprint(scene, config)
    state = None
    if resume and os.path.exists(checkpoint_path):
        cand = RenderState.load(checkpoint_path)
        if (cand.width, cand.height, cand.seed) == (w, h, seed) and (
            cand.fingerprint in (0, fp)
        ):
            state = cand
        else:
            import sys

            print(
                f"checkpoint {checkpoint_path} does not match this render "
                "(dims/seed/scene+config fingerprint); ignoring it and "
                "restarting from sample 0",
                file=sys.stderr,
            )
    if state is None:
        state = RenderState(
            accum=np.zeros((npix, 3), dtype=np.float32),
            samples_done=0,
            width=w,
            height=h,
            seed=seed,
            fingerprint=fp,
        )
    if jax.process_count() > 1:
        # Hosts checkpoint to their OWN files and may disagree after a
        # partial failure (one host restarted on a fresh disk, a stale or
        # rejected file): differing samples_done would desynchronize the
        # per-span allgather collectives.  Host
        # 0's state is authoritative — every host already holds the FULL
        # merged accumulator after each pass, so broadcasting rank 0's
        # (samples_done, accum) once at resume restores agreement exactly.
        from jax.experimental import multihost_utils

        done, accum = multihost_utils.broadcast_one_to_all(
            (np.int32(state.samples_done), state.accum)
        )
        state.samples_done = int(done)
        # Copy: broadcast results come back read-only, and accum is the
        # running in-place accumulator.
        state.accum = np.array(accum, dtype=np.float32)

    pass_spp = checkpoint_every or config.spp_per_pass
    while state.samples_done < spp:
        todo = min(pass_spp, spp - state.samples_done)
        img = _render_span(
            scene, todo, seed, config, sample_start=state.samples_done
        )
        state.accum += img.reshape(-1, 3) * todo
        state.samples_done += todo
        state.save(checkpoint_path)
    return state.image

"""Checkpoint / resume for long renders.

The reference has nothing here: a 47-minute Sponza render that dies restarts
from scratch (README.md:4, SURVEY §5).  Counter-based per-pixel RNG makes
checkpointing nearly free for us: the full render state is just the HDR
accumulator plus the number of samples already folded in — resuming means
continuing the sample counter from ``samples_done``.  Any crash loses at most
one pass of work, and a resumed render is sample-for-sample identical to an
uninterrupted one.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import RenderConfig
from ..models.pathtracer import render_chunk
from ..scene.types import TriangleScene


# Config fields that change HOW the render executes but not WHAT estimator
# it computes (sample-for-sample identical output up to fp summation order).
# Excluded from the fingerprint so tuning them between sessions cannot
# silently discard a resumable accumulator.
_EXECUTION_KNOBS = (
    "rays_per_batch",
    "spp_per_pass",
    "failure_retries",
    "sort_key",
    "frame_pool",
    "compaction",
    "tuning",
)


def scene_fingerprint(scene: TriangleScene, config: RenderConfig) -> int:
    """Cheap stable hash of the scene arrays + the ESTIMATOR-relevant config.

    Guards resume against blending a checkpoint from a *different* scene or
    estimator config into the new accumulator (same-resolution/seed
    checkpoints are otherwise indistinguishable).  Execution-only knobs
    (_EXECUTION_KNOBS) are normalized out: they move fp summation order at
    most, and including them made every tuning change silently restart
    pre-existing checkpoints from sample 0."""
    import zlib

    defaults = RenderConfig()
    normalized = dataclasses.replace(
        config,
        **{k: getattr(defaults, k) for k in _EXECUTION_KNOBS},
    )
    crc = zlib.crc32(repr(normalized).encode())
    for leaf in jax.tree.leaves(scene):
        arr = np.asarray(leaf)
        crc = zlib.crc32(arr.tobytes(), crc)
        crc = zlib.crc32(str(arr.dtype).encode() + str(arr.shape).encode(), crc)
    return crc


@dataclasses.dataclass
class RenderState:
    """Resumable accumulation state: sum of per-sample radiance per pixel."""

    accum: np.ndarray  # [H*W, 3] float32, SUM over samples (not mean)
    samples_done: int
    width: int
    height: int
    seed: int
    fingerprint: int = 0  # scene+config hash (0 = unknown, legacy checkpoints)

    @property
    def image(self) -> np.ndarray:
        """Current mean-radiance HDR image."""
        n = max(self.samples_done, 1)
        return (self.accum / n).reshape(self.height, self.width, 3)

    def save(self, path: str) -> None:
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        # Atomic write: a crash mid-save must not corrupt the checkpoint.
        fd, tmp = tempfile.mkstemp(dir=parent or ".", suffix=".npz.tmp")
        os.close(fd)
        try:
            with open(tmp, "wb") as f:
                np.savez(
                    f,
                    accum=self.accum,
                    samples_done=self.samples_done,
                    width=self.width,
                    height=self.height,
                    seed=self.seed,
                    fingerprint=self.fingerprint,
                )
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    @staticmethod
    def load(path: str) -> "RenderState":
        z = np.load(path)
        return RenderState(
            accum=z["accum"],
            samples_done=int(z["samples_done"]),
            width=int(z["width"]),
            height=int(z["height"]),
            seed=int(z["seed"]),
            fingerprint=int(z["fingerprint"]) if "fingerprint" in z else 0,
        )


def render_with_checkpoints(
    scene: TriangleScene,
    spp: int,
    seed: int = 0,
    config: Optional[RenderConfig] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: Optional[int] = None,
    resume: bool = True,
    progress: Optional[Callable[[int, int], None]] = None,
) -> np.ndarray:
    """Like models.pathtracer.render, but accumulates in resumable passes.

    Samples are rendered in passes of ``spp_per_pass``; after each pass the
    accumulator is checkpointed.  If ``checkpoint_path`` exists and matches
    the target resolution/seed, rendering resumes from ``samples_done``.
    Returns the final [H, W, 3] HDR image.
    """
    config = config or RenderConfig()
    cam = scene.camera
    h, w = cam.height, cam.width
    npix = h * w
    if scene.ray_depth == 0:
        return np.broadcast_to(
            np.asarray(scene.bg_color, dtype=np.float32), (h, w, 3)
        ).copy()

    fp = scene_fingerprint(scene, config)
    state = None
    if checkpoint_path and resume and os.path.exists(checkpoint_path):
        cand = RenderState.load(checkpoint_path)
        if (cand.width, cand.height, cand.seed) == (w, h, seed) and (
            cand.fingerprint in (0, fp)  # 0: legacy checkpoint, accept
        ):
            state = cand
        else:
            # A rejected checkpoint restarts from sample 0 — say so instead
            # of silently discarding the old accumulator.
            import sys

            print(
                f"checkpoint {checkpoint_path}: scene/config fingerprint or "
                "dims/seed mismatch — ignoring it and restarting from "
                "sample 0",
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

    from ..models.pathtracer import pick_chunk

    base = jax.random.key(seed)
    chunk = pick_chunk(config, npix)
    pass_spp = checkpoint_every or config.spp_per_pass
    # Frame pool (config.frame_pool): pool the whole frame per persistent
    # call so the drain tail is paid once per pass, not once per chunk.
    # Device executions get longer by npix/chunk — bound them with
    # checkpoint_every / spp_per_pass.
    frame_pool = config.frame_pool and config.compaction and npix > chunk
    pix_step = npix if frame_pool else chunk

    while state.samples_done < spp:
        todo = min(pass_spp, spp - state.samples_done)
        from ..models.pathtracer import render_chunk_persistent

        engine = render_chunk_persistent if config.compaction else render_chunk
        for start in range(0, npix, pix_step):
            n = min(pix_step, npix - start)
            if config.compaction:  # persistent engine also returns ray count
                if frame_pool:
                    pc, ar = jnp.asarray(n, jnp.int32), n
                else:
                    pc, ar = (
                        None if n == chunk else jnp.asarray(n, jnp.int32)
                    ), None
                rad, _nb = engine(
                    scene,
                    jnp.asarray(start, jnp.int32),
                    base,
                    jnp.asarray(state.samples_done, jnp.int32),
                    chunk,
                    todo,
                    config,
                    pix_count=pc,
                    accum_rows=ar,
                )
            else:
                rad = engine(
                    scene,
                    jnp.asarray(start, jnp.int32),
                    base,
                    jnp.asarray(state.samples_done, jnp.int32),
                    chunk,
                    todo,
                    config,
                )
            # render_chunk returns the mean over `todo`; accumulate the sum.
            state.accum[start : start + n] += np.asarray(rad[:n]) * todo
        state.samples_done += todo
        if checkpoint_path:
            state.save(checkpoint_path)
        if progress:
            progress(state.samples_done, spp)

    return state.image

"""Multi-device tests on the faked 8-device CPU mesh (conftest sets
--xla_force_host_platform_device_count=8)."""

import dataclasses

import jax
import numpy as np
import pytest

from tpu_pathtracer.models.pathtracer import render
from tpu_pathtracer.parallel.mesh import make_mesh, render_sharded
from tpu_pathtracer.scene.gltf import parse_gltf_scene
from tpu_pathtracer.utils.testscenes import make_cornell_gltf


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    p = make_cornell_gltf(str(tmp_path_factory.mktemp("s") / "c.gltf"))
    s = parse_gltf_scene(p, 1.0)
    return dataclasses.replace(s, camera=s.camera.with_dims(16, 16))


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_sharded_matches_single_device(scene):
    """Per-pixel counter RNG gives every pixel the same sample stream under
    any sharding, so sharded output matches the single-device render to fp
    scheduling noise (XLA may reassociate reductions for different shapes;
    psum reassociates the spp sum) — a few ulps, not MC-noise-scale drift."""
    want = render(scene, spp=8, seed=3)
    for rays, spp_axis in [(8, 1), (4, 2), (2, 4), (1, 8)]:
        mesh = make_mesh(rays=rays, spp=spp_axis)
        got = render_sharded(scene, spp=8, seed=3, mesh=mesh)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_sharded_uses_all_devices(scene):
    # smoke: just ensure a (2,4) mesh runs and returns finite values
    mesh = make_mesh(rays=2, spp=4)
    img = render_sharded(scene, spp=8, seed=0, mesh=mesh)
    assert np.isfinite(img).all()
    assert img.shape == (16, 16, 3)


def test_sharded_nondivisible_spp(scene):
    """spp that does NOT divide the spp mesh axis must be honored exactly
    (no silent rounding up — the samples rendered are exactly {0..spp-1})."""
    for spp in (3, 5, 7):
        want = render(scene, spp=spp, seed=11)
        mesh = make_mesh(rays=2, spp=4)
        got = render_sharded(scene, spp=spp, seed=11, mesh=mesh)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_sharded_sample_start_offset(scene):
    """sample_start shifts the counter stream: [0,4) + [4,8) == [0,8)."""
    lo = render_sharded(scene, spp=4, seed=3, mesh=make_mesh(rays=4, spp=2))
    hi = render_sharded(
        scene, spp=4, seed=3, mesh=make_mesh(rays=4, spp=2), sample_start=4
    )
    want = render(scene, spp=8, seed=3)
    np.testing.assert_allclose((lo + hi) / 2, want, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def big_scene(tmp_path_factory):
    """capacity > 1024: the sorted large-scene branch
    (per-bounce argsort permutation carries, leaf traversal, compaction)
    actually executes under shard_map (a 16x16 Cornell's capacity <= 1024
    takes the dense sweep)."""
    from tpu_pathtracer.utils.testscenes import make_sphere_field_gltf

    p = make_sphere_field_gltf(
        str(tmp_path_factory.mktemp("s") / "field.gltf"),
        n_spheres=8, subdiv=2, textured=True,
    )
    s = parse_gltf_scene(p, 2.0)
    # 8192 pixels = 2048 rays/rank on a rays=4 mesh.
    return dataclasses.replace(s, camera=s.camera.with_dims(128, 64))


def test_sharded_large_scene_sort_path(big_scene):
    """Sorted-branch parity under shard_map: the per-bounce permutation
    carries (perm/slot varying-axis typing is hand-managed) must reproduce
    the single-device render, and the psum'd measured-rays counter must
    equal the single-host count EXACTLY (each path's bounce count is a pure
    function of its (pixel, sample) counter stream, so the sum over paths is
    partition-invariant)."""
    assert int(big_scene.capacity) > 1024
    stats_single = {}
    want = render(big_scene, spp=2, seed=5, stats=stats_single)
    stats_sharded = {}
    mesh = make_mesh(rays=4, spp=2)
    got = render_sharded(
        big_scene, spp=2, seed=5, mesh=mesh, stats=stats_sharded
    )
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert stats_sharded["measured_rays"] > 0
    assert stats_sharded["measured_rays"] == stats_single["measured_rays"]


def test_multihost_checkpoint_resume(scene, tmp_path):
    """A killed-and-resumed multihost render matches the uninterrupted one
    BIT-exactly: pass sums accumulate in the same fp
    order, and sample_start makes the resumed slices the exact missing
    samples."""
    from tpu_pathtracer.parallel.multihost import render_multihost

    ck_full = str(tmp_path / "full.npz")
    want = render_multihost(
        scene, spp=8, seed=3, checkpoint_path=ck_full, checkpoint_every=4
    )
    # "Kill" after the first pass: render only 4 samples, then resume to 8.
    ck = str(tmp_path / "resume.npz")
    render_multihost(
        scene, spp=4, seed=3, checkpoint_path=ck, checkpoint_every=4
    )
    got = render_multihost(
        scene, spp=8, seed=3, checkpoint_path=ck, checkpoint_every=4
    )
    np.testing.assert_array_equal(got, want)


def test_multihost_single_process(scene):
    """With one process render_multihost degrades to the sharded render."""
    from tpu_pathtracer.parallel.multihost import (
        maybe_initialize_distributed,
        render_multihost,
    )

    assert maybe_initialize_distributed() is False
    img = render_multihost(scene, spp=8, seed=3)
    want = render(scene, spp=8, seed=3)
    np.testing.assert_allclose(img, want, rtol=0, atol=1e-5)


def test_multihost_two_processes(scene, tmp_path):
    """render_multihost's P>1 branch, executed for real: two jax.distributed
    CPU processes (4 faked devices each) render disjoint sample slices of a
    non-divisible spp and DCN-merge; rank 0's image must match the
    single-process render."""
    import os
    import socket
    import subprocess
    import sys

    p = make_cornell_gltf(str(tmp_path / "c.gltf"))
    out = str(tmp_path / "img.npy")
    with socket.socket() as s:  # free port for the coordinator
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    worker = os.path.join(
        os.path.dirname(__file__), "..", "scripts", "multihost_worker.py"
    )
    spp = 7  # odd on purpose: 4 + 3 split across the two hosts
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4")
    env.pop("JAX_PLATFORMS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(r), "2", f"localhost:{port}", p,
             str(spp), out],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for r in range(2)
    ]
    for pr in procs:
        try:
            _, err = pr.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multihost worker timed out")
        assert pr.returncode == 0, err[-2000:]
    got = np.load(out)
    want = render(scene, spp=spp, seed=3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_sharded_sobol_jitter_matches_single_device(scene):
    """The Owen-Sobol jitter stream is a pure function of (seed, pixel,
    sample) like every other draw, so sharded renders stay equal to
    single-device under jitter='sobol' too."""
    from tpu_pathtracer.config import RenderConfig

    config = RenderConfig(jitter="sobol")
    want = render(scene, spp=4, seed=9, config=config)
    got = render_sharded(
        scene, spp=4, seed=9, config=config, mesh=make_mesh(rays=2, spp=4)
    )
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # And it is genuinely a different estimator stream than uniform.
    assert np.abs(want - render(scene, spp=4, seed=9)).max() > 1e-4


def test_sharded_padded_tail_counter_parity(big_scene):
    """A frame whose pixel count does NOT divide the sharded chunk must
    exclude the padded tail from both radiance and measured_rays, exactly
    like the single-host render (code-review r4: render_pass_sharded
    originally spawned and counted out-of-frame pixel ids; partially-padded
    ranks exercise the per-rank pix_count clamp)."""
    s = dataclasses.replace(
        big_scene, camera=big_scene.camera.with_dims(120, 60)
    )
    stats_single = {}
    want = render(s, spp=2, seed=7, stats=stats_single)
    stats_sharded = {}
    got = render_sharded(
        s, spp=2, seed=7, mesh=make_mesh(rays=4, spp=2),
        stats=stats_sharded,
    )
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert stats_sharded["measured_rays"] > 0
    assert stats_sharded["measured_rays"] == stats_single["measured_rays"]


def test_multihost_two_process_desynced_checkpoint_resume(scene, tmp_path):
    """The pod resume-desync scenario, executed for real: two
    jax.distributed processes checkpoint to their OWN files, then rank 1
    'loses' its file (restarted host, fresh disk) and the job resumes.
    Without the rank-0 broadcast (code-review r4 finding) rank 1 would
    restart from sample 0 and run more allgather spans than rank 0 —
    a distributed hang.  With it, both hosts resume from rank 0's
    (samples_done, accum) and the final image matches the single-host
    render."""
    import os
    import socket
    import subprocess
    import sys

    p = make_cornell_gltf(str(tmp_path / "c.gltf"))
    out = str(tmp_path / "img.npy")
    ck = str(tmp_path / "ck{rank}.npz")
    worker = os.path.join(
        os.path.dirname(__file__), "..", "scripts", "multihost_worker.py"
    )
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4")
    env.pop("JAX_PLATFORMS", None)

    def run(spp):
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        procs = [
            subprocess.Popen(
                [sys.executable, worker, str(r), "2", f"localhost:{port}",
                 p, str(spp), out, ck, "4"],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True,
            )
            for r in range(2)
        ]
        for pr in procs:
            try:
                _, err = pr.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                pytest.fail("multihost worker timed out (resume desync?)")
            assert pr.returncode == 0, err[-2000:]

    run(4)  # both ranks checkpoint samples_done=4 to their own files
    assert os.path.exists(str(tmp_path / "ck0.npz"))
    os.remove(str(tmp_path / "ck1.npz"))  # rank 1 restarted on a fresh disk
    run(8)  # resume: rank 0 at 4, rank 1 at 0 -> broadcast realigns
    got = np.load(out)
    want = render(scene, spp=8, seed=3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

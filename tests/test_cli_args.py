"""CLI argv parsing parity: ``_strtol`` must match C ``strtol`` semantics
(src/main.cpp:23-25 parses width/height/samples with strtol base 10)."""

import pytest

from tpu_pathtracer.cli import _strtol


@pytest.mark.parametrize(
    "s,expected",
    [
        ("400", 400),
        (" 400", 400),  # strtol skips leading whitespace
        ("\t\n 400", 400),
        ("+12", 12),
        ("-7", -7),
        (" -7px", -7),  # trailing garbage ignored
        ("12ab", 12),
        ("ab", 0),  # no digits -> 0
        ("", 0),
        ("+", 0),
        ("+-3", 0),  # sign not followed by digits
        ("  ", 0),
        ("007", 7),
    ],
)
def test_strtol_parity(s, expected):
    assert _strtol(s) == expected


def test_cli_jitter_env(tmp_path, monkeypatch):
    """TPU_PATHTRACER_JITTER=sobol reaches the render through the 5-arg CLI
    (which has no flag slots): the image differs from the uniform-jitter
    render but converges to the same estimator (close means)."""
    import numpy as np

    from tpu_pathtracer.cli import render_scene_file
    from tpu_pathtracer.utils.testscenes import make_cornell_gltf

    p = make_cornell_gltf(str(tmp_path / "c.gltf"))
    a, _ = render_scene_file(p, 32, 32, 4, progress=False)
    monkeypatch.setenv("TPU_PATHTRACER_JITTER", "sobol")
    b, _ = render_scene_file(p, 32, 32, 4, progress=False)
    assert not np.array_equal(a, b)
    assert np.abs(np.mean(a, axis=(0, 1)) - np.mean(b, axis=(0, 1))).max() < 0.2


@pytest.mark.parametrize("env_set", [False, True])
def test_compile_cache_placement(tmp_path, monkeypatch, env_set):
    """setup_backend keeps the persistent compilation cache at the fixed
    in-checkout path, and sets no directory when JAX_COMPILATION_CACHE_DIR
    is set (JAX reads that itself).  The global config is restored."""
    import os

    import jax

    from tpu_pathtracer import cli

    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        cli.setup_backend()
        after = jax.config.jax_compilation_cache_dir
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cli.CACHE_DIR == os.path.join(repo, ".jax_cache")
    assert after == (before if env_set else cli.CACHE_DIR)


def test_cli_refuses_without_gpu(tmp_path):
    """With JAX_PLATFORMS unset and no GPU, the CLI exits 1 with a message
    naming the fix instead of rendering on the CPU."""
    import os
    import subprocess
    import sys

    from tpu_pathtracer.utils.testscenes import make_cornell_gltf

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["CUDA_VISIBLE_DEVICES"] = ""  # no card, even where there is one
    scene = make_cornell_gltf(str(tmp_path / "c.gltf"))
    out = tmp_path / "o.ppm"
    proc = subprocess.run(
        [sys.executable, os.path.join(repo, "main.py"), scene, "8", "8", "1",
         str(out)],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 1, proc.stderr[-2000:]
    assert "no GPU found" in proc.stderr
    assert not out.exists()

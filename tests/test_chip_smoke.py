"""chip_smoke.py's contract off the card: it refuses to run anywhere but a
GPU, and its last line has a fixed shape."""

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")


def _fake_nvidia_smi(tmp_path):
    """A stand-in nvidia-smi on PATH, so the run gets past phase (a)."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    tool = bin_dir / "nvidia-smi"
    tool.write_text("#!/bin/sh\necho 'Fake Card, 700.00 W'\n")
    tool.chmod(0o755)
    return dict(os.environ, PATH=f"{bin_dir}{os.pathsep}{os.environ['PATH']}")


def _run(args, env, cwd):
    return subprocess.run(
        [sys.executable, *args], env=env, cwd=cwd, capture_output=True,
        text=True, timeout=300,
    )


def test_refuses_non_gpu_backend(tmp_path):
    env = _fake_nvidia_smi(tmp_path)
    env["JAX_PLATFORMS"] = "cpu"
    proc = _run([SCRIPT], env, REPO)
    assert proc.returncode != 0
    assert "not 'gpu'" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_refuses_without_the_repo(tmp_path):
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(SCRIPT, alone / "chip_smoke.py")
    env = _fake_nvidia_smi(tmp_path)
    env.pop("PYTHONPATH", None)
    proc = _run(["chip_smoke.py"], env, str(alone))
    assert proc.returncode != 0
    assert "cannot import the renderer" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_result_line_shape():
    sys.path.insert(0, REPO)
    import chip_smoke

    class Dev:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    line = chip_smoke.result_line([Dev()])
    assert line == (
        '{"ok": true, "device": {"platform": "gpu", '
        '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}'
    )
    assert json.loads(chip_smoke.result_line([Dev()] * 4))["device"][
        "count"
    ] == 4

"""chip_smoke.py refuses to run without a GPU, and its pure helpers."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO_ROOT)

import chip_smoke  # noqa: E402


@pytest.mark.parametrize("args", [[], ["--four"]])
def test_refuses_cpu_backend(args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO_ROOT, "chip_smoke.py"), *args],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_block_z_separates_bias_from_noise():
    rng = np.random.default_rng(0)
    a = rng.random((80, 80, 3)).astype(np.float32)
    b = rng.random((80, 80, 3)).astype(np.float32)
    z_same, blocks = chip_smoke.block_z(a, b)
    assert blocks == 4 and z_same < chip_smoke.Z_MAX
    z_biased, _ = chip_smoke.block_z(a * 1.2, b)
    assert z_biased > chip_smoke.Z_MAX


@pytest.fixture
def no_side_effects(monkeypatch, tmp_path):
    """main() without the compile cache or the output directory."""
    from project3_cuda_path_tracer_tpu.utils import compile_cache
    monkeypatch.setattr(compile_cache, "enable_compile_cache", lambda: "")
    monkeypatch.setattr(chip_smoke, "OUT_DIR", str(tmp_path))


def test_ok_line_only_after_every_phase(monkeypatch, capsys,
                                        no_side_effects):
    """A failing phase propagates; the ok line is never printed."""
    class Dev:
        platform, device_kind = "gpu", "fake"
    monkeypatch.setattr(chip_smoke, "phase_device", lambda n: [Dev()] * n)
    monkeypatch.setattr(chip_smoke, "phase_build", lambda: None)
    monkeypatch.setattr(chip_smoke, "phase_forward", lambda cpu: None)

    def boom(cpu):
        raise AssertionError("train failed")
    monkeypatch.setattr(chip_smoke, "phase_train", boom)
    with pytest.raises(AssertionError, match="train failed"):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_ok_line_is_last_and_exact(monkeypatch, capsys, no_side_effects):
    class Dev:
        platform, device_kind = "gpu", "fake"
    monkeypatch.setattr(chip_smoke, "phase_device", lambda n: [Dev()] * n)
    for name in ("phase_build", "phase_sweep", "phase_gpu_tests"):
        monkeypatch.setattr(chip_smoke, name, lambda: None)
    for name in ("phase_forward", "phase_train"):
        monkeypatch.setattr(chip_smoke, name, lambda cpu: None)
    monkeypatch.setattr(chip_smoke, "phase_mesh", lambda: None)
    assert chip_smoke.main([]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"ok": True, "device": {
        "platform": "gpu", "kind": "fake", "count": 1}}

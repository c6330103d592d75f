"""Two-process `jax.distributed` rendering (SURVEY §5.8, the multi-host
claim actually executed).

Spawns two OS processes (coordinator + worker, Gloo collectives on the CPU
backend, 2 virtual devices each => a 4-device GLOBAL mesh), renders cornell
sharded across both processes via tools/mp_worker.py, assembles the
addressable shards each process wrote, and asserts the image equals a
single-process render with the same seed — proving init_distributed /
make_mesh / ShardedRenderer work across process boundaries, not just on a
single-process virtual mesh.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from project3_cuda_path_tracer_tpu import load_scene
from project3_cuda_path_tracer_tpu.render.integrator import Renderer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tools", "mp_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_render_matches_single(tmp_path):
    port = _free_port()
    env = dict(os.environ)  # workers force the CPU backend themselves
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, "--pid", str(i), "--nproc", "2",
             "--port", str(port), "--outdir", str(tmp_path),
             "--res", "32", "--spp", "4", "--depth", "4", "--seed", "5"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(2)
    ]
    outs = [p.communicate(timeout=240)[0].decode() for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}"

    # Assemble the global accumulator from the per-process shard files.
    shards = sorted(os.listdir(tmp_path))
    assert len([f for f in shards if f.startswith("shard_")]) == 4
    rows = {}
    for f in shards:
        if f.startswith("shard_"):
            rows[int(f[len("shard_"):-4])] = np.load(tmp_path / f)
    accum = np.concatenate([rows[k] for k in sorted(rows)], axis=0)
    assert accum.shape == (32, 32, 3)

    s = load_scene("scenes/cornell.txt")
    s.camera.resolution = (32, 32)
    s.camera.derive()
    s.settings.trace_depth = 4
    single = Renderer(s)
    single.render(4, seed=5)
    np.testing.assert_allclose(accum, np.asarray(single.accum), atol=1e-5)

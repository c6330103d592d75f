"""Live-path histogram / compaction-ratio diagnostics."""
import numpy as np

from project3_cuda_path_tracer_tpu import load_scene
from project3_cuda_path_tracer_tpu.render.diagnostics import (
    live_path_histogram, compaction_ratios)


def test_live_paths_monotonically_decrease():
    s = load_scene("scenes/cornell.txt")
    s.camera.resolution = (32, 32)
    s.camera.derive()
    s.settings.trace_depth = 5
    h = live_path_histogram(s)
    assert h[0] == 32 * 32
    assert (np.diff(h) <= 0).all()
    # cornell: most paths survive bounce 1 (walls), some die on the light
    assert h[1] > 0.5 * h[0]


def test_compaction_ratios_bounded():
    s = load_scene("scenes/sphere.txt")
    s.camera.resolution = (16, 16)
    s.camera.derive()
    s.settings.trace_depth = 3
    r = compaction_ratios(s)
    assert r[0] == 1.0
    assert (r >= 0).all() and (r <= 1).all()
    # sphere scene: everything hits the light or misses on bounce 0
    assert r[1] == 0.0

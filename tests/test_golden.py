"""Golden-image regression tests (SURVEY §4 item 1).

The converged correctness anchor is the repository's own cornell render
(renders/cornell_5000spp.png, 800x800 @ 5000 spp, scenes/cornell.txt).
Two guards:

1. `test_reference_golden_image`: render cornell at 200x200 x 200 spp
   (~50 s on the CPU backend) and compare against the block-mean-downsampled
   golden. The mirror-sphere region is thresholded separately (mirror
   paths converge slowest). A BSDF, wall-color, light, or
   x-mirror regression fails this test — an x-flip alone pushes the
   non-sphere diff from ~0.027 to ~0.3.

2. `test_self_golden_bitwise`: pinned-seed 64x64 x 8 spp accumulator vs a
   committed artifact — catches ANY numerical change in the default
   pipeline exactly. Regenerate deliberately with
   tools/gen_assets.py --self-golden after an intentional estimator change.
"""
import os

import numpy as np
import pytest

from project3_cuda_path_tracer_tpu import load_scene
from project3_cuda_path_tracer_tpu.render.integrator import Renderer
from project3_cuda_path_tracer_tpu.utils.image import read_png

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN_PNG = os.path.join(os.path.dirname(HERE), "renders",
                          "cornell_5000spp.png")
SELF_GOLDEN = os.path.join(HERE, "golden_cornell_64x64_8spp_seed123.npz")


def _render_cornell(res, spp, seed=None):
    s = load_scene("scenes/cornell.txt")
    s.camera.resolution = (res, res)
    s.camera.derive()
    r = Renderer(s)
    r.render(spp, seed=seed)
    return r


@pytest.mark.skipif(not os.path.exists(GOLDEN_PNG),
                    reason="converged golden render not present")
@pytest.mark.slow
def test_reference_golden_image():
    golden = read_png(GOLDEN_PNG).astype(np.float64)
    g = golden.reshape(200, 4, 200, 4, 3).mean(axis=(1, 3))

    r = _render_cornell(200, 200)
    img = np.clip(r.image(), 0.0, 1.0)
    d = np.abs(img - g).mean(axis=-1)

    yy, xx = np.mgrid[0:200, 0:200]
    sphere = (yy - 118) ** 2 + (xx - 100) ** 2 < 45 ** 2

    # Measured healthy values: overall 0.0353, non-sphere 0.0274,
    # sphere-region 0.0769 (fake-diffuse golden). Thresholds leave ~30%
    # headroom for Monte Carlo noise while failing hard on real regressions.
    assert d.mean() < 0.046, f"overall golden diff {d.mean():.4f}"
    assert d[~sphere].mean() < 0.036, \
        f"non-sphere golden diff {d[~sphere].mean():.4f}"
    # Orientation check: left wall red-dominant, right wall green-dominant
    # in BOTH images (catches a silent x-mirror regression directly).
    left, right = img[80:120, 8:28], img[80:120, 172:192]
    assert left[..., 0].mean() > 1.5 * left[..., 2].mean()
    assert right[..., 1].mean() > 1.5 * right[..., 0].mean()


def test_self_golden_bitwise():
    want = np.load(SELF_GOLDEN)["accum"]
    r = _render_cornell(64, 8, seed=123)
    got = np.asarray(r.accum, dtype=np.float32)
    np.testing.assert_array_equal(got, want)

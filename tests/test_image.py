"""Image I/O tests: PNG/HDR round-trips and saveImage semantics
(reference: src/image.cpp:22-45, src/main.cpp:78-99)."""
import numpy as np

from project3_cuda_path_tracer_tpu.utils import image as img_io


def test_png_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, size=(13, 17, 3), dtype=np.uint8)
    p = str(tmp_path / "t.png")
    img_io.write_png(p, img)
    back = img_io.read_png(p)
    np.testing.assert_allclose(back, img.astype(np.float32) / 255.0,
                               atol=1e-6)


def test_reference_golden_png_loads():
    ref = img_io.read_png("renders/cornell_5000spp.png")
    assert ref.shape == (800, 800, 3)
    assert 0.05 < ref.mean() < 0.3


def test_hdr_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    img = (rng.random((8, 9, 3)) * 10.0).astype(np.float32)
    p = str(tmp_path / "t.hdr")
    img_io.write_hdr(p, img)
    back = img_io.read_hdr(p)
    # RGBE: shared exponent -> small channels only accurate to the max
    # channel's quantum (scale/2 = max/256 per texel)
    quantum = img.max(axis=-1, keepdims=True) / 128.0
    assert (np.abs(back - img) <= quantum + 1e-4).all()


def test_tonemap_no_gamma():
    acc = np.full((2, 2, 3), 2.0, np.float32)  # 4 iters -> 0.5
    out = img_io.tonemap(acc, 4)
    assert out.dtype == np.uint8
    np.testing.assert_array_equal(out, np.full((2, 2, 3), 127, np.uint8))


def test_save_render_divides_and_mirrors(tmp_path):
    acc = np.zeros((1, 4, 3), np.float32)
    acc[0, 0] = [2.0, 0.0, 0.0]  # leftmost pixel red
    base = str(tmp_path / "img")
    out = img_io.save_render(base, acc, 2)
    back = img_io.read_png(out)
    # x-mirrored: red lands at the rightmost pixel, value 1.0
    np.testing.assert_allclose(back[0, 3], [1, 0, 0], atol=1e-6)
    np.testing.assert_allclose(back[0, 0], [0, 0, 0], atol=1e-6)

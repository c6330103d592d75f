"""Adaptive sampling (render/adaptive.py): planner invariants, warmup
bitwise-equality with the uniform renderer, estimator unbiasedness, and
budget concentration on high-variance pixels."""
import numpy as np
import jax
import pytest

from project3_cuda_path_tracer_tpu import load_scene
from project3_cuda_path_tracer_tpu.render import adaptive as A
from project3_cuda_path_tracer_tpu.render import integrator as I
from project3_cuda_path_tracer_tpu.scene import types as T


@pytest.fixture(scope="module")
def cornell_small():
    s = load_scene("scenes/cornell.txt")
    s.camera.resolution = (32, 32)
    s.camera.derive()
    return s


def make(scene, **kw):
    st = T.RenderSettings(**{**scene.settings.__dict__, **kw})
    return I.Renderer(scene, settings=st)


# ---------------------------------------------------------------- planner

def test_apportion_sums_and_proportions():
    n = A.apportion(np.array([1.0, 3.0, 0.0, 4.0]), 800)
    assert n.sum() == 800
    assert n[2] == 0
    assert abs(n[1] - 300) <= 1 and abs(n[3] - 400) <= 1


def test_apportion_degenerate_weights():
    n = A.apportion(np.zeros(7), 21)
    assert n.sum() == 21 and (n == 3).all()


def test_plan_epoch_mapping_invariants():
    h = w = 8
    rng = np.random.default_rng(0)
    count = np.full((h, w), 4.0)
    accum = rng.uniform(0.1, 1.0, (h, w, 3)) * count[..., None]
    # one pixel with huge variance
    lum = (accum[..., 0] * 0.2126 + accum[..., 1] * 0.7152
           + accum[..., 2] * 0.0722)
    accum2 = (lum / count) ** 2 * count + 1e-4
    accum2[3, 5] += 50.0
    pix, surr, cimg = A.plan_epoch(accum, accum2, count)
    pix, surr = np.asarray(pix), np.asarray(surr)
    assert pix.shape == (h * w,)
    assert (pix >= 0).all() and (pix < h * w).all()
    # count image == bincount of the mapping
    assert (np.bincount(pix, minlength=h * w).reshape(h, w)
            == cimg.astype(np.int64)).all()
    # surrogates unique (distinct sample streams for co-located paths)
    assert len(np.unique(surr)) == len(surr)
    # the high-variance pixel got more than the uniform share
    assert cimg[3, 5] > 1


def test_identity_plan_tile_swizzle_is_permutation():
    pix, surr, cimg = A.identity_plan(64, 32, tile=32)
    pix = np.asarray(pix)
    assert (np.sort(pix) == np.arange(64 * 32)).all()
    assert (np.asarray(surr) == pix).all()
    assert (cimg == 1).all()


# ------------------------------------------------------------- rendering

def test_warmup_epoch_matches_uniform_bitwise(cornell_small):
    """The first (identity-mapped) adaptive epoch accumulates bitwise the
    same image as the uniform renderer with the same seed."""
    r_u = make(cornell_small, adaptive=False)
    r_u.render(4)
    r_a = make(cornell_small, adaptive=True, adaptive_epoch=8)
    r_a.render(4)
    assert (np.asarray(r_a.accum) == np.asarray(r_u.accum)).all()
    assert (r_a.count == 4.0).all()
    assert np.allclose(r_a.image(), r_u.image())


def test_adaptive_mean_unbiased(cornell_small):
    """Past the warmup the per-pixel mean stays consistent with the
    uniform estimate (same scene, independent seeds, loose tolerance)."""
    r_u = make(cornell_small, adaptive=False, seed=5)
    r_u.render(48)
    r_a = make(cornell_small, adaptive=True, adaptive_epoch=8, seed=11)
    r_a.render(48)
    mu, ma = r_u.image(), r_a.image()
    assert abs(float(mu.mean()) - float(ma.mean())) < 0.02
    # per-pixel agreement within Monte-Carlo noise at 48ish spp
    assert float(np.abs(mu - ma).mean()) < 0.12


def test_adaptive_reallocates_budget(cornell_small):
    """After a re-plan the counts differ across pixels but every
    iteration still spends exactly W*H paths."""
    r = make(cornell_small, adaptive=True, adaptive_epoch=4)
    r.render(12)
    cnt = r.count
    assert cnt.sum() == 12 * 32 * 32
    assert cnt.std() > 0.0         # non-uniform after re-plans
    assert r.iteration == 12


def test_adaptive_rejects_sort_compact(cornell_small):
    r = make(cornell_small, adaptive=True, sort_materials=True)
    with pytest.raises(ValueError, match="adaptive"):
        r.render(1)


@pytest.mark.slow
def test_adaptive_checkpoint_resume(cornell_small):
    """checkpoint_extras/restore_extras reproduce an uninterrupted run:
    counts exactly, radiance to float re-association tolerance (the
    path-space chunk accumulation regroups sums across the split)."""
    r1 = make(cornell_small, adaptive=True, adaptive_epoch=8)
    r1.render(24)
    r2 = make(cornell_small, adaptive=True, adaptive_epoch=8)
    r2.render(14)  # mid-epoch split
    extras = r2.checkpoint_extras()
    accum, it = np.asarray(r2.accum), r2.iteration
    r3 = make(cornell_small, adaptive=True, adaptive_epoch=8)
    import jax.numpy as jnp
    r3.accum = jnp.asarray(accum)
    r3.iteration = it
    r3.restore_extras(extras)
    r3.render(10)
    assert (r3.count == r1.count).all()
    np.testing.assert_allclose(np.asarray(r3.accum), np.asarray(r1.accum),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np.asarray(r3.accum2),
                               np.asarray(r1.accum2), rtol=2e-5, atol=2e-5)


def test_adaptive_cli_flag(tmp_path):
    from project3_cuda_path_tracer_tpu.app import cli
    rc = cli.main(["scenes/cornell.txt", "--adaptive", "--sort"])
    assert rc == 2  # incompatible combination is refused


# ----------------------------------------------------------- sharded

def test_sharded_adaptive_warmup_matches_single(cornell_small):
    """Under --stratified every sample dim is pixel-keyed, so the
    sharded adaptive warmup (identity plans) is bitwise the single-device
    adaptive warmup — shard_map locality must not change the estimator."""
    from project3_cuda_path_tracer_tpu.parallel.sharding import (
        ShardedRenderer)
    st = dict(adaptive=True, adaptive_epoch=8, stratified=True)
    single = make(cornell_small, **st)
    single.render(4)
    sharded = ShardedRenderer(cornell_small, settings=T.RenderSettings(
        **{**cornell_small.settings.__dict__, **st}))
    sharded.render(4)
    a = np.asarray(single.accum)
    b = np.asarray(jax.device_get(sharded.accum))
    np.testing.assert_allclose(a, b, atol=1e-6)
    assert (sharded.count == 4.0).all()


@pytest.mark.slow
def test_sharded_adaptive_checkpoint_resume(cornell_small):
    """ShardedRenderer.checkpoint_extras/restore_extras reproduce an
    uninterrupted sharded adaptive run across a mid-epoch split (the
    `--adaptive --sharded` resume path in app/cli.py)."""
    from project3_cuda_path_tracer_tpu.parallel.sharding import (
        ShardedRenderer)
    import jax.numpy as jnp

    def mk():
        st = T.RenderSettings(**{**cornell_small.settings.__dict__,
                                 "adaptive": True, "adaptive_epoch": 8})
        return ShardedRenderer(cornell_small, settings=st)

    r1 = mk()
    r1.render(24)
    r2 = mk()
    r2.render(14)  # mid-epoch split
    extras = r2.checkpoint_extras()
    accum, it = np.asarray(jax.device_get(r2.accum)), r2.iteration
    r3 = mk()
    r3.accum = jax.device_put(jnp.asarray(accum), r3.accum_sharding)
    r3.iteration = it
    r3.restore_extras(extras)
    r3.render(10)
    assert (r3.count == r1.count).all()
    np.testing.assert_allclose(np.asarray(jax.device_get(r3.accum)),
                               np.asarray(jax.device_get(r1.accum)),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np.asarray(jax.device_get(r3.accum2)),
                               np.asarray(jax.device_get(r1.accum2)),
                               rtol=2e-5, atol=2e-5)


def test_sharded_adaptive_plans_stay_shard_local(cornell_small):
    """Past the warmup each path's pixel stays inside its shard's row
    block (plan_epoch_sharded invariant) and the budget is conserved."""
    from project3_cuda_path_tracer_tpu.parallel.sharding import (
        ShardedRenderer)
    st = T.RenderSettings(**{**cornell_small.settings.__dict__,
                             "adaptive": True, "adaptive_epoch": 4})
    r = ShardedRenderer(cornell_small, settings=st)
    r.render(12)
    pix = np.asarray(r._plan[0])
    h = w = 32
    ndev = 8
    n_loc = (h // ndev) * w
    for d in range(ndev):
        blk = pix[d * n_loc:(d + 1) * n_loc]
        assert (blk >= d * n_loc).all() and (blk < (d + 1) * n_loc).all()
    assert r.count.sum() == 12 * h * w
    assert r.count.std() > 0.0
    # estimator still sane
    img = r.image()
    assert 0.05 < float(img.mean()) < 0.5


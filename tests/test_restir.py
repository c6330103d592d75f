"""Temporal ReSTIR (--restir M; render/integrator.py reservoir block).

Extends the tested RIS baseline (tests/test_ris.py) with per-pixel
temporal reservoir reuse across progressive iterations (Bitterli et al.
2020, temporal half). Covered here:

  * reservoir wiring: M-cap growth, invalid-slot invalidation;
  * estimator agreement with plain NEE in expectation, and the
    documented temporal-selection bias measured against a 3-seed
    plain-NEE truth (it must be small relative to the truth signal);
  * the honest accumulation contract: temporal reuse correlates
    consecutive frames, so at equal spp restir is bounded-close to
    fresh RIS, not better (measured 0.94-1.00x quality across the spp
    sweep);
  * checkpoint extras round-trip (stream-identical resume);
  * CLI flag wiring + incompatibility exits.

Equal-TIME RMSE is a chip measurement (CPU timings would be meaningless
for the kernel mix); no H100 number exists yet (ROADMAP A9).
"""
import numpy as np
import pytest

from project3_cuda_path_tracer_tpu import load_scene
from project3_cuda_path_tracer_tpu.render import integrator as I
from project3_cuda_path_tracer_tpu.scene import types as T


@pytest.fixture(scope="module")
def manylights_small():
    s = load_scene("scenes/manylights.txt")
    s.camera.resolution = (32, 32)
    s.camera.derive()
    s.settings.trace_depth = 4
    return s


def make(scene, **kw):
    st = T.RenderSettings(**{**scene.settings.__dict__, **kw})
    return I.Renderer(scene, settings=st)


def render(scene, spp, **kw):
    r = make(scene, **kw)
    r.render(spp)
    return r.image()


def test_restir_cfg_and_reservoir_shapes(manylights_small):
    r = make(manylights_small, restir=4, seed=0)
    assert r.cfg.restir and r.cfg.nee and r.cfg.nee_ris == 4
    n = 32 * 32
    assert set(r.reservoir) == {"lpx", "lpy", "lpz", "lnx", "lny", "lnz",
                                "lex", "ley", "lez", "W", "M"}
    assert all(v.shape == (n,) for v in r.reservoir.values())
    assert float(np.asarray(r.reservoir["M"]).max()) == 0.0


@pytest.mark.slow
def test_reservoir_m_growth_and_cap(manylights_small):
    """M grows by the per-frame candidate count each merge and clamps at
    restir_cap * M. Slots legitimately RESTART mid-stream (AA-jittered
    silhouette pixels flip hit/miss between frames), so the invariants
    are: every M is a multiple of the
    per-frame count, some pixel reaches the unbroken-streak value, and
    the cap is never exceeded."""
    r = make(manylights_small, restir=4, restir_cap=5.0, seed=2,
             antialias=False)
    r.step_many(3)
    m = np.asarray(r.reservoir["M"])
    assert (m > 0).any()
    assert np.allclose(m % 4.0, 0.0)
    assert float(m.max()) == pytest.approx(12.0)
    r.step_many(17)   # 20 iterations total: 80 > cap = 5 * 4 = 20
    m = np.asarray(r.reservoir["M"])
    assert float(m.max()) == pytest.approx(20.0)
    assert np.allclose(m % 4.0, 0.0)
    # miss/emissive slots stay invalidated
    assert float(m.min()) == 0.0


@pytest.mark.slow
def test_reservoir_m_growth_under_aa(manylights_small):
    """Same invariants hold under the default stochastic AA."""
    r = make(manylights_small, restir=4, restir_cap=5.0, seed=2)
    r.step_many(3)
    m = np.asarray(r.reservoir["M"])
    assert np.allclose(m % 4.0, 0.0)
    assert float(m.max()) == pytest.approx(12.0)


@pytest.mark.slow
def test_restir_matches_nee_in_expectation(manylights_small):
    """The temporal estimator must agree with plain NEE in expectation
    (independent seeds). ReSTIR's documented temporal-selection bias is
    second-order at these depths; the tolerance reflects MC noise."""
    plain = render(manylights_small, 96, nee=True, seed=3)
    restir = render(manylights_small, 96, restir=4, seed=9)
    assert abs(float(plain.mean()) - float(restir.mean())) < 0.02
    assert float(np.abs(plain - restir).mean()) < 0.08


@pytest.mark.slow
def test_restir_bias_vs_three_seed_truth(manylights_small):
    """Measure the temporal-selection bias (the stored winner was
    SELECTED under the previous iteration's jittered shading point)
    against a 3-seed plain-NEE truth: the mean shift must stay well
    under the truth's own seed-to-seed spread."""
    truth_imgs = [render(manylights_small, 256, nee=True, seed=s)
                  for s in (11, 22, 33)]
    truth = np.mean(truth_imgs, axis=0)
    spread = float(np.mean([abs(float(t.mean() - truth.mean()))
                            for t in truth_imgs]))
    restir = np.mean([render(manylights_small, 256, restir=4, seed=s)
                      for s in (44, 55)], axis=0)
    bias = abs(float(restir.mean()) - float(truth.mean()))
    # bias bounded by the truth's own MC uncertainty scale (x3 margin)
    assert bias < max(3.0 * spread, 0.01), (bias, spread)


@pytest.mark.slow
def test_restir_accumulation_regression_bound(manylights_small):
    """HONEST MEASURED CONTRACT: under
    progressive ACCUMULATION the temporal reservoir's reused winner
    correlates consecutive frames, so at equal spp it does NOT beat
    fresh RIS — measured 0.94-1.00x of fresh-RIS quality across the spp
    sweep (1..16). The contract tested here is
    the regression BOUND: restir accumulation RMSE stays within 12% of
    fresh RIS at 16 spp (it is a real-time/preview feature, and its
    progressive mode must never fall off a cliff)."""
    gt = render(manylights_small, 768, nee=True, seed=1)

    def rmse(img):
        return float(np.sqrt(((img - gt) ** 2).mean()))

    e_ris = np.mean([rmse(render(manylights_small, 16, nee=True,
                                 nee_ris=4, seed=s)) for s in (5, 7, 13)])
    e_restir = np.mean([rmse(render(manylights_small, 16, restir=4,
                                    seed=s)) for s in (5, 7, 13)])
    assert e_restir < 1.12 * e_ris, (e_restir, e_ris)


@pytest.mark.slow
def test_restir_checkpoint_resume_stream_identical(manylights_small):
    """16 iterations straight == 8 + checkpoint-extras round-trip + 8:
    the reservoir is loop-carried state and must be persisted."""
    ra = make(manylights_small, restir=4, seed=6)
    ra.step_many(16)

    rb = make(manylights_small, restir=4, seed=6)
    rb.step_many(8)
    extras = rb.checkpoint_extras()
    assert any(k.startswith("res_") for k in extras)

    rc = make(manylights_small, restir=4, seed=6)
    rc.accum = rb.accum
    rc.iteration = rb.iteration
    rc.restore_extras({k: np.asarray(v) for k, v in extras.items()})
    rc.step_many(8)

    np.testing.assert_array_equal(np.asarray(ra.accum), np.asarray(rc.accum))
    for k in ra.reservoir:
        np.testing.assert_array_equal(np.asarray(ra.reservoir[k]),
                                      np.asarray(rc.reservoir[k]))


def test_restir_resume_without_extras_fails(manylights_small):
    rc = make(manylights_small, restir=4, seed=6)
    with pytest.raises(ValueError, match="restir"):
        rc.restore_extras({})


def test_restir_requires_area_lights(tmp_path):
    """A scene with no emissive area lights disables restir with a
    warning instead of crashing."""
    f = tmp_path / "nolights.txt"
    f.write_text("""MATERIAL 0
RGB .5 .5 .5

CAMERA
RES 16 16
FOVY 45
ITERATIONS 4
DEPTH 2
FILE n
EYE 0 2 6
LOOKAT 0 2 0
UP 0 1 0

OBJECT 0
cube
material 0
TRANS 0 0 0
ROTAT 0 0 0
SCALE 4 .1 4
""")
    s = load_scene(str(f))
    r = make(s, restir=2)
    assert not r.cfg.restir
    r.render(2)   # falls back to a plain render


def test_restir_incompatible_modes(manylights_small):
    with pytest.raises(ValueError, match="restir"):
        make(manylights_small, restir=4, sort_materials=True)
    with pytest.raises(ValueError, match="restir"):
        make(manylights_small, restir=4, adaptive=True)


CLI_SCENE = """MATERIAL 0
RGB 1 1 1
EMITTANCE 5

MATERIAL 1
RGB .6 .6 .6

CAMERA
RES 24 24
FOVY 45
ITERATIONS 4
DEPTH 3
FILE c
EYE 0 2 6
LOOKAT 0 2 0
UP 0 1 0

OBJECT 0
cube
material 0
TRANS 0 6 0
ROTAT 0 0 0
SCALE 2 .2 2

OBJECT 1
cube
material 1
TRANS 0 0 0
ROTAT 0 0 0
SCALE 8 .1 8
"""


def test_cli_restir_flag(tmp_path):
    from project3_cuda_path_tracer_tpu.app.cli import main
    f = tmp_path / "small.txt"
    f.write_text(CLI_SCENE)
    out = tmp_path / "ml"
    rc = main([str(f), "--restir", "2", "--iterations", "2",
               "--out", str(out)])
    assert rc == 0
    import glob
    assert glob.glob(str(out) + "*.png")


def test_cli_restir_incompatible_exit(tmp_path):
    from project3_cuda_path_tracer_tpu.app.cli import main
    f = tmp_path / "small.txt"
    f.write_text(CLI_SCENE)
    assert main([str(f), "--restir", "2", "--sort"]) == 2

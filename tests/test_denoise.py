"""Edge-avoiding à-trous denoiser (render/denoise.py): noise reduction,
edge preservation, shift correctness, and Renderer/CLI wiring."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from project3_cuda_path_tracer_tpu import load_scene
from project3_cuda_path_tracer_tpu.render import denoise as dn
from project3_cuda_path_tracer_tpu.render.integrator import Renderer


def test_shift_edge_clamp():
    a = jnp.arange(12.0).reshape(3, 4, 1)
    s = np.asarray(dn._shift(a, 1, 0))  # content moves down, top row clamps
    np.testing.assert_array_equal(s[1, :, 0], np.asarray(a)[0, :, 0])
    np.testing.assert_array_equal(s[0, :, 0], np.asarray(a)[0, :, 0])
    s = np.asarray(dn._shift(a, 0, -2))  # content moves left
    np.testing.assert_array_equal(s[:, 0, 0], np.asarray(a)[:, 2, 0])
    np.testing.assert_array_equal(s[:, 3, 0], np.asarray(a)[:, 3, 0])


def test_flat_region_noise_shrinks_edges_survive():
    """Two constant half-planes with different normals + additive noise:
    the filter must cut in-region noise hard without mixing the halves."""
    rng = np.random.default_rng(0)
    h = w = 64
    clean = np.zeros((h, w, 3), np.float32)
    clean[:, : w // 2] = 0.2
    clean[:, w // 2:] = 0.9
    noisy = clean + rng.normal(0, 0.12, clean.shape).astype(np.float32)
    normal = np.zeros((h, w, 3), np.float32)
    normal[:, : w // 2, 1] = 1.0
    normal[:, w // 2:, 0] = 1.0
    pos = np.zeros((h, w, 3), np.float32)
    pos[..., 0] = np.arange(w)[None, :] * 0.02
    pos[..., 2] = np.arange(h)[:, None] * 0.02
    out = np.asarray(dn.atrous_denoise(jnp.asarray(noisy),
                                       jnp.asarray(normal),
                                       jnp.asarray(pos)))
    err_in = np.abs(out - clean)[:, 4:w // 2 - 4].mean()
    err_noisy = np.abs(noisy - clean)[:, 4:w // 2 - 4].mean()
    assert err_in < 0.35 * err_noisy            # flat regions smoothed
    left = out[:, w // 2 - 1].mean()
    right = out[:, w // 2].mean()
    assert right - left > 0.55                  # the edge survives


def test_albedo_gbuffer_classes():
    """cornell first-hit albedo plane: diffuse walls carry their material
    color; the mirror sphere carries the RELAYED factor spec_color x
    (reflected surface's albedo, or 1 on a reflected miss)."""
    s = load_scene("scenes/cornell.txt")
    s.camera.resolution = (64, 64)
    s.camera.derive()
    cfg = Renderer(s).cfg
    normal, pos, alb = dn.gbuffer(s, cfg, s.packed_meshes, albedo=True)
    alb = np.asarray(alb)
    assert alb.shape == (64, 64, 3)
    assert (alb >= 0).all() and (alb <= 1).all()
    # the red and green wall colors both appear (cornell.txt MATERIAL 2/3)
    for wall in ([.85, .35, .35], [.35, .85, .35]):
        assert np.isclose(alb, wall, atol=1e-3).all(axis=-1).any(), wall
    # the center pixel sees the mirror sphere head-on: the relayed ray
    # lands on the diffuse-white back wall -> factor = .98 (spec) x .98
    assert np.allclose(alb[32, 32], 0.98 * 0.98, atol=1e-3), alb[32, 32]
    # and somewhere on the sphere the relay lands on the red wall:
    # factors of spec x wall-color appear
    assert np.isclose(alb, [.98 * .85, .98 * .35, .98 * .35],
                      atol=2e-3).all(axis=-1).any()
    # with the relay off, mirror pixels fall back to factor 1
    _, _, alb0 = dn.gbuffer(s, cfg, s.packed_meshes, albedo=True,
                            relay=False)
    assert np.allclose(np.asarray(alb0)[32, 32], 1.0)


def test_gbuffer_unswizzles_tiled_path_order():
    """Mesh scenes emit paths tile-swizzled (TraceConfig.tile=32); the
    G-buffers must come back in row-major pixel order — regression for
    the block-scrambled G-buffer this produced."""
    import dataclasses
    s = load_scene("scenes/mesh.txt")
    s.camera.resolution = (64, 64)
    s.camera.derive()
    r = Renderer(s)
    assert r.cfg.tile == 32
    tiled = dn.gbuffer(s, r.cfg, s.packed_meshes, albedo=True)
    flat = dn.gbuffer(s, dataclasses.replace(r.cfg, tile=0),
                      s.packed_meshes, albedo=True)
    for a, b in zip(tiled, flat):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_demod_identity_when_albedo_one():
    """albedo == 1 must reproduce the undemodulated filter bitwise."""
    rng = np.random.default_rng(1)
    img = jnp.asarray(rng.uniform(0, 1, (16, 16, 3)).astype(np.float32))
    normal = jnp.zeros((16, 16, 3), jnp.float32)
    pos = jnp.zeros((16, 16, 3), jnp.float32)
    a = np.asarray(dn.atrous_denoise(img, normal, pos))
    b = np.asarray(dn.atrous_denoise(img, normal, pos,
                                     albedo=jnp.ones((16, 16, 3))))
    np.testing.assert_array_equal(a, b)


def test_demod_preserves_texture_detail():
    """Fine checker albedo x smooth illumination + noise: demodulated
    filtering must beat plain filtering (which treats albedo edges as
    noise/edges) by a wide margin."""
    rng = np.random.default_rng(2)
    h = w = 64
    yy, xx = np.mgrid[0:h, 0:w]
    checker = np.where(((yy // 2 + xx // 2) % 2) > 0, 0.9, 0.2)
    albedo = np.repeat(checker[:, :, None], 3, axis=-1).astype(np.float32)
    illum = (0.4 + 0.3 * np.sin(xx / 17.0) * np.cos(yy / 23.0)
             ).astype(np.float32)[:, :, None]
    clean = albedo * illum
    noisy = (albedo * (illum + rng.normal(0, 0.15, illum.shape))
             ).astype(np.float32)
    normal = np.zeros((h, w, 3), np.float32)
    normal[..., 1] = 1.0
    pos = np.zeros((h, w, 3), np.float32)
    pos[..., 0] = xx * 0.02
    pos[..., 2] = yy * 0.02
    plain = np.asarray(dn.atrous_denoise(
        jnp.asarray(noisy), jnp.asarray(normal), jnp.asarray(pos)))
    demod = np.asarray(dn.atrous_denoise(
        jnp.asarray(noisy), jnp.asarray(normal), jnp.asarray(pos),
        albedo=jnp.asarray(albedo)))
    rmse_plain = float(np.sqrt(((plain - clean) ** 2).mean()))
    rmse_demod = float(np.sqrt(((demod - clean) ** 2).mean()))
    assert rmse_demod < 0.6 * rmse_plain, (rmse_demod, rmse_plain)


def test_renderer_denoise_improves_low_spp(tmp_path):
    """4-spp cornell denoised must land closer to a 160-spp reference
    than raw 4-spp does (the point of the Project-4 extension)."""
    s = load_scene("scenes/cornell.txt")
    s.camera.resolution = (64, 64)
    s.camera.derive()
    s.settings.trace_depth = 4
    ref_r = Renderer(s)
    ref_r.render(160, seed=3)
    ref = ref_r.image()
    low = Renderer(s)
    low.render(4, seed=7)
    raw = low.image()
    den = low.denoised_accum()[:, ::-1, :] / 4
    rmse_raw = float(np.sqrt(((raw - ref) ** 2).mean()))
    rmse_den = float(np.sqrt(((den - ref) ** 2).mean()))
    assert rmse_den < 0.6 * rmse_raw, (rmse_den, rmse_raw)
    # save path writes a file
    out = low.save(str(tmp_path / "dn"), denoise=True)
    assert out.endswith(".png")


def test_cli_flag_parses():
    from project3_cuda_path_tracer_tpu.app.cli import build_parser
    args = build_parser().parse_args(["scene.txt", "--denoise"])
    assert args.denoise


def test_variance_guided_filter_runs_and_improves_raw():
    """SVGF-style variance guidance (atrous_denoise(variance_guided=True)):
    MEASURED across spp 4/16/64 on the cornell benchmark, the
    spatial-variance-guided filter does NOT beat the tuned fixed-sigma
    a-trous schedule (e.g. 0.0921 vs 0.0723 RMSE at 16 spp; true
    per-pixel MC variance from the adaptive accumulator wins only ~6% at
    4 spp and loses at 16), so the default stays
    fixed-sigma and no CLI flag promotes this mode. The pinned contract:
    the guided filter is finite and still a strong improvement over the
    raw image."""
    from project3_cuda_path_tracer_tpu.render import denoise as dn
    import jax.numpy as jnp
    s = load_scene("scenes/cornell.txt")
    s.camera.resolution = (64, 64)
    s.camera.derive()
    s.settings.trace_depth = 4
    ref_r = Renderer(s)
    ref_r.render(160, seed=3)
    ref = ref_r.image()
    low = Renderer(s)
    low.render(4, seed=7)
    raw = low.image()
    normal, pos, alb = dn.gbuffer(s, low.cfg, s.packed_meshes,
                                  albedo=True, relay=False)
    mean = jnp.asarray(low.accum) / 4
    out = np.asarray(dn.atrous_denoise(mean, normal, pos, albedo=alb,
                                       variance_guided=True))[:, ::-1, :]
    assert np.isfinite(out).all()
    rmse_raw = float(np.sqrt(((raw - ref) ** 2).mean()))
    rmse_sv = float(np.sqrt(((out - ref) ** 2).mean()))
    assert rmse_sv < 0.65 * rmse_raw, (rmse_sv, rmse_raw)

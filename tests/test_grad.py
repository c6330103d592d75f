"""Gradient correctness: jax.grad through the renderer vs finite differences
(BASELINE north star; SURVEY §7 step 6 — detached sampling makes the
continuous-parameter gradients unbiased, so with a FIXED RNG key the jax
gradient must match the finite-difference gradient of the same fixed-key
estimator to first order)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from project3_cuda_path_tracer_tpu import load_scene
from project3_cuda_path_tracer_tpu.render import integrator as integ
from project3_cuda_path_tracer_tpu.models.inverse import (
    RenderParams, render_image, mse_loss)


@pytest.fixture(scope="module")
def setup():
    s = load_scene("scenes/cornell.txt")
    s.camera.resolution = (16, 16)
    s.camera.derive()
    gt = tuple(int(x) for x in np.asarray(s.geoms.type))
    cfg = integ.TraceConfig(width=16, height=16, trace_depth=3,
                            antialias=False, geom_types=gt)
    key = jax.random.PRNGKey(0)
    params = RenderParams(materials=s.materials, cam=s.camera.flat())
    return s, cfg, key, params


def _loss_of(setup, params):
    s, cfg, key, _ = setup
    img = render_image(params, s.geoms, s.meshes, s.textures, key, cfg)
    return jnp.sum(img ** 2) / img.size


def _fd_check(setup, params, get, set_, eps, rtol=0.08, atol=1e-5):
    """Central finite difference along one scalar coordinate."""
    s, cfg, key, _ = setup
    loss = jax.jit(lambda p: _loss_of(setup, p))
    g = jax.grad(loss)(params)
    analytic = float(get(g))

    p_plus = set_(params, float(get(params)) + eps)
    p_minus = set_(params, float(get(params)) - eps)
    fd = (float(loss(p_plus)) - float(loss(p_minus))) / (2 * eps)
    assert np.isfinite(analytic)
    assert analytic == pytest.approx(fd, rel=rtol, abs=atol), \
        f"analytic={analytic} fd={fd}"
    return analytic, fd


def _set_mat_field(params, field, idx, value):
    import dataclasses
    arr = getattr(params.materials, field)
    arr = arr.at[idx].set(value)
    return params._replace(
        materials=dataclasses.replace(params.materials, **{field: arr}))


def test_grad_wrt_emittance(setup):
    _, _, _, params = setup
    a, fd = _fd_check(
        setup, params,
        get=lambda p: p.materials.emittance[0],
        set_=lambda p, v: _set_mat_field(p, "emittance", 0, v),
        eps=1e-2)
    assert a > 0  # brighter light -> larger mean-square image


def test_grad_wrt_albedo(setup):
    _, _, _, params = setup
    a, fd = _fd_check(
        setup, params,
        get=lambda p: p.materials.color[1][0],
        set_=lambda p, v: _set_mat_field(p, "color", (1, 0), v),
        eps=1e-2)
    assert a != 0.0


def test_grad_wrt_specular_color(setup):
    _, _, _, params = setup
    _fd_check(
        setup, params,
        get=lambda p: p.materials.specular_color[4][1],
        set_=lambda p, v: _set_mat_field(p, "specular_color", (4, 1), v),
        eps=1e-2)


def test_grad_wrt_camera_position(setup):
    """Camera gradients flow through ray generation (no geometric
    discontinuity handling needed for this smooth test: loss is smooth in
    position when samples are frozen)."""
    s, cfg, key, params = setup

    def set_campos(p, v):
        cam = dict(p.cam)
        cam["position"] = cam["position"].at[2].set(v)
        return p._replace(cam=cam)

    loss = jax.jit(lambda p: _loss_of(setup, p))
    g = jax.grad(loss)(params)
    analytic = float(g.cam["position"][2])
    eps = 1e-3
    z0 = float(params.cam["position"][2])
    fd = (float(loss(set_campos(params, z0 + eps)))
          - float(loss(set_campos(params, z0 - eps)))) / (2 * eps)
    assert np.isfinite(analytic)
    # visibility discontinuities make camera FD noisier; sign + magnitude
    assert analytic == pytest.approx(fd, rel=0.25, abs=1e-3)


def _fd_material_scalar(scene_path, field, idx, depth, res, eps,
                        rtol, key_seed=0):
    """FD-vs-analytic for a scalar material field on a scene with NEE
    wired (NEE's solid-angle pdfs give the loss its CONTINUOUS
    dependence on scatter directions; under the plain estimator a
    flat-wall scene's image is piecewise constant in them — cosine
    importance sampling cancels every geometric factor — so both
    gradients are trivially zero)."""
    import dataclasses
    s = load_scene(scene_path)
    s.camera.resolution = (res, res)
    s.camera.derive()
    gt = tuple(int(x) for x in np.asarray(s.geoms.type))
    cfg = integ.TraceConfig(width=res, height=res, trace_depth=depth,
                            antialias=False, geom_types=gt, glossy=True)
    cfg = integ._wire_nee(s, cfg)
    assert cfg.nee
    key = jax.random.PRNGKey(key_seed)
    params = RenderParams(materials=s.materials, cam=s.camera.flat())

    def loss(p):
        img = render_image(p, s.geoms, s.meshes, s.textures, key, cfg)
        return jnp.sum(img ** 2) / img.size

    g = jax.grad(loss)(params)
    analytic = float(np.asarray(getattr(g.materials, field))[idx])
    v0 = float(np.asarray(getattr(s.materials, field))[idx])
    # FD loss is reduced HOST-SIDE in float64: the device f32 scalar
    # loss has ~6e-8 ULPs at these magnitudes, and the true loss
    # difference over a workable eps is only a few ULPs — an f32-scalar
    # FD measures quantization, not the slope. The per-pixel image
    # changes are orders of magnitude above pixel ULPs, so an f64 sum
    # of the f32 image resolves the difference exactly.
    rimg = jax.jit(lambda p: render_image(p, s.geoms, s.meshes,
                                          s.textures, key, cfg))

    def loss64(p):
        img = np.asarray(rimg(p), np.float64)
        return float((img ** 2).sum() / img.size)

    def set_(v):
        m = dataclasses.replace(
            params.materials,
            **{field: getattr(params.materials, field).at[idx].set(v)})
        return params._replace(materials=m)

    fd = (loss64(set_(v0 + eps)) - loss64(set_(v0 - eps))) / (2 * eps)
    assert np.isfinite(analytic) and analytic != 0.0
    assert analytic == pytest.approx(fd, rel=rtol, abs=1e-7), \
        f"analytic={analytic} fd={fd}"


@pytest.mark.slow
def test_grad_wrt_ior():
    """REFRIOR gradient (north-star list; reference contract
    src/interactions.h:44-68): the refraction direction is a
    deterministic function of eta, kept differentiable since round 5
    (ops/wavefront.py scatter-direction gradient note), so jax.grad
    w.r.t. the glass IOR must match the fixed-key FD gradient. The
    residual mismatch budget is f32 FD quantization + the detached
    Fresnel-Bernoulli score term (documented)."""
    _fd_material_scalar('scenes/cornell_glass.txt', 'ior', 5,
                        depth=5, res=32, eps=1e-3, rtol=0.2)


@pytest.mark.slow
def test_grad_wrt_specular_exponent():
    """SPECEX gradient (the reference's roughness analogue,
    src/sceneStructs.h:33-35): flows through the reparameterized Phong
    sample cos_a = u^(1/(e+1)) and the NEE glossy MIS weight."""
    _fd_material_scalar('scenes/cornell_glossy.txt', 'specular_exponent',
                        4, depth=4, res=32, eps=0.25, rtol=0.15)


def test_mse_loss_grad_finite_everywhere(setup):
    s, cfg, key, params = setup
    target = jnp.zeros((16, 16, 3))
    g = jax.grad(mse_loss)(params, s.geoms, s.meshes, s.textures, key, cfg,
                           target)
    for leaf in jax.tree_util.tree_leaves(g):
        assert np.isfinite(np.asarray(leaf)).all()


@pytest.mark.slow
def test_inverse_rendering_recovers_albedo():
    """End-to-end inverse test: perturb the back-wall albedo, fit it back."""
    import dataclasses
    import optax
    s = load_scene("scenes/cornell.txt")
    s.camera.resolution = (16, 16)
    s.camera.derive()
    gt = tuple(int(x) for x in np.asarray(s.geoms.type))
    cfg = integ.TraceConfig(width=16, height=16, trace_depth=2,
                            antialias=False, geom_types=gt)

    true_params = RenderParams(materials=s.materials, cam=s.camera.flat())
    # average a few keys for a stable target
    keys = [jax.random.PRNGKey(i) for i in range(4)]
    render = jax.jit(lambda p, k: render_image(
        p, s.geoms, s.meshes, s.textures, k, cfg))
    target = jnp.mean(jnp.stack([render(true_params, k) for k in keys]), 0)

    # perturb material 1 (white walls) albedo down to 0.5
    bad_mats = dataclasses.replace(
        s.materials, color=s.materials.color.at[1].set(jnp.array([0.5] * 3)))
    params = RenderParams(materials=bad_mats, cam=true_params.cam)

    opt = optax.adam(5e-2)
    opt_state = opt.init(params)

    from project3_cuda_path_tracer_tpu.models.inverse import (
        unbiased_mse_grad_loss)

    @jax.jit
    def step(params, opt_state, key):
        loss_fn = lambda p: unbiased_mse_grad_loss(
            p, s.geoms, s.meshes, s.textures, key, cfg, target)
        loss, grads = jax.value_and_grad(loss_fn)(params)
        # only optimize the albedo (freeze everything else)
        grads = RenderParams(
            materials=dataclasses.replace(
                jax.tree_util.tree_map(jnp.zeros_like, params.materials),
                color=grads.materials.color),
            cam=jax.tree_util.tree_map(jnp.zeros_like, params.cam))
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    key = jax.random.PRNGKey(7)
    tail = []
    for i in range(250):
        key, k = jax.random.split(key)
        params, opt_state, loss = step(params, opt_state, k)
        if i >= 150:  # Polyak-average the noisy tail iterates
            tail.append(np.asarray(params.materials.color[1]))

    recovered = np.stack(tail).mean(axis=0)
    np.testing.assert_allclose(recovered, 0.98, atol=0.2)


@pytest.mark.slow
def test_grad_through_mesh_scene():
    """Mesh scenes: the winning triangle is a detached decision but hit
    attributes are recomputed differentiably (differentiable_mesh), so
    gradients w.r.t. the mesh material's albedo must match finite
    differences."""
    import dataclasses
    s = load_scene("scenes/mesh.txt")
    s.camera.resolution = (32, 32)
    s.camera.derive()
    gt = tuple(int(x) for x in np.asarray(s.geoms.type))
    cfg = integ.TraceConfig(
        width=32, height=32, trace_depth=3, antialias=False,
        geom_types=gt,
        mesh_ids=tuple(int(m) for m in np.asarray(s.geoms.mesh_id)),
        unroll=True, differentiable_mesh=True)
    key = jax.random.PRNGKey(0)

    def loss(params):
        img = render_image(params, s.geoms, s.meshes, s.textures, key, cfg,
                           packed_meshes=s.packed_meshes)
        return jnp.sum(img ** 2) / img.size

    params = RenderParams(materials=s.materials, cam=s.camera.flat())
    g = jax.grad(loss)(params)
    analytic = float(g.materials.color[2][0])  # the mesh material's red
    assert np.isfinite(analytic) and analytic != 0.0

    eps = 1e-2
    def set_c(v):
        m = dataclasses.replace(
            params.materials,
            color=params.materials.color.at[2, 0].set(v))
        return params._replace(materials=m)
    c0 = float(params.materials.color[2][0])
    jloss = jax.jit(loss)
    fd = (float(jloss(set_c(c0 + eps))) - float(jloss(set_c(c0 - eps)))) / (2 * eps)
    assert analytic == pytest.approx(fd, rel=0.08, abs=1e-5)


@pytest.mark.slow
def test_train_scan_matches_sequential_steps():
    """make_train_scan (the one-dispatch production loop) must produce the
    same losses and parameters as the equivalent make_train_step sequence
    (same fold_in RNG schedule, same optimizer)."""
    from project3_cuda_path_tracer_tpu.models.inverse import (
        RenderParams, make_train_step, make_train_scan)
    s = load_scene("scenes/cornell.txt")
    s.camera.resolution = (16, 16)
    s.camera.derive()
    gt = tuple(int(x) for x in np.asarray(s.geoms.type))
    cfg = integ.TraceConfig(width=16, height=16, trace_depth=3,
                            antialias=False, geom_types=gt)
    target = jnp.zeros((16, 16, 3), jnp.float32)
    key = jax.random.PRNGKey(4)
    N = 3

    def fresh():
        return jax.tree_util.tree_map(
            jnp.array, RenderParams(materials=s.materials,
                                    cam=s.camera.flat()))

    opt, step = make_train_step(s.geoms, s.meshes, s.textures, cfg)
    p = fresh()
    st = opt.init(p)
    seq_losses = []
    for i in range(N):
        p, st, loss = step(p, st, jax.random.fold_in(key, i), target)
        seq_losses.append(float(loss))

    opt2, run = make_train_scan(s.geoms, s.meshes, s.textures, cfg,
                                num_steps=N, history=False)
    p2 = fresh()
    st2 = opt2.init(p2)
    p2, st2, losses = run(p2, st2, key, target)

    np.testing.assert_allclose(np.asarray(losses), seq_losses, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(p2.materials.color),
                               np.asarray(p.materials.color), atol=1e-6)


@pytest.mark.slow
def test_history_loss_grad_equals_unbiased_when_residual_is_fresh():
    """With the residual supplied as an independent same-params render,
    history_residual_grad_loss's gradient must equal
    unbiased_mse_grad_loss's gradient exactly (identical computation
    graph — the history form just hoists the detached factor out)."""
    from project3_cuda_path_tracer_tpu.models.inverse import (
        unbiased_mse_grad_loss, history_residual_grad_loss, render_image)
    s = load_scene("scenes/cornell.txt")
    s.camera.resolution = (16, 16)
    s.camera.derive()
    gt = tuple(int(x) for x in np.asarray(s.geoms.type))
    cfg = integ.TraceConfig(width=16, height=16, trace_depth=3,
                            antialias=False, geom_types=gt)
    params = RenderParams(materials=s.materials, cam=s.camera.flat())
    target = jnp.full((16, 16, 3), 0.25, jnp.float32)
    key = jax.random.PRNGKey(12)
    k_primal, k_diff = jax.random.split(key)

    g_two = jax.grad(unbiased_mse_grad_loss)(
        params, s.geoms, s.meshes, s.textures, key, cfg, target)

    residual = render_image(params, s.geoms, s.meshes, s.textures,
                            k_primal, cfg)
    g_hist = jax.grad(
        lambda p: history_residual_grad_loss(
            p, s.geoms, s.meshes, s.textures, k_diff, cfg, target,
            residual)[0])(params)

    for a, b in zip(jax.tree_util.tree_leaves(g_two),
                    jax.tree_util.tree_leaves(g_hist)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-6, atol=1e-7)


def test_history_scan_matches_sequential_history_steps():
    """make_train_scan(history=True) must produce the same losses, params
    and history EMA as the equivalent make_train_step(history=True)
    sequence (same fold_in schedule, same seed render)."""
    from project3_cuda_path_tracer_tpu.models.inverse import (
        RenderParams, make_train_step, make_train_scan, make_seed_history)
    s = load_scene("scenes/cornell.txt")
    s.camera.resolution = (16, 16)
    s.camera.derive()
    gt = tuple(int(x) for x in np.asarray(s.geoms.type))
    cfg = integ.TraceConfig(width=16, height=16, trace_depth=3,
                            antialias=False, geom_types=gt)
    target = jnp.zeros((16, 16, 3), jnp.float32)
    key = jax.random.PRNGKey(4)
    N = 3

    def fresh():
        return jax.tree_util.tree_map(
            jnp.array, RenderParams(materials=s.materials,
                                    cam=s.camera.flat()))

    seed_hist = make_seed_history(s.geoms, s.meshes, s.textures, cfg)

    opt, step = make_train_step(s.geoms, s.meshes, s.textures, cfg,
                                history=True)
    p = fresh()
    st = opt.init(p)
    h = seed_hist(p, jax.random.fold_in(key, 999))
    seq_losses = []
    for i in range(N):
        p, st, h, loss = step(p, st, h, jax.random.fold_in(key, i), target)
        seq_losses.append(float(loss))

    opt2, run = make_train_scan(s.geoms, s.meshes, s.textures, cfg,
                                num_steps=N, history=True)
    p2 = fresh()
    st2 = opt2.init(p2)
    h2 = seed_hist(p2, jax.random.fold_in(key, 999))
    p2, st2, h2, losses = run(p2, st2, h2, key, target)

    np.testing.assert_allclose(np.asarray(losses), seq_losses, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(p2.materials.color),
                               np.asarray(p.materials.color), atol=1e-6)
    np.testing.assert_allclose(np.asarray(h2), np.asarray(h), atol=1e-6)


@pytest.mark.slow
def test_history_scan_recovers_albedo():
    """End-to-end fit quality with the one-render history-residual step
    (the round-4 bench form): perturb the white-wall albedo, fit it back
    with make_train_scan(history=True)."""
    import dataclasses
    import optax
    from project3_cuda_path_tracer_tpu.models.inverse import (
        make_train_scan, make_seed_history)
    s = load_scene("scenes/cornell.txt")
    s.camera.resolution = (16, 16)
    s.camera.derive()
    gt = tuple(int(x) for x in np.asarray(s.geoms.type))
    cfg = integ.TraceConfig(width=16, height=16, trace_depth=2,
                            antialias=False, geom_types=gt)

    true_params = RenderParams(materials=s.materials, cam=s.camera.flat())
    keys = [jax.random.PRNGKey(i) for i in range(4)]
    render = jax.jit(lambda p, k: render_image(
        p, s.geoms, s.meshes, s.textures, k, cfg))
    target = jnp.mean(jnp.stack([render(true_params, k) for k in keys]), 0)

    bad_mats = dataclasses.replace(
        s.materials, color=s.materials.color.at[1].set(jnp.array([0.5] * 3)))
    params = jax.tree_util.tree_map(
        jnp.array, RenderParams(materials=bad_mats, cam=true_params.cam))

    # optimize only the albedo table (masked adam, mirroring the frozen
    # grads in test_inverse_rendering_recovers_albedo) — N scanned steps
    # in ONE program
    N = 250
    mask = RenderParams(
        materials=dataclasses.replace(
            jax.tree_util.tree_map(lambda _: False, params.materials),
            color=True),
        cam=jax.tree_util.tree_map(lambda _: False, params.cam))
    opt, run = make_train_scan(s.geoms, s.meshes, s.textures, cfg,
                               num_steps=N,
                               optimizer=optax.masked(optax.adam(5e-2),
                                                      mask),
                               history=True)
    seed_hist = make_seed_history(s.geoms, s.meshes, s.textures, cfg)
    key = jax.random.PRNGKey(7)
    hist = seed_hist(params, jax.random.fold_in(key, 999))
    opt_state = opt.init(params)
    params, opt_state, hist, losses = run(params, opt_state, hist, key,
                                          target)
    recovered = np.asarray(params.materials.color[1])
    np.testing.assert_allclose(recovered, 0.98, atol=0.2)


def test_inverse_renderer_history_mode():
    """InverseRenderer(history=True) — the class-level wrapper around the
    one-render step — must run, maintain its residual image, and report
    finite losses; history=False keeps the two-render path."""
    s = load_scene("scenes/cornell.txt")
    s.camera.resolution = (16, 16)
    s.camera.derive()
    target = np.zeros((16, 16, 3), np.float32)
    from project3_cuda_path_tracer_tpu.models.inverse import InverseRenderer
    for hist in (True, False):
        ir = InverseRenderer(s, target, trace_depth=2, seed=3, history=hist)
        # polish_steps=0: pure history mode (the default fit() ends with
        # a two-render polish tail, which re-seeds the residual — tested
        # separately below)
        losses = ir.fit(3, polish_steps=0) if hist else ir.fit(3)
        assert len(losses) == 3 and all(np.isfinite(l) for l in losses)
        if hist:
            assert ir.hist is not None and ir.hist.shape == (16, 16, 3)
        else:
            assert ir.hist is None


def test_inverse_renderer_polish_tail():
    """fit() under history mode ends with two-render polish steps
    (default POLISH_STEPS capped at half the fit): losses stay finite,
    the optimizer state carries across the loss switch, and the stale
    residual is dropped (re-seeded on any later history step)."""
    s = load_scene("scenes/cornell.txt")
    s.camera.resolution = (16, 16)
    s.camera.derive()
    target = np.zeros((16, 16, 3), np.float32)
    from project3_cuda_path_tracer_tpu.models.inverse import InverseRenderer
    ir = InverseRenderer(s, target, trace_depth=2, seed=3, history=True)
    assert ir.polish_steps == InverseRenderer.POLISH_STEPS
    losses = ir.fit(4)          # 2 history + 2 polish (half-cap)
    assert len(losses) == 4 and all(np.isfinite(l) for l in losses)
    assert ir.hist is None      # polish invalidated the stale residual
    # a later history step re-seeds and runs
    loss = ir.step()
    assert np.isfinite(loss) and ir.hist is not None

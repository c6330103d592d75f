"""Differentiable / inverse rendering (the capability the reference lacks;
BASELINE.json north star: pixel gradients w.r.t. BSDF albedo, emission,
specular color, IOR and camera parameters matching finite differences).

Design (SURVEY §7 step 6): the forward renderer `render_radiance` is pure in
(materials, camera); all discrete sampling decisions are detached inside
ops/bsdf.py (detached-sampling Monte Carlo), so `jax.grad` of any pixel loss
w.r.t. the continuous parameters is an unbiased estimator of the true
gradient. The train step is the "fwd+bwd" unit the BASELINE benchmark times,
and the thing `__graft_entry__.dryrun_multichip` shards across a mesh.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..render import integrator as integ
from ..scene import types as T


class RenderParams(NamedTuple):
    """The differentiable parameter pytree: material table + camera."""
    materials: T.Materials
    cam: dict  # Camera.flat()


def render_image(params: RenderParams, geoms, meshes, textures, key,
                 cfg: integ.TraceConfig, packed_meshes=()) -> jnp.ndarray:
    """One-iteration radiance estimate [H,W,3], differentiable in params."""
    return integ.render_radiance(params.materials, params.cam, geoms, meshes,
                                 textures, key, cfg,
                                 packed_meshes=packed_meshes)


def mse_loss(params: RenderParams, geoms, meshes, textures, key, cfg,
             target: jnp.ndarray, packed_meshes=()) -> jnp.ndarray:
    img = render_image(params, geoms, meshes, textures, key, cfg,
                       packed_meshes)
    return jnp.mean((img - target) ** 2)


def unbiased_mse_grad_loss(params: RenderParams, geoms, meshes, textures,
                           key, cfg, target: jnp.ndarray,
                           packed_meshes=()) -> jnp.ndarray:
    """Surrogate loss whose gradient is an unbiased estimator of
    d/dθ (E[L] - target)².

    Single-sample MSE of a Monte Carlo estimate minimizes
    Var(L) + (E[L]-target)² — the variance term biases fits toward black
    (the renderer's primary failure mode for inverse problems). The standard
    fix (differentiable-rendering practice, e.g. Mitsuba): evaluate the
    residual with one independent sample (detached) and the differential
    with another, so the cross term is E[L_a-target]·E[dL_b/dθ]."""
    k_primal, k_diff = jax.random.split(key)
    primal = jax.lax.stop_gradient(
        render_image(params, geoms, meshes, textures, k_primal, cfg,
                     packed_meshes))
    diff = render_image(params, geoms, meshes, textures, k_diff, cfg,
                        packed_meshes)
    return 2.0 * jnp.mean((primal - target) * diff)


# Default EMA decay for the history residual (see history_residual_grad_loss).
# 0.0 = the residual is simply the PREVIOUS step's detached render: same
# residual variance as the two-render loss, one step stale, half the cost.
# MEASURED (tests/test_grad.py fit A/B, 16x16 cornell albedo recovery, 250
# masked-adam steps): beta=0.0 recovers (1.05 vs true 0.98, on par with the
# two-render loss), while EVERY beta>0 diverges or stalls (0.3 -> ~0.6,
# 0.9 -> ~0.3): the EMA correlates the residual across steps, and the
# resulting correlated gradient noise + feedback through the model's own
# renders destabilizes the fit. Keep 0.0 unless you re-measure.
HISTORY_DECAY = 0.0


def history_residual_grad_loss(params, geoms, meshes, textures, key, cfg,
                               target: jnp.ndarray, residual: jnp.ndarray,
                               packed_meshes=()) -> Tuple[jnp.ndarray,
                                                          jnp.ndarray]:
    """ONE-render surrogate loss for the training loop: the detached
    residual factor of `unbiased_mse_grad_loss` is supplied by the CALLER
    (the training loop's running EMA of past renders) instead of being
    re-rendered every step.

    Why this is sound: the surrogate's gradient is
    2·mean((residual − target) · dL/dθ). It is an unbiased estimator of
    the true gradient 2·mean((E[L] − target) · dE[L]/dθ) whenever the
    residual is (a) detached and (b) statistically independent of THIS
    step's render — samples from *previous* iterations satisfy both by
    construction, and their average has far lower variance than one fresh
    render. The one caveat is staleness: past renders were taken at past
    θ, so the residual lags E[L(θ_now)] by one optimizer step (the
    default HISTORY_DECAY = 0.0 uses exactly the previous step's
    render). MEASURED consequence (tools/inverse_demo.py A/B): under
    CONSTANT-lr adam the lag shifts the fit's
    equilibrium by roughly one adam step's worth of parameter drift —
    e.g. +0.2 albedo at lr 5e-2 on the 32^2 demo, shrinking to the
    two-render loss's own level at lr 1e-2; a periodic independent
    residual refresh does NOT remove it (it is the lag, not
    sample-noise coupling). For precision fits, anneal the lr or polish
    with `unbiased_mse_grad_loss` for the final steps; for training
    throughput the shift is irrelevant. Decays >0 were measured UNSTABLE
    — see the HISTORY_DECAY comment. This halves the train step (one
    render + backward instead of two renders + backward).

    Returns (loss, rendered_image): the caller folds the (detached) image
    into its history EMA for the next step."""
    diff = render_image(params, geoms, meshes, textures, key, cfg,
                        packed_meshes)
    res = jax.lax.stop_gradient(residual)
    return 2.0 * jnp.mean((res - target) * diff), diff


def _bake_static_tables(geoms, textures, bake: bool):
    """Convert the NON-differentiable scene tables to host constants so
    XLA folds them (render/integrator.bake_tables rationale). The
    differentiable params (materials, camera) are NOT touched — and geoms
    baking means sdf_params/transforms cannot be differentiated through
    this step (RenderParams never includes them)."""
    if not bake:
        return geoms, textures
    geoms = jax.tree_util.tree_map(np.asarray, geoms)
    tex_bytes = sum(a.size * a.dtype.itemsize
                    for a in jax.tree_util.tree_leaves(textures))
    if tex_bytes <= integ.BAKE_TEXTURE_LIMIT:
        textures = jax.tree_util.tree_map(np.asarray, textures)
    return geoms, textures


def make_seed_history(geoms, meshes, textures, cfg: integ.TraceConfig,
                      packed_meshes=(), bake: bool = True):
    """Jitted (params, key) -> detached [H,W,3] render that seeds the
    history-residual EMA (one forward pass, run ONCE before training)."""
    geoms, textures = _bake_static_tables(geoms, textures, bake)

    @jax.jit
    def seed(params: RenderParams, key):
        return jax.lax.stop_gradient(render_image(
            params, geoms, meshes, textures, key, cfg, packed_meshes))

    return seed


def make_train_step(geoms, meshes, textures, cfg: integ.TraceConfig,
                    optimizer=None, unbiased: bool = True,
                    packed_meshes=(), bake: bool = True,
                    history: bool = False,
                    history_decay: float = HISTORY_DECAY):
    """Build a jitted (params, opt_state, key, target) -> (params, opt_state,
    loss) step. Under a sharded jit the pixel loss is data-parallel and the
    replicated-parameter gradients get an automatic psum over the mesh.

    ``history=True`` switches to the one-render history-residual step
    (history_residual_grad_loss): signature becomes
    (params, opt_state, hist, key, target) -> (params, opt_state, hist,
    loss), where `hist` is the residual EMA image — seed it with
    make_seed_history, then thread it through every call.

    The step DONATES params/opt_state (and hist) — do not pass arrays you
    still need (copy with tree_map(jnp.array, ...) first if they alias
    scene tables).
    """
    import optax
    opt = optimizer or optax.adam(1e-2)
    geoms, textures = _bake_static_tables(geoms, textures, bake)

    from functools import partial

    if history:
        beta = jnp.float32(history_decay)

        @partial(jax.jit, donate_argnums=(0, 1, 2))
        def hstep(params: RenderParams, opt_state, hist, key, target):
            def lf(p):
                return history_residual_grad_loss(
                    p, geoms, meshes, textures, key, cfg, target, hist,
                    packed_meshes)
            (loss, img), grads = jax.value_and_grad(lf, has_aux=True)(params)
            updates, opt_state = opt.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            hist = beta * hist + (1.0 - beta) * jax.lax.stop_gradient(img)
            return params, opt_state, hist, loss

        return opt, hstep

    loss_fn = unbiased_mse_grad_loss if unbiased else mse_loss

    @partial(jax.jit, donate_argnums=(0, 1))
    def step(params: RenderParams, opt_state, key, target):
        loss, grads = jax.value_and_grad(loss_fn)(
            params, geoms, meshes, textures, key, cfg, target,
            packed_meshes)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return opt, step


def make_train_scan(geoms, meshes, textures, cfg: integ.TraceConfig,
                    num_steps: int, optimizer=None, unbiased: bool = True,
                    packed_meshes=(), bake: bool = True,
                    history: bool = False,
                    history_decay: float = HISTORY_DECAY):
    """Build a jitted function that runs `num_steps` optimizer steps in ONE
    device program via lax.scan — the production training-loop form.
    Scanning the loop on device removes the per-step host dispatch (and
    is the standard JAX idiom for training epochs). RNG: step i uses
    fold_in(key, i), matching what the equivalent make_train_step loop
    would do.

    ``history=True`` (opt-in — the throughput form, what bench.py
    uses) switches to the one-render history-residual step: signature
    (params, opt_state, hist, key, target) -> (params, opt_state, hist,
    losses[num_steps]); the residual EMA is loop-carried through the scan
    AND across epochs (seed it once with make_seed_history). One render +
    backward per step instead of two renders + backward, at equal fit
    quality (tests/test_grad.py).
    ``history=False`` gives the original two-render form
    (params, opt_state, key, target) -> (params, opt_state, losses).

    Donates params/opt_state (and hist) like make_train_step (copy aliased
    arrays first)."""
    import optax
    opt = optimizer or optax.adam(1e-2)
    geoms, textures = _bake_static_tables(geoms, textures, bake)

    if history:
        beta = jnp.float32(history_decay)

        @partial(jax.jit, donate_argnums=(0, 1, 2))
        def hrun(params: RenderParams, opt_state, hist, key, target):
            def one(carry, i):
                params, opt_state, hist = carry

                def lf(p):
                    return history_residual_grad_loss(
                        p, geoms, meshes, textures,
                        jax.random.fold_in(key, i), cfg, target, hist,
                        packed_meshes)
                (loss, img), grads = jax.value_and_grad(
                    lf, has_aux=True)(params)
                updates, opt_state = opt.update(grads, opt_state, params)
                params = optax.apply_updates(params, updates)
                hist = (beta * hist
                        + (1.0 - beta) * jax.lax.stop_gradient(img))
                return (params, opt_state, hist), loss

            (params, opt_state, hist), losses = jax.lax.scan(
                one, (params, opt_state, hist), jnp.arange(num_steps))
            return params, opt_state, hist, losses

        return opt, hrun

    loss_fn = unbiased_mse_grad_loss if unbiased else mse_loss

    @partial(jax.jit, donate_argnums=(0, 1), static_argnames=())
    def run(params: RenderParams, opt_state, key, target):
        def one(carry, i):
            params, opt_state = carry
            loss, grads = jax.value_and_grad(loss_fn)(
                params, geoms, meshes, textures, jax.random.fold_in(key, i),
                cfg, target, packed_meshes)
            updates, opt_state = opt.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return (params, opt_state), loss

        (params, opt_state), losses = jax.lax.scan(
            one, (params, opt_state), jnp.arange(num_steps))
        return params, opt_state, losses

    return opt, run


class InverseRenderer:
    """Fit scene parameters to a target image by gradient descent.

    Loss schedule: ``history=True`` (default) runs the fast ONE-render
    history-residual step, whose one-step-stale residual shifts the fit
    equilibrium by ~one adam step of drift at constant lr (measured:
    +0.2 albedo at lr 5e-2 on the 32^2 demo). The PRECISION mitigation is shipped, not advisory:
    ``fit(steps)`` finishes with ``polish_steps`` two-render unbiased
    steps (same optimizer state; the lag term vanishes, adam's momentum
    washes out in ~1/(1-b1)=10 steps), so the default fit converges to
    the two-render equilibrium at nearly one-render cost. Set
    ``polish_steps=0`` for raw throughput, or call ``step(polish=True)``
    yourself for custom schedules."""

    # Default two-render polish tail for fit() under history=True: adam's
    # momentum horizon is 1/(1-b1) = 10 steps; 3x that replaces the stale
    # history equilibrium with the unbiased one (measured: recovers the
    # two-render fit to ±0.02 on the 32^2 demo at lr 5e-2 — see
    # tools/inverse_demo.py --polish).
    POLISH_STEPS = 30

    def __init__(self, scene: T.Scene, target: np.ndarray,
                 spp_per_step: int = 1, learning_rate: float = 1e-2,
                 trace_depth: Optional[int] = None, seed: int = 0,
                 history: bool = True,
                 polish_steps: Optional[int] = None):
        import optax
        w, h = scene.camera.resolution
        types = np.asarray(scene.geoms.type)
        mesh_idx = tuple(int(i) for i in np.nonzero(types == T.MESH)[0])
        depth = trace_depth or scene.settings.trace_depth
        # Auto trace schedule: for non-mesh scenes up to the canonical
        # 800^2 x depth-8 size, UNROLL the bounce loop with remat OFF (all
        # bounce residuals stay plain live values; under a scan the same
        # choice is the worst schedule). Mesh scenes and bigger traces
        # keep scan+save-"hits" for memory. Chosen from measurements on
        # the previous accelerator; an H100 train cell on each side of the
        # size threshold decides it again (ROADMAP A3).
        fast = (not mesh_idx) and (w * h * depth <= 800 * 800 * 8)
        self.cfg = integ.TraceConfig(
            width=w, height=h,
            trace_depth=depth,
            antialias=scene.settings.antialias,
            mesh_geom_indices=mesh_idx,
            geom_types=tuple(int(t) for t in types),
            mesh_ids=tuple(int(m) for m in np.asarray(scene.geoms.mesh_id)),
            unroll=fast,
            remat=not fast,
            differentiable_mesh=bool(len(mesh_idx)),
            glossy=bool(np.any(np.asarray(
                scene.materials.specular_exponent) > 0)),
            sky=bool(float(np.asarray(scene.textures.sky)[0]) > 0))
        self.scene = scene
        self.target = jnp.asarray(target, jnp.float32)
        # copy: the train step donates its param buffers, and params must
        # not alias the scene's material tables (donation would delete them)
        self.params = jax.tree_util.tree_map(
            jnp.array, RenderParams(materials=scene.materials,
                                    cam=scene.camera.flat()))
        self.history = history
        self.polish_steps = (self.POLISH_STEPS if polish_steps is None
                             else int(polish_steps)) if history else 0
        self.opt = optax.adam(learning_rate)
        _, self._step = make_train_step(
            scene.geoms, scene.meshes, scene.textures, self.cfg,
            optimizer=self.opt,
            packed_meshes=scene.packed_meshes, history=history)
        self.opt_state = self.opt.init(self.params)
        self.key = jax.random.PRNGKey(seed)
        self.spp = spp_per_step
        self.hist = None
        self._plain_step = None if history else self._step
        if history:
            self._seed_hist = make_seed_history(
                scene.geoms, scene.meshes, scene.textures, self.cfg,
                packed_meshes=scene.packed_meshes)

    def _get_plain_step(self):
        """Lazily-built two-render unbiased step sharing self.opt (same
        adam hyperparams -> opt_state carries over across loss forms)."""
        if self._plain_step is None:
            _, self._plain_step = make_train_step(
                self.scene.geoms, self.scene.meshes, self.scene.textures,
                self.cfg, optimizer=self.opt,
                packed_meshes=self.scene.packed_meshes, history=False)
        return self._plain_step

    def step(self, polish: bool = False) -> float:
        """One optimizer step. ``polish=True`` forces the two-render
        unbiased loss regardless of the history mode (the precision
        tail; optimizer state is shared between the two forms)."""
        loss = None
        use_hist = self.history and not polish
        if use_hist and self.hist is None:
            # Seed the residual EMA with ONE detached render — the first
            # history step is then exactly the two-render unbiased loss.
            self.key, k = jax.random.split(self.key)
            self.hist = self._seed_hist(self.params, k)
        for _ in range(self.spp):
            self.key, k = jax.random.split(self.key)
            if use_hist:
                self.params, self.opt_state, self.hist, loss = self._step(
                    self.params, self.opt_state, self.hist, k, self.target)
            else:
                step = self._get_plain_step()
                self.params, self.opt_state, loss = step(
                    self.params, self.opt_state, k, self.target)
                # a later history step must re-seed: params moved under a
                # different loss, the old residual is extra-stale
                self.hist = None
        return float(loss)

    def fit(self, steps: int, polish_steps: Optional[int] = None) -> list:
        """Run `steps` optimizer steps; under history mode the LAST
        `polish_steps` (default self.polish_steps) use the two-render
        unbiased loss so the fit lands on the unbiased equilibrium."""
        ps = self.polish_steps if polish_steps is None else int(polish_steps)
        # cap at half the fit so short fits still exercise the history
        # loss they asked for (an explicit polish_steps= arg may exceed it)
        cap = steps if polish_steps is not None else steps // 2
        ps = min(max(ps, 0), cap) if self.history else 0
        losses = [self.step() for _ in range(steps - ps)]
        losses += [self.step(polish=True) for _ in range(ps)]
        return losses

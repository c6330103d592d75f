"""Multi-chip / multi-host sharding of the render pipeline.

The reference is single-process, single-GPU (device 0 hard-bound at
reference src/preview.cpp:107). The scaling story here (SURVEY §2.3,
§5.8) is pure data parallelism over pixels:

  * 1-D `Mesh(devices, ('data',))` — the cards of one host (NVLink joins
    them all to all, so no torus shape applies); with
    `jax.distributed.initialize` it extends across hosts;
  * the W×H wavefront's leading N dimension is sharded on 'data'
    (each chip owns a contiguous block of pixel rows);
  * scene tables (geoms / materials / BVH / textures) are KB–MB scale and
    replicated (the reference uploads them once per device too,
    src/pathtrace.cu:89-96);
  * the progressive accumulation image stays sharded on-device; it is only
    gathered to the host at save/preview cadence (the reference instead
    copies D2H every iteration, src/pathtrace.cu:389-390 — we don't);
  * for the differentiable path, per-material parameter gradients are
    partial sums per chip; GSPMD inserts the `psum` over 'data'
    automatically because the parameters are replicated.

No ring/Ulysses-style exchange exists because ray i never reads ray j
(SURVEY §5.7): the only collectives are the parameter-grad psum and the
save-time framebuffer all-gather.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..render import integrator as integ
from ..scene import types as T
from ..utils import image as img_io


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Multi-host bring-up (SURVEY §5.8): `jax.distributed.initialize` with
    explicit args for manual launches or no-args under a cluster
    environment (GKE/SLURM auto-detection). Call once per process before
    any jax op; afterwards `jax.devices()` spans every host's devices and
    `make_mesh()` builds the global data mesh (NVLink within a host, the
    network across hosts — XLA routes collectives)."""
    kwargs = {}
    if coordinator_address is not None:
        kwargs.update(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)


def make_mesh(num_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D data mesh over all (or the first `num_devices`) local+global
    devices. Call `jax.distributed.initialize()` first for multi-host."""
    devs = list(devices if devices is not None else jax.devices())
    if num_devices is not None:
        devs = devs[:num_devices]
    return Mesh(np.array(devs), ("data",))


def shard_scene(scene: T.Scene, mesh: Mesh) -> T.Scene:
    """Replicate all scene tables across the mesh (explicit placement so
    multi-host runs don't rely on implicit broadcasting)."""
    rep = NamedSharding(mesh, P())
    put = lambda tree: jax.tree_util.tree_map(
        lambda a: jax.device_put(a, rep), tree)
    return T.Scene(
        camera=scene.camera, settings=scene.settings,
        materials=put(scene.materials), geoms=put(scene.geoms),
        meshes=put(scene.meshes), textures=put(scene.textures),
        source_path=scene.source_path,
        packed_meshes=put(scene.packed_meshes),
    )


@partial(jax.jit, static_argnames=("cfg",), donate_argnames=("accum",))
def render_step_sharded(accum, materials, cam, geoms, meshes, textures, key,
                        cfg: integ.TraceConfig, packed_meshes=(),
                        iteration=None):
    """One sharded progressive iteration; `cfg.ray_sharding` carries the
    wavefront sharding and `accum` arrives sharded on its row dimension."""
    rad = integ.render_radiance(materials, cam, geoms, meshes, textures, key,
                                cfg, packed_meshes=packed_meshes,
                                iteration=iteration)
    return accum + rad


@partial(jax.jit, static_argnames=("cfg", "chunk"),
         donate_argnames=("accum",))
def render_chunk_sharded(accum, materials, cam, geoms, meshes, textures,
                         base_key, start_iter, cfg: integ.TraceConfig,
                         chunk, packed_meshes=()):
    """`chunk` sharded iterations in ONE SPMD program (lax.scan) — the
    multi-card analogue of integrator.render_chunk: progressive rendering
    scans iterations on device so the host dispatches once per chunk.
    Iteration i draws fold_in(base_key, start_iter
    + i), bitwise the stream step()-at-a-time draws."""
    def one(acc, i):
        key = jax.random.fold_in(base_key, start_iter + i)
        rad = integ.render_radiance(materials, cam, geoms, meshes, textures,
                                    key, cfg, packed_meshes=packed_meshes,
                                    iteration=start_iter + i)
        return acc + rad, None
    out, _ = jax.lax.scan(one, accum, jnp.arange(chunk, dtype=jnp.int32))
    return out


class ShardedRenderer:
    """Data-parallel progressive renderer over a device mesh.

    Equivalent public surface to `render.integrator.Renderer`, but the
    accumulator lives sharded across chips and every iteration runs SPMD.
    Requires H to be divisible by the mesh size (pad the scene resolution or
    pass a smaller mesh otherwise — path tracing has no cross-pixel
    dependencies, so any row partition is valid).
    """

    def __init__(self, scene: T.Scene, mesh: Optional[Mesh] = None,
                 settings: Optional[T.RenderSettings] = None):
        self.mesh = mesh or make_mesh()
        w, h = scene.camera.resolution
        ndev = self.mesh.devices.size
        if h % ndev != 0:
            raise ValueError(
                f"height {h} not divisible by mesh size {ndev}; "
                f"pad the resolution")
        self.scene = shard_scene(scene, self.mesh)
        self.settings = settings or scene.settings

        ray_sharding = NamedSharding(self.mesh, P("data"))
        self.accum_sharding = NamedSharding(self.mesh, P("data", None, None))
        drops: list = []
        # Shared settings->cfg resolution with the single-device Renderer
        # (integrator.build_trace_config — one builder so feature flags
        # cannot drift between the two surfaces). cfg.adaptive stays False
        # at the top level here: the sharded adaptive path flips it inside
        # its shard_map body (_build_adaptive_chunk), where the wavefront
        # is shard-local and ray_sharding is off.
        self.cfg = integ.build_trace_config(self.scene, self.settings,
                                            ray_sharding=ray_sharding)
        if int(getattr(self.settings, "restir", 0)) >= 1:
            drops.append("restir (single-device only: the temporal "
                         "reservoir needs the identity path order)")
        if getattr(self.settings, "nee", False):
            self.cfg = integ._wire_nee(self.scene, self.cfg, drops)
        integ.announce_drops(drops)
        self.adaptive = bool(getattr(self.settings, "adaptive", False))
        if self.adaptive and (self.settings.sort_materials
                              or self.settings.compact):
            raise ValueError("adaptive is incompatible with sort/compact")
        # Scene baking (see integrator.bake_tables): the tables become
        # replicated HLO constants under GSPMD; camera/accum/key stay
        # traced. Built after _wire_nee so env alias tables are included.
        self._baked_chunk = None
        if self.adaptive:
            self._adaptive_chunk = self._build_adaptive_chunk()
        elif getattr(self.settings, "bake_scene", True):
            self._baked_chunk = self._build_baked_chunk()
        self.base_key = jax.random.key(self.settings.seed, impl=self.settings.rng)
        self.reset()

    def _build_baked_chunk(self):
        from functools import partial
        s = self.scene
        geoms_c, mats_c, tex_c = integ.bake_tables(s)
        cfg = self.cfg
        meshes, pm = s.meshes, s.packed_meshes

        @partial(jax.jit, static_argnames=("chunk",),
                 donate_argnames=("accum",))
        def baked(accum, cam, textures, base_key, start_iter, chunk):
            def one(acc, i):
                key = jax.random.fold_in(base_key, start_iter + i)
                return acc + integ.render_radiance(
                    mats_c, cam, geoms_c, meshes,
                    tex_c if tex_c is not None else textures, key, cfg,
                    packed_meshes=pm, iteration=start_iter + i), None
            out, _ = jax.lax.scan(one, accum,
                                  jnp.arange(chunk, dtype=jnp.int32))
            return out

        def run(accum, chunk):
            return baked(accum, s.camera.flat(),
                         jnp.zeros((0,)) if tex_c is not None
                         else s.textures,
                         self.base_key,
                         jnp.asarray(self.iteration, jnp.int32), chunk)
        return run

    def _build_adaptive_chunk(self):
        """Adaptive sampling under the data mesh (render/adaptive.py),
        as a shard_map: each device traces its own block of paths whose
        pixels live in its own accumulator rows BY CONSTRUCTION
        (adaptive.plan_epoch_sharded apportions each shard's budget
        within its row block), so the radiance scatter is local — no
        cross-chip collectives, same as the uniform renderer."""
        import dataclasses
        from functools import partial
        from ..render import adaptive as A  # noqa: F401 (doc anchor)
        s = self.scene
        geoms_c, mats_c, tex_c = integ.bake_tables(s)
        meshes, pm = s.meshes, s.packed_meshes
        mesh = self.mesh
        ndev = mesh.devices.size
        cfg = dataclasses.replace(self.cfg, ray_sharding=None,
                                  adaptive=True)
        h, w = cfg.height, cfg.width
        rows_loc = h // ndev
        n_loc = rows_loc * w

        def body(chunk, accum_l, accum2_l, cam, textures, base_key,
                 start_iter, pix_l, surr_l):
            off = jax.lax.axis_index("data") * n_loc
            zero = jnp.zeros((n_loc,), jnp.float32)

            def one(carry, i):
                px, py, pz, pl = carry
                key = jax.random.fold_in(base_key, start_iter + i)
                # decorrelate the lane-indexed (non-stratified) draws
                # across shards; pixel-keyed stratified draws are
                # shard-independent already
                key = jax.random.fold_in(key, jax.lax.axis_index("data"))
                rad, _ = integ.trace_wavefront(
                    mats_c, cam, geoms_c, meshes,
                    tex_c if tex_c is not None else textures, key, cfg,
                    packed_meshes=pm, iteration=start_iter + i,
                    pix_override=pix_l, samp_index=surr_l)
                lum = (0.2126 * rad.x + 0.7152 * rad.y + 0.0722 * rad.z)
                return (px + rad.x, py + rad.y, pz + rad.z,
                        pl + lum * lum), None

            (px, py, pz, pl), _ = jax.lax.scan(
                one, (zero, zero, zero, zero),
                jnp.arange(chunk, dtype=jnp.int32))
            sc = lambda v: zero.at[pix_l - off].add(v)
            img = jnp.stack([sc(px), sc(py), sc(pz)],
                            axis=-1).reshape(rows_loc, w, 3)
            return (accum_l + img,
                    accum2_l + sc(pl).reshape(rows_loc, w))

        @partial(jax.jit, static_argnames=("chunk",),
                 donate_argnames=("accum", "accum2"))
        def baked(accum, accum2, cam, textures, base_key, start_iter,
                  pix, surr, chunk):
            # check_vma off: the body is collective-free (locality by
            # plan construction) and its scan carries mix replicated-
            # and shard-derived values, which the varying-axis typing
            # rejects without pervasive pvary annotations.
            f = jax.shard_map(
                partial(body, chunk),
                mesh=mesh,
                in_specs=(P("data", None, None), P("data", None),
                          P(), P(), P(), P(), P("data"), P("data")),
                out_specs=(P("data", None, None), P("data", None)),
                check_vma=False)
            return f(accum, accum2, cam, textures, base_key, start_iter,
                     pix, surr)

        shard1 = NamedSharding(mesh, P("data"))

        def run(accum, accum2, chunk, pix, surr):
            return baked(accum, accum2, s.camera.flat(),
                         jnp.zeros((0,)) if tex_c is not None
                         else s.textures,
                         self.base_key,
                         jnp.asarray(self.iteration, jnp.int32),
                         jax.device_put(pix, shard1),
                         jax.device_put(surr, shard1), chunk)
        return run

    def reset(self) -> None:
        w, h = self.scene.camera.resolution
        self.accum = jax.device_put(jnp.zeros((h, w, 3), jnp.float32),
                                    self.accum_sharding)
        self.iteration = 0
        if getattr(self, "adaptive", False):
            from ..render import adaptive as A
            ndev = self.mesh.devices.size
            self.accum2 = jax.device_put(
                jnp.zeros((h, w), jnp.float32),
                NamedSharding(self.mesh, P("data", None)))
            self.count = np.zeros((h, w), np.float64)
            self._plan = A.identity_plan_sharded(w, h, ndev,
                                                 self.cfg.tile)
            ep = max(1, int(getattr(self.settings, "adaptive_epoch", 32)))
            self._next_replan = ep

    def step(self) -> None:
        if getattr(self, "adaptive", False):
            self.step_many(1)
            return
        s = self.scene
        key = jax.random.fold_in(self.base_key, self.iteration)
        self.accum = render_step_sharded(
            self.accum, s.materials, s.camera.flat(), s.geoms, s.meshes,
            s.textures, key, self.cfg, s.packed_meshes,
            iteration=jnp.asarray(self.iteration, jnp.int32))
        self.iteration += 1

    # iterations per device program in step_many (see integrator.Renderer)
    CHUNK = 64

    def step_many(self, n: int) -> None:
        """Advance n iterations, scanning them in one SPMD program per
        chunk; bitwise-identical sample streams to n step() calls."""
        if getattr(self, "adaptive", False):
            self._step_many_adaptive(n)
            return
        s = self.scene
        while n > 0:
            k = min(n, self.CHUNK)
            if self._baked_chunk is not None:
                self.accum = self._baked_chunk(self.accum, k)
            else:
                self.accum = render_chunk_sharded(
                    self.accum, s.materials, s.camera.flat(), s.geoms,
                    s.meshes, s.textures, self.base_key, self.iteration,
                    self.cfg, k, s.packed_meshes)
            self.iteration += k
            n -= k

    def _step_many_adaptive(self, n: int) -> None:
        """Adaptive iterations over the mesh: shard-local chunks under
        one fixed per-shard plan; the host re-plans every adaptive_epoch
        iterations from the gathered statistics (the save-cadence
        framebuffer gather, SURVEY §5.8)."""
        from ..render import adaptive as A
        ndev = self.mesh.devices.size
        ep = max(1, int(getattr(self.settings, "adaptive_epoch", 32)))
        while n > 0:
            if self.iteration >= self._next_replan:
                self._plan = A.plan_epoch_sharded(
                    np.asarray(jax.device_get(self.accum)),
                    np.asarray(jax.device_get(self.accum2)),
                    self.count, ndev)
                self._next_replan = self.iteration + ep
            k = min(n, self.CHUNK, self._next_replan - self.iteration)
            pix, surr, count_img = self._plan
            self.accum, self.accum2 = self._adaptive_chunk(
                self.accum, self.accum2, k, pix, surr)
            self.count += count_img.astype(np.float64) * k
            self.iteration += k
            n -= k

    def checkpoint_extras(self) -> dict:
        """Adaptive-mode state beyond (accum, iteration) for
        render/checkpoint.py — mirrors integrator.Renderer so
        `--adaptive --sharded` resumes stream-identically. The sharded
        accum2 is gathered to the host (the save-cadence gather of
        SURVEY §5.8); plans/counts are host arrays already."""
        if not getattr(self, "adaptive", False):
            return {}
        pix, surr, cimg = self._plan
        return dict(accum2=np.asarray(jax.device_get(self.accum2)),
                    count=self.count,
                    plan_pix=np.asarray(pix), plan_surr=np.asarray(surr),
                    plan_cimg=np.asarray(cimg),
                    next_replan=np.int64(self._next_replan))

    def restore_extras(self, extras: dict) -> None:
        if not getattr(self, "adaptive", False):
            return
        if "accum2" not in extras:
            raise ValueError("checkpoint has no adaptive state; resume "
                             "without --adaptive or re-render")
        self.accum2 = jax.device_put(
            jnp.asarray(extras["accum2"], jnp.float32),
            NamedSharding(self.mesh, P("data", None)))
        self.count = np.asarray(extras["count"], np.float64)
        self._plan = (jnp.asarray(extras["plan_pix"], jnp.int32),
                      jnp.asarray(extras["plan_surr"], jnp.int32),
                      np.asarray(extras["plan_cimg"], np.float32))
        self._next_replan = int(extras["next_replan"])

    def render(self, num_iterations: int, seed: Optional[int] = None):
        if seed is not None:
            self.base_key = jax.random.key(
                seed, impl=self.settings.rng)
        self.step_many(num_iterations)
        self.accum.block_until_ready()
        return self.accum

    def image(self) -> np.ndarray:
        """Gather the sharded accumulator to the host and finalize
        (the save-time all-gather of SURVEY §5.8). Adaptive runs divide
        per pixel by its own sample count."""
        gathered = np.asarray(jax.device_get(self.accum))
        if getattr(self, "adaptive", False):
            return (gathered / np.maximum(self.count, 1.0)[:, :, None]
                    )[:, ::-1, :].astype(np.float32)
        return gathered[:, ::-1, :] / max(self.iteration, 1)

    def save(self, path_base: Optional[str] = None, hdr: bool = False,
             denoise: bool = False, gamma: float = 0.0,
             aces: bool = False) -> str:
        base = path_base or self.settings.image_name
        accum = np.asarray(jax.device_get(self.accum))
        it = max(self.iteration, 1)
        if getattr(self, "adaptive", False):
            # pre-scale so save_render's /iterations lands on accum/count
            accum = accum / np.maximum(self.count, 1.0)[:, :, None] * it
        if denoise:
            # Post-process on the gathered host image (the denoiser is a
            # save-time pass, not part of the SPMD loop).
            from ..render import denoise as dn
            # relay gate: see integrator.denoised_accum (measured ~64 spp
            # crossover)
            normal, pos, alb = dn.gbuffer(self.scene, self.cfg,
                                          self.scene.packed_meshes,
                                          albedo=True,
                                          relay=self.iteration >= 64)
            accum = np.asarray(dn.atrous_denoise(
                jnp.asarray(accum) / it, jax.device_get(normal),
                jax.device_get(pos),
                albedo=jax.device_get(alb))) * it
        return img_io.save_render(base, accum, self.iteration, hdr=hdr,
                                  gamma=gamma, aces=aces)

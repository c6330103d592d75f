"""Scene data model: host dataclasses + device-side SoA pytrees.

Structure-of-arrays re-design of the reference's AoS POD structs
(reference: src/sceneStructs.h:8-76). Device data is structure-of-arrays so
every field maps onto flat [G]/[M]/[N] vectors that kernels stream;
transforms are [G,4,4] stacked matrices.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import jax
import numpy as np
import jax.numpy as jnp

from ..utils import math as m

# GeomType (reference: src/sceneStructs.h:10-13)
SPHERE = 0
CUBE = 1
MESH = 2  # extension slot (reference TODO: src/pathtrace.cu:188)
SDF = 3   # implicit-surface slot (same TODO: "metaball? CSG?"); ops/sdf.py

BACKGROUND_COLOR = np.zeros(3, dtype=np.float32)  # src/sceneStructs.h:8


def _register(cls):
    """Register a dataclass as a JAX pytree (all fields are leaves)."""
    fields = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])
    return cls


@_register
@dataclass
class Materials:
    """SoA material table (reference: src/sceneStructs.h:31-41).

    All arrays have leading dim M (number of materials). These are the
    *differentiable parameters* of the renderer: `jax.grad` flows into
    color / specular_color / emittance / ior.
    """
    color: jnp.ndarray            # [M,3]
    specular_exponent: jnp.ndarray  # [M]
    specular_color: jnp.ndarray   # [M,3]
    has_reflective: jnp.ndarray   # [M]  float; used as specular lobe probability
    has_refractive: jnp.ndarray   # [M]  float; used as refractive lobe probability
    ior: jnp.ndarray              # [M]
    emittance: jnp.ndarray        # [M]
    # Spectral dispersion strength (extension; MATERIAL key DISPERSION d):
    # refraction samples one RGB channel with ior + d*(channel-1) — red
    # bends least, blue most (ops/wavefront.shade_planar). None = absent
    # (an empty pytree subtree, like Geoms.sdf_params).
    dispersion: Optional[jnp.ndarray] = None  # [M]

    @staticmethod
    def zeros(n: int) -> "Materials":
        return Materials(
            color=jnp.zeros((n, 3), jnp.float32),
            specular_exponent=jnp.zeros((n,), jnp.float32),
            specular_color=jnp.zeros((n, 3), jnp.float32),
            has_reflective=jnp.zeros((n,), jnp.float32),
            has_refractive=jnp.zeros((n,), jnp.float32),
            ior=jnp.zeros((n,), jnp.float32),
            emittance=jnp.zeros((n,), jnp.float32),
            dispersion=jnp.zeros((n,), jnp.float32),
        )


@_register
@dataclass
class Geoms:
    """SoA geometry table (reference: src/sceneStructs.h:20-29).

    transform / inverse_transform / inverse_transpose are stacked 4x4s;
    canonical primitives are the unit sphere (r=0.5) and unit cube
    ([-0.5,0.5]^3) in object space (reference: src/intersections.h:40-41,94).
    `velocity` is the motion-blur extension (reference TODO:
    src/pathtrace.cu:119): world-space translation per unit shutter time.
    """
    type: jnp.ndarray               # [G] int32 (SPHERE/CUBE/MESH/SDF)
    material_id: jnp.ndarray        # [G] int32
    transform: jnp.ndarray          # [G,4,4]
    inverse_transform: jnp.ndarray  # [G,4,4]
    inverse_transpose: jnp.ndarray  # [G,4,4]
    velocity: jnp.ndarray           # [G,3]
    mesh_id: jnp.ndarray            # [G] int32; index into MeshBundle, -1 if none
    # [G, ops.sdf.PARAM_SLOTS] float32 SDF shape parameters (traced, so
    # implicit shapes are differentiable scene inputs); None when the scene
    # has no SDF geoms (None is an empty pytree subtree, not a leaf).
    sdf_params: Optional[jnp.ndarray] = None


@_register
@dataclass
class MeshBundle:
    """Flattened triangle-mesh + BVH arrays shared by all MESH geoms.

    All meshes are concatenated; per-geom `mesh_id` selects a (node, tri)
    range. Built host-side (scene/bvh.py), resident in HBM on device.
    """
    # triangle soup, object space
    tri_v0: jnp.ndarray     # [T,3]
    tri_e1: jnp.ndarray     # [T,3]  v1 - v0
    tri_e2: jnp.ndarray     # [T,3]  v2 - v0
    tri_n0: jnp.ndarray     # [T,3]  vertex normals (face normal if absent)
    tri_n1: jnp.ndarray     # [T,3]
    tri_n2: jnp.ndarray     # [T,3]
    tri_uv0: jnp.ndarray    # [T,2]
    tri_uv1: jnp.ndarray    # [T,2]
    tri_uv2: jnp.ndarray    # [T,2]
    # flattened BVH (depth-first, stackless-friendly layout)
    node_lo: jnp.ndarray    # [B,3]  aabb min
    node_hi: jnp.ndarray    # [B,3]  aabb max
    node_right: jnp.ndarray  # [B] int32: right-child index (internal) or -1
    node_start: jnp.ndarray  # [B] int32: first tri (leaf) else -1
    node_count: jnp.ndarray  # [B] int32: tri count (leaf) else 0
    node_skip: jnp.ndarray   # [B] int32: next node if subtree skipped (escape idx)
    mesh_root: jnp.ndarray   # [K] int32: BVH root node per mesh
    mesh_tri_offset: jnp.ndarray  # [K] int32

    @staticmethod
    def empty() -> "MeshBundle":
        f3 = jnp.zeros((1, 3), jnp.float32)
        f2 = jnp.zeros((1, 2), jnp.float32)
        i1 = jnp.zeros((1,), jnp.int32)
        return MeshBundle(
            tri_v0=f3, tri_e1=f3, tri_e2=f3,
            tri_n0=f3, tri_n1=f3, tri_n2=f3,
            tri_uv0=f2, tri_uv1=f2, tri_uv2=f2,
            node_lo=f3, node_hi=f3,
            node_right=i1 - 1, node_start=i1, node_count=i1, node_skip=i1 - 1,
            mesh_root=jnp.zeros((1,), jnp.int32),
            mesh_tri_offset=jnp.zeros((1,), jnp.int32),
        )


@_register
@dataclass
class Textures:
    """Texture atlas + per-material texture table (extension: BASELINE config 5).

    A single [H,W,3] atlas; per-material rectangle (offset + size in texels).
    material `tex_id` < 0 means untextured. Env map is an equirect [He,We,3]
    radiance image; env_enabled gates it (background stays black otherwise,
    reference: src/sceneStructs.h:8).
    """
    atlas: jnp.ndarray       # [Ha,Wa,3] float32
    rect: jnp.ndarray        # [M,4] int32 (x, y, w, h) per material
    tex_id: jnp.ndarray      # [M] int32 (-1 = none)
    env: jnp.ndarray         # [He,We,3] float32
    env_enabled: jnp.ndarray  # [] float32 (0/1)
    # Procedural texturing (pure elementwise, no gathers).
    # checker_scale[m] > 0 blends material color with checker_color2 on a
    # scale-sized uv checkerboard. sky: [14] = enabled, zenith rgb,
    # horizon rgb, sun dir xyz, sun rgb, sun sharpness.
    checker_scale: jnp.ndarray   # [M] float32 (0 = off)
    checker_color2: jnp.ndarray  # [M,3] float32
    sky: jnp.ndarray             # [14] float32
    # Packed single-gather texel planes (one u32 take per fetch instead
    # of three f32 takes, ops/wavefront.py). Encodings roundtrip bitwise to
    # the f32 planes: atlas R8G8B8 (source PNGs are 8-bit; byte/255 in f32
    # reproduces read_png exactly) and env RGBE (the Radiance .hdr wire
    # format itself; (m+0.5)*2^(e-136) reproduces read_hdr exactly).
    # Shape (1,) = absent (fall back to the f32 planes).
    atlas_packed: jnp.ndarray = None  # [Ha*Wa] uint32
    env_packed: jnp.ndarray = None    # [He*We] uint32
    # Horizontal-pair RGB565 plane for the 2-gather bilinear fast path
    # (--bilinear-fast): entry (y,x) holds texel(y,x) in the low 16 bits
    # and its RIGHT neighbor (clamped inside the texel's own atlas rect,
    # built at parse time where the strip layout is known) in the high 16.
    # One gather returns a whole bilinear ROW, so the 4-corner fetch
    # becomes 2 gathers at 5/6-bit channel (mag-filter) quality.
    # Shape (1,) = absent (fast mode falls back to exact 4-gather).
    atlas_pair: jnp.ndarray = None    # [Ha*Wa] uint32
    # ENV horizontal-pair plane for --bilinear-fast (utils/image.
    # pack_env_pair): texel + right neighbor ((x+1) mod W — longitude
    # wraps) as two 12-bit shared-exponent mini-RGBE texels per u32, so
    # the env's 4-corner bilinear fetch rides the same 2 gathers as the
    # atlas. Built lazily by build_trace_config when the flag is set.
    # Shape (1,) = absent (fast mode keeps the nearest-RGBE env).
    env_pair: jnp.ndarray = None      # [He*We] uint32
    # Env-map importance-sampling alias table (ops/nee.py env NEE):
    # Vose alias method over texels weighted by luminance * solid angle.
    # Shape (1,) = absent; built lazily by Renderer when settings.nee is
    # on for an env-lit scene.
    env_alias: jnp.ndarray = None     # [He*We] int32
    env_prob: jnp.ndarray = None      # [He*We] float32
    # Bump/normal mapping (the texture-item companion feature,
    # reference INSTRUCTION.md "Texture mapping AND Bump mapping"):
    #   bump[m] = (scale, freq) procedural world-space bump field
    #             (elementwise analytic gradient, no gathers, like
    #             the checker; scale 0 = off);
    #   nrm_id[m]/nrm_rect[m] = file-loaded tangent-space normal map,
    #             packed into the SAME atlas strip as the color
    #             textures (one extra u32 gather per bounce, only when
    #             a scene uses the feature). -1 = none.
    bump: jnp.ndarray = None          # [M,2] float32 (scale, freq)
    nrm_rect: jnp.ndarray = None      # [M,4] int32 (x, y, w, h)
    nrm_id: jnp.ndarray = None        # [M] int32 (-1 = none)

    def __post_init__(self):
        m = self.tex_id.shape[0]
        if self.bump is None:
            object.__setattr__(self, "bump", jnp.zeros((m, 2), jnp.float32))
        if self.nrm_rect is None:
            object.__setattr__(self, "nrm_rect",
                               jnp.zeros((m, 4), jnp.int32))
        if self.nrm_id is None:
            object.__setattr__(self, "nrm_id", -jnp.ones((m,), jnp.int32))
        if self.atlas_packed is None:
            object.__setattr__(self, "atlas_packed",
                               jnp.zeros((1,), jnp.uint32))
        if self.env_packed is None:
            object.__setattr__(self, "env_packed",
                               jnp.zeros((1,), jnp.uint32))
        if self.atlas_pair is None:
            object.__setattr__(self, "atlas_pair",
                               jnp.zeros((1,), jnp.uint32))
        if self.env_pair is None:
            object.__setattr__(self, "env_pair",
                               jnp.zeros((1,), jnp.uint32))
        if self.env_alias is None:
            object.__setattr__(self, "env_alias",
                               jnp.zeros((1,), jnp.int32))
        if self.env_prob is None:
            object.__setattr__(self, "env_prob",
                               jnp.zeros((1,), jnp.float32))

    @staticmethod
    def none(num_materials: int) -> "Textures":
        m = max(num_materials, 1)
        return Textures(
            atlas=jnp.zeros((1, 1, 3), jnp.float32),
            rect=jnp.zeros((m, 4), jnp.int32),
            tex_id=-jnp.ones((m,), jnp.int32),
            env=jnp.zeros((1, 1, 3), jnp.float32),
            env_enabled=jnp.zeros((), jnp.float32),
            checker_scale=jnp.zeros((m,), jnp.float32),
            checker_color2=jnp.zeros((m, 3), jnp.float32),
            sky=jnp.zeros((14,), jnp.float32),
        )


@dataclass
class Camera:
    """Host-side camera (reference: src/sceneStructs.h:43-52).

    Derived quantities follow Scene::loadCamera (src/scene.cpp:132-142):
      yscaled = tan(fovy deg); xscaled = yscaled * resx / resy
      pixel_length = (2*xscaled/resx, 2*yscaled/resy)
      view = normalize(lookAt - position)
    and the orbit rebuild of runCuda (src/main.cpp:102-120) re-orthogonalizes
    right/up. Extensions: thin-lens DoF (aperture radius + focal distance,
    reference TODO src/pathtrace.cu:120) and shutter time for motion blur.
    """
    resolution: tuple  # (w, h)
    position: np.ndarray
    look_at: np.ndarray
    up: np.ndarray
    view: np.ndarray = None
    right: np.ndarray = None
    fov: np.ndarray = None          # (fovx, fovy) degrees
    pixel_length: np.ndarray = None
    fovy: float = 45.0
    aperture: float = 0.0
    focal_distance: float = 0.0
    shutter: float = 0.0            # motion-blur shutter span (0 = off)

    def derive(self) -> "Camera":
        w, h = self.resolution
        yscaled = np.tan(self.fovy * (m.PI / 180.0))
        xscaled = yscaled * w / h
        fovx = np.arctan(xscaled) * 180.0 / m.PI
        self.fov = np.array([fovx, self.fovy], dtype=np.float32)
        self.pixel_length = np.array(
            [2.0 * xscaled / w, 2.0 * yscaled / h], dtype=np.float32)
        self.view = m.normalize(np.asarray(self.look_at) - np.asarray(self.position))
        r = np.cross(self.view, np.asarray(self.up, dtype=np.float32))
        self.right = m.normalize(r)
        self.up = m.normalize(np.cross(self.right, self.view))
        self.position = np.asarray(self.position, dtype=np.float32)
        self.look_at = np.asarray(self.look_at, dtype=np.float32)
        return self

    def flat(self) -> dict:
        """Device-friendly dict of float32 arrays (a pytree of camera params
        that jax.grad can differentiate through)."""
        return dict(
            position=jnp.asarray(self.position, jnp.float32),
            view=jnp.asarray(self.view, jnp.float32),
            up=jnp.asarray(self.up, jnp.float32),
            right=jnp.asarray(self.right, jnp.float32),
            pixel_length=jnp.asarray(self.pixel_length, jnp.float32),
            aperture=jnp.asarray(self.aperture, jnp.float32),
            focal_distance=jnp.asarray(self.focal_distance, jnp.float32),
            shutter=jnp.asarray(self.shutter, jnp.float32),
        )


@dataclass
class RenderSettings:
    """Render-state config (reference: src/sceneStructs.h:54-60) plus
    the device-side knobs (SURVEY §5.6)."""
    iterations: int = 5000
    trace_depth: int = 8
    image_name: str = "render"
    antialias: bool = True
    sort_materials: bool = False
    compact: bool = False
    first_bounce_cache: bool = False
    russian_roulette: bool = False
    # Next-event estimation / direct-light sampling (ops/nee.py): the
    # classic completed-project extension; unbiased, large variance cut
    # for diffuse scenes. Auto-disabled when the scene has no eligible
    # area lights (Renderer warns).
    nee: bool = False
    # RIS direct lighting (--nee-ris M): one shadow ray resampled from M
    # light candidates per bounce; unbiased, big penumbra-variance cut on
    # multi-light scenes (render/integrator.py RIS block). 0/1 = off.
    nee_ris: int = 0
    # Temporal ReSTIR (--restir M): depth-0 RIS over M fresh candidates
    # PLUS a per-pixel temporal reservoir reused across progressive
    # iterations (Bitterli et al. 2020, temporal half + visibility
    # reuse). Effective candidate count grows to restir_cap*M at
    # constant per-frame cost. Small documented bias (tests/
    # test_restir.py measures it). A real-time/preview feature — under
    # progressive accumulation the reused winner correlates frames, so
    # equal-spp quality is no better than fresh --nee-ris; use for
    # interactive preview.
    # Implies NEE; area-light scenes with the identity path order only.
    # 0 = off.
    restir: int = 0
    restir_cap: float = 20.0
    # Stratified sampling: per-pixel CP-rotated low-discrepancy
    # sequences for the camera, NEE, and per-bounce BSDF dims
    # (ops/wavefront; --stratified). strat_impl: "lattice" (default,
    # net speedup) or "sobol" (Owen-scrambled (0,2) pairs, best
    # per-sample RMSE; --sampler).
    stratified: bool = False
    strat_impl: str = "lattice"
    # Adaptive sampling (render/adaptive.py; --adaptive): per-pixel
    # sample budgets re-planned on host every `adaptive_epoch` iterations
    # from the running variance image. Static shapes throughout (the
    # iteration still traces W*H paths; only the path->pixel mapping
    # changes). Estimator: accum/count per pixel, unbiased.
    adaptive: bool = False
    adaptive_epoch: int = 32
    # Bilinear texture/env filtering (--bilinear; nearest is the default).
    bilinear: bool = False
    # --bilinear-fast: with --bilinear, use the 2-gather RGB565 pair
    # plane instead of 4 exact corner gathers (mag-filter atlas quality,
    # nearest env on the fused path; Textures.atlas_pair).
    bilinear_fast: bool = False
    # Per-sample radiance clamp (--clamp R; 0 = off): production firefly
    # suppression — biased, opt-in, pairs well with --denoise.
    clamp: float = 0.0
    # Bake the scene tables (geoms/materials/small textures) into the
    # compiled program as constants so XLA folds the transform zeros
    # and absent features. Recompiles on
    # scene (not camera) change; disable for workflows that mutate the
    # scene tables between steps (--no-bake).
    bake_scene: bool = True
    seed: int = 0
    # PRNG implementation: 'rbg' (XLA RngBitGenerator — cheaper bit
    # generation, slightly weaker split/fold_in decorrelation, fine for
    # Monte Carlo) or 'threefry2x32' (reference-grade counter RNG). A
    # choice made on the previous accelerator; an H100 cell decides it
    # again.
    rng: str = "rbg"



@dataclass
class Scene:
    """Parsed scene: host camera/settings + device SoA tables.

    `packed_meshes` holds one 8-wide BVH per mesh (ops/bvh8.PackedMesh8,
    built by ops/bvh8.pack_all8 at parse time), read by the mesh
    traversal; empty for no meshes."""
    camera: Camera
    settings: RenderSettings
    materials: Materials
    geoms: Geoms
    meshes: MeshBundle = field(default_factory=MeshBundle.empty)
    textures: Optional[Textures] = None
    source_path: str = ""
    packed_meshes: tuple = ()
    # Static per-geom SDF kind triples (kind, aux_a, aux_b) from ops/sdf.py,
    # (-1, -1, -1) for non-SDF geoms; () when the scene has none. Host-side
    # (hashable) so TraceConfig can carry it as a jit-static argument.
    sdf_kinds: tuple = ()

    def __post_init__(self):
        if self.textures is None:
            self.textures = Textures.none(int(self.materials.color.shape[0]))

    @property
    def num_geoms(self) -> int:
        return int(self.geoms.type.shape[0])

    @property
    def num_materials(self) -> int:
        return int(self.materials.color.shape[0])

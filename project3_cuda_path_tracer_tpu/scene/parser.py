"""Scene-file parser for the reference's text grammar.

Verbatim-compatible with the reference format (reference: src/scene.cpp):
  MATERIAL n  -> RGB/SPECEX/SPECRGB/REFL/REFR/REFRIOR/EMITTANCE (src/scene.cpp:153-188)
  CAMERA      -> RES/FOVY/ITERATIONS/DEPTH/FILE then EYE/LOOKAT/UP (src/scene.cpp:92-151)
  OBJECT n    -> type line, `material k`, TRANS/ROTAT/SCALE (src/scene.cpp:35-90)
IDs must be sequential (src/scene.cpp:37,155). Blocks end at a blank line.

Extensions (gated on new keywords, so reference scenes parse unchanged):
  OBJECT type   `mesh <path.obj>`          (TODO slot: src/pathtrace.cu:188)
                `sdf <kind>`               (same TODO's "metaball? CSG?":
                                            torus/roundbox/capsule/metaball/
                                            csg_union/csg_inter/csg_diff;
                                            ops/sdf.py)
  OBJECT key    PARAMS p0 p1 ...           (SDF shape parameters)
                A|B sphere cx cy cz r      (CSG sub-shapes, object space)
                A|B box cx cy cz hx hy hz
  OBJECT key    VELOC vx vy vz             (motion blur: src/pathtrace.cu:119)
  CAMERA keys   APERTURE r / FOCAL d       (thin-lens DoF: src/pathtrace.cu:120)
                SHUTTER t                  (motion blur time span)
  MATERIAL key  DISPERSION d               (spectral dispersion: per-RGB
                                            ior = REFRIOR + d*(c-1))
  MATERIAL key  TEXTURE <path>             (texture mapping, BASELINE config 5)
                CHECKER s r2 g2 b2         (procedural checker: RGB vs c2)
                NORMALMAP <path.png>       (file tangent-space normal map;
                                            INSTRUCTION.md "Texture mapping
                                            AND Bump mapping")
                BUMP scale freq            (procedural world-space bump,
                                            analytic gradient — gather-free)
  top-level     ENVMAP <path.hdr|.png>     (environment lighting, BASELINE config 5)
                ENVSKY zr zg zb hr hg hb sx sy sz sunr sung sunb sharp
                                           (procedural sky, gather-free)
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import jax.numpy as jnp

from ..utils import math as m
from . import types as T


class SceneParseError(ValueError):
    pass


def _tokenize(line: str) -> List[str]:
    return line.split()


def _is_blank(line: str) -> bool:
    return len(line.strip()) == 0


def _is_comment(line: str) -> bool:
    return line.lstrip().startswith("//")


class _Cursor:
    def __init__(self, lines: List[str]):
        self.lines = lines
        self.i = 0

    def eof(self) -> bool:
        return self.i >= len(self.lines)

    def peek(self) -> str:
        return self.lines[self.i]

    def next(self) -> str:
        line = self.lines[self.i]
        self.i += 1
        return line


def _read_block(cur: _Cursor) -> List[List[str]]:
    """Read token-lines until a blank line or EOF (comments skipped)."""
    rows = []
    while not cur.eof():
        line = cur.peek()
        if _is_blank(line):
            break
        cur.next()
        if _is_comment(line):
            continue
        rows.append(_tokenize(line))
    return rows


def load_scene(path: str) -> T.Scene:
    with open(path, "r") as f:
        lines = [ln.rstrip("\r\n") for ln in f]
    cur = _Cursor(lines)

    mats: List[dict] = []
    geoms: List[dict] = []
    cam: Optional[T.Camera] = None
    settings = T.RenderSettings()
    envmap_path: Optional[str] = None
    envsky: Optional[list] = None
    base = os.path.dirname(os.path.abspath(path))

    while not cur.eof():
        line = cur.next()
        if _is_blank(line) or _is_comment(line):
            continue
        tok = _tokenize(line)
        kw = tok[0]
        if kw == "MATERIAL":
            mid = int(tok[1])
            if mid != len(mats):
                raise SceneParseError(
                    f"MATERIAL ID {mid} does not match expected {len(mats)}")
            mat = dict(color=(0, 0, 0), specex=0.0, speccol=(0, 0, 0),
                       refl=0.0, refr=0.0, ior=0.0, emittance=0.0,
                       texture=None, checker=None, normalmap=None,
                       bump=None, disp=0.0)
            for row in _read_block(cur):
                k = row[0]
                if k == "RGB":
                    mat["color"] = tuple(float(v) for v in row[1:4])
                elif k == "SPECEX":
                    mat["specex"] = float(row[1])
                elif k == "SPECRGB":
                    mat["speccol"] = tuple(float(v) for v in row[1:4])
                elif k == "REFL":
                    mat["refl"] = float(row[1])
                elif k == "REFR":
                    mat["refr"] = float(row[1])
                elif k == "REFRIOR":
                    mat["ior"] = float(row[1])
                elif k == "EMITTANCE":
                    mat["emittance"] = float(row[1])
                elif k == "TEXTURE":
                    mat["texture"] = os.path.join(base, row[1])
                elif k == "CHECKER":
                    mat["checker"] = [float(v) for v in row[1:5]]
                elif k == "NORMALMAP":
                    mat["normalmap"] = os.path.join(base, row[1])
                elif k == "BUMP":
                    # BUMP <scale> <freq>: procedural world-space bump
                    mat["bump"] = (float(row[1]), float(row[2]))
                elif k == "DISPERSION":
                    # DISPERSION <d>: per-channel ior = REFRIOR + d*(c-1)
                    mat["disp"] = float(row[1])
            mats.append(mat)
        elif kw == "OBJECT":
            gid = int(tok[1])
            if gid != len(geoms):
                raise SceneParseError(
                    f"OBJECT ID {gid} does not match expected {len(geoms)}")
            g = dict(type=None, mesh_path=None, material=0,
                     trans=(0, 0, 0), rotat=(0, 0, 0), scale=(1, 1, 1),
                     veloc=(0, 0, 0),
                     sdf_kind=(-1, -1, -1), sdf_params=None)
            # type line (reference: src/scene.cpp:46-55)
            while True:
                tline = cur.next()
                if not _is_comment(tline):
                    break
            trow = _tokenize(tline)
            tname = trow[0]
            if tname == "sphere":
                g["type"] = T.SPHERE
            elif tname == "cube":
                g["type"] = T.CUBE
            elif tname == "mesh":
                g["type"] = T.MESH
                g["mesh_path"] = os.path.join(base, trow[1])
            elif tname == "sdf":
                from ..ops import sdf as S
                kinds = dict(torus=S.TORUS, roundbox=S.ROUNDBOX,
                             capsule=S.CAPSULE, metaball=S.METABALL,
                             csg_union=S.CSG_UNION, csg_inter=S.CSG_INTER,
                             csg_diff=S.CSG_DIFF)
                if len(trow) < 2 or trow[1] not in kinds:
                    raise SceneParseError(
                        f"sdf needs a kind in {sorted(kinds)}")
                g["type"] = T.SDF
                g["sdf_kind"] = (kinds[trow[1]], -1, -1)
                g["sdf_params"] = [0.0] * 20
            else:
                raise SceneParseError(f"unknown OBJECT type {tname!r}")
            subshape = dict(sphere=0, box=1)   # ops/sdf SUB_SPHERE/SUB_BOX
            for row in _read_block(cur):
                k = row[0]
                if k == "material":
                    g["material"] = int(row[1])
                elif k == "TRANS":
                    g["trans"] = tuple(float(v) for v in row[1:4])
                elif k == "ROTAT":
                    g["rotat"] = tuple(float(v) for v in row[1:4])
                elif k == "SCALE":
                    g["scale"] = tuple(float(v) for v in row[1:4])
                elif k == "VELOC":
                    g["veloc"] = tuple(float(v) for v in row[1:4])
                elif k == "PARAMS" and g["type"] == T.SDF:
                    vals = [float(v) for v in row[1:21]]
                    g["sdf_params"][:len(vals)] = vals
                    from ..ops import sdf as S
                    if g["sdf_kind"][0] == S.METABALL:
                        # metaball PARAMS = k then (x y z r) per ball; the
                        # static ball count rides in aux_a
                        nballs = max(1, min((len(vals) - 1) // 4,
                                            S.MAX_BALLS))
                        g["sdf_kind"] = (S.METABALL, nballs, -1)
                elif k in ("A", "B") and g["type"] == T.SDF:
                    if row[1] not in subshape:
                        raise SceneParseError(
                            f"CSG sub-shape must be sphere|box, got {row[1]!r}")
                    vals = [float(v) for v in row[2:10]]
                    off = 0 if k == "A" else 8
                    g["sdf_params"][off:off + len(vals)] = vals
                    kd, a, b = g["sdf_kind"]
                    g["sdf_kind"] = ((kd, subshape[row[1]], b) if k == "A"
                                     else (kd, a, subshape[row[1]]))
            geoms.append(g)
        elif kw == "CAMERA":
            res = (800, 800)
            fovy = 45.0
            eye = (0.0, 0.0, 0.0)
            look = (0.0, 0.0, -1.0)
            up = (0.0, 1.0, 0.0)
            aperture = 0.0
            focal = 0.0
            shutter = 0.0
            for row in _read_block(cur):
                k = row[0]
                if k == "RES":
                    res = (int(row[1]), int(row[2]))
                elif k == "FOVY":
                    fovy = float(row[1])
                elif k == "ITERATIONS":
                    settings.iterations = int(row[1])
                elif k == "DEPTH":
                    settings.trace_depth = int(row[1])
                elif k == "FILE":
                    settings.image_name = row[1]
                elif k == "EYE":
                    eye = tuple(float(v) for v in row[1:4])
                elif k == "LOOKAT":
                    look = tuple(float(v) for v in row[1:4])
                elif k == "UP":
                    up = tuple(float(v) for v in row[1:4])
                elif k == "APERTURE":
                    aperture = float(row[1])
                elif k == "FOCAL":
                    focal = float(row[1])
                elif k == "SHUTTER":
                    shutter = float(row[1])
            cam = T.Camera(
                resolution=res,
                position=np.array(eye, np.float32),
                look_at=np.array(look, np.float32),
                up=np.array(up, np.float32),
                fovy=fovy, aperture=aperture, focal_distance=focal,
                shutter=shutter,
            ).derive()
        elif kw == "ENVMAP":
            envmap_path = os.path.join(base, tok[1])
        elif kw == "ENVSKY":
            envsky = [float(v) for v in tok[1:14]]

    if cam is None:
        raise SceneParseError("scene has no CAMERA block")
    if not mats:
        raise SceneParseError("scene has no materials")

    materials = T.Materials(
        color=jnp.array([mt["color"] for mt in mats], jnp.float32),
        specular_exponent=jnp.array([mt["specex"] for mt in mats], jnp.float32),
        specular_color=jnp.array([mt["speccol"] for mt in mats], jnp.float32),
        has_reflective=jnp.array([mt["refl"] for mt in mats], jnp.float32),
        has_refractive=jnp.array([mt["refr"] for mt in mats], jnp.float32),
        ior=jnp.array([mt["ior"] for mt in mats], jnp.float32),
        emittance=jnp.array([mt["emittance"] for mt in mats], jnp.float32),
        dispersion=jnp.array([mt["disp"] for mt in mats], jnp.float32),
    )

    transforms = np.stack([
        m.build_transformation_matrix(g["trans"], g["rotat"], g["scale"])
        for g in geoms]) if geoms else np.zeros((0, 4, 4), np.float32)
    inv = np.stack([m.inverse(t) for t in transforms]) if geoms else transforms
    invt = np.stack([m.inverse_transpose(t) for t in transforms]) if geoms else transforms

    # Load meshes referenced by OBJECTs (deduplicated by path).
    mesh_paths: List[str] = []
    mesh_ids = []
    for g in geoms:
        if g["type"] == T.MESH:
            if g["mesh_path"] not in mesh_paths:
                mesh_paths.append(g["mesh_path"])
            mesh_ids.append(mesh_paths.index(g["mesh_path"]))
        else:
            mesh_ids.append(-1)

    has_sdf = any(g["type"] == T.SDF for g in geoms)
    geom_soa = T.Geoms(
        type=jnp.array([g["type"] for g in geoms], jnp.int32),
        material_id=jnp.array([g["material"] for g in geoms], jnp.int32),
        transform=jnp.asarray(transforms),
        inverse_transform=jnp.asarray(inv),
        inverse_transpose=jnp.asarray(invt),
        velocity=jnp.array([g["veloc"] for g in geoms], jnp.float32),
        mesh_id=jnp.array(mesh_ids, jnp.int32),
        sdf_params=(jnp.array([g["sdf_params"] or [0.0] * 20 for g in geoms],
                              jnp.float32) if has_sdf else None),
    )
    sdf_kinds = (tuple(g["sdf_kind"] for g in geoms) if has_sdf else ())

    if mesh_paths:
        from .bvh import build_mesh_bundle
        from ..ops.bvh8 import pack_all8
        meshes = build_mesh_bundle(mesh_paths)
        # one 8-wide BVH per mesh: the tables the mesh traversal reads
        # (ops/bvh8.py)
        packed = pack_all8(meshes)
    else:
        meshes = T.MeshBundle.empty()
        packed = ()

    textures = _load_textures(mats, envmap_path, envsky)

    return T.Scene(camera=cam, settings=settings, materials=materials,
                   geoms=geom_soa, meshes=meshes, textures=textures,
                   source_path=os.path.abspath(path), packed_meshes=packed,
                   sdf_kinds=sdf_kinds)


def _load_textures(mats: List[dict], envmap_path: Optional[str],
                   envsky: Optional[list] = None) -> T.Textures:
    from ..utils.image import read_image  # lazy: avoids cycle
    import numpy as _np
    m_count = max(len(mats), 1)
    checker_scale = _np.zeros((m_count,), _np.float32)
    checker_c2 = _np.zeros((m_count, 3), _np.float32)
    for i, mt in enumerate(mats):
        if mt.get("checker"):
            c = mt["checker"]
            checker_scale[i] = c[0]   # CHECKER s r2 g2 b2: RGB vs (r2,g2,b2)
            checker_c2[i] = c[1:4]
    sky = _np.zeros((14,), _np.float32)
    if envsky is not None:
        sky[0] = 1.0
        sky[1:1 + len(envsky)] = envsky

    bump = _np.zeros((m_count, 2), _np.float32)
    for i, mt in enumerate(mats):
        if mt.get("bump"):
            bump[i] = mt["bump"]

    tex_paths = [mt["texture"] for mt in mats]
    nrm_paths = [mt.get("normalmap") for mt in mats]
    imgs = {}
    for p in tex_paths + nrm_paths:
        if p is not None and p not in imgs:
            imgs[p] = read_image(p)
    if not imgs and envmap_path is None:
        base_tex = T.Textures.none(len(mats))
        import dataclasses as _dc
        return _dc.replace(base_tex,
                           checker_scale=jnp.asarray(checker_scale),
                           checker_color2=jnp.asarray(checker_c2),
                           sky=jnp.asarray(sky),
                           bump=jnp.asarray(bump))

    # Pack a vertical-strip atlas (simple + static-shape friendly).
    if imgs:
        ordered = list(imgs.items())
        wa = max(im.shape[1] for _, im in ordered)
        ha = sum(im.shape[0] for _, im in ordered)
        atlas = np.zeros((ha, wa, 3), np.float32)
        offsets = {}
        y = 0
        for p, im in ordered:
            atlas[y:y + im.shape[0], :im.shape[1]] = im
            offsets[p] = (0, y, im.shape[1], im.shape[0])
            y += im.shape[0]
    else:
        atlas = np.zeros((1, 1, 3), np.float32)
        offsets = {}

    rect = np.zeros((len(mats), 4), np.int32)
    tex_id = -np.ones((len(mats),), np.int32)
    for i, p in enumerate(tex_paths):
        if p is not None:
            rect[i] = offsets[p]
            tex_id[i] = 0
    # normal maps live in the SAME strip (they are just RGB images);
    # their own rect/id rows select them at shade time (ops/wavefront
    # applies the tangent-space perturbation when nrm_id >= 0)
    nrm_rect = np.zeros((len(mats), 4), np.int32)
    nrm_id = -np.ones((len(mats),), np.int32)
    for i, p in enumerate(nrm_paths):
        if p is not None:
            nrm_rect[i] = offsets[p]
            nrm_id[i] = 0
    if envmap_path is not None:
        env = read_image(envmap_path)
        env_enabled = 1.0
    else:
        env = np.zeros((1, 1, 3), np.float32)
        env_enabled = 0.0
    from ..utils.image import pack_rgb8, pack_rgbe

    def _packed_or_none(img, pack, unpack):
        # Only ship the single-gather plane when it roundtrips BITWISE to
        # the f32 plane (true for PNG-sourced LDR / HDR-sourced RGBE; an
        # unusual source, e.g. an .hdr used as a material texture, falls
        # back to the three-take path instead of losing precision).
        p = pack(img)
        if np.array_equal(unpack(p).reshape(img.shape), img):
            return jnp.asarray(p)
        return None

    def _unpack_rgb8(p):
        b = np.stack([(p & 0xFF), (p >> 8) & 0xFF, (p >> 16) & 0xFF], -1)
        return b.astype(np.float32) / 255.0

    def _unpack_rgbe(p):
        # mirrors the shader's clamped bit-constructed power of two
        # (ops/wavefront._sample_env_planar) so the guard rejects any
        # asset the shader couldn't reproduce exactly
        e = ((p >> 24) & 0xFF).astype(np.int32)
        s = np.where(e > 0,
                     np.exp2(np.clip(e - 9, 1, 254) - 127.0), 0.0
                     ).astype(np.float32)
        m = np.stack([(p & 0xFF), (p >> 8) & 0xFF, (p >> 16) & 0xFF], -1)
        return (m.astype(np.float32) + 0.5) * s[..., None]

    return T.Textures(
        atlas=jnp.asarray(atlas), rect=jnp.asarray(rect),
        tex_id=jnp.asarray(tex_id), env=jnp.asarray(env),
        env_enabled=jnp.asarray(env_enabled, jnp.float32),
        checker_scale=jnp.asarray(checker_scale),
        checker_color2=jnp.asarray(checker_c2),
        sky=jnp.asarray(sky),
        atlas_packed=_packed_or_none(atlas, pack_rgb8, _unpack_rgb8),
        env_packed=_packed_or_none(env, pack_rgbe, _unpack_rgbe),
        # atlas_pair (--bilinear-fast's RGB565 plane) is built LAZILY by
        # the renderer when the flag is actually set (build_atlas_pair
        # below) — it costs +4 bytes/texel and bake/compile constant size
        # for every textured scene otherwise.
        bump=jnp.asarray(bump), nrm_rect=jnp.asarray(nrm_rect),
        nrm_id=jnp.asarray(nrm_id),
    )


def build_atlas_pair(textures: T.Textures):
    """RGB565 horizontal-pair plane for --bilinear-fast (scene/types.py
    atlas_pair): entry (y,x) packs texel(y,x) in the low 16 bits and its
    RIGHT neighbor in the high 16, the neighbor clamped INSIDE the texel's
    own strip image so a rect's right-edge pair never bleeds into the next
    image. Rebuilt from the atlas + the per-material rects (every strip
    image's rect appears in rect/nrm_rect, so the parse-time layout is
    recoverable). Returns a [Ha*Wa] uint32 plane, or None for an untextured
    scene. Called lazily by Renderer/ShardedRenderer when bilinear_fast is
    requested."""
    atlas = np.asarray(textures.atlas)
    if atlas.shape[0] == 1 and atlas.shape[1] == 1:
        return None
    from ..utils.image import pack_565_pair
    rects = set()
    for rect_t, id_t in ((textures.rect, textures.tex_id),
                         (textures.nrm_rect, textures.nrm_id)):
        rect_n, id_n = np.asarray(rect_t), np.asarray(id_t)
        for i in np.nonzero(id_n >= 0)[0]:
            rects.add(tuple(int(v) for v in rect_n[i]))
    pair = np.zeros(atlas.shape[:2], np.uint32)
    for (x0, y0, w, h) in rects:
        pair[y0:y0 + h, x0:x0 + w] = pack_565_pair(
            atlas[y0:y0 + h, x0:x0 + w])
    return jnp.asarray(pair.reshape(-1))

"""Generate procedural assets for the benchmark configs (BASELINE.json
configs 2-5). The container has no network egress, so the canonical Stanford
bunny is replaced by a displaced icosphere ("blob") of comparable triangle
count (~70k); the texture/env assets are procedural.

Run once:  python tools/gen_assets.py
Writes under scenes/meshes/ and scenes/assets/ (idempotent).
"""
from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

MESH_DIR = os.path.join(ROOT, "scenes", "meshes")
ASSET_DIR = os.path.join(ROOT, "scenes", "assets")


def icosphere(subdiv: int) -> tuple:
    """Unit icosphere: returns (verts [V,3], faces [F,3])."""
    t = (1.0 + 5 ** 0.5) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)

    for _ in range(subdiv):
        cache = {}
        new_faces = []
        verts_l = verts.tolist()

        def midpoint(a, b):
            k = (min(a, b), max(a, b))
            if k in cache:
                return cache[k]
            m = np.asarray(verts_l[a]) + np.asarray(verts_l[b])
            m /= np.linalg.norm(m)
            verts_l.append(m.tolist())
            cache[k] = len(verts_l) - 1
            return cache[k]

        for f in faces:
            a, b, c = int(f[0]), int(f[1]), int(f[2])
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc],
                          [ab, bc, ca]]
        verts = np.asarray(verts_l)
        faces = np.asarray(new_faces, np.int64)
    return verts, faces


def displaced_blob(subdiv: int = 6, seed: int = 0):
    """Bunny-stand-in: icosphere with smooth multi-frequency displacement.
    subdiv=6 -> 81920 triangles (Stanford bunny is ~69k)."""
    verts, faces = icosphere(subdiv)
    rng = np.random.default_rng(seed)
    # sum of random low-order spherical harmonics-ish lobes
    disp = np.zeros(len(verts))
    for _ in range(12):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        freq = rng.uniform(1.0, 4.0)
        phase = rng.uniform(0, 2 * np.pi)
        amp = rng.uniform(0.02, 0.09)
        disp += amp * np.sin(freq * (verts @ axis) * np.pi + phase)
    r = 1.0 + disp
    return verts * r[:, None], faces


def torus(major_seg=96, minor_seg=64, R=1.0, r=0.35):
    u = np.linspace(0, 2 * np.pi, major_seg, endpoint=False)
    v = np.linspace(0, 2 * np.pi, minor_seg, endpoint=False)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    x = (R + r * np.cos(vv)) * np.cos(uu)
    y = r * np.sin(vv)
    z = (R + r * np.cos(vv)) * np.sin(uu)
    verts = np.stack([x, y, z], -1).reshape(-1, 3)
    faces = []
    for i in range(major_seg):
        for j in range(minor_seg):
            a = i * minor_seg + j
            b = ((i + 1) % major_seg) * minor_seg + j
            c = ((i + 1) % major_seg) * minor_seg + (j + 1) % minor_seg
            d = i * minor_seg + (j + 1) % minor_seg
            faces += [[a, b, c], [a, c, d]]
    return verts, np.asarray(faces, np.int64)


def write_obj(path, verts, faces, with_normals=True, with_uv=False):
    lines = []
    for v in verts:
        lines.append(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}")
    if with_uv:
        for v in verts:
            th = np.arctan2(v[2], v[0]) / (2 * np.pi) + 0.5
            ph = np.arccos(np.clip(v[1] / (np.linalg.norm(v) + 1e-9), -1, 1)) / np.pi
            lines.append(f"vt {th:.6f} {1 - ph:.6f}")
    if with_normals:
        # area-weighted vertex normals
        n = np.zeros_like(verts)
        fv = verts[faces]
        fn = np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
        for k in range(3):
            np.add.at(n, faces[:, k], fn)
        n /= np.linalg.norm(n, axis=1, keepdims=True) + 1e-12
        for v in n:
            lines.append(f"vn {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}")
    for f in faces:
        a, b, c = f + 1
        if with_uv and with_normals:
            lines.append(f"f {a}/{a}/{a} {b}/{b}/{b} {c}/{c}/{c}")
        elif with_normals:
            lines.append(f"f {a}//{a} {b}//{b} {c}//{c}")
        else:
            lines.append(f"f {a} {b} {c}")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    print(f"wrote {path}: {len(verts)} verts, {len(faces)} tris")


def checker_png(path, n=512, tiles=16):
    from project3_cuda_path_tracer_tpu.utils.image import write_png
    yy, xx = np.mgrid[0:n, 0:n]
    c = (((xx * tiles // n) + (yy * tiles // n)) % 2).astype(np.float32)
    img = np.stack([0.9 * c + 0.08 * (1 - c),
                    0.35 * c + 0.5 * (1 - c),
                    0.15 * c + 0.75 * (1 - c)], -1)
    write_png(path, (img * 255).astype(np.uint8))
    print("wrote", path)


def sky_hdr(path, h=256, w=512):
    from project3_cuda_path_tracer_tpu.utils.image import write_hdr
    v = np.linspace(0, 1, h)[:, None]  # 0=up
    u = np.linspace(0, 1, w)[None, :]
    # gradient sky: bright zenith-blue to warm horizon + a sun disk
    sky = np.zeros((h, w, 3), np.float32)
    sky[..., 0] = 0.35 + 1.2 * np.maximum(0, v - 0.45) ** 1.5
    sky[..., 1] = 0.55 + 0.9 * np.maximum(0, v - 0.45) ** 1.5
    sky[..., 2] = 1.1 - 0.5 * v
    sun_u, sun_v = 0.3, 0.35
    d2 = ((u - sun_u) * 2) ** 2 + ((v - sun_v)) ** 2
    sky += 40.0 * np.exp(-d2 / 0.001)[..., None]
    write_hdr(path, np.maximum(sky, 0).astype(np.float32))
    print("wrote", path)


def regen_self_golden():
    """Regenerate tests/golden_cornell_64x64_8spp_seed123.npz after a
    DELIBERATE estimator change (tests/test_golden.py compares bitwise).

    Must run under EXACTLY the test env (CPU backend, 8 virtual devices):
    the default "rbg" PRNG rides XLA's RngBitGenerator, whose bitstream
    depends on backend AND device topology — a 1-device artifact fails
    bitwise against an 8-device test render. Re-exec with the right env
    rather than trusting the caller."""
    import subprocess
    env_ok = (os.environ.get("JAX_PLATFORMS") == "cpu"
              and "xla_force_host_platform_device_count=8"
              in os.environ.get("XLA_FLAGS", ""))
    if not env_ok:
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                            + " --xla_force_host_platform_device_count=8"
                            ).strip()
        raise SystemExit(subprocess.call(
            [sys.executable, os.path.abspath(__file__), "--self-golden"],
            env=env))
    import jax
    assert jax.devices()[0].platform == "cpu" and len(jax.devices()) == 8
    from project3_cuda_path_tracer_tpu import load_scene
    from project3_cuda_path_tracer_tpu.render.integrator import Renderer
    s = load_scene("scenes/cornell.txt")
    s.camera.resolution = (64, 64)
    s.camera.derive()
    r = Renderer(s)
    r.render(8, seed=123)
    out = os.path.join(ROOT, "tests", "golden_cornell_64x64_8spp_seed123.npz")
    np.savez_compressed(out, accum=np.asarray(r.accum, dtype=np.float32))
    print("wrote", out)


def main():
    if "--self-golden" in sys.argv:
        regen_self_golden()
        return
    os.makedirs(MESH_DIR, exist_ok=True)
    os.makedirs(ASSET_DIR, exist_ok=True)

    blob_path = os.path.join(MESH_DIR, "blob.obj")
    if not os.path.exists(blob_path):
        v, f = displaced_blob(subdiv=6)
        write_obj(blob_path, v, f, with_normals=True, with_uv=True)

    torus_path = os.path.join(MESH_DIR, "torus.obj")
    if not os.path.exists(torus_path):
        v, f = torus()
        write_obj(torus_path, v, f, with_normals=True, with_uv=True)

    checker = os.path.join(ASSET_DIR, "checker.png")
    if not os.path.exists(checker):
        checker_png(checker)

    sky = os.path.join(ASSET_DIR, "sky.hdr")
    if not os.path.exists(sky):
        sky_hdr(sky)


if __name__ == "__main__":
    main()

"""Generate scenes/manylights256.txt: 256 sphere emitters, each with its
OWN material (257+ materials total), over a glossy floor.

The many-light stress scene (round-5 verdict item): proves the whole
direct-lighting path is DYNAMIC in light count — the CDF-gather face
sampler (ops/nee.py, F > UNROLL_MAX_FACES), gather-based material fetch
(ops/wavefront.MAT_UNROLL_MAX), and RIS candidates all compile O(1) in
F and M (the static unroll took >50 min of CPU compile at just 64
faces x M=4). Light-SELECTION variance dominates here — the home regime
for --nee-ris / --restir.

Deterministic (fixed seed); run from the repo root:
    python tools/gen_manylights256.py > scenes/manylights256.txt
"""
import colorsys

import numpy as np

N_SIDE = 16          # 16 x 16 grid = 256 lights
ROOM = 24.0

rng = np.random.default_rng(256)

print("// 256 sphere emitters (one material EACH; generated by")
print("// tools/gen_manylights256.py — do not hand-edit) over a glossy")
print("// floor; light-selection variance dominates: the --nee-ris /")
print("// --restir home regime at a scale only the dynamic (gather)")
print("// light path can compile.")
print()
print("MATERIAL 0")
print("RGB .7 .7 .7")
print("SPECEX 64")
print("SPECRGB .5 .5 .5")
print("REFL .3")
print("EMITTANCE 0")
print()
print("MATERIAL 1")
print("RGB .6 .6 .65")
print("EMITTANCE 0")
print()

mat = 2
for i in range(N_SIDE * N_SIDE):
    hue = rng.uniform(0.0, 1.0)
    sat = rng.uniform(0.4, 1.0)
    r, g, b = colorsys.hsv_to_rgb(hue, sat, 1.0)
    # 100x intensity spread (log-uniform): selection variance source
    emit = float(np.exp(rng.uniform(np.log(1.0), np.log(100.0))))
    print(f"MATERIAL {mat}")
    print(f"RGB {r:.3f} {g:.3f} {b:.3f}")
    print(f"EMITTANCE {emit:.2f}")
    print()
    mat += 1

print("CAMERA")
print("RES 800 800")
print("FOVY 40")
print("ITERATIONS 2000")
print("DEPTH 5")
print("FILE manylights256")
print("EYE 0 4 14")
print("LOOKAT 0 2.5 0")
print("UP 0 1 0")
print()
print("OBJECT 0")
print("cube")
print("material 0")
print("TRANS 0 0 0")
print("ROTAT 0 0 0")
print(f"SCALE {ROOM} .1 {ROOM}")
print()
print("OBJECT 1")
print("cube")
print("material 1")
print("TRANS 0 6 -8")
print("ROTAT 0 90 0")
print(f"SCALE .1 12 {ROOM}")
print()

obj = 2
half = ROOM / 2.0 - 1.5
for iy in range(N_SIDE):
    for ix in range(N_SIDE):
        x = -half + (2 * half) * (ix + 0.5) / N_SIDE + rng.uniform(-0.3, 0.3)
        z = -7.5 + 6.5 * (iy + 0.5) / N_SIDE + rng.uniform(-0.15, 0.15)
        y = rng.uniform(1.2, 6.5)
        rad = rng.uniform(0.12, 0.25)
        print(f"OBJECT {obj}")
        print("sphere")
        print(f"material {2 + iy * N_SIDE + ix}")
        print(f"TRANS {x:.2f} {y:.2f} {z:.2f}")
        print("ROTAT 0 0 0")
        print(f"SCALE {rad:.2f} {rad:.2f} {rad:.2f}")
        print()
        obj += 1

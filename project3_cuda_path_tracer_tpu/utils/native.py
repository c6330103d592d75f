"""Native libraries of the path tracer (native/).

Host runtime: ctypes bindings for the C++ OBJ parser, BVH builder and PNG
writer (the reference's host runtime is C++ too, reference src/*.cpp).
They degrade gracefully: every entry point answers `is_available()` and
callers fall back to the pure-Python implementations (scene/bvh.py,
utils/image.py) when the library isn't built.  Build once:  make -C native

GPU kernels: `cuda_library()` builds native/src/bvh8_traverse.cu with nvcc
for sm_90a on first use (or `make -C native cuda`, which calls the same
builder) and returns the shared library's path; ops/bvh8.py registers its
handlers with XLA. There is no fallback: a GPU program that needs the
library fails when it cannot be built.
"""
from __future__ import annotations

import ctypes as C
import os
import shutil
import subprocess
import sys
from typing import Optional, Tuple

import numpy as np

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")
_LIB_PATHS = [os.path.join(NATIVE_DIR, "build", "libpt_native.so")]
CUDA_SOURCE = os.path.join(NATIVE_DIR, "src", "bvh8_traverse.cu")
CUDA_LIBRARY = os.path.join(NATIVE_DIR, "build", "libpt_cuda.so")
# Full-precision float (no --use_fast_math): the kernel must agree with
# the plain XLA walk. sm_90a is Hopper's own target.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> Optional[str]:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    return default if os.path.exists(default) else None


def cuda_library(source: Optional[str] = None,
                 library: Optional[str] = None,
                 timeout: float = 600.0) -> str:
    """Path of the CUDA kernel library (default CUDA_LIBRARY), compiled
    from `source` (default CUDA_SOURCE) when it is missing or older than
    the source. Raises RuntimeError when it cannot be built (no nvcc, or a
    compile error)."""
    source = source or CUDA_SOURCE
    library = library or CUDA_LIBRARY
    if (os.path.exists(library)
            and os.path.getmtime(library) >= os.path.getmtime(source)):
        return library
    nvcc = _nvcc()
    if nvcc is None:
        raise RuntimeError(
            f"{library} is missing and nvcc was not found to build it from "
            f"{source} (make -C native cuda)")
    import jax.ffi
    os.makedirs(os.path.dirname(library), exist_ok=True)
    tmp = f"{library}.tmp{os.getpid()}"
    cmd = [nvcc, *NVCC_FLAGS, "-I", jax.ffi.include_dir(), source,
           "-o", tmp]
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"building {library} failed:\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, library)
    return library

_lib = None


class _ObjResult(C.Structure):
    _fields_ = [("tri_count", C.c_int64),
                ("verts", C.POINTER(C.c_float)),
                ("normals", C.POINTER(C.c_float)),
                ("uvs", C.POINTER(C.c_float))]


class _BvhResult(C.Structure):
    _fields_ = [("node_count", C.c_int64),
                ("perm", C.POINTER(C.c_int64)),
                ("node_lo", C.POINTER(C.c_float)),
                ("node_hi", C.POINTER(C.c_float)),
                ("node_start", C.POINTER(C.c_int32)),
                ("node_count_arr", C.POINTER(C.c_int32)),
                ("node_skip", C.POINTER(C.c_int32)),
                ("node_right", C.POINTER(C.c_int32))]


def _load():
    global _lib
    if _lib is not None:
        return _lib
    for p in _LIB_PATHS:
        if os.path.exists(p):
            lib = C.CDLL(p)
            lib.pt_parse_obj.restype = C.POINTER(_ObjResult)
            lib.pt_parse_obj.argtypes = [C.c_char_p]
            lib.pt_free_obj.argtypes = [C.POINTER(_ObjResult)]
            lib.pt_build_bvh.restype = C.POINTER(_BvhResult)
            lib.pt_build_bvh.argtypes = [C.POINTER(C.c_float), C.c_int64,
                                         C.c_int32]
            lib.pt_free_bvh.argtypes = [C.POINTER(_BvhResult)]
            lib.pt_write_png.restype = C.c_int
            lib.pt_write_png.argtypes = [C.c_char_p, C.c_int32, C.c_int32,
                                         C.POINTER(C.c_ubyte)]
            _lib = lib
            return lib
    _lib = False
    return False


def is_available() -> bool:
    return bool(_load())


def parse_obj(path: str) -> Optional[Tuple[np.ndarray, np.ndarray,
                                           np.ndarray]]:
    """(verts [T,3,3], normals [T,3,3], uvs [T,3,2]) or None if unavailable."""
    lib = _load()
    if not lib:
        return None
    res = lib.pt_parse_obj(path.encode())
    if not res:
        raise FileNotFoundError(path)
    try:
        t = res.contents.tri_count
        v = np.ctypeslib.as_array(res.contents.verts,
                                  (t, 3, 3)).copy()
        n = np.ctypeslib.as_array(res.contents.normals, (t, 3, 3)).copy()
        uv = np.ctypeslib.as_array(res.contents.uvs, (t, 3, 2)).copy()
        return v, n, uv
    finally:
        lib.pt_free_obj(res)


def build_bvh(verts: np.ndarray, leaf_k: int):
    """Mirror of scene.bvh.build_bvh; returns the same 7-tuple or None."""
    lib = _load()
    if not lib:
        return None
    v = np.ascontiguousarray(verts, np.float32)
    t = v.shape[0]
    res = lib.pt_build_bvh(v.ctypes.data_as(C.POINTER(C.c_float)), t,
                           leaf_k)
    try:
        nb = res.contents.node_count
        return (
            np.ctypeslib.as_array(res.contents.perm, (t,)).copy(),
            np.ctypeslib.as_array(res.contents.node_lo, (nb, 3)).copy(),
            np.ctypeslib.as_array(res.contents.node_hi, (nb, 3)).copy(),
            np.ctypeslib.as_array(res.contents.node_start, (nb,)).copy(),
            np.ctypeslib.as_array(res.contents.node_count_arr, (nb,)).copy(),
            np.ctypeslib.as_array(res.contents.node_skip, (nb,)).copy(),
            np.ctypeslib.as_array(res.contents.node_right, (nb,)).copy(),
        )
    finally:
        lib.pt_free_bvh(res)


def write_png(path: str, rgb8: np.ndarray) -> bool:
    lib = _load()
    if not lib:
        return False
    img = np.ascontiguousarray(rgb8, np.uint8)
    h, w, _ = img.shape
    rc = lib.pt_write_png(path.encode(), w, h,
                          img.ctypes.data_as(C.POINTER(C.c_ubyte)))
    return rc == 0


if __name__ == "__main__":
    # `make -C native cuda` builds the GPU library through this entry.
    print(cuda_library())
    sys.exit(0)

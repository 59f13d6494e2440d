"""The host geometry builders of ``hostsrc/ngp_host.cpp`` through ctypes:
:func:`bvh_build`, :func:`octree_build` and :func:`chessboard_dt`, with the
numpy signatures of ``ngp_tpu/native/__init__.py`` (the thread count
added). Their output equals the numpy builders'
(``geometry/triangle_bvh.build_bvh_arrays``,
``geometry/triangle_octree``) array for array.

The library is compiled by ``g++`` at first use into
``build/ngp_tpu_torch/`` (git-ignored), named by a hash of the source and
the flags, as ``ops/cuda_build.py`` names the kernels' libraries. A
compiler or loader failure raises: nothing falls back to numpy here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from ngp_tpu_torch.ops.cuda_build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[1] / "hostsrc" / "ngp_host.cpp"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

_i64, _int, _vp = ctypes.c_int64, ctypes.c_int, ctypes.c_void_p
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
SIGNATURES = {
    "ngp_bvh_build": (_vp, [_f32p, _i64, _int, _int]),
    "ngp_bvh_n_nodes": (_i64, [_vp]),
    "ngp_bvh_n_padded": (_i64, [_vp]),
    "ngp_bvh_copy": (None, [_vp, _f32p, _f32p, _i32p, _i32p, _u8p, _f32p, _f32p, _i32p]),
    "ngp_bvh_free": (None, [_vp]),
    "ngp_octree_build": (_vp, [_f64p, _i64, _int, _int]),
    "ngp_octree_level_size": (_i64, [_vp, _int]),
    "ngp_octree_copy_level": (None, [_vp, _int, _i32p, _i32p]),
    "ngp_octree_n_vertices": (_i64, [_vp]),
    "ngp_octree_free": (None, [_vp]),
    "ngp_chessboard_dt": (None, [_u8p, _int, _i32p]),
}
_LIB: ctypes.CDLL | None = None


def lib_path() -> Path:
    """The library's path, named by a hash of the source and the flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libngp_host-{h.hexdigest()[:12]}.so"


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found (set CXX) to build the host builders")
    return cxx


def library() -> ctypes.CDLL:
    """The loaded library, compiled first where its file does not exist;
    raises ``RuntimeError`` where the compiler fails."""
    global _LIB
    if _LIB is None:
        out = lib_path()
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            proc = subprocess.run([_compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{proc.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        for fn, (restype, argtypes) in SIGNATURES.items():
            f = getattr(lib, fn)
            f.restype, f.argtypes = restype, argtypes
        _LIB = lib
    return _LIB


def bvh_build(triangles: np.ndarray, leaf_size: int, n_threads: int = 0):
    """The median-split BVH of ``triangles`` (T, 3, 3): (node_min,
    node_max, node_a, node_b, node_leaf (bool), triangles (Tp, 3, 3),
    normals, tri_index), as ``build_bvh_arrays`` returns them.
    ``n_threads`` 0 uses one a hardware thread."""
    lib = library()
    tris = np.ascontiguousarray(np.asarray(triangles).reshape(-1, 9), np.float32)
    h = lib.ngp_bvh_build(tris, tris.shape[0], leaf_size, n_threads)
    try:
        m, tp = int(lib.ngp_bvh_n_nodes(h)), int(lib.ngp_bvh_n_padded(h))
        node_min, node_max = np.empty((m, 3), np.float32), np.empty((m, 3), np.float32)
        node_a, node_b = np.empty((m,), np.int32), np.empty((m,), np.int32)
        node_leaf = np.empty((m,), np.uint8)
        out_tris, normals = np.empty((tp, 9), np.float32), np.empty((tp, 3), np.float32)
        tri_index = np.empty((tp,), np.int32)
        lib.ngp_bvh_copy(h, node_min, node_max, node_a, node_b, node_leaf, out_tris,
                         normals, tri_index)
    finally:
        lib.ngp_bvh_free(h)
    return (node_min, node_max, node_a, node_b, node_leaf.astype(bool),
            out_tris.reshape(tp, 3, 3), normals, tri_index)


def octree_build(triangles: np.ndarray, max_depth: int, n_threads: int = 0):
    """The octree refinement of ``triangles`` (T, 3, 3) to ``max_depth``
    levels: (codes per depth (n_d,) int32 sorted, dual-vertex ids per depth
    (n_d, 8) int32, n_vertices), as the numpy path of
    ``TriangleOctree.build`` makes them."""
    lib = library()
    tris = np.ascontiguousarray(np.asarray(triangles).reshape(-1, 9), np.float64)
    h = lib.ngp_octree_build(tris, tris.shape[0], max_depth, n_threads)
    try:
        codes, verts = [], []
        for d in range(max_depth):
            n = int(lib.ngp_octree_level_size(h, d))
            c, v = np.empty((n,), np.int32), np.empty((n, 8), np.int32)
            lib.ngp_octree_copy_level(h, d, c, v)
            codes.append(c)
            verts.append(v)
        n_vertices = int(lib.ngp_octree_n_vertices(h))
    finally:
        lib.ngp_octree_free(h)
    return codes, verts, n_vertices


def chessboard_dt(occ: np.ndarray) -> np.ndarray:
    """The exact L∞ distance transform of a (G, G, G) bool grid (two
    chamfer sweeps): int32, 0 at occupied cells."""
    lib = library()
    g = occ.shape[0]
    out = np.empty((g, g, g), np.int32)
    lib.ngp_chessboard_dt(np.ascontiguousarray(occ, np.uint8), g, out)
    return out

"""The host library of ``hostsrc/`` through ctypes: the geometry builders
of ``ngp_host.cpp`` (:func:`bvh_build`, :func:`octree_build` and
:func:`chessboard_dt`, with the numpy signatures of
``ngp_tpu/native/__init__.py``, the thread count added; their output equals
the numpy builders' (``geometry/triangle_bvh.build_bvh_arrays``,
``geometry/triangle_octree``) array for array), the JPEG decoder of
``jpeg_decode.cpp`` (:func:`jpeg_info`, :func:`jpeg_decode`) and the JPEG
encoder of ``jpeg_encode.cpp`` (:func:`jpeg_encode`); ``data/jpeg.py``
wraps the last three.

The library is compiled by ``g++`` at first use into
``build/ngp_tpu_torch/`` (git-ignored), named by a hash of the sources and
the flags, as ``ops/cuda_build.py`` names the kernels' libraries. A
compiler or loader failure raises: nothing falls back to numpy or Python
here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

# the kernels' build directory (``ops/cuda_build.py``), named here so that
# the JPEG reader and the converters run without importing torch
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ngp_tpu_torch"
_HOSTSRC = Path(__file__).resolve().parents[1] / "hostsrc"
SOURCES = (_HOSTSRC / "ngp_host.cpp", _HOSTSRC / "jpeg_decode.cpp",
           _HOSTSRC / "jpeg_encode.cpp")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

_i64, _int, _vp = ctypes.c_int64, ctypes.c_int, ctypes.c_void_p
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
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
    "ngp_jpeg_info": (_int, [ctypes.c_char_p, _i64, _i32p, _u8p, _i64]),
    "ngp_jpeg_decode": (None, [_i64, _vp, _i64p, _vp, _int, _int, _i32p, _u8p, _i64]),
    "ngp_jpeg_encode": (_i64, [_u8p, _int, _int, _int, _u8p, _i64]),
}
# the decoder's statuses: 1 a truncated or corrupt stream, 2 a mode it refuses
_JPEG_ERRORS = {1: ValueError, 2: NotImplementedError}
_ERR_LEN = 256
_LIB: ctypes.CDLL | None = None


def lib_path() -> Path:
    """The library's path, named by a hash of the sources and the flags."""
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
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
            proc = subprocess.run([_compiler(), *CXX_FLAGS, "-o", str(tmp),
                                   *map(str, SOURCES)], capture_output=True, text=True)
            if proc.returncode != 0:
                names = ", ".join(src.name for src in SOURCES)
                raise RuntimeError(f"g++ failed for {names}:\n{proc.stderr}")
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


def _jpeg_error(status: int, message: bytes, name: str) -> Exception:
    text = bytes(message).split(b"\0", 1)[0].decode(errors="replace")
    return _JPEG_ERRORS[status](f"{name}: {text}")


def jpeg_info(data: bytes, name: str = "<jpeg>") -> tuple:
    """(width, height, components, progressive) from the frame header of
    the JPEG ``data``; raises ``ValueError`` on a corrupt header."""
    info = np.zeros(4, np.int32)
    err = np.zeros(_ERR_LEN, np.uint8)
    status = library().ngp_jpeg_info(data, len(data), info, err, _ERR_LEN)
    if status:
        raise _jpeg_error(status, err, name)
    return int(info[0]), int(info[1]), int(info[2]), bool(info[3])


def jpeg_decode(datas: list, rgba: bool, n_threads: int = 0, names=None) -> list:
    """Decode the JPEG files ``datas`` (bytes each), one a thread over
    ``n_threads`` (0: one a hardware thread): (H, W, 4) RGBA uint8 each
    where ``rgba``, else (H, W) grey or (H, W, 3) RGB. Raises
    ``ValueError`` for a truncated or corrupt file and
    ``NotImplementedError`` for a mode the decoder refuses, naming the
    first such file."""
    names = names or [f"<jpeg {i}>" for i in range(len(datas))]
    lib = library()
    outs = []
    for data, name in zip(datas, names):
        w, h, c, _ = jpeg_info(data, name)
        shape = (h, w, 4) if rgba else (h, w) if c == 1 else (h, w, c)
        outs.append(np.empty(shape, np.uint8))
    n = len(datas)
    if n == 0:
        return outs
    bufs = [np.frombuffer(d, np.uint8) for d in datas]  # no copies
    ptrs = (ctypes.c_void_p * n)(*[b.ctypes.data for b in bufs])
    out_ptrs = (ctypes.c_void_p * n)(*[o.ctypes.data for o in outs])
    sizes = np.array([len(d) for d in datas], np.int64)
    status = np.zeros(n, np.int32)
    errs = np.zeros(n * _ERR_LEN, np.uint8)
    lib.ngp_jpeg_decode(n, ptrs, sizes, out_ptrs, int(rgba), n_threads, status, errs,
                        _ERR_LEN)
    for i in np.flatnonzero(status):
        raise _jpeg_error(int(status[i]), errs[i * _ERR_LEN:(i + 1) * _ERR_LEN], names[i])
    return outs


def jpeg_encode(rgb: np.ndarray, quality: int) -> bytes:
    """The baseline 4:2:0 JPEG file of the (H, W, 3) uint8 RGB image
    ``rgb`` at ``quality`` (1-100), as PIL writes it; the caller checks
    the shape, dtype and quality."""
    rgb = np.ascontiguousarray(rgb)
    h, w = rgb.shape[:2]
    # at most 27 bits a coefficient, every byte stuffed: 432 bytes a block,
    # 6 blocks an MCU of 16 x 16 pixels, and the headers
    cap = 1024 + 432 * 6 * ((w + 15) // 16) * ((h + 15) // 16)
    out = np.empty(cap, np.uint8)
    n = library().ngp_jpeg_encode(rgb.reshape(-1), w, h, quality, out, cap)
    if n < 0:
        raise RuntimeError(f"jpeg_encode: {-n} bytes exceed the bound of {cap}")
    return out[:n].tobytes()

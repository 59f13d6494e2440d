"""Triangle-mesh loading and normalization for SDF mode, the port's copy
of ``ngp_tpu/geometry/mesh.py`` (numpy only), with the ``.xyz`` point
cloud reader of the NeRF geometry priors.

Counterpart of the reference's ``load_mesh`` (``src/testbed_sdf.cu:1100-1185``)
and the obj/stl readers (``tinyobj_loader_wrapper.cpp``, ``stl_reader``):
vertices in, triangle soup out, normalized so the mesh sits centered in
[0,1]³ with 0.5% AABB inflation wiggle room, plus the area-weighted
triangle distribution used for surface sampling.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np


def load_obj(path: str) -> np.ndarray:
    """ASCII OBJ → (T, 3, 3) float32 triangle soup (fans for polygons)."""
    verts: list = []
    tris: list = []
    with open(path, "r", errors="ignore") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = []
                for tok in line.split()[1:]:
                    i = tok.split("/")[0]
                    i = int(i)
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):
                    tris.append((idx[0], idx[k], idx[k + 1]))
    v = np.asarray(verts, np.float32)
    t = np.asarray(tris, np.int64)
    return v[t]


def load_stl(path: str) -> np.ndarray:
    """Binary STL → (T, 3, 3) float32 triangle soup."""
    with open(path, "rb") as f:
        head = f.read(84)
        if len(head) < 84:
            raise ValueError("truncated STL")
        (n,) = struct.unpack("<I", head[80:84])
        data = np.frombuffer(f.read(n * 50), dtype=np.uint8).reshape(n, 50)
    tris = data[:, 12:48].copy().view(np.float32).reshape(n, 3, 3)
    return tris.astype(np.float32)


def load_mesh_file(path: str) -> np.ndarray:
    if path.lower().endswith(".obj"):
        return load_obj(path)
    if path.lower().endswith(".stl"):
        return load_stl(path)
    raise ValueError("SDF data path must be an ascii .obj or binary .stl mesh")


@dataclass
class Mesh:
    triangles: np.ndarray  # (T, 3, 3) float32, normalized to [0,1]^3
    mesh_scale: float  # original max AABB extent (for de-normalization)
    raw_aabb_min: np.ndarray
    raw_aabb_max: np.ndarray
    aabb_min: np.ndarray  # normalized-space AABB (inflated, clipped to unit)
    aabb_max: np.ndarray

    @property
    def n_triangles(self) -> int:
        return self.triangles.shape[0]

    def areas(self) -> np.ndarray:
        a, b, c = self.triangles[:, 0], self.triangles[:, 1], self.triangles[:, 2]
        return 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=-1)

    def area_cdf(self) -> np.ndarray:
        """Normalized inclusive CDF over triangle areas (DiscreteDistribution,
        ``discrete_distribution.h``)."""
        w = self.areas().astype(np.float64)
        cdf = np.cumsum(w)
        return (cdf / cdf[-1]).astype(np.float32)

    def normals(self) -> np.ndarray:
        a, b, c = self.triangles[:, 0], self.triangles[:, 1], self.triangles[:, 2]
        n = np.cross(b - a, c - a)
        return (n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)).astype(
            np.float32
        )


def normalize_mesh(raw_triangles: np.ndarray) -> Mesh:
    """Reference normalization (``load_mesh``): inflate the raw AABB by
    0.5% of its diagonal, scale by the max extent so the mesh is centered
    at (0.5,)³ inside the unit cube."""
    v = raw_triangles.reshape(-1, 3)
    mn, mx = v.min(axis=0), v.max(axis=0)
    diag = mx - mn
    inflate = float(np.linalg.norm(diag)) * 0.005
    mn, mx = mn - inflate, mx + inflate
    diag = mx - mn
    mesh_scale = float(diag.max())
    tris = ((raw_triangles - mn - 0.5 * diag) / mesh_scale + 0.5).astype(np.float32)

    v2 = tris.reshape(-1, 3)
    amn, amx = v2.min(axis=0), v2.max(axis=0)
    ainf = float(np.linalg.norm(amx - amn)) * 0.005
    amn = np.maximum(amn - ainf, 0.0)
    amx = np.minimum(amx + ainf, 1.0)
    return Mesh(
        triangles=tris,
        mesh_scale=mesh_scale,
        raw_aabb_min=mn.astype(np.float32),
        raw_aabb_max=mx.astype(np.float32),
        aabb_min=amn.astype(np.float32),
        aabb_max=amx.astype(np.float32),
    )


def load_mesh(path: str) -> Mesh:
    return normalize_mesh(load_mesh_file(path))


def sample_surface(mesh: Mesh, u: np.ndarray, cdf: np.ndarray | None = None) -> np.ndarray:
    """Area-uniform surface samples: ``u`` is (N, 3) uniforms — u[:,0]
    picks the triangle via the CDF, u[:,1:3] the point via the sqrt warp
    (``Triangle::sample_uniform_position``)."""
    if cdf is None:
        cdf = mesh.area_cdf()
    ti = np.searchsorted(cdf, u[:, 0], side="left").clip(0, mesh.n_triangles - 1)
    tri = mesh.triangles[ti]
    su = np.sqrt(u[:, 1])[:, None]
    v = u[:, 2][:, None]
    return (
        tri[:, 0] * (1.0 - su) + tri[:, 1] * (su * (1.0 - v)) + tri[:, 2] * (su * v)
    ).astype(np.float32)


def load_xyz(path: str) -> np.ndarray:
    """A ``.xyz`` point cloud (one ``x y z [extras]`` line a point; the
    fork's ``XYZLoader`` input, testbed_nerf.cu:3396-3407): lines with
    fewer than three columns or a non-number among the first three
    (headers, comments) are skipped. Returns (N, 3) float32 raw
    coordinates; the caller applies the dataset's scale, offset and axis
    cycle."""
    pts = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 3:
                try:
                    pts.append([float(parts[0]), float(parts[1]), float(parts[2])])
                except ValueError:
                    continue
    return np.asarray(pts, np.float32).reshape(-1, 3)

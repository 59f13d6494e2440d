"""The triangle octree as a sparse voxel pyramid, the port of
``ngp_tpu/geometry/triangle_octree.py`` (the reference's
``TriangleOctree``, ``triangle_octree.cuh:46-382``).

Per depth ``d`` the octree keeps the sorted linear codes ``x + y·2^d +
z·4^d`` of its occupied voxels and the 8 dual-vertex ids of each voxel
(vertices shared between voxels of a depth are one id; ids are numbered
depth by depth from the root). The reference's pointer walks become
batched queries on the octree's device:

- ``traverse`` → :meth:`TriangleOctree.lookup_level`, a ``searchsorted``
  of each query's code at one depth (an occupied voxel's parent is
  occupied, so each depth is looked up on its own);
- ``contains`` → the same at the finest depth;
- the tracer's empty-space ``ray_intersect`` → :meth:`skip_distance`, a
  lower bound on the distance to the occupied voxels from the chessboard
  distance transform of one depth (at most 128³ voxels);
- ``uniform_octree_sample_kernel`` → :meth:`sample_uniform`.

The build runs on the host: level by level, each triangle's box of
candidate voxels among the children of occupied voxels, kept where the
separating-axis test (Akenine-Möller) finds an overlap.
:func:`octree_arrays` runs the C++ builders of ``hostsrc/ngp_host.cpp``
(``ops/host_build.py``); :func:`octree_arrays_numpy`, the numpy build
copied from the JAX package, is their reference and gives the same
arrays. At depth 11 the numpy build's
candidate list takes gigabytes on a mesh of a few hundred thousand
triangles: build deep octrees natively.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

MIN_DEPTH, MAX_DEPTH = 2, 11  # depth 11's finest codes (< 2^30) fit int32, depth 12's not
_CORNERS = np.array(
    [[(c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)], np.int64
)


def tri_box_overlap(center: np.ndarray, half: float, tri: np.ndarray) -> np.ndarray:
    """The separating-axis test of triangles and cubes: ``center`` (M, 3)
    box centres, ``half`` their half extent, ``tri`` (M, 3, 3) vertices →
    (M,) bool. The 13 axes: the box's 3, the triangle's normal and the 9
    cross products of the box's axes with the triangle's edges."""
    v = tri - center[:, None, :]  # (M, 3, 3)
    e = v[:, [1, 2, 0], :] - v  # edges e0, e1, e2

    ok = np.ones(center.shape[0], bool)
    for a in range(3):
        ok &= v[:, :, a].min(1) <= half
        ok &= v[:, :, a].max(1) >= -half

    n = np.cross(e[:, 0], e[:, 1])
    d = np.einsum("md,md->m", n, v[:, 0])
    r = half * np.abs(n).sum(1)
    ok &= np.abs(d) <= r

    for i in range(3):
        ex, ey, ez = e[:, i, 0], e[:, i, 1], e[:, i, 2]
        fex, fey, fez = np.abs(ex), np.abs(ey), np.abs(ez)
        for j in range(3):
            if j == 0:  # axis (0, -ez, ey)
                p = -ez[:, None] * v[:, :, 1] + ey[:, None] * v[:, :, 2]
                rad = half * (fez + fey)
            elif j == 1:  # axis (ez, 0, -ex)
                p = ez[:, None] * v[:, :, 0] - ex[:, None] * v[:, :, 2]
                rad = half * (fez + fex)
            else:  # axis (-ey, ex, 0)
                p = -ey[:, None] * v[:, :, 0] + ex[:, None] * v[:, :, 1]
                rad = half * (fey + fex)
            ok &= (p.min(1) <= rad) & (p.max(1) >= -rad)
    return ok


def chessboard_distance(occ: np.ndarray) -> np.ndarray:
    """The exact L∞ (chessboard) distance transform of a (G, G, G) bool
    grid, int32, 0 at occupied cells: ``d ← min(d, minpool3(d) + 1)`` to
    a fixed point (a separable 3³ min-pool, nothing wrapping at the
    edges)."""
    G = occ.shape[0]
    INF = np.int32(3 * G)
    d = np.where(occ, np.int32(0), INF)

    def minpool3(a):
        for ax in range(3):
            lo = np.roll(a, 1, axis=ax)
            hi = np.roll(a, -1, axis=ax)
            idx_lo = [slice(None)] * 3
            idx_lo[ax] = 0
            idx_hi = [slice(None)] * 3
            idx_hi[ax] = G - 1
            lo[tuple(idx_lo)] = INF
            hi[tuple(idx_hi)] = INF
            a = np.minimum(a, np.minimum(lo, hi))
        return a

    for _ in range(3 * G):
        nd = np.minimum(d, minpool3(d) + 1)
        if np.array_equal(nd, d):
            break
        d = nd
    return d


def _build_numpy(tris: np.ndarray, max_depth: int):
    """The numpy refinement: (codes per depth int64, verts per depth
    (n, 8) int32, n_vertices)."""
    tmin = tris.min(1)
    tmax = tris.max(1)

    codes_per_depth = [np.zeros((1,), np.int64)]  # root
    for d in range(1, max_depth):
        R = 1 << d
        size = 1.0 / R
        lo = np.clip(np.floor(tmin / size).astype(np.int64), 0, R - 1)
        hi = np.clip(np.floor(tmax / size).astype(np.int64), 0, R - 1)
        ext = hi - lo + 1  # (T, 3)
        cnt = ext.prod(1)
        tot = int(cnt.sum())
        tri_id = np.repeat(np.arange(len(tris)), cnt)
        off = np.arange(tot) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        ex = ext[tri_id]
        dx = off % ex[:, 0]
        rem = off // ex[:, 0]
        dy = rem % ex[:, 1]
        dz = rem // ex[:, 1]
        vox = lo[tri_id] + np.stack([dx, dy, dz], 1)  # (P, 3)
        code = vox[:, 0] + (vox[:, 1] << d) + (vox[:, 2] << (2 * d))

        # only children of occupied voxels
        parent = ((vox[:, 0] >> 1) + ((vox[:, 1] >> 1) << (d - 1))
                  + ((vox[:, 2] >> 1) << (2 * (d - 1))))
        pc = codes_per_depth[d - 1]
        j = np.searchsorted(pc, parent)
        keep = (j < len(pc)) & (pc[np.minimum(j, len(pc) - 1)] == parent)
        vox, code, tri_id = vox[keep], code[keep], tri_id[keep]

        center = (vox.astype(np.float64) + 0.5) * size
        hit = tri_box_overlap(center, 0.5 * size, tris[tri_id])
        codes_per_depth.append(np.unique(code[hit]))

    # dual vertices: corners (x, y, z) of a depth made unique, ids depth by
    # depth from the root
    verts_per_depth = []
    n_vertices = 0
    for d, codes in enumerate(codes_per_depth):
        R = 1 << d
        x = codes & (R - 1)
        y = (codes >> d) & (R - 1)
        z = codes >> (2 * d)
        cx = x[:, None] + _CORNERS[None, :, 0]  # (n, 8) in [0, R]
        cy = y[:, None] + _CORNERS[None, :, 1]
        cz = z[:, None] + _CORNERS[None, :, 2]
        ckey = cx + cy * (R + 1) + cz * (R + 1) * (R + 1)
        uniq, inv = np.unique(ckey, return_inverse=True)
        verts_per_depth.append((inv.reshape(-1, 8) + n_vertices).astype(np.int32))
        n_vertices += len(uniq)
    return codes_per_depth, verts_per_depth, n_vertices


def _check_depth(max_depth: int) -> None:
    if not MIN_DEPTH <= max_depth <= MAX_DEPTH:
        raise ValueError(f"octree depth {max_depth} is outside [{MIN_DEPTH}, {MAX_DEPTH}]: "
                         f"the finest level's int32 codes need depth ≤ {MAX_DEPTH}")


def _finish(codes, verts, n_vertices: int, max_depth: int, dt_max_res: int,
            distance_transform) -> dict:
    dt_depth = min(max_depth - 1, int(np.log2(dt_max_res)))
    G = 1 << dt_depth
    occ = np.zeros((G, G, G), bool)
    c = np.asarray(codes[dt_depth], np.int64)
    occ[c >> (2 * dt_depth), (c >> dt_depth) & (G - 1), c & (G - 1)] = True  # [z, y, x]
    return {
        "codes": [np.asarray(c, np.int32) for c in codes],
        "verts": [np.asarray(v, np.int32) for v in verts],
        "n_vertices": int(n_vertices),
        "distance_field": distance_transform(occ).astype(np.int32),
        "dt_depth": dt_depth,
    }


def octree_arrays(triangles: np.ndarray, max_depth: int, dt_max_res: int = 128,
                  n_threads: int = 0) -> dict:
    """The octree of ``triangles`` (T, 3, 3) in [0, 1]³ as numpy arrays, by
    the C++ builders (``n_threads`` splits the build, 0 one a hardware
    thread): ``codes`` and ``verts`` (one int32 array a depth),
    ``n_vertices``, ``distance_field`` (G, G, G) int32 indexed [z, y, x]
    and ``dt_depth`` (the depth of the distance field, ``min(max_depth −
    1, log2(dt_max_res))``). Dual vertices reach ``2^(max_depth−1) + 1`` a
    side, as the reference's. Raises ``ValueError`` for a depth outside
    [2, 11] (the JAX package asserts the same range; with ``octree_depth``
    0 its sdf engine takes the encoding's ``n_levels``, 16 at the default
    config, which fails that assertion)."""
    from ngp_tpu_torch.ops.host_build import chessboard_dt, octree_build

    _check_depth(max_depth)
    codes, verts, n_vertices = octree_build(np.asarray(triangles, np.float64), max_depth,
                                            n_threads)
    return _finish(codes, verts, n_vertices, max_depth, dt_max_res, chessboard_dt)


def octree_arrays_numpy(triangles: np.ndarray, max_depth: int, dt_max_res: int = 128) -> dict:
    """:func:`octree_arrays` by the numpy build and distance transform
    copied from the JAX package: the reference of the C++ builders. Its
    candidate list takes gigabytes at depth 11 on a large mesh."""
    _check_depth(max_depth)
    codes, verts, n_vertices = _build_numpy(np.asarray(triangles, np.float64), max_depth)
    return _finish(codes, verts, n_vertices, max_depth, dt_max_res, chessboard_distance)


@dataclass
class TriangleOctree:
    """The octree on ``device``: ``codes[d]`` (n_d,) int32 sorted,
    ``verts[d]`` (n_d, 8) int32 (corner c at offset (c & 1, c >> 1 & 1,
    c >> 2 & 1), the reference's ``i&1/i&2/i&4``), ``n_vertices``,
    ``distance_field`` (G, G, G) int32 [z, y, x] at ``dt_depth``."""

    max_depth: int
    codes: tuple
    verts: tuple
    n_vertices: int
    distance_field: torch.Tensor
    dt_depth: int

    @staticmethod
    def build(triangles: np.ndarray, max_depth: int, dt_max_res: int = 128,
              device="cpu") -> "TriangleOctree":
        """Build on the host (:func:`octree_arrays`), keep on ``device``."""
        a = octree_arrays(triangles, max_depth, dt_max_res)
        return TriangleOctree(
            max_depth=max_depth,
            codes=tuple(torch.as_tensor(c, device=device) for c in a["codes"]),
            verts=tuple(torch.as_tensor(v, device=device) for v in a["verts"]),
            n_vertices=a["n_vertices"],
            distance_field=torch.as_tensor(a["distance_field"], device=device),
            dt_depth=a["dt_depth"],
        )

    @property
    def n_nodes(self) -> int:
        return sum(len(c) for c in self.codes)

    def lookup_level(self, d: int, pos: torch.Tensor):
        """At depth ``d``, for positions (N, 3) float32 in [0, 1]³: (found
        (N,) bool, the voxel's vertex ids (N, 8) int32, the position's
        fraction in its voxel (N, 3) float32), as the JAX package computes
        them (``pos·R`` clamped to [0, R − 1e-4] in float32, truncated)."""
        R = 1 << d
        codes, verts = self.codes[d], self.verts[d]
        cell_f = torch.clamp(pos * R, 0.0, R - 1e-4)
        cell = cell_f.to(torch.int32)
        frac = cell_f - cell.to(torch.float32)
        code = cell[:, 0] + (cell[:, 1] << d) + (cell[:, 2] << (2 * d))
        j = torch.clamp(torch.searchsorted(codes, code, side="left"), 0, len(codes) - 1)
        return codes[j] == code, verts[j], frac

    def contains(self, pos: torch.Tensor) -> torch.Tensor:
        """Whether each position lies in an occupied voxel of the finest
        depth (``TriangleOctree::contains``)."""
        return self.lookup_level(self.max_depth - 1, pos)[0]

    def skip_distance(self, pos: torch.Tensor) -> torch.Tensor:
        """A lower bound on the Euclidean distance from each position to
        the occupied voxels (0 inside), from the chessboard distance field:
        the sphere tracer's safe step over empty space in place of the
        reference's per-ray ``ray_intersect`` (``testbed_sdf.cu:183-186``)."""
        G = 1 << self.dt_depth
        cell = torch.clamp((pos * G).to(torch.int32), 0, G - 1).long()
        d = self.distance_field[cell[:, 2], cell[:, 1], cell[:, 0]]
        return torch.clamp_min(d.to(torch.float32) - 1.0, 0.0) / G

    def draw_uniform(self, n: int, generator: torch.Generator | None = None):
        """The draws of :meth:`sample_uniform` for ``n`` positions from
        ``generator`` on the octree's device: (pick (n,) int64 leaf numbers
        in [0, n_leaves), u (n, 3) float32 in [0, 1))."""
        dev = self.codes[0].device
        leaves = len(self.codes[self.max_depth - 1])
        pick = torch.randint(0, leaves, (n,), generator=generator, device=dev)
        return pick, torch.rand((n, 3), generator=generator, device=dev)

    def sample_uniform(self, pick: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """Positions uniform in finest-depth voxels
        (``uniform_octree_sample_kernel``, ``testbed_sdf.cu:436-471``):
        voxel ``pick`` (the leaf numbers of :meth:`draw_uniform`, or the
        JAX package's ``randint`` draw) at offset ``u`` (n, 3) in it."""
        d = self.max_depth - 1
        R = 1 << d
        c = self.codes[d][pick]
        cell = torch.stack([c & (R - 1), (c >> d) & (R - 1), c >> (2 * d)], -1)
        return (cell.to(torch.float32) + u) / R

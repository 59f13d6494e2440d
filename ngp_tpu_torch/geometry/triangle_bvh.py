"""Triangle BVH: the median-split build and the queries, the port of
``ngp_tpu/geometry/triangle_bvh.py`` (the reference's ``TriangleBvh``,
``src/triangle_bvh.cu``).

The build makes the tree of the JAX package's numpy build (binary, median
split on the longest centroid axis, leaves padded to exactly ``LEAF_SIZE``
triangles at 1e10), a level at a time, and its arrays equal that
build's exactly. :func:`build_bvh` runs the C++ builder of
``hostsrc/ngp_host.cpp`` (:func:`build_bvh_arrays_native`), which gives
the same arrays; the numpy build :func:`build_bvh_arrays` is its
reference. Beside those arrays the tree carries the traversal
kernels' packed records (:func:`pack_bvh_records`). The tree lives on the
engine's device. ``closest_point`` and ``ray_intersect`` run the traversal
kernels of ``ops/bvh.py`` on the card and their twins on the CPU; the sign
modes build on them. ``winding_number`` is plain PyTorch over triangle
chunks (a brute-force option of the ground truth, off by default).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ngp_tpu_torch.ops.bvh import (
    FAR,
    LEAF_SIZE,
    RECORD_WORDS,
    STACK_DEPTH,
    dot3,
    bvh_closest_point,
    bvh_ray_intersect,
    leaf_ref,
)


class TriangleBvh(NamedTuple):
    node_min: torch.Tensor  # (M, 3) float32
    node_max: torch.Tensor  # (M, 3) float32
    node_a: torch.Tensor  # (M,) int32: left child | a leaf's first slot
    node_b: torch.Tensor  # (M,) int32: right child | 0
    node_leaf: torch.Tensor  # (M,) bool
    triangles: torch.Tensor  # (Tp, 3, 3) float32, leaf order, padded
    normals: torch.Tensor  # (Tp, 3) float32 unit
    tri_index: torch.Tensor  # (Tp,) int32 original triangle id, -1 for padding
    depth: int  # nodes on the longest root-to-leaf path
    records: torch.Tensor  # (R, RECORD_WORDS) int32: the kernels' packed internal nodes
    root: int  # the root's reference: record 0, or a leaf's (:func:`pack_bvh_records`)


def _segment_reduce(ufunc, values: np.ndarray, starts: np.ndarray,
                    lens: np.ndarray) -> np.ndarray:
    """``ufunc`` over the rows of each segment ``values[s:s + n]``
    (segments sorted, disjoint, non-empty)."""
    bounds = np.stack([starts, starts + lens], 1).ravel()
    return ufunc.reduceat(np.concatenate([values, values[:1]]), bounds, axis=0)[0::2]


def _subtree_nodes(n: np.ndarray) -> np.ndarray:
    """Nodes in the subtree of a node of ``n`` triangles: 1 for a leaf,
    else 1 + both halves'."""
    memo = {}

    def count(k: int) -> int:
        if k not in memo:
            memo[k] = 1 if k <= LEAF_SIZE else 1 + count(k // 2) + count(k - k // 2)
        return memo[k]

    return np.asarray([count(int(k)) for k in n], np.int64)


def build_bvh_arrays(triangles: np.ndarray) -> dict:
    """The JAX package's ``_build_bvh_numpy`` as numpy arrays (the fields
    of :class:`TriangleBvh`) plus the tree's ``depth``, equal to its output
    exactly. Raises where the depth reaches ``STACK_DEPTH``, which the
    traversal's stacks could not hold.

    The JAX build recurses: a node takes the box of its triangles; more
    than ``LEAF_SIZE`` triangles are sorted (stably) by their centroids
    along the centroids' longest extent and split at half, the left half
    built first; nodes are numbered in that depth-first order, and leaves
    take their slots in it. Here one level of the tree is built at a time:
    each node owns a contiguous run of one triangle order, the runs of a
    level are reduced and sorted together, and a node's depth-first number
    follows from its parent's and the size of its left sibling's subtree."""
    triangles = np.asarray(triangles, np.float32)
    T = triangles.shape[0]
    cent = triangles.mean(axis=1)
    tri_min = triangles.min(axis=1)
    tri_max = triangles.max(axis=1)
    M = int(_subtree_nodes(np.asarray([T]))[0])
    node_min = np.empty((M, 3), np.float32)
    node_max = np.empty((M, 3), np.float32)
    node_a = np.zeros(M, np.int32)
    node_b = np.zeros(M, np.int32)
    node_leaf = np.zeros(M, bool)
    order = np.arange(T)
    starts, lens, ids = np.zeros(1, np.int64), np.full(1, T, np.int64), np.zeros(1, np.int64)
    leaves = []  # (start, length, node) of each level's leaves
    depth = 0
    while len(starts):
        depth += 1
        node_min[ids] = _segment_reduce(np.minimum, tri_min[order], starts, lens)
        node_max[ids] = _segment_reduce(np.maximum, tri_max[order], starts, lens)
        leaf = lens <= LEAF_SIZE
        node_leaf[ids[leaf]] = True
        leaves.append((starts[leaf], lens[leaf], ids[leaf]))
        starts, lens, ids = starts[~leaf], lens[~leaf], ids[~leaf]
        if not len(starts):
            break
        c = cent[order]
        extent = (_segment_reduce(np.maximum, c, starts, lens)
                  - _segment_reduce(np.minimum, c, starts, lens))
        axis = np.argmax(extent, axis=1)
        seg = np.repeat(np.arange(len(starts)), lens)
        pos = _runs(starts, lens)
        order[pos] = order[pos[np.argsort(_segment_keys(seg, c[pos, axis[seg]]),
                                          kind="stable")]]
        half = lens // 2
        left, right = ids + 1, ids + 1 + _subtree_nodes(half)
        node_a[ids], node_b[ids] = left, right
        starts = np.stack([starts, starts + half], 1).ravel()
        lens = np.stack([half, lens - half], 1).ravel()
        ids = np.stack([left, right], 1).ravel()
    if depth >= STACK_DEPTH:
        raise ValueError(f"BVH depth {depth} of {T} triangles reaches the "
                         f"traversal stack's {STACK_DEPTH} entries")

    l_start, l_len, l_id = (np.concatenate(a) for a in zip(*leaves))
    by_slot = np.argsort(l_start)  # depth-first leaf order is left to right
    l_start, l_len, l_id = l_start[by_slot], l_len[by_slot], l_id[by_slot]
    node_a[l_id] = np.arange(len(l_id)) * LEAF_SIZE
    slot = np.arange(LEAF_SIZE)
    idx = np.where(slot < l_len[:, None], order[np.minimum(l_start[:, None] + slot, T - 1)], -1)
    idx = idx.reshape(-1)
    tris = np.where((idx >= 0)[:, None, None], triangles[np.maximum(idx, 0)],
                    np.float32(FAR)).astype(np.float32)
    n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    return {
        "node_min": node_min,
        "node_max": node_max,
        "node_a": node_a,
        "node_b": node_b,
        "node_leaf": node_leaf,
        "triangles": tris,
        "normals": n.astype(np.float32),
        "tri_index": idx.astype(np.int32),
        "depth": depth,
    }


def _segment_keys(seg: np.ndarray, key: np.ndarray) -> np.ndarray:
    """uint64 keys that order by segment, then by the float32 ``key`` as
    numpy orders floats (−0.0 made +0.0, which numpy holds equal): a
    stable sort by them is each segment's stable sort by ``key``."""
    bits = (key + np.float32(0.0)).view(np.uint32).astype(np.uint64)
    bits = np.where(bits >> np.uint64(31), bits ^ np.uint64(0xFFFFFFFF),
                    bits | np.uint64(0x80000000))
    return (seg.astype(np.uint64) << np.uint64(32)) | bits


def _runs(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """The positions ``s, s + 1, …, s + n − 1`` of every run, concatenated."""
    first = np.repeat(starts - np.cumsum(np.concatenate([[0], lens[:-1]])), lens)
    return first + np.arange(int(lens.sum()))


def pack_bvh_records(arrays: dict) -> tuple[np.ndarray, int]:
    """The traversal kernels' layout of the tree ``arrays`` (as
    :func:`build_bvh_arrays` returns them): one 64-byte record for each
    internal node, numbered level by level from the root (record 0), left
    to right. A record holds, as
    int32 words (floats by their bits):

    - 0-5: the left child's box (min xyz, max xyz), 6-11: the right's;
    - 12, 13: the left and right child's references: an internal child's
      record number (≥ 0), or a leaf's ``~(leaf << 3 | real)``
      (:func:`ops.bvh.leaf_ref`), where ``leaf`` is its first slot /
      ``LEAF_SIZE`` and ``real`` the count of its triangles that are not
      padding (slots ``real`` … ``LEAF_SIZE − 1`` are);
    - 14, 15: the children's node numbers in ``arrays`` (for tests; the
      kernels do not read them).

    Returns the records (R, RECORD_WORDS) int32 and the root's reference
    (0, or a leaf's when the root is a leaf and R = 0). The root's own box
    is in no record: the traversal never tests it."""
    node_a, node_b, leaf = arrays["node_a"], arrays["node_b"], arrays["node_leaf"]
    real = (arrays["tri_index"].reshape(-1, LEAF_SIZE) >= 0).sum(1)
    levels, level = [], np.zeros(1, np.int64)
    while len(level):
        inner = level[~leaf[level]]
        levels.append(inner)
        level = np.stack([node_a[inner], node_b[inner]], 1).ravel().astype(np.int64)
    order = np.concatenate(levels)
    record_of = np.full(len(leaf), -1, np.int64)
    record_of[order] = np.arange(len(order))

    def ref(nodes):
        first = np.where(leaf[nodes], node_a[nodes] // LEAF_SIZE, 0)
        return np.where(leaf[nodes], leaf_ref(first, real[first]), record_of[nodes])

    left, right = node_a[order], node_b[order]
    boxes = np.concatenate([arrays["node_min"][left], arrays["node_max"][left],
                            arrays["node_min"][right], arrays["node_max"][right]], 1)
    records = np.empty((len(order), RECORD_WORDS), np.int32)
    records[:, :12] = np.ascontiguousarray(boxes, np.float32).view(np.int32)
    records[:, 12], records[:, 13] = ref(left), ref(right)
    records[:, 14], records[:, 15] = left, right
    return records, int(ref(np.zeros(1, np.int64))[0])


def tree_depth(node_a: np.ndarray, node_b: np.ndarray, node_leaf: np.ndarray) -> int:
    """Nodes on the longest root-to-leaf path of a tree's arrays."""
    depth, level = 0, np.zeros(1, np.int64)
    while len(level):
        depth += 1
        inner = level[~node_leaf[level]]
        level = np.concatenate([node_a[inner], node_b[inner]]).astype(np.int64)
    return depth


def build_bvh_arrays_native(triangles: np.ndarray, n_threads: int = 0) -> dict:
    """:func:`build_bvh_arrays` by the C++ builder of ``hostsrc/ngp_host.cpp``
    (``ops/host_build.bvh_build``; ``n_threads`` 0 uses one a hardware
    thread): the same arrays and depth, and the same refusal of a tree as
    deep as the stack."""
    from ngp_tpu_torch.ops.host_build import bvh_build

    names = ("node_min", "node_max", "node_a", "node_b", "node_leaf", "triangles",
             "normals", "tri_index")
    arrays = dict(zip(names, bvh_build(triangles, LEAF_SIZE, n_threads)))
    depth = tree_depth(arrays["node_a"], arrays["node_b"], arrays["node_leaf"])
    if depth >= STACK_DEPTH:
        raise ValueError(f"BVH depth {depth} of {len(triangles)} triangles reaches the "
                         f"traversal stack's {STACK_DEPTH} entries")
    return {**arrays, "depth": depth}


def build_bvh(triangles: np.ndarray, device="cpu") -> TriangleBvh:
    """Build on the host by the C++ builder (:func:`build_bvh_arrays_native`;
    :func:`build_bvh_arrays` is its numpy reference), pack the records
    (:func:`pack_bvh_records`), keep on ``device``."""
    arrays = build_bvh_arrays_native(triangles)
    records, root = pack_bvh_records(arrays)
    depth = arrays.pop("depth")
    return TriangleBvh(**{k: torch.as_tensor(v, device=device) for k, v in arrays.items()},
                       depth=depth, records=torch.as_tensor(records, device=device), root=root)


def closest_point(bvh: TriangleBvh, points: torch.Tensor):
    """Exact closest point on the mesh of ``points`` (P, 3): (distance,
    point, leaf slot)."""
    return bvh_closest_point(bvh, points.contiguous())


def signed_distance_watertight(bvh: TriangleBvh, points: torch.Tensor) -> torch.Tensor:
    """The distance, negative where ``points − closest point`` faces away
    from the closest triangle's normal (``triangle_bvh.cu:405``)."""
    dist, cp, tri = closest_point(bvh, points)
    n = bvh.normals[torch.clamp_min(tri, 0).long()]
    inside = dot3(points - cp, n) < 0.0
    return torch.where(inside, -dist, dist)


def ray_intersect(bvh: TriangleBvh, origins: torch.Tensor, dirs: torch.Tensor):
    """Nearest hit of each ray: (t, inf on a miss; leaf slot)."""
    return bvh_ray_intersect(bvh, origins.contiguous(), dirs.contiguous())


def signed_distance_raystab(bvh: TriangleBvh, points: torch.Tensor,
                            n_stabs: int = 32) -> torch.Tensor:
    """Parity sign (``triangle_bvh.cu:415``): along each of ``n_stabs``
    fixed directions, count the crossings by marching from hit to hit
    (1e-5 past each); a point is inside only if every direction counts an
    odd number. The directions are the JAX package's: ``n_stabs`` normal
    draws of ``default_rng(0)``, normalised in float64."""
    dist, _, _ = closest_point(bvh, points)
    inside = torch.ones(points.shape[:1], dtype=torch.bool, device=points.device)
    dirs = np.random.default_rng(0).normal(size=(n_stabs, 3))
    for s in dirs / np.linalg.norm(dirs, axis=-1, keepdims=True):
        d = torch.as_tensor(s, dtype=torch.float32, device=points.device).expand_as(points)
        d = d.contiguous()
        o = points
        t, _ = ray_intersect(bvh, o, d)
        count = torch.zeros_like(inside, dtype=torch.int32)
        while bool(torch.isfinite(t).any()):
            hit = torch.isfinite(t)
            o = torch.where(hit[:, None], o + d * (t[:, None] + 1e-5), o)
            t2, _ = ray_intersect(bvh, o, d)
            t = torch.where(hit, t2, torch.full_like(t2, float("inf")))
            count = count + hit.to(torch.int32)
        inside &= count % 2 == 1
    return torch.where(inside, -dist, dist)


def winding_number(triangles: torch.Tensor, points: torch.Tensor,
                   tri_chunk: int = 4096) -> torch.Tensor:
    """Generalised winding number of ``points`` (P, 3) for the soup
    ``triangles`` (T, 3, 3): Σ solid angles / 4π (van Oosterom–Strackee),
    ≈1 inside, ≈0 outside. O(P·T) over chunks of ``tri_chunk`` triangles;
    degenerate triangles (the BVH's padding) add 0."""
    total = torch.zeros(points.shape[:1], dtype=torch.float32, device=points.device)
    for tris in triangles.split(tri_chunk):
        a = tris[None, :, 0, :] - points[:, None, :]
        b = tris[None, :, 1, :] - points[:, None, :]
        c = tris[None, :, 2, :] - points[:, None, :]
        la = torch.linalg.norm(a, dim=-1)
        lb = torch.linalg.norm(b, dim=-1)
        lc = torch.linalg.norm(c, dim=-1)
        num = torch.sum(a * torch.linalg.cross(b, c, dim=-1), dim=-1)
        den = (la * lb * lc + torch.sum(a * b, dim=-1) * lc
               + torch.sum(b * c, dim=-1) * la + torch.sum(c * a, dim=-1) * lb)
        total = total + torch.sum(2.0 * torch.atan2(num, den), dim=-1)
    return total / (4.0 * math.pi)


def signed_distance_winding(bvh: TriangleBvh, points: torch.Tensor,
                            tri_chunk: int = 4096) -> torch.Tensor:
    """The distance, negative where the winding number of the tree's
    triangles exceeds 0.5 (the JAX package's counterpart of the
    reference's OptiX-only PathEscape sign)."""
    dist, _, _ = closest_point(bvh, points)
    inside = winding_number(bvh.triangles, points, tri_chunk) > 0.5
    return torch.where(inside, -dist, dist)

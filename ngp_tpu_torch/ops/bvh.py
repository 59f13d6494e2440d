"""Triangle-BVH traversal: the CUDA kernels' wrappers
(:func:`bvh_closest_point_cuda`, :func:`bvh_ray_intersect_cuda`) and their
plain PyTorch twins (:func:`bvh_closest_point_reference`,
:func:`bvh_ray_intersect_reference`).

The JAX package has no TPU kernel here: its queries are ``lax.while_loop``
traversals (``ngp_tpu/geometry/triangle_bvh.py``, ``closest_point`` and
``ray_intersect``). The twins run that loop as a batched loop on
tensors over the tree's arrays: every query pops one node an iteration, a
leaf tests its ``LEAF_SIZE`` triangles, an internal node pushes the
children that can still beat the query's best; an iteration computes only
the queries that popped a node of each kind. The kernels
(``ngp_tpu_torch/csrc/triangle_bvh.cu``) walk the tree's packed records
(``geometry/triangle_bvh.pack_bvh_records``) one thread a query: the child
the loop would pop next is taken without a push, and a leaf's padding
slots are not tested one by one. Each query still processes the same
nodes in the same order and returns the same triangle, ties included.
:func:`bvh_closest_point_packed` and :func:`bvh_ray_intersect_packed` walk
the packed records as the kernels do, in plain PyTorch, so that the layout
and that walk are tested on the CPU against the twins.

Every dot and cross product is written out in one order, left to right,
here and in the kernel; the kernel is compiled with ``-fmad=false``, so
that it equals its twin bit for bit on the card.

:func:`bvh_closest_point` and :func:`bvh_ray_intersect` pick by the device
of the queries: the twin for CPU tensors, the kernel for CUDA tensors,
which launches or raises. ``bvh`` is any object with the fields of
``geometry/triangle_bvh.TriangleBvh``.
"""

from __future__ import annotations

import ctypes

import torch

from ngp_tpu_torch.ops.cuda_build import CudaKernel, launch_on

LEAF_SIZE = 4
STACK_DEPTH = 64
FAR = 1e10  # padding triangles' coordinate
RECORD_WORDS = 16  # a packed internal node: 64 bytes

_vp, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_TREE = [_vp, _i, _i, _vp]  # records, root, stack entries, triangles
TRIANGLE_BVH = CudaKernel(
    "triangle_bvh.cu",
    {
        "bvh_closest_point": (_i, _TREE + [_vp, _ll, _vp, _vp, _vp, _vp, _vp]),
        "bvh_ray_intersect": (_i, _TREE + [_vp, _vp, _ll, _vp, _vp, _vp, _vp]),
        "triangle_bvh_error_string": (ctypes.c_char_p, [_i]),
    },
    ("bvh_closest_point", "bvh_ray_intersect"),
    flags=("-fmad=false",),
)


def leaf_ref(leaf, real):
    """A packed record's reference to a leaf: ``~(leaf << 3 | real)``,
    negative, where the leaf's slots start at ``leaf · LEAF_SIZE`` and its
    first ``real`` slots (0 … ``LEAF_SIZE``) hold triangles."""
    return ~((leaf << 3) | real)


def leaf_of(ref):
    """(first slot, real triangles) of leaf references ``ref``."""
    return (~ref >> 3) * LEAF_SIZE, ~ref & 7


# -- the arithmetic both versions share, written out in the kernel's order


def dot3(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _safe(x, eps: float, fill: float):
    """``x`` where ``|x| > eps``, else ``fill``."""
    return torch.where(torch.abs(x) > eps, x, torch.full_like(x, fill))


def closest_point_on_triangle(p, a, b, c):
    """Ericson's 7-region closest point, all inputs (..., 3), in the JAX
    package's arithmetic; where several regions' tests hold, the last of
    edge ab, edge ac, edge bc, vertex a, b, c wins over the face."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = dot3(ab, ap)
    d2 = dot3(ac, ap)
    bp = p - b
    d3 = dot3(ab, bp)
    d4 = dot3(ac, bp)
    cp_ = p - c
    d5 = dot3(ab, cp_)
    d6 = dot3(ac, cp_)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    denom = _safe(va + vb + vc, 1e-20, 1.0)
    face = a + ab * (vb / denom)[..., None] + ac * (vc / denom)[..., None]
    t_ab = torch.clamp(d1 / _safe(d1 - d3, 1e-20, 1.0), 0.0, 1.0)
    t_ac = torch.clamp(d2 / _safe(d2 - d6, 1e-20, 1.0), 0.0, 1.0)
    d43, d56 = d4 - d3, d5 - d6
    t_bc = torch.clamp(d43 / _safe(d43 + d56, 1e-20, 1.0), 0.0, 1.0)

    out = face
    for cond, val in (
        ((vc <= 0) & (d1 >= 0) & (d3 <= 0), a + ab * t_ab[..., None]),
        ((vb <= 0) & (d2 >= 0) & (d6 <= 0), a + ac * t_ac[..., None]),
        ((va <= 0) & (d43 >= 0) & (d56 >= 0), b + (c - b) * t_bc[..., None]),
        ((d1 <= 0) & (d2 <= 0), a),
        ((d3 >= 0) & (d4 <= d3), b),
        ((d6 >= 0) & (d5 <= d6), c),
    ):
        out = torch.where(cond[..., None], val, out)
    return out


def _aabb_sq_dist(p, mn, mx):
    d = torch.maximum(torch.clamp_min(mn - p, 0.0), p - mx)
    return dot3(d, d)


def _ray_tri(o, d, a, b, c):
    """Möller–Trumbore; t, inf on a miss."""
    e1 = b - a
    e2 = c - a
    pv = _cross(d, e2)
    det = dot3(e1, pv)
    inv = 1.0 / _safe(det, 1e-12, 1.0)
    tv = o - a
    u = dot3(tv, pv) * inv
    qv = _cross(tv, e1)
    v = dot3(d, qv) * inv
    t = dot3(e2, qv) * inv
    hit = (torch.abs(det) > 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-6)
    return torch.where(hit, t, torch.full_like(t, float("inf")))


def _aabb_ray_hit(o, inv_d, mn, mx, tmax):
    t0 = (mn - o) * inv_d
    t1 = (mx - o) * inv_d
    tn = torch.amax(torch.minimum(t0, t1), dim=-1)
    tf = torch.amin(torch.maximum(t0, t1), dim=-1)
    return (tf >= torch.clamp_min(tn, 0.0)) & (tn < tmax)


def _inverse_dirs(dirs):
    """``1 / d`` per component, a component of magnitude at most 1e-12
    (either sign) taken as +1e-12."""
    return 1.0 / _safe(dirs, 1e-12, 1e-12)


# -- the twins: the JAX package's while_loops as batched loops


class _Stacks:
    """Per-query stacks of node indices, the root pushed. A push past the
    top overwrites the top entry, as the JAX loop's clamped index does."""

    def __init__(self, n: int, device):
        self.stack = torch.zeros((n, STACK_DEPTH), dtype=torch.int64, device=device)
        self.sp = torch.ones((n,), dtype=torch.int64, device=device)

    def pop(self):
        """Pop a node off every non-empty stack: (which popped, node)."""
        active = self.sp > 0
        spm1 = torch.clamp_min(self.sp - 1, 0)
        node = self.stack.gather(1, spm1[:, None])[:, 0]
        self.sp = torch.where(active, spm1, self.sp)
        return active, node

    def push(self, rows, child, do):
        """Push ``child`` onto the stacks ``rows`` where ``do``."""
        sp = self.sp[rows]
        idx = torch.clamp_max(sp, STACK_DEPTH - 1)
        self.stack[rows, idx] = torch.where(do, child, self.stack[rows, idx])
        self.sp[rows] = torch.where(do, sp + 1, sp)


def _traverse(bvh, n: int, device, visit_leaves, visit_internal, stats: dict | None):
    """Pop a node off every query's stack an iteration until all are
    empty; ``visit_leaves(rows, first_slot)`` tests the leaves that the
    queries ``rows`` popped, ``visit_internal(stacks, rows, left, right)``
    the internal nodes. Each query's sequence of pops is the JAX loop's;
    only the queries that popped a node of a kind are computed. With
    ``stats``, records the nodes any query popped (``visited``, a bool per
    node), the pops of leaves and of internal nodes, the real (not
    padding) triangles of the leaves popped (``leaf_real_tests``), the
    iterations, and each query's pops (``visits``, (n,) int32)."""
    stacks = _Stacks(n, device)
    if stats is not None:
        stats.update(visited=torch.zeros_like(bvh.node_leaf), leaf_pops=0, internal_pops=0,
                     iterations=0, visits=torch.zeros((n,), dtype=torch.int32, device=device),
                     leaf_real_tests=0)
        real = (bvh.tri_index.view(-1, LEAF_SIZE) >= 0).sum(1)
    while True:
        active, node = stacks.pop()
        leaf = bvh.node_leaf[node]
        leaves = (active & leaf).nonzero()[:, 0]
        internal = (active & ~leaf).nonzero()[:, 0]
        if leaves.numel() + internal.numel() == 0:
            return
        if stats is not None:
            stats["visited"][node[active]] = True
            stats["leaf_pops"] += leaves.numel()
            stats["leaf_real_tests"] += int(real[bvh.node_a[node[leaves]].long()
                                                 // LEAF_SIZE].sum())
            stats["internal_pops"] += internal.numel()
            stats["iterations"] += 1
            stats["visits"] += active.to(torch.int32)
        if leaves.numel():
            visit_leaves(leaves, bvh.node_a[node[leaves]].long())
        if internal.numel():
            n_int = node[internal]
            visit_internal(stacks, internal, bvh.node_a[n_int].long(),
                           bvh.node_b[n_int].long())


def bvh_closest_point_reference(bvh, points, stats: dict | None = None):
    """Plain PyTorch twin of the closest-point kernel: for ``points``
    (P, 3) float32 the distance (P,), the closest point (P, 3) and the
    leaf slot of its triangle (P,) int32 (-1 only for an empty tree).
    Farther child pushed first, nearer second, each only if its box is
    strictly nearer than the best; a leaf's triangles replace the best in
    slot order on a strict ``<``. ``stats``: see :func:`_traverse`."""
    P = points.shape[0]
    dev = points.device
    best_d2 = torch.full((P,), float("inf"), dtype=torch.float32, device=dev)
    best_cp = torch.zeros((P, 3), dtype=torch.float32, device=dev)
    best_tri = torch.full((P,), -1, dtype=torch.int64, device=dev)

    def visit_leaves(rows, start):
        p = points[rows]
        slots = start[:, None] + torch.arange(LEAF_SIZE, device=dev)
        tri = bvh.triangles[slots]  # (n, LEAF_SIZE, 3, 3)
        cps = closest_point_on_triangle(p[:, None], tri[:, :, 0], tri[:, :, 1], tri[:, :, 2])
        e = cps - p[:, None]
        d2s = dot3(e, e)
        d2_best, cp_best, tri_best = best_d2[rows], best_cp[rows], best_tri[rows]
        for j in range(LEAF_SIZE):  # in slot order, each on a strict <
            better = d2s[:, j] < d2_best
            cp_best = torch.where(better[:, None], cps[:, j], cp_best)
            tri_best = torch.where(better, slots[:, j], tri_best)
            d2_best = torch.where(better, d2s[:, j], d2_best)
        best_d2[rows], best_cp[rows], best_tri[rows] = d2_best, cp_best, tri_best

    def visit_internal(stacks, rows, left, right):
        p = points[rows]
        dl = _aabb_sq_dist(p, bvh.node_min[left], bvh.node_max[left])
        dr = _aabb_sq_dist(p, bvh.node_min[right], bvh.node_max[right])
        left_near = dl <= dr
        best = best_d2[rows]
        stacks.push(rows, torch.where(left_near, right, left), torch.maximum(dl, dr) < best)
        stacks.push(rows, torch.where(left_near, left, right), torch.minimum(dl, dr) < best)

    _traverse(bvh, P, dev, visit_leaves, visit_internal, stats)
    return torch.sqrt(best_d2), best_cp, best_tri.to(torch.int32)


def bvh_ray_intersect_reference(bvh, origins, dirs, stats: dict | None = None):
    """Plain PyTorch twin of the ray-hit kernel: for rays ``origins``,
    ``dirs`` (P, 3) float32 the nearest hit's t (P,), inf on a miss, and
    its leaf slot (P,) int32, -1 on a miss. Right child pushed first, left
    second, each only if the ray meets its box before the best hit; a
    leaf's triangles replace the best in slot order on a strict ``<``.
    ``stats``: see :func:`_traverse`."""
    P = origins.shape[0]
    dev = origins.device
    inv_d = _inverse_dirs(dirs)
    best_t = torch.full((P,), float("inf"), dtype=torch.float32, device=dev)
    best_tri = torch.full((P,), -1, dtype=torch.int64, device=dev)

    def visit_leaves(rows, start):
        slots = start[:, None] + torch.arange(LEAF_SIZE, device=dev)
        tri = bvh.triangles[slots]  # (n, LEAF_SIZE, 3, 3)
        ts = _ray_tri(origins[rows][:, None], dirs[rows][:, None], tri[:, :, 0], tri[:, :, 1],
                      tri[:, :, 2])
        t_best, tri_best = best_t[rows], best_tri[rows]
        for j in range(LEAF_SIZE):  # in slot order, each on a strict <
            better = ts[:, j] < t_best
            t_best = torch.where(better, ts[:, j], t_best)
            tri_best = torch.where(better, slots[:, j], tri_best)
        best_t[rows], best_tri[rows] = t_best, tri_best

    def visit_internal(stacks, rows, left, right):
        o, inv, tmax = origins[rows], inv_d[rows], best_t[rows]
        hl = _aabb_ray_hit(o, inv, bvh.node_min[left], bvh.node_max[left], tmax)
        hr = _aabb_ray_hit(o, inv, bvh.node_min[right], bvh.node_max[right], tmax)
        stacks.push(rows, right, hr)
        stacks.push(rows, left, hl)

    _traverse(bvh, P, dev, visit_leaves, visit_internal, stats)
    return best_t, best_tri.to(torch.int32)


# -- the kernels' walk over the packed records, in plain PyTorch


def _walk_packed(bvh, n: int, device, visit_leaves, visit_internal):
    """The kernels' walk, batched: each query holds its next node's
    reference (``bvh.root`` first); a leaf's real triangles are tested
    (``visit_leaves(rows, first_slot, real)``), an internal record's
    children tested (``visit_internal(rows, record words, their floats)``
    returns where a query goes next, that child's reference, where it
    pushes the other child, and that child's reference), and a query
    with nowhere to go pops its stack, which holds ``bvh.depth − 1``
    entries. Returns each query's nodes processed, (n,) int32."""
    node = torch.full((n,), bvh.root, dtype=torch.int64, device=device)
    stack = torch.zeros((n, max(bvh.depth - 1, 1)), dtype=torch.int64, device=device)
    sp = torch.zeros((n,), dtype=torch.int64, device=device)
    live = torch.ones((n,), dtype=torch.bool, device=device)
    visits = torch.zeros((n,), dtype=torch.int32, device=device)
    words = bvh.records.long()
    boxes = bvh.records[:, :12].view(torch.float32)
    while bool(live.any()):
        visits += live.to(torch.int32)
        rows = live.nonzero()[:, 0]
        ref = node[rows]
        leaves = ref < 0
        taken = torch.zeros_like(leaves)
        if bool(leaves.any()):
            visit_leaves(rows[leaves], *leaf_of(ref[leaves]))
        inner = (~leaves).nonzero()[:, 0]
        if inner.numel():
            r = ref[inner]
            take, to, push, other = visit_internal(rows[inner], words[r], boxes[r])
            pushed = rows[inner][push]
            stack[pushed, sp[pushed]] = other[push]
            sp[pushed] += 1
            node[rows[inner][take]] = to[take]
            taken[inner] = take
        pop = rows[~taken]
        empty = sp[pop] == 0
        live[pop[empty]] = False
        pop = pop[~empty]
        sp[pop] -= 1
        node[pop] = stack[pop, sp[pop]]
    return visits


def bvh_closest_point_packed(bvh, points):
    """The closest-point kernel's walk over ``bvh.records`` in plain
    PyTorch: (distance, point, slot, nodes processed (P,) int32), the first
    three equal to :func:`bvh_closest_point_reference`'s and the last to
    its ``stats["visits"]``. The near child is taken and the far one
    pushed; a leaf's real triangles are tested in slot order, then its
    first padding slot, at the padding's squared distance."""
    P = points.shape[0]
    dev = points.device
    best_d2 = torch.full((P,), float("inf"), dtype=torch.float32, device=dev)
    best_cp = torch.zeros((P, 3), dtype=torch.float32, device=dev)
    best_tri = torch.full((P,), -1, dtype=torch.int64, device=dev)
    pad = torch.full((3,), FAR, dtype=torch.float32, device=dev)
    pad_e = pad - points
    pad_d2 = dot3(pad_e, pad_e)

    def visit_leaves(rows, first, real):
        p = points[rows]
        d2_best, cp_best, tri_best = best_d2[rows], best_cp[rows], best_tri[rows]
        for j in range(LEAF_SIZE):
            tri = bvh.triangles[torch.clamp_max(first + j, bvh.triangles.shape[0] - 1)]
            cp = closest_point_on_triangle(p, tri[:, 0], tri[:, 1], tri[:, 2])
            e = cp - p
            d2 = dot3(e, e)
            better = (j < real) & (d2 < d2_best)
            cp_best = torch.where(better[:, None], cp, cp_best)
            tri_best = torch.where(better, first + j, tri_best)
            d2_best = torch.where(better, d2, d2_best)
        better = (real < LEAF_SIZE) & (pad_d2[rows] < d2_best)
        cp_best = torch.where(better[:, None], pad, cp_best)
        tri_best = torch.where(better, first + real, tri_best)
        d2_best = torch.where(better, pad_d2[rows], d2_best)
        best_d2[rows], best_cp[rows], best_tri[rows] = d2_best, cp_best, tri_best

    def visit_internal(rows, words, box):
        p, best = points[rows], best_d2[rows]
        dl = _aabb_sq_dist(p, box[:, 0:3], box[:, 3:6])
        dr = _aabb_sq_dist(p, box[:, 6:9], box[:, 9:12])
        left_near = dl <= dr
        near = torch.where(left_near, words[:, 12], words[:, 13])
        far = torch.where(left_near, words[:, 13], words[:, 12])
        return torch.minimum(dl, dr) < best, near, torch.maximum(dl, dr) < best, far

    visits = _walk_packed(bvh, P, dev, visit_leaves, visit_internal)
    return torch.sqrt(best_d2), best_cp, best_tri.to(torch.int32), visits


def bvh_ray_intersect_packed(bvh, origins, dirs):
    """The ray-hit kernel's walk over ``bvh.records`` in plain PyTorch:
    (t, slot, nodes processed (P,) int32), equal to
    :func:`bvh_ray_intersect_reference`'s outputs and ``stats["visits"]``.
    The left child is taken when the ray meets its box (the right one
    pushed when it meets that too), else the right; a leaf's real
    triangles are tested in slot order, its padding never (it always
    misses)."""
    P = origins.shape[0]
    dev = origins.device
    inv_d = _inverse_dirs(dirs)
    best_t = torch.full((P,), float("inf"), dtype=torch.float32, device=dev)
    best_tri = torch.full((P,), -1, dtype=torch.int64, device=dev)

    def visit_leaves(rows, first, real):
        o, d = origins[rows], dirs[rows]
        t_best, tri_best = best_t[rows], best_tri[rows]
        for j in range(LEAF_SIZE):
            tri = bvh.triangles[torch.clamp_max(first + j, bvh.triangles.shape[0] - 1)]
            t = _ray_tri(o, d, tri[:, 0], tri[:, 1], tri[:, 2])
            better = (j < real) & (t < t_best)
            t_best = torch.where(better, t, t_best)
            tri_best = torch.where(better, first + j, tri_best)
        best_t[rows], best_tri[rows] = t_best, tri_best

    def visit_internal(rows, words, box):
        o, inv, tmax = origins[rows], inv_d[rows], best_t[rows]
        hl = _aabb_ray_hit(o, inv, box[:, 0:3], box[:, 3:6], tmax)
        hr = _aabb_ray_hit(o, inv, box[:, 6:9], box[:, 9:12], tmax)
        return hl | hr, torch.where(hl, words[:, 12], words[:, 13]), hl & hr, words[:, 13]

    visits = _walk_packed(bvh, P, dev, visit_leaves, visit_internal)
    return best_t, best_tri.to(torch.int32), visits


# -- dispatch by device


def bvh_closest_point(bvh, points):
    """(distance (P,), closest point (P, 3), leaf slot (P,) int32) of
    ``points`` (P, 3) on the mesh of ``bvh``: the twin on the CPU, the
    kernel on the card."""
    if points.device.type == "cpu":
        return bvh_closest_point_reference(bvh, points)
    return bvh_closest_point_cuda(bvh, points)


def bvh_ray_intersect(bvh, origins, dirs):
    """(t (P,), inf on a miss; leaf slot (P,) int32) of the nearest hit of
    rays ``origins``, ``dirs`` (P, 3): the twin on the CPU, the kernel on
    the card."""
    if origins.device.type == "cpu":
        return bvh_ray_intersect_reference(bvh, origins, dirs)
    return bvh_ray_intersect_cuda(bvh, origins, dirs)


# -- the kernels


def _check(cond: bool, msg: str, fn: str):
    if not cond:
        raise ValueError(f"{fn}: {msg}")


def _check_tree(fn: str, bvh, queries: dict):
    """Device, dtypes, shapes, contiguity and 16-byte alignment of what
    the kernels read (the packed records and the triangles) and of the
    queries (each (P, 3) float32)."""
    dev = next(iter(queries.values())).device
    _check(dev.type == "cuda", f"queries must be CUDA tensors, got {dev}", fn)
    R = bvh.records.shape[0]
    for name, t, dtype, shape in (
        ("records", bvh.records, torch.int32, (R, RECORD_WORDS)),
        ("triangles", bvh.triangles, torch.float32, (bvh.triangles.shape[0], 3, 3)),
    ):
        _check(t.dtype == dtype and tuple(t.shape) == shape,
               f"{name} must be {shape} {dtype}, got {tuple(t.shape)} {t.dtype}", fn)
        _check(t.device == dev, f"{name} is on {t.device}, queries on {dev}", fn)
        _check(t.is_contiguous() and t.data_ptr() % 16 == 0,
               f"{name} must be contiguous and 16-byte aligned", fn)
    _check(bvh.triangles.shape[0] % LEAF_SIZE == 0 and bvh.triangles.shape[0] > 0,
           f"a tree needs whole leaves of {LEAF_SIZE} triangles", fn)
    _check((bvh.root == 0) == (R > 0) and 1 <= bvh.depth < STACK_DEPTH,
           f"root {bvh.root}, {R} records and depth {bvh.depth} do not make a tree", fn)
    P = None
    for name, t in queries.items():
        _check(t.dtype == torch.float32 and t.dim() == 2 and t.shape[1] == 3,
               f"{name} must be (P, 3) float32, got {tuple(t.shape)} {t.dtype}", fn)
        _check(P is None or t.shape[0] == P, f"{name} has {t.shape[0]} rows, not {P}", fn)
        _check(t.device == dev, f"{name} is on {t.device}, not {dev}", fn)
        _check(t.is_contiguous(), f"{name} must be contiguous", fn)
        P = t.shape[0]
    return dev, P


def _tree_args(bvh):
    """The C functions' tree arguments: records, root, stack entries (the
    depth less one holds every walk), triangles."""
    return (bvh.records.data_ptr(), bvh.root, max(bvh.depth - 1, 1), bvh.triangles.data_ptr())


def _visits_ptr(fn: str, visits, P: int, dev) -> int:
    if visits is None:
        return 0
    _check(visits.dtype == torch.int32 and tuple(visits.shape) == (P,)
           and visits.device == dev and visits.is_contiguous(),
           f"visits must be a contiguous ({P},) int32 tensor on {dev}", fn)
    return visits.data_ptr()


def _raise_on(lib, rc: int, fn: str):
    if rc != 0:
        msg = lib.triangle_bvh_error_string(rc).decode()
        raise RuntimeError(f"{fn} launch failed: {msg} ({rc})")


def bvh_closest_point_cuda(bvh, points, visits=None):
    """Launch the closest-point kernel of ``csrc/triangle_bvh.cu`` on the
    current stream. ``visits``, a (P,) int32 tensor, receives each query's
    nodes processed (tests and measurements; no path asks for it). Raises
    on any input the kernel does not take and on a refused launch."""
    fn = "bvh_closest_point_cuda"
    dev, P = _check_tree(fn, bvh, {"points": points})
    visits_ptr = _visits_ptr(fn, visits, P, dev)
    dist = torch.empty((P,), dtype=torch.float32, device=dev)
    cp = torch.empty((P, 3), dtype=torch.float32, device=dev)
    tri = torch.empty((P,), dtype=torch.int32, device=dev)
    if P == 0:
        return dist, cp, tri
    lib = TRIANGLE_BVH.library()
    rc = launch_on(dev, lambda stream: lib.bvh_closest_point(
        *_tree_args(bvh), points.data_ptr(), P, dist.data_ptr(), cp.data_ptr(),
        tri.data_ptr(), visits_ptr, stream))
    _raise_on(lib, rc, "bvh_closest_point")
    TRIANGLE_BVH.launches["bvh_closest_point"] += 1
    return dist, cp, tri


def bvh_ray_intersect_cuda(bvh, origins, dirs, visits=None):
    """Launch the ray-hit kernel of ``csrc/triangle_bvh.cu`` on the current
    stream; ``visits`` as for :func:`bvh_closest_point_cuda`. Raises on any
    input the kernel does not take and on a refused launch."""
    fn = "bvh_ray_intersect_cuda"
    dev, P = _check_tree(fn, bvh, {"origins": origins, "dirs": dirs})
    visits_ptr = _visits_ptr(fn, visits, P, dev)
    t = torch.empty((P,), dtype=torch.float32, device=dev)
    tri = torch.empty((P,), dtype=torch.int32, device=dev)
    if P == 0:
        return t, tri
    lib = TRIANGLE_BVH.library()
    rc = launch_on(dev, lambda stream: lib.bvh_ray_intersect(
        *_tree_args(bvh), origins.data_ptr(), dirs.data_ptr(), P,
        t.data_ptr(), tri.data_ptr(), visits_ptr, stream))
    _raise_on(lib, rc, "bvh_ray_intersect")
    TRIANGLE_BVH.launches["bvh_ray_intersect"] += 1
    return t, tri

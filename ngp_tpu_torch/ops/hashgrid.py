"""Multiresolution hash/dense grid encoding: the CUDA kernels' wrappers
(:func:`hashgrid_encode_cuda`, :func:`hashgrid_backward_cuda`,
:func:`hashgrid_input_grad_cuda`) and their plain PyTorch twins
(:func:`hashgrid_encode_reference`, :func:`hashgrid_backward_reference`,
:func:`hashgrid_input_grad_reference`).

Counterpart of ``ngp_tpu/ops/pallas/hashgrid.py`` (``_encode_kernel``),
extended to the additive hash that the JAX package computes with XLA
gathers (``models/encodings.py:grid_dup_gather_blend``). The source and its
design notes are in ``ngp_tpu_torch/csrc/hashgrid_encode.cu``.

:func:`hashgrid_encode`, :func:`hashgrid_backward` and
:func:`hashgrid_input_grad` pick by the device of ``x``: the twin for CPU
tensors, the kernel for CUDA tensors. On a CUDA tensor the kernel launches
or the call raises; nothing falls back to the twin.

The backward is the JAX package's ``_pge_bwd`` (``models/encodings.py``):
d(table), each corner's ``w_c · g`` rounded to bf16 and summed in float32
by row. Its twin is built from two: :func:`hashgrid_backward_addends_reference`
writes every (level, sample, corner)'s row as a segment key and ``w_c · g``
as the addend, and ``ops/segsum.segment_sum_reference`` sums them; the
kernel adds each addend to its row as it computes it. With
``payload_dtype="float32"`` the addends stay unrounded: the d(table) of
the JAX package's ``differentiable_inputs`` path.

The input gradient d(out)/dx contracted with the cotangent (the JAX
package's autodiff through ``GridEncoding.__call__(...,
differentiable_inputs=True)``) has no TPU kernel; its CUDA kernel is the
port's own.

Every function takes ``interpolation``: ``"Linear"`` (the 2^D cell
corners, multilinear weights) or ``"Simplex"`` (the JAX package's
``_simplex_corners_weights``: the D + 1 corners of the cell's Kuhn simplex
that holds the sample, barycentric weights). Tiled grids need no flag of
their own: a level's row index ends in ``& mask`` (:func:`level_mask`),
which is the JAX package's ``lin % size`` on a Tiled level that wraps.
"""

from __future__ import annotations

import ctypes

import torch

from ngp_tpu_torch.ops.cuda_build import CudaKernel, launch_on
from ngp_tpu_torch.ops.segsum import segment_sum_reference

HASH_PRIMES = (1, 2654435761, 805459861)
MAX_LEVELS = 32  # levels the kernels' geometry argument holds
HASH_VARIANTS = {"tcnn": 0, "additive": 1}  # XOR | addition of the prime terms
INTERPOLATIONS = {"Linear": 0, "Simplex": 1}
_U32 = 0xFFFFFFFF

_vp, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
HASHGRID_ENCODE = CudaKernel(
    "hashgrid_encode.cu",
    {
        "hashgrid_encode": (
            _i,
            [_vp] * 4 + [_ll, _i, _ll, _i, _i, _i, _i, _i, _i, _vp],
        ),
        "hashgrid_backward": (
            _i,
            [_vp] * 4 + [_ll, _i, _ll, _i, _i, _i, _i, _i, _i, _vp],
        ),
        "hashgrid_input_grad": (
            _i,
            [_vp] * 5 + [_ll, _i, _ll, _i, _i, _i, _i, _i, _vp],
        ),
        "hashgrid_encode_error_string": (ctypes.c_char_p, [_i]),
    },
    ("hashgrid_encode", "hashgrid_backward", "hashgrid_input_grad"),
)


class _Geometry(ctypes.Structure):
    """The kernels' per-level geometry (``Geometry`` in
    ``csrc/hashgrid_encode.cu``), passed by value in their arguments."""

    _fields_ = [("scale", ctypes.c_float * MAX_LEVELS),
                ("res", ctypes.c_int32 * MAX_LEVELS),
                ("mask", ctypes.c_uint32 * MAX_LEVELS),
                ("hashed", ctypes.c_int32 * MAX_LEVELS)]


def level_mask(size: int) -> int:
    """The uint32 mask that ends every row index of a level of ``size``
    rows: ``size − 1`` where the size is a power of two, all ones
    elsewhere. A hashed level (a power-of-two size) takes its hash modulo
    the size; a Tiled level whose ``res^D`` exceeds its rows (then exactly
    ``2^log2_hashmap_size``) wraps its linear index modulo the size; on
    every other level the linear index stays below the size, so the mask
    changes nothing."""
    return size - 1 if size & (size - 1) == 0 else _U32


def _host_geometry(scale, res, size, hashed) -> _Geometry:
    """The geometry tensors as the kernel's argument struct. Read from the
    device once and kept on ``scale`` with the other three tensors and all
    four versions, so that later calls with the same tensors cost no copy
    and no synchronisation, and a changed or different tensor is read
    anew. The largest level size rides along as ``geo.rows``."""
    parts = (scale, res, size, hashed)
    versions = tuple(t._version for t in parts)
    kept = getattr(scale, "_kernel_geometry", None)
    if (kept is not None and kept[1] == versions
            and all(a is b for a, b in zip(kept[0], parts))):
        return kept[2]
    geo = _Geometry()
    for l, (sc, r, sz, h) in enumerate(_levels(scale, res, size, hashed)):
        geo.scale[l], geo.res[l], geo.hashed[l] = sc, r, int(h)
        geo.mask[l] = level_mask(sz)
    geo.rows = max(size.tolist(), default=0)
    scale._kernel_geometry = (parts, versions, geo)
    return geo


def hashgrid_encode(x, table, scale, res, size, hashed, hash_variant: str,
                    max_level: int | None = None,
                    interpolation: str = "Linear") -> torch.Tensor:
    """Encode positions ``x`` (N, D) → (N, L·F) float32, level-major.

    ``table`` (L, T, F) float32 or bf16; ``scale`` (L,) float32 and ``res``,
    ``size``, ``hashed`` (L,) int32 per-level geometry (hashed levels have
    a power-of-two ``size``); ``hash_variant`` ``"tcnn"`` (XOR) or
    ``"additive"``; levels above ``max_level`` are zero; ``interpolation``
    ``"Linear"`` or ``"Simplex"``."""
    if x.device.type == "cpu":
        return hashgrid_encode_reference(
            x, table, scale, res, size, hashed, hash_variant, max_level, interpolation
        )
    return hashgrid_encode_cuda(
        x, table, scale, res, size, hashed, hash_variant, max_level, interpolation
    )


def _cell_fraction(x, scale: float):
    """(cell base (int64), fraction (float32)) of every sample at a level of
    ``scale``, ``x · scale + 0.5`` rounded twice as the kernels round it."""
    p = x * scale + 0.5
    p0f = torch.floor(p)
    return p0f.to(torch.int64), p - p0f


def _corner_row(cd, res: int, mask: int, hashed: bool, additive: bool):
    """Table rows (int64) of corners with coordinates ``cd`` (D int64
    tensors), in the kernels' uint32 arithmetic done in int64 masked to 32
    bits after every step: the hash, or the clipped linear index with
    strides ``res^d``; then ``& mask`` (:func:`level_mask`)."""
    idx, stride = 0, 1
    for d, c in enumerate(cd):
        if hashed:
            term = (c * HASH_PRIMES[d]) & _U32
            if d == 0:
                idx = term
            elif additive:
                idx = (idx + term) & _U32
            else:
                idx = idx ^ term
        else:
            idx = (idx + c.clamp(0, res - 1) * stride) & _U32
            stride = (stride * res) & _U32
    return idx & mask


def simplex_ranks(frac):
    """Rank (int64, 0 for the largest) of each of the D fractions ``frac``
    (N, D) in descending order, a tie ranking the lower dimension first:
    ``rank_d = #{e < d : f_e ≥ f_d} + #{e > d : f_e > f_d}``, the order of
    the JAX package's stable sort of ``-frac``."""
    D = frac.shape[1]
    ranks = []
    for d in range(D):
        r = torch.zeros(frac.shape[0], dtype=torch.int64, device=frac.device)
        for e in range(D):
            if e < d:
                r = r + (frac[:, e] >= frac[:, d])
            elif e > d:
                r = r + (frac[:, e] > frac[:, d])
        ranks.append(r)
    return ranks


def _by_rank(ranks, values, j):
    """``values[d]`` of the dimension d whose rank is ``j`` (the lowest d
    where ranks collide), as the kernels' chain of selects picks it."""
    out = values[-1]
    for d in range(len(values) - 2, -1, -1):
        out = torch.where(ranks[d] == j, values[d], out)
    return out


def _select_rank(rank, values):
    """``values[rank]`` per sample, as the kernel's chain of selects from
    the last value down picks it."""
    out = values[-1]
    for j in range(len(values) - 2, -1, -1):
        out = torch.where(rank == j, values[j], out)
    return out


def _level_corners(x, scale: float, res: int, size: int, hashed: bool,
                   additive: bool, interpolation: str = "Linear"):
    """Table rows (int64) and weights (float32) of the corners of every
    sample at one level, in the kernels' corner order and arithmetic.
    Linear: the 2^D cell corners in bit order, weights multiplied one
    dimension at a time. Simplex: corner k (k = 0..D) is the cell base plus
    e_d for every d of rank below k; with g_j the fraction of rank j the
    weights are ``[1 − g_0, g_0 − g_1, ..., g_{D−1}]``."""
    p0, frac = _cell_fraction(x, scale)
    D = x.shape[1]
    mask = level_mask(size)
    if interpolation == "Simplex":
        ranks = simplex_ranks(frac)
        cols = [frac[:, d] for d in range(D)]
        g = [_by_rank(ranks, cols, j) for j in range(D)]
        w = [1.0 - g[0]] + [g[k - 1] - g[k] for k in range(1, D)] + [g[D - 1]]
        for k in range(D + 1):
            cd = [p0[:, d] + (ranks[d] < k) for d in range(D)]
            yield _corner_row(cd, res, mask, hashed, additive), w[k]
        return
    for c in range(1 << D):
        w = None
        for d in range(D):
            wd = frac[:, d] if (c >> d) & 1 else 1.0 - frac[:, d]
            w = wd if w is None else w * wd
        cd = [p0[:, d] + ((c >> d) & 1) for d in range(D)]
        yield _corner_row(cd, res, mask, hashed, additive), w


def n_corners(n_dims: int, interpolation: str) -> int:
    """Corners a sample reads at a level: D + 1 (Simplex) or 2^D."""
    return n_dims + 1 if interpolation == "Simplex" else 1 << n_dims


def _levels(scale, res, size, hashed):
    return zip(scale.tolist(), res.tolist(), size.tolist(),
               (bool(h) for h in hashed.tolist()))


def hashgrid_encode_reference(x, table, scale, res, size, hashed,
                              hash_variant: str,
                              max_level: int | None = None,
                              interpolation: str = "Linear") -> torch.Tensor:
    """Plain PyTorch twin of the forward kernel, with the same arithmetic:
    products and sums in float32 (the dtype of ``x``) in the kernel's
    corner order."""
    additive = HASH_VARIANTS[hash_variant] == 1
    N = x.shape[0]
    L, T, F = table.shape
    top = L - 1 if max_level is None else max_level
    flat = table.reshape(L * T, F)
    out = torch.zeros((N, L, F), dtype=x.dtype, device=x.device)
    for l, geo in enumerate(_levels(scale, res, size, hashed)):
        if l > top:
            continue
        acc = torch.zeros((N, F), dtype=x.dtype, device=x.device)
        for idx, w in _level_corners(x, *geo, additive, interpolation):
            acc = acc + w[:, None] * flat[idx + l * T].to(x.dtype)
        out[:, l] = acc
    return out.reshape(N, L * F)


def hashgrid_backward(x, g, scale, res, size, hashed, hash_variant: str,
                      max_level: int | None, n_rows: int,
                      payload_dtype: str = "bfloat16",
                      interpolation: str = "Linear") -> torch.Tensor:
    """d(table) (L, n_rows, F) float32 of :func:`hashgrid_encode` for
    positions ``x`` (N, D) and the output cotangent ``g`` (N, L·F): each
    corner's ``w_c · g`` rounded to ``payload_dtype`` (bf16, the training
    path's rule, or float32, unrounded), summed in float32 by row; levels
    above ``max_level`` and rows no corner reaches are +0.0."""
    if x.device.type == "cpu":
        return hashgrid_backward_reference(
            x, g, scale, res, size, hashed, hash_variant, max_level, n_rows,
            payload_dtype, interpolation)
    return hashgrid_backward_cuda(
        x, g, scale, res, size, hashed, hash_variant, max_level, n_rows,
        payload_dtype, interpolation)


def hashgrid_backward_reference(x, g, scale, res, size, hashed,
                                hash_variant: str, max_level: int | None,
                                n_rows: int,
                                payload_dtype: str = "bfloat16",
                                interpolation: str = "Linear") -> torch.Tensor:
    """Plain PyTorch twin of the backward kernel: the corner keys and
    addends of :func:`hashgrid_backward_addends_reference`, summed by
    ``segment_sum_reference`` with addends rounded to ``payload_dtype``."""
    keys, vals = hashgrid_backward_addends_reference(
        x, g, scale, res, size, hashed, hash_variant, max_level, interpolation)
    return segment_sum_reference(keys, vals, n_rows, payload_dtype)


def hashgrid_backward_addends_reference(x, g, scale, res, size, hashed,
                                        hash_variant: str,
                                        max_level: int | None = None,
                                        interpolation: str = "Linear"):
    """Segment keys and addends of d(table): keys (L, N·C) int32 (the
    corner rows, sample-major then corner; C corners a sample,
    :func:`n_corners`), vals (L, N·C, F) float32 ``w_c·g``, zero on levels
    above ``max_level``. The forward twin's corner loop, with ``w_c · g`` in
    place of the table read; the backward twin sums them."""
    additive = HASH_VARIANTS[hash_variant] == 1
    N, D = x.shape
    L = scale.shape[0]
    F = g.shape[1] // L
    C = n_corners(D, interpolation)
    top = L - 1 if max_level is None else max_level
    gl = g.reshape(N, L, F)
    keys = torch.empty((L, N, C), dtype=torch.int32, device=x.device)
    vals = torch.zeros((L, N, C, F), dtype=torch.float32, device=x.device)
    for l, geo in enumerate(_levels(scale, res, size, hashed)):
        for c, (idx, w) in enumerate(_level_corners(x, *geo, additive, interpolation)):
            keys[l, :, c] = idx.to(torch.int32)
            if l <= top:
                vals[l, :, c] = w[:, None] * gl[:, l]
    return keys.reshape(L, N * C), vals.reshape(L, N * C, F)


def hashgrid_input_grad(x, g, table, scale, res, size, hashed,
                        hash_variant: str,
                        max_level: int | None = None,
                        interpolation: str = "Linear") -> torch.Tensor:
    """dx (N, D) float32: the gradient of ``sum(g · hashgrid_encode(x,
    table))`` with respect to positions ``x`` (N, D), for the output
    cotangent ``g`` (N, L·F) and a float32 ``table`` (L, T, F). Levels above
    ``max_level`` add nothing; the floor of each cell has no gradient."""
    if x.device.type == "cpu":
        return hashgrid_input_grad_reference(
            x, g, table, scale, res, size, hashed, hash_variant, max_level, interpolation)
    return hashgrid_input_grad_cuda(
        x, g, table, scale, res, size, hashed, hash_variant, max_level, interpolation)


def _corner_sums(x, gl, flat, geo, l: int, T: int, additive: bool, interpolation: str):
    """Per corner of level ``l``, ``a = Σ_f g_f · row_f`` in feature order
    from 0.0 (in ``abs`` terms where ``gl`` and ``flat`` are absolute
    values); and the level's cell fractions."""
    F = flat.shape[1]
    sums = []
    for idx, _ in _level_corners(x, *geo, additive, interpolation):
        rows = flat[idx + l * T]
        a = torch.zeros(x.shape[0], dtype=gl.dtype, device=x.device)
        for f in range(F):
            a = a + gl[:, l, f] * rows[:, f]
        sums.append(a)
    return sums, _cell_fraction(x, geo[0])[1]


def hashgrid_input_grad_reference(x, g, table, scale, res, size, hashed,
                                  hash_variant: str,
                                  max_level: int | None = None,
                                  interpolation: str = "Linear") -> torch.Tensor:
    """Plain PyTorch twin of the input-gradient kernel, in its arithmetic:
    per level, per corner ``a = Σ_f g·table[idx_c]`` (features in order).
    Linear: ``a`` times the other dimensions' weight factors in dimension
    order, added to dimension d's fraction gradient for the upper corner and
    subtracted for the lower. Simplex: dimension d of rank j takes
    ``a_{j+1} − a_j``. Then ``dx += dfrac · scale``, level by level from
    dx = +0.0 (so however a kernel spreads the levels, it keeps these bits
    by adding the terms in level order from +0.0). Computed in the dtype of
    ``x`` (float32; float64 for checks)."""
    additive = HASH_VARIANTS[hash_variant] == 1
    N, D = x.shape
    L, T, F = table.shape
    top = L - 1 if max_level is None else max_level
    flat = table.reshape(L * T, F)
    gl = g.reshape(N, L, F)
    zeros = lambda *shape: torch.zeros(shape, dtype=x.dtype, device=x.device)  # noqa: E731
    dx = zeros(N, D)
    for l, geo in enumerate(_levels(scale, res, size, hashed)):
        if l > top:
            break
        sums, frac = _corner_sums(x, gl, flat, geo, l, T, additive, interpolation)
        if interpolation == "Simplex":
            ranks = simplex_ranks(frac)
            dg = [sums[j + 1] - sums[j] for j in range(D)]
            dfrac = [_select_rank(ranks[d], dg) for d in range(D)]
        else:
            dfrac = [zeros(N)] * D
            for c, a in enumerate(sums):
                for d in range(D):
                    p = a
                    for e in range(D):
                        if e != d:
                            p = p * (frac[:, e] if (c >> e) & 1 else 1.0 - frac[:, e])
                    dfrac[d] = dfrac[d] + p if (c >> d) & 1 else dfrac[d] - p
        for d in range(D):
            dx[:, d] = dx[:, d] + dfrac[d] * geo[0]
    return dx


def hashgrid_input_grad_mass(x, g, table, scale, res, size, hashed,
                             hash_variant: str, max_level: int | None = None,
                             interpolation: str = "Linear"):
    """What bounds dx's float32 rounding: Σ|term| (N, D) float64 over the
    terms that each component sums, and their number n. Linear: the terms
    ``scale_l · g_f · table[idx_c, f] · Π_{d'≠d} w_{c,d'}``, n = levels ·
    2^D · F. Simplex: ``scale_l · g_f · table[idx_k, f]`` of the two corners
    k = rank_d, rank_d + 1, n = levels · 2 · F. Two orders of the same
    float32 terms differ by at most 2·(n − 1)·2^-24·Σ|term|."""
    additive = HASH_VARIANTS[hash_variant] == 1
    N, D = x.shape
    L, T, F = table.shape
    top = L - 1 if max_level is None else min(max_level, L - 1)
    flat = table.reshape(L * T, F).abs().double()
    gl = g.reshape(N, L, F).abs().double()
    mass = torch.zeros((N, D), dtype=torch.float64, device=x.device)
    for l, geo in enumerate(_levels(scale, res, size, hashed)):
        if l > top:
            break
        sums, frac = _corner_sums(x, gl, flat, geo, l, T, additive, interpolation)
        sums = [a * geo[0] for a in sums]
        frac = frac.double()
        if interpolation == "Simplex":
            ranks = simplex_ranks(frac)
            pair = [sums[j] + sums[j + 1] for j in range(D)]
            for d in range(D):
                mass[:, d] += _select_rank(ranks[d], pair)
            continue
        for c, a in enumerate(sums):
            for d in range(D):
                term = a
                for e in range(D):
                    if e != d:
                        term = term * (frac[:, e] if (c >> e) & 1 else 1.0 - frac[:, e])
                mass[:, d] += term
    per_level = 2 if interpolation == "Simplex" else 1 << D
    return mass, (top + 1) * per_level * F


def _check(cond: bool, msg: str, fn: str = "hashgrid_encode_cuda"):
    if not cond:
        raise ValueError(f"{fn}: {msg}")


def _check_common(fn: str, x, L: int, F: int, scale, res, size, hashed,
                  hash_variant: str, interpolation: str, tensors: dict):
    """Checks shared by the kernels' wrappers: positions, levels, geometry,
    interpolation, device and contiguity."""
    dev = x.device
    _check(dev.type == "cuda", f"x must be a CUDA tensor, got {dev}", fn)
    _check(x.dtype == torch.float32 and x.dim() == 2 and x.shape[1] in (2, 3),
           f"x must be (N, 2|3) float32, got {tuple(x.shape)} {x.dtype}", fn)
    _check(F in (1, 2, 4, 8), f"F must be 1, 2, 4 or 8, got {F}", fn)
    _check(L <= MAX_LEVELS, f"at most {MAX_LEVELS} levels, got {L}", fn)
    _check(hash_variant in HASH_VARIANTS,
           f"hash_variant must be one of {sorted(HASH_VARIANTS)}", fn)
    _check(interpolation in INTERPOLATIONS,
           f"interpolation must be one of {sorted(INTERPOLATIONS)}", fn)
    for name, t, dt in (("scale", scale, torch.float32), ("res", res, torch.int32),
                        ("size", size, torch.int32), ("hashed", hashed, torch.int32)):
        _check(t.dtype == dt and tuple(t.shape) == (L,),
               f"{name} must be ({L},) {dt}, got {tuple(t.shape)} {t.dtype}", fn)
    for name, t in dict(tensors, x=x, scale=scale, res=res, size=size,
                        hashed=hashed).items():
        _check(t.device == dev, f"{name} is on {t.device}, x on {dev}", fn)
        _check(t.is_contiguous(), f"{name} must be contiguous", fn)


def hashgrid_encode_cuda(x, table, scale, res, size, hashed,
                         hash_variant: str,
                         max_level: int | None = None,
                         interpolation: str = "Linear") -> torch.Tensor:
    """Launch the forward kernel of ``csrc/hashgrid_encode.cu`` on the
    current stream. Raises on any input the kernel does not take and on a
    refused launch."""
    dev = x.device
    _check(table.dtype in (torch.float32, torch.bfloat16) and table.dim() == 3,
           f"table must be (L, T, F) float32|bf16, got "
           f"{tuple(table.shape)} {table.dtype}")
    L, T, F = table.shape
    _check_common("hashgrid_encode_cuda", x, L, F, scale, res, size, hashed,
                  hash_variant, interpolation, {"table": table})
    N = x.shape[0]
    out = torch.empty((N, L * F), dtype=torch.float32, device=dev)
    if N == 0:
        return out
    geo = _host_geometry(scale, res, size, hashed)
    lib = HASHGRID_ENCODE.library()
    rc = launch_on(dev, lambda stream: lib.hashgrid_encode(
        x.data_ptr(), table.data_ptr(), ctypes.addressof(geo), out.data_ptr(),
        N, L, T, F, x.shape[1], int(table.dtype == torch.bfloat16),
        HASH_VARIANTS[hash_variant],
        L - 1 if max_level is None else max_level, INTERPOLATIONS[interpolation],
        stream))
    if rc != 0:
        msg = lib.hashgrid_encode_error_string(rc).decode()
        raise RuntimeError(f"hashgrid_encode launch failed: {msg} ({rc})")
    HASHGRID_ENCODE.launches["hashgrid_encode"] += 1
    return out


def _check_cotangent(fn: str, x, g, L: int):
    _check(g.dtype == torch.float32 and g.dim() == 2
           and g.shape[0] == x.shape[0] and L > 0 and g.shape[1] % L == 0,
           f"g must be (N, L*F) float32, got {tuple(g.shape)} {g.dtype}", fn)


def hashgrid_backward_cuda(x, g, scale, res, size, hashed, hash_variant: str,
                           max_level: int | None, n_rows: int,
                           payload_dtype: str = "bfloat16",
                           interpolation: str = "Linear") -> torch.Tensor:
    """Launch the backward kernel of ``csrc/hashgrid_encode.cu`` on the
    current stream into a zeroed (L, n_rows, F) float32 output. Raises on
    any input the kernel does not take and on a refused launch."""
    fn = "hashgrid_backward_cuda"
    dev = x.device
    L = scale.shape[0]
    _check_cotangent(fn, x, g, L)
    _check(payload_dtype in ("bfloat16", "float32"),
           f"payload_dtype must be bfloat16 or float32, got {payload_dtype!r}", fn)
    F = g.shape[1] // L
    _check_common(fn, x, L, F, scale, res, size, hashed, hash_variant,
                  interpolation, {"g": g})
    geo = _host_geometry(scale, res, size, hashed)
    _check(geo.rows <= n_rows, f"n_rows {n_rows} is below a level's {geo.rows} rows", fn)
    out = torch.zeros((L, n_rows, F), dtype=torch.float32, device=dev)
    N, D = x.shape
    if N == 0:
        return out
    lib = HASHGRID_ENCODE.library()
    rc = launch_on(dev, lambda stream: lib.hashgrid_backward(
        x.data_ptr(), g.data_ptr(), ctypes.addressof(geo), out.data_ptr(), N,
        L, n_rows, F, D, HASH_VARIANTS[hash_variant],
        L - 1 if max_level is None else max_level,
        int(payload_dtype == "bfloat16"), INTERPOLATIONS[interpolation], stream))
    if rc != 0:
        msg = lib.hashgrid_encode_error_string(rc).decode()
        raise RuntimeError(f"hashgrid_backward launch failed: {msg} ({rc})")
    HASHGRID_ENCODE.launches["hashgrid_backward"] += 1
    return out


def hashgrid_input_grad_cuda(x, g, table, scale, res, size, hashed,
                             hash_variant: str,
                             max_level: int | None = None,
                             interpolation: str = "Linear") -> torch.Tensor:
    """Launch the input-gradient kernel of ``csrc/hashgrid_encode.cu`` on
    the current stream into a new (N, D) float32 dx. Raises on any input the
    kernel does not take and on a refused launch."""
    fn = "hashgrid_input_grad_cuda"
    dev = x.device
    _check(table.dtype == torch.float32 and table.dim() == 3,
           f"table must be (L, T, F) float32, got {tuple(table.shape)} "
           f"{table.dtype}", fn)
    L, T, F = table.shape
    _check_cotangent(fn, x, g, L)
    _check(g.shape[1] == L * F, f"g has {g.shape[1]} columns for L*F = {L * F}", fn)
    _check_common(fn, x, L, F, scale, res, size, hashed, hash_variant,
                  interpolation, {"g": g, "table": table})
    geo = _host_geometry(scale, res, size, hashed)
    _check(geo.rows <= T, f"table has {T} rows, below a level's {geo.rows}", fn)
    dx = torch.empty_like(x)
    N, D = x.shape
    if N == 0:
        return dx
    lib = HASHGRID_ENCODE.library()
    rc = launch_on(dev, lambda stream: lib.hashgrid_input_grad(
        x.data_ptr(), g.data_ptr(), table.data_ptr(), ctypes.addressof(geo),
        dx.data_ptr(), N, L, T, F, D, HASH_VARIANTS[hash_variant],
        L - 1 if max_level is None else max_level, INTERPOLATIONS[interpolation],
        stream))
    if rc != 0:
        msg = lib.hashgrid_encode_error_string(rc).decode()
        raise RuntimeError(f"hashgrid_input_grad launch failed: {msg} ({rc})")
    HASHGRID_ENCODE.launches["hashgrid_input_grad"] += 1
    return dx

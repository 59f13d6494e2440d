"""Multiresolution hash/dense grid encoding: the CUDA kernels' wrappers
(:func:`hashgrid_encode_cuda`, :func:`hashgrid_backward_addends_cuda`) and
their plain PyTorch twins (:func:`hashgrid_encode_reference`,
:func:`hashgrid_backward_addends_reference`).

Counterpart of ``ngp_tpu/ops/pallas/hashgrid.py`` (``_encode_kernel``),
extended to the additive hash that the JAX package computes with XLA
gathers (``models/encodings.py:grid_dup_gather_blend``). The source and its
design notes are in ``ngp_tpu_torch/csrc/hashgrid_encode.cu``.

:func:`hashgrid_encode` and :func:`hashgrid_backward_addends` pick by the
device of ``x``: the twin for CPU tensors, the kernel for CUDA tensors. On a
CUDA tensor the kernel launches or the call raises; nothing falls back to
the twin.

The backward half writes, for every (level, sample, corner), the corner's
table row as a segment key and ``w_c · g`` as the addend;
``ops/segsum.batched_segment_sum`` turns them into d(table) (the JAX
package's ``_pge_bwd``, ``models/encodings.py``).
"""

from __future__ import annotations

import ctypes

import torch

from ngp_tpu_torch.ops.cuda_build import CudaKernel

HASH_PRIMES = (1, 2654435761, 805459861)
HASH_VARIANTS = {"tcnn": 0, "additive": 1}  # XOR | addition of the prime terms
_U32 = 0xFFFFFFFF

_vp, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
HASHGRID_ENCODE = CudaKernel(
    "hashgrid_encode.cu",
    {
        "hashgrid_encode": (
            _i,
            [_vp] * 7 + [_ll, _i, _ll, _i, _i, _i, _i, _i, _vp],
        ),
        "hashgrid_backward_addends": (
            _i,
            [_vp] * 8 + [_ll, _i, _i, _i, _i, _i, _vp],
        ),
        "hashgrid_encode_error_string": (ctypes.c_char_p, [_i]),
    },
    ("hashgrid_encode", "hashgrid_backward_addends"),
)


def hashgrid_encode(x, table, scale, res, size, hashed, hash_variant: str,
                    max_level: int | None = None) -> torch.Tensor:
    """Encode positions ``x`` (N, D) → (N, L·F) float32, level-major.

    ``table`` (L, T, F) float32 or bf16; ``scale`` (L,) float32 and ``res``,
    ``size``, ``hashed`` (L,) int32 per-level geometry (hashed levels have
    a power-of-two ``size``); ``hash_variant`` ``"tcnn"`` (XOR) or
    ``"additive"``; levels above ``max_level`` are zero."""
    if x.device.type == "cpu":
        return hashgrid_encode_reference(
            x, table, scale, res, size, hashed, hash_variant, max_level
        )
    return hashgrid_encode_cuda(
        x, table, scale, res, size, hashed, hash_variant, max_level
    )


def _level_corners(x, scale: float, res: int, size: int, hashed: bool,
                   additive: bool):
    """Table rows (int64) and multilinear weights (float32) of the 2^D
    corners of every sample's cell at one level, in the kernels' corner
    order and arithmetic: uint32 hashing done in int64 masked to 32 bits
    after every step, weights multiplied one dimension at a time."""
    p = x * scale + 0.5
    p0f = torch.floor(p)
    frac = p - p0f
    p0 = p0f.to(torch.int64)
    D = x.shape[1]
    for c in range(1 << D):
        w = None
        idx = None
        stride = 1
        for d in range(D):
            bit = (c >> d) & 1
            wd = frac[:, d] if bit else 1.0 - frac[:, d]
            w = wd if w is None else w * wd
            cd = p0[:, d] + bit
            if hashed:
                term = (cd * HASH_PRIMES[d]) & _U32
                if idx is None:
                    idx = term
                elif additive:
                    idx = (idx + term) & _U32
                else:
                    idx = idx ^ term
            else:
                lin = cd.clamp(0, res - 1) * stride
                idx = lin if idx is None else idx + lin
                stride *= res
        if hashed:
            idx = idx & (size - 1)
        yield idx, w


def _levels(scale, res, size, hashed):
    return zip(scale.tolist(), res.tolist(), size.tolist(),
               (bool(h) for h in hashed.tolist()))


def hashgrid_encode_reference(x, table, scale, res, size, hashed,
                              hash_variant: str,
                              max_level: int | None = None) -> torch.Tensor:
    """Plain PyTorch twin of the forward kernel, with the same arithmetic:
    products and sums in float32 in the kernel's corner order."""
    additive = HASH_VARIANTS[hash_variant] == 1
    N = x.shape[0]
    L, T, F = table.shape
    top = L - 1 if max_level is None else max_level
    flat = table.reshape(L * T, F)
    out = torch.zeros((N, L, F), dtype=torch.float32, device=x.device)
    for l, geo in enumerate(_levels(scale, res, size, hashed)):
        if l > top:
            continue
        acc = torch.zeros((N, F), dtype=torch.float32, device=x.device)
        for idx, w in _level_corners(x, *geo, additive):
            acc = acc + w[:, None] * flat[idx + l * T].to(torch.float32)
        out[:, l] = acc
    return out.reshape(N, L * F)


def hashgrid_backward_addends(x, g, scale, res, size, hashed,
                              hash_variant: str,
                              max_level: int | None = None):
    """Segment keys and addends of d(table) for positions ``x`` (N, D) and
    the output cotangent ``g`` (N, L·F): keys (L, N·2^D) int32 (the corner
    rows, sample-major then corner), vals (L, N·2^D, F) float32 ``w_c·g``;
    levels above ``max_level`` get zero addends."""
    if x.device.type == "cpu":
        return hashgrid_backward_addends_reference(
            x, g, scale, res, size, hashed, hash_variant, max_level
        )
    return hashgrid_backward_addends_cuda(
        x, g, scale, res, size, hashed, hash_variant, max_level
    )


def hashgrid_backward_addends_reference(x, g, scale, res, size, hashed,
                                        hash_variant: str,
                                        max_level: int | None = None):
    """Plain PyTorch twin of the backward-addends kernel: the forward twin's
    corner loop, with ``w_c · g`` in place of the table read."""
    additive = HASH_VARIANTS[hash_variant] == 1
    N, D = x.shape
    L = scale.shape[0]
    F = g.shape[1] // L
    C = 1 << D
    top = L - 1 if max_level is None else max_level
    gl = g.reshape(N, L, F)
    keys = torch.empty((L, N, C), dtype=torch.int32, device=x.device)
    vals = torch.zeros((L, N, C, F), dtype=torch.float32, device=x.device)
    for l, geo in enumerate(_levels(scale, res, size, hashed)):
        for c, (idx, w) in enumerate(_level_corners(x, *geo, additive)):
            keys[l, :, c] = idx.to(torch.int32)
            if l <= top:
                vals[l, :, c] = w[:, None] * gl[:, l]
    return keys.reshape(L, N * C), vals.reshape(L, N * C, F)


def _check(cond: bool, msg: str, fn: str = "hashgrid_encode_cuda"):
    if not cond:
        raise ValueError(f"{fn}: {msg}")


def _check_common(fn: str, x, L: int, F: int, scale, res, size, hashed,
                  hash_variant: str, tensors: dict):
    """Checks shared by both kernels' wrappers: positions, geometry, device
    and contiguity."""
    dev = x.device
    _check(dev.type == "cuda", f"x must be a CUDA tensor, got {dev}", fn)
    _check(x.dtype == torch.float32 and x.dim() == 2 and x.shape[1] in (2, 3),
           f"x must be (N, 2|3) float32, got {tuple(x.shape)} {x.dtype}", fn)
    _check(F in (1, 2, 4, 8), f"F must be 1, 2, 4 or 8, got {F}", fn)
    _check(hash_variant in HASH_VARIANTS,
           f"hash_variant must be one of {sorted(HASH_VARIANTS)}", fn)
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
                         max_level: int | None = None) -> torch.Tensor:
    """Launch the forward kernel of ``csrc/hashgrid_encode.cu`` on the
    current stream. Raises on any input the kernel does not take and on a
    refused launch."""
    dev = x.device
    _check(table.dtype in (torch.float32, torch.bfloat16) and table.dim() == 3,
           f"table must be (L, T, F) float32|bf16, got "
           f"{tuple(table.shape)} {table.dtype}")
    L, T, F = table.shape
    _check_common("hashgrid_encode_cuda", x, L, F, scale, res, size, hashed,
                  hash_variant, {"table": table})
    N = x.shape[0]
    out = torch.empty((N, L * F), dtype=torch.float32, device=dev)
    if N == 0:
        return out
    lib = HASHGRID_ENCODE.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.hashgrid_encode(
            x.data_ptr(), table.data_ptr(), scale.data_ptr(), res.data_ptr(),
            size.data_ptr(), hashed.data_ptr(), out.data_ptr(), N, L, T, F,
            x.shape[1], int(table.dtype == torch.bfloat16),
            HASH_VARIANTS[hash_variant], L - 1 if max_level is None else max_level,
            stream,
        )
    if rc != 0:
        msg = lib.hashgrid_encode_error_string(rc).decode()
        raise RuntimeError(f"hashgrid_encode launch failed: {msg} ({rc})")
    HASHGRID_ENCODE.launches["hashgrid_encode"] += 1
    return out


def hashgrid_backward_addends_cuda(x, g, scale, res, size, hashed,
                                   hash_variant: str,
                                   max_level: int | None = None):
    """Launch the backward-addends kernel of ``csrc/hashgrid_encode.cu`` on
    the current stream. Raises on any input the kernel does not take and on
    a refused launch."""
    fn = "hashgrid_backward_addends_cuda"
    dev = x.device
    L = scale.shape[0]
    _check(g.dtype == torch.float32 and g.dim() == 2
           and g.shape[0] == x.shape[0] and L > 0 and g.shape[1] % L == 0,
           f"g must be (N, L*F) float32, got {tuple(g.shape)} {g.dtype}", fn)
    F = g.shape[1] // L
    _check_common(fn, x, L, F, scale, res, size, hashed, hash_variant,
                  {"g": g})
    N, D = x.shape
    C = 1 << D
    keys = torch.empty((L, N * C), dtype=torch.int32, device=dev)
    vals = torch.empty((L, N * C, F), dtype=torch.float32, device=dev)
    if N == 0:
        return keys, vals
    lib = HASHGRID_ENCODE.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.hashgrid_backward_addends(
            x.data_ptr(), g.data_ptr(), scale.data_ptr(), res.data_ptr(),
            size.data_ptr(), hashed.data_ptr(), keys.data_ptr(),
            vals.data_ptr(), N, L, F, D, HASH_VARIANTS[hash_variant],
            L - 1 if max_level is None else max_level, stream,
        )
    if rc != 0:
        msg = lib.hashgrid_encode_error_string(rc).decode()
        raise RuntimeError(f"hashgrid_backward_addends launch failed: {msg} ({rc})")
    HASHGRID_ENCODE.launches["hashgrid_backward_addends"] += 1
    return keys, vals

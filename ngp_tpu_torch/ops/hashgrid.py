"""Multiresolution hash/dense grid encoding forward: the CUDA kernel's
wrapper (:func:`hashgrid_encode_cuda`) and its plain PyTorch twin
(:func:`hashgrid_encode_reference`).

Counterpart of ``ngp_tpu/ops/pallas/hashgrid.py`` (``_encode_kernel``),
extended to the additive hash that the JAX package computes with XLA
gathers (``models/encodings.py:grid_dup_gather_blend``). The source and its
design notes are in ``ngp_tpu_torch/csrc/hashgrid_encode.cu``.

:func:`hashgrid_encode` picks by the device of ``x``: the twin for CPU
tensors, the kernel for CUDA tensors. On a CUDA tensor the kernel launches
or the call raises; nothing falls back to the twin.
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
        "hashgrid_encode_error_string": (ctypes.c_char_p, [_i]),
    },
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


def hashgrid_encode_reference(x, table, scale, res, size, hashed,
                              hash_variant: str,
                              max_level: int | None = None) -> torch.Tensor:
    """Plain PyTorch twin of the kernel, with the same arithmetic: uint32
    hashing done in int64 masked to 32 bits after every step, products and
    sums in float32 in the kernel's corner order."""
    additive = HASH_VARIANTS[hash_variant] == 1
    N, D = x.shape
    L, T, F = table.shape
    top = L - 1 if max_level is None else max_level
    scales = scale.tolist()
    ress, sizes, hasheds = res.tolist(), size.tolist(), hashed.tolist()
    flat = table.reshape(L * T, F)
    out = torch.zeros((N, L, F), dtype=torch.float32, device=x.device)
    for l in range(L):
        if l > top:
            continue
        p = x * scales[l] + 0.5
        p0f = torch.floor(p)
        frac = p - p0f
        p0 = p0f.to(torch.int64)
        acc = torch.zeros((N, F), dtype=torch.float32, device=x.device)
        for c in range(1 << D):
            w = None
            idx = None
            stride = 1
            for d in range(D):
                bit = (c >> d) & 1
                wd = frac[:, d] if bit else 1.0 - frac[:, d]
                w = wd if w is None else w * wd
                cd = p0[:, d] + bit
                if hasheds[l]:
                    term = (cd * HASH_PRIMES[d]) & _U32
                    if idx is None:
                        idx = term
                    elif additive:
                        idx = (idx + term) & _U32
                    else:
                        idx = idx ^ term
                else:
                    lin = cd.clamp(0, ress[l] - 1) * stride
                    idx = lin if idx is None else idx + lin
                    stride *= ress[l]
            if hasheds[l]:
                idx = idx & (sizes[l] - 1)
            feats = flat[idx + l * T].to(torch.float32)
            acc = acc + w[:, None] * feats
        out[:, l] = acc
    return out.reshape(N, L * F)


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"hashgrid_encode_cuda: {msg}")


def hashgrid_encode_cuda(x, table, scale, res, size, hashed,
                         hash_variant: str,
                         max_level: int | None = None) -> torch.Tensor:
    """Launch ``csrc/hashgrid_encode.cu`` on the current stream. Raises on
    any input the kernel does not take and on a refused launch."""
    dev = x.device
    _check(dev.type == "cuda", f"x must be a CUDA tensor, got {dev}")
    _check(x.dtype == torch.float32 and x.dim() == 2 and x.shape[1] in (2, 3),
           f"x must be (N, 2|3) float32, got {tuple(x.shape)} {x.dtype}")
    _check(table.dtype in (torch.float32, torch.bfloat16) and table.dim() == 3,
           f"table must be (L, T, F) float32|bf16, got "
           f"{tuple(table.shape)} {table.dtype}")
    L, T, F = table.shape
    _check(F in (1, 2, 4, 8), f"F must be 1, 2, 4 or 8, got {F}")
    _check(hash_variant in HASH_VARIANTS,
           f"hash_variant must be one of {sorted(HASH_VARIANTS)}")
    for name, t, dt in (("scale", scale, torch.float32), ("res", res, torch.int32),
                        ("size", size, torch.int32), ("hashed", hashed, torch.int32)):
        _check(t.dtype == dt and tuple(t.shape) == (L,),
               f"{name} must be ({L},) {dt}, got {tuple(t.shape)} {t.dtype}")
    for name, t in (("x", x), ("table", table), ("scale", scale), ("res", res),
                    ("size", size), ("hashed", hashed)):
        _check(t.device == dev, f"{name} is on {t.device}, x on {dev}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
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
    HASHGRID_ENCODE.launches += 1
    return out

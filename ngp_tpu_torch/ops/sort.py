"""Batched bitonic sort with its argsort: the CUDA kernel's wrapper
(:func:`bitonic_sort_pos_cuda`) and its plain PyTorch twin
(:func:`bitonic_sort_pos_reference`).

Counterpart of ``ngp_tpu/ops/pallas/sort.py`` (``bitonic_sort_pos``, B5). The
JAX package keeps that kernel as a documented experiment that no path calls,
and so does the port: nothing here is on the serving or training path. The
source and its design notes are in ``ngp_tpu_torch/csrc/bitonic_sort.cu``.

Both run the TPU kernel's network, stage for stage: stages k = 1 … log2 n,
strides j = 2^(k−1) … 1; element i pairs with i ^ j; a pair is ascending
where bit k of i (within the row) is 0; the two exchange only where they are
strictly out of order. The permutation is therefore the JAX kernel's exactly,
ties included, not merely some argsort.

:func:`bitonic_sort_pos` picks by the device of ``keys``: the twin for CPU
tensors, the kernel for CUDA tensors, which launches or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ngp_tpu_torch.ops.cuda_build import CudaKernel, launch_on

INT32_MAX = 2**31 - 1  # padding: sorts to the tail
MIN_N = 128  # the JAX kernel's lane tile

_vp, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
BITONIC_SORT = CudaKernel(
    "bitonic_sort.cu",
    {
        "bitonic_sort_pos": (_i, [_vp] * 3 + [_ll, _i, _vp]),
        "bitonic_sort_launches": (_i, [_i]),
        "bitonic_sort_error_string": (ctypes.c_char_p, [_i]),
    },
    ("bitonic_sort_pos",),
)


def _check_keys(fn: str, keys):
    if keys.dtype != torch.int32 or keys.dim() != 2:
        raise ValueError(f"{fn}: keys must be (B, n) int32, got "
                         f"{tuple(keys.shape)} {keys.dtype}")
    n = keys.shape[1]
    if n & (n - 1) or n < MIN_N or n > 1 << 30:
        raise ValueError(f"{fn}: n must be a power of two in "
                         f"[{MIN_N}, 2^30], got {n}")


def bitonic_sort_launches(n: int) -> int:
    """Kernel launches that one :func:`bitonic_sort_pos_cuda` call makes for
    rows of ``n`` elements, as the C entry point plans them (builds the
    library)."""
    return BITONIC_SORT.library().bitonic_sort_launches(n)


def bitonic_sort_pos(keys):
    """Sort each row of ``keys`` (B, n) int32 ascending, n a power of two
    ≥ 128 (pad with ``INT32_MAX``). Returns ``(sorted_keys, perm)``, both
    (B, n) int32, with ``sorted_keys[b, i] = keys[b, perm[b, i]]``; ``keys``
    is not modified."""
    if keys.device.type == "cpu":
        return bitonic_sort_pos_reference(keys)
    return bitonic_sort_pos_cuda(keys)


def bitonic_sort_pos_reference(keys):
    """Plain PyTorch twin: every stage of the network over the whole tensor,
    the partner fetched with a gather and the strict exchange rule applied
    to both elements of a pair, as the JAX kernel's ``take``."""
    _check_keys("bitonic_sort_pos_reference", keys)
    B, n = keys.shape
    i = torch.arange(n, device=keys.device)
    key = keys.clone()
    pos = i.to(torch.int32).expand(B, n).clone()
    for k in range(1, n.bit_length()):
        ascending = ((i >> k) & 1) == 0
        for lj in range(k - 1, -1, -1):
            j = 1 << lj
            partner = i ^ j
            want_small = ascending == ((i & j) == 0)
            pk = key[:, partner]
            take = (want_small & (pk < key)) | (~want_small & (pk > key))
            key = torch.where(take, pk, key)
            pos = torch.where(take, pos[:, partner], pos)
    return key, pos


def bitonic_sort_pos_cuda(keys):
    """Launch ``bitonic_sort_pos`` of ``csrc/bitonic_sort.cu`` on the
    current stream (one call, counted once, runs every stage's launch).
    Raises on any input the kernel does not take and on a refused launch."""
    fn = "bitonic_sort_pos_cuda"
    if keys.device.type != "cuda":
        raise ValueError(f"{fn}: keys must be a CUDA tensor, got {keys.device}")
    _check_keys(fn, keys)
    if not keys.is_contiguous():
        raise ValueError(f"{fn}: keys must be contiguous")
    B, n = keys.shape
    sorted_keys = torch.empty_like(keys)
    perm = torch.empty_like(keys)
    if B == 0:
        return sorted_keys, perm
    lib = BITONIC_SORT.library()
    rc = launch_on(keys.device, lambda stream: lib.bitonic_sort_pos(
        keys.data_ptr(), sorted_keys.data_ptr(), perm.data_ptr(), B, n, stream))
    if rc != 0:
        msg = lib.bitonic_sort_error_string(rc).decode()
        raise RuntimeError(f"bitonic_sort_pos launch failed: {msg} ({rc})")
    BITONIC_SORT.launches["bitonic_sort_pos"] += 1
    return sorted_keys, perm

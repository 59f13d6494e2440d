"""Dense segment sums and key histograms: the CUDA kernels' wrappers
(:func:`segment_sum_cuda`, :func:`segment_count_cuda`), their plain PyTorch
twins (:func:`segment_sum_reference`, :func:`segment_count_reference`), and
the entry points the JAX package names:

- :func:`batched_segment_sum`: the contract of
  ``ngp_tpu/ops/scatter_free.py:batched_segment_sum``, which carries every
  hash-table gradient (on the TPU through ``segment_sum_sorted_blocks``, B2);
- :func:`segment_count`: ``segment_count_onehot_batched`` (B3);
- :func:`segment_sum_onehot` and :func:`segment_count_onehot`: the one-hot
  kernels ``ngp_tpu/ops/pallas/segsum.py:_run`` (B4), as the same two
  kernels with one level.

The sorts, block windows, bf16 pair packing and sentinel rows that the JAX
package needs on the TPU are not ported: the kernels add each addend with
one atomic (``csrc/segment_sum.cu``). Each dispatcher picks by the device
of ``keys``: the twin for CPU tensors, the kernel for CUDA tensors, which
launches or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ngp_tpu_torch.ops.cuda_build import CudaKernel

PAYLOAD_DTYPES = ("bfloat16", "float32")

_vp, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SEGMENT_SUM = CudaKernel(
    "segment_sum.cu",
    {
        "segment_sum": (_i, [_vp] * 3 + [_ll, _i, _ll, _i, _i, _vp]),
        "segment_count": (_i, [_vp] * 2 + [_ll, _i, _ll, _vp]),
        "segment_sum_error_string": (ctypes.c_char_p, [_i]),
    },
    ("segment_sum", "segment_count", "segment_sum_onehot", "segment_count_onehot"),
)


def _payload(vals: torch.Tensor, payload_dtype: str) -> torch.Tensor:
    if payload_dtype not in PAYLOAD_DTYPES:
        raise ValueError(f"payload_dtype must be one of {PAYLOAD_DTYPES}, "
                         f"got {payload_dtype!r}")
    v = vals.to(torch.float32)
    return v.to(torch.bfloat16).to(torch.float32) if payload_dtype == "bfloat16" else v


# -- dispatchers


def batched_segment_sum(keys, vals, n_segments: int,
                        payload_dtype: str = "bfloat16",
                        level_sizes=None) -> torch.Tensor:
    """The contract of the JAX package's ``batched_segment_sum``: keys
    (L, M) int32 in [0, n_segments), any order; vals (L, M, F) float32 →
    (L, n_segments, F) float32, each addend rounded to ``payload_dtype``
    first (bf16 by default; ``"float32"`` keeps exact addends, as
    ``NGP_TPU_SEGSUM_PAYLOAD=float32`` does there). ``level_sizes`` (level
    l's keys are below ``level_sizes[l]``) sized the TPU's one-hot work;
    the atomic sum does not depend on it, so it is only checked against
    the number of levels."""
    if level_sizes is not None and len(level_sizes) != keys.shape[0]:
        raise ValueError(f"level_sizes has {len(level_sizes)} entries for "
                         f"{keys.shape[0]} levels")
    if keys.device.type == "cpu":
        return segment_sum_reference(keys, vals, n_segments, payload_dtype)
    return segment_sum_cuda(keys, vals, n_segments, payload_dtype)


def segment_count(keys, n_segments: int) -> torch.Tensor:
    """``segment_count_onehot_batched``: keys (L, M) int32 in
    [0, n_segments) → per-level histogram (L, n_segments) int32."""
    if keys.device.type == "cpu":
        return segment_count_reference(keys, n_segments)
    return segment_count_cuda(keys, n_segments)


def segment_sum_onehot(keys, vals, n_segments: int,
                       payload_dtype: str = "bfloat16") -> torch.Tensor:
    """``segment_sum_onehot``: keys (M,), vals (M, F) → (T, F) float32 with
    bf16 addends and a float32 sum (B4 with F ≥ 1). Its launches count
    under their own name."""
    if keys.device.type == "cpu":
        return segment_sum_reference(keys[None], vals[None], n_segments, payload_dtype)[0]
    return segment_sum_cuda(keys[None], vals[None], n_segments, payload_dtype,
                            entry="segment_sum_onehot")[0]


def segment_count_onehot(keys, n_segments: int) -> torch.Tensor:
    """``segment_count_onehot``: keys (M,) → (T,) int32 (B4 with F = 0).
    Its launches count under their own name."""
    if keys.device.type == "cpu":
        return segment_count_reference(keys[None], n_segments)[0]
    return segment_count_cuda(keys[None], n_segments, entry="segment_count_onehot")[0]


# -- plain twins


def segment_sum_reference(keys, vals, n_segments: int,
                          payload_dtype: str = "bfloat16") -> torch.Tensor:
    """Plain PyTorch twin: ``index_add_`` of the rounded addends per level
    (keys outside [0, n_segments) are skipped, as the kernel skips them)."""
    L, M = keys.shape
    F = vals.shape[-1]
    v = _payload(vals, payload_dtype)
    out = torch.zeros((L, n_segments, F), dtype=torch.float32, device=keys.device)
    for l in range(L):
        k = keys[l].long()
        ok = (k >= 0) & (k < n_segments)
        out[l].index_add_(0, k[ok], v[l][ok])
    return out


def segment_count_reference(keys, n_segments: int) -> torch.Tensor:
    """Plain PyTorch twin: ``bincount`` per level."""
    rows = []
    for k in keys.long():
        k = k[(k >= 0) & (k < n_segments)]
        rows.append(torch.bincount(k, minlength=n_segments))
    return torch.stack(rows).to(torch.int32)


# -- kernel wrappers


def _check(cond: bool, fn: str, msg: str):
    if not cond:
        raise ValueError(f"{fn}: {msg}")


def _check_keys(fn: str, keys):
    _check(keys.device.type == "cuda", fn,
           f"keys must be a CUDA tensor, got {keys.device}")
    _check(keys.dtype == torch.int32 and keys.dim() == 2, fn,
           f"keys must be (L, M) int32, got {tuple(keys.shape)} {keys.dtype}")
    _check(keys.is_contiguous(), fn, "keys must be contiguous")


def _raise_on(rc: int, lib, name: str):
    if rc != 0:
        msg = lib.segment_sum_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({rc})")


def segment_sum_cuda(keys, vals, n_segments: int,
                     payload_dtype: str = "bfloat16",
                     entry: str = "segment_sum") -> torch.Tensor:
    """Launch ``segment_sum`` of ``csrc/segment_sum.cu`` on the current
    stream, counted under ``entry`` (the entry point that asked). Raises on
    any input the kernel does not take and on a refused launch."""
    fn = "segment_sum_cuda"
    _check_keys(fn, keys)
    L, M = keys.shape
    _check(vals.dtype == torch.float32 and vals.dim() == 3
           and tuple(vals.shape[:2]) == (L, M), fn,
           f"vals must be ({L}, {M}, F) float32, got {tuple(vals.shape)} {vals.dtype}")
    F = vals.shape[2]
    _check(F in (1, 2, 4, 8), fn, f"F must be 1, 2, 4 or 8, got {F}")
    _check(vals.device == keys.device, fn,
           f"vals is on {vals.device}, keys on {keys.device}")
    _check(vals.is_contiguous(), fn, "vals must be contiguous")
    _check(payload_dtype in PAYLOAD_DTYPES, fn,
           f"payload_dtype must be one of {PAYLOAD_DTYPES}")
    out = torch.zeros((L, n_segments, F), dtype=torch.float32, device=keys.device)
    if L * M == 0:
        return out
    lib = SEGMENT_SUM.library()
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        rc = lib.segment_sum(keys.data_ptr(), vals.data_ptr(), out.data_ptr(),
                             M, L, n_segments, F,
                             int(payload_dtype == "bfloat16"), stream)
    _raise_on(rc, lib, "segment_sum")
    SEGMENT_SUM.launches[entry] += 1
    return out


def segment_count_cuda(keys, n_segments: int,
                       entry: str = "segment_count") -> torch.Tensor:
    """Launch ``segment_count`` of ``csrc/segment_sum.cu`` on the current
    stream, counted under ``entry`` (the entry point that asked). Raises on
    any input the kernel does not take and on a refused launch."""
    _check_keys("segment_count_cuda", keys)
    L, M = keys.shape
    out = torch.zeros((L, n_segments), dtype=torch.int32, device=keys.device)
    if L * M == 0:
        return out
    lib = SEGMENT_SUM.library()
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        rc = lib.segment_count(keys.data_ptr(), out.data_ptr(), M, L,
                               n_segments, stream)
    _raise_on(rc, lib, "segment_count")
    SEGMENT_SUM.launches[entry] += 1
    return out

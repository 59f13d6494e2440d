"""2D training-position samplers for image fitting, the port of
``ngp_tpu/ops/image_sampler.py``: Uniform, Halton(2,3), Sobol-ish low
discrepancy and Stratified, after the reference's ``halton23_kernel`` /
``sobol2_kernel`` / ``stratify2_kernel`` (``src/testbed_image.cu:41-77``),
keyed off the global sample index ``step · batch_size + i``.

torch has no complete uint32 arithmetic, so the samplers compute in int64
and mask to 32 bits after every multiply, add and shift; an int64 product
that wraps still agrees with the uint32 product modulo 2^32. Halton, Sobol
and ``stratify2`` equal the JAX package's outputs bit for bit.

``uniform2`` cannot equal ``jax.random``: it draws from a
``torch.Generator`` on the positions' device seeded from ``(seed, step)``.
The stream is step-indexed, as the JAX package's ``fold_in(PRNGKey(seed),
step)`` is, so a run resumed from a snapshot draws what the uninterrupted
run would have drawn; the values differ from the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

_U32 = 0xFFFFFFFF
_U64 = (1 << 64) - 1


def _radical_inverse(base: int, idx: torch.Tensor, n_digits: int = 20) -> torch.Tensor:
    """Van der Corput radical inverse of int64 indices in [0, 2^32), summed
    in float32 digit by digit as the JAX package sums it (the digit scale
    kept in double precision and rounded to float32 at each product)."""
    result = torch.zeros(idx.shape, dtype=torch.float32, device=idx.device)
    inv_base = 1.0 / base
    scale = inv_base
    for _ in range(n_digits):
        digit = idx % base
        result = result + digit.to(torch.float32) * float(np.float32(scale))
        idx = idx // base
        scale = scale * inv_base
    return result


def _indices(base_idx: int, n: int, device) -> torch.Tensor:
    return (base_idx + torch.arange(n, dtype=torch.int64, device=device)) & _U32


def halton23(base_idx: int, n: int, device="cpu") -> torch.Tensor:
    """(n, 2) Halton(2,3) points starting at sample index ``base_idx``."""
    idx = _indices(base_idx, n, device)
    return torch.stack([_radical_inverse(2, idx), _radical_inverse(3, idx)], dim=-1)


def _sobol_owen_scramble(x: torch.Tensor, seed: int) -> torch.Tensor:
    """Laine-Karras style hash scramble (the JAX package's), on uint32
    values held in int64."""
    x = x ^ ((x * 0x3D20ADEA) & _U32)
    x = (x + seed) & _U32
    x = (x * ((seed >> 16) | 1)) & _U32
    x = x ^ ((x * 0x05526C56) & _U32)
    return x ^ ((x * 0x53A22864) & _U32)


def _reverse_bits32(x: torch.Tensor) -> torch.Tensor:
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) & _U32) | (x >> 16)


def _sobol2d(idx: torch.Tensor) -> torch.Tensor:
    """First two Sobol dimensions (direction numbers: identity and Pascal)."""
    d0 = _reverse_bits32(idx)
    v = idx
    x = torch.zeros_like(idx)
    c = 1 << 31
    for _ in range(32):
        x = torch.where((v & 1) != 0, x ^ c, x)
        v = v >> 1
        c = c ^ (c >> 1)
    return torch.stack([d0, x], dim=-1)


def sobol2(base_idx: int, n: int, seed: int, device="cpu") -> torch.Tensor:
    pts = _sobol2d(_indices(base_idx, n, device))
    seed = seed & _U32
    s0 = _sobol_owen_scramble(pts[:, 0], (seed * 0x9E3779B9 + 1) & _U32)
    s1 = _sobol_owen_scramble(pts[:, 1], (seed * 0x9E3779B9 + 2) & _U32)
    return torch.stack([s0, s1], dim=-1).to(torch.float32) * (1.0 / 4294967296.0)


def step_seed(seed: int, step: int) -> int:
    """A 64-bit generator seed for training step ``step`` of a run seeded
    ``seed`` (SplitMix64's finaliser, so that the low 32 bits, all a CPU
    generator keeps, depend on both)."""
    z = (seed * 0x9E3779B97F4A7C15 + step + 1) & _U64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _U64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _U64
    return z ^ (z >> 31)


def uniform2(n: int, seed: int, step: int, device="cpu") -> torch.Tensor:
    """(n, 2) uniform [0, 1) float32 from a generator on ``device`` seeded
    with :func:`step_seed` (module docstring)."""
    gen = torch.Generator(device).manual_seed(step_seed(seed, step))
    return torch.rand((n, 2), generator=gen, device=device)


def stratify2(positions: torch.Tensor, log2_batch_size: int) -> torch.Tensor:
    """Jitter uniform samples into a sqrt(batch)×sqrt(batch) grid, matching
    ``stratify2_kernel``. Requires a square power-of-two batch."""
    n = positions.shape[0]
    log2_size = log2_batch_size // 2
    size = 1 << log2_size
    in_batch = torch.arange(n, dtype=torch.int64, device=positions.device) & (
        (1 << log2_batch_size) - 1)
    x = (in_batch & (size - 1)).to(torch.float32)
    y = (in_batch >> log2_size).to(torch.float32)
    return torch.stack([positions[:, 0] / size + x / size,
                        positions[:, 1] / size + y / size], dim=-1)


def sample_positions(mode: str, step: int, batch_size: int, seed: int = 1337,
                     device="cpu") -> torch.Tensor:
    """(batch_size, 2) positions of training step ``step``, by the
    reference's ERandomMode (Halton, Sobol, Uniform, Stratified)."""
    mode = mode.lower()
    base = (step * batch_size) & _U32
    if mode == "halton":
        return halton23(base, batch_size, device)
    if mode == "sobol":
        return sobol2(base, batch_size, seed, device)
    pos = uniform2(batch_size, seed, step, device)
    if mode == "stratified":
        lb = int(batch_size).bit_length() - 1
        if (1 << lb) == batch_size and lb % 2 == 0:
            pos = stratify2(pos, lb)
    return pos

"""Cascaded occupancy grid, the render subset of ``ngp_tpu/ops/occupancy.py``.

The grid is a dense ``(C, G, G, G)`` float32 tensor in row-major (x, y, z)
order and the bitfield a uint8 0/1 tensor of the same shape. Cascade ``c``
covers the cube of half-extent ``2^(c-1)`` around (0.5,)³; coarser
cascades OR in the max-pool of the next finer one over their central half.
Every function here is bit-exact with the JAX package: integer math on the
float's exponent field, power-of-two scales from a table.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

# Reference constants (src/testbed_nerf.cu:55-100, nerf.h:24-30).
NERF_GRIDSIZE = 128
NERF_CASCADES = 8
SQRT3 = 1.73205080757
NERF_STEPS = 1024
MIN_CONE_STEPSIZE = SQRT3 / NERF_STEPS
MAX_CONE_STEPSIZE = MIN_CONE_STEPSIZE * (1 << (NERF_CASCADES - 1)) * NERF_STEPS / NERF_GRIDSIZE
NERF_MIN_OPTICAL_THICKNESS = 0.01


@dataclass(frozen=True)
class OccupancyGridConfig:
    grid_size: int = NERF_GRIDSIZE
    n_cascades: int = 1

    @property
    def max_mip(self) -> int:
        return self.n_cascades - 1


class OccupancyGridState(NamedTuple):
    """density (C, G, G, G) float32 (-1 marks culled cells); bitfield of
    the same shape, uint8 0/1; mean_density, a 0-dim float32 tensor over
    cascade 0."""

    density: torch.Tensor
    bitfield: torch.Tensor
    mean_density: torch.Tensor


def _floor_log2(x: torch.Tensor) -> torch.Tensor:
    """Exact ``floor(log2(x))`` of positive normal float32 values from the
    IEEE exponent field (the reference's ``frexpf``)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits >> 23) & 0xFF) - 127


def mip_from_pos(pos: torch.Tensor, max_mip: int) -> torch.Tensor:
    """Smallest cascade whose cube contains ``pos`` (..., 3) → (...,) int32."""
    maxval = torch.amax(torch.abs(pos - 0.5), dim=-1)
    e = _floor_log2(torch.clamp_min(maxval, 1e-10)) + 1
    return torch.clamp(e + 1, 0, max_mip)


def mip_from_dt(dt: torch.Tensor, pos: torch.Tensor, max_mip: int,
                grid_size: int = NERF_GRIDSIZE) -> torch.Tensor:
    """Cascade used while marching: at least the position's, coarser when
    the step spans more than one fine cell."""
    mip = mip_from_pos(pos, max_mip)
    dtx = dt * (2 * grid_size)
    e = _floor_log2(torch.clamp_min(dtx, 1e-10)) + 1
    return torch.where(dtx < 1.0, mip, torch.clamp(torch.maximum(mip, e), 0, max_mip))


def _mip_scales(n: int, device) -> torch.Tensor:
    return torch.tensor([2.0 ** -m for m in range(n)], dtype=torch.float32,
                        device=device)


def cell_index_at(pos: torch.Tensor, mip: torch.Tensor, grid_size: int,
                  n_cascades: int):
    """(cell xyz int64 (..., 3), valid (...,)) of scene positions at cascade
    ``mip`` (``cascaded_grid_idx_at`` without the Morton packing)."""
    mip_scale = _mip_scales(n_cascades, pos.device)[mip.long()][..., None]
    p = (pos - 0.5) * mip_scale + 0.5
    cell = torch.floor(p * grid_size).to(torch.int64)
    valid = torch.all((cell >= 0) & (cell < grid_size), dim=-1)
    return cell, valid


def occupied_at(bitfield: torch.Tensor, pos: torch.Tensor,
                mip: torch.Tensor) -> torch.Tensor:
    """Occupancy lookup (``density_grid_occupied_at``): bool (...,)."""
    C, G = bitfield.shape[0], bitfield.shape[1]
    cell, valid = cell_index_at(pos, mip, G, C)
    flat = ((mip.long() * G + cell[..., 0]) * G + cell[..., 1]) * G + cell[..., 2]
    flat = torch.where(valid, flat, 0)
    return (bitfield.reshape(-1)[flat] > 0) & valid


def build_bitfield(density: torch.Tensor, mean_density: torch.Tensor) -> torch.Tensor:
    """Threshold the float grid at ``min(0.01, mean_density)`` and OR each
    cascade's 2³ max-pool into the next coarser cascade's central half
    (``grid_to_bitfield`` + ``bitfield_max_pool``)."""
    C, G = density.shape[0], density.shape[1]
    thresh = torch.clamp_max(mean_density, NERF_MIN_OPTICAL_THICKNESS)
    bits = density > thresh
    levels = [bits[0]]
    q = G // 4
    for c in range(1, C):
        pooled = levels[-1].reshape(G // 2, 2, G // 2, 2, G // 2, 2).any(5).any(3).any(1)
        merged = bits[c].clone()
        merged[q : 3 * q, q : 3 * q, q : 3 * q] |= pooled
        levels.append(merged)
    return torch.stack(levels).to(torch.uint8)

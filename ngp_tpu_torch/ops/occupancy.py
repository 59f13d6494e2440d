"""Cascaded occupancy grid, the port of ``ngp_tpu/ops/occupancy.py``
(render lookups and the training-time maintenance: frustum culling,
all-cells and stride-residue refresh positions, EMA update, coarse gate).

The grid is a dense ``(C, G, G, G)`` float32 tensor in row-major (x, y, z)
order and the bitfield a uint8 0/1 tensor of the same shape. Cascade ``c``
covers the cube of half-extent ``2^(c-1)`` around (0.5,)³; coarser
cascades OR in the max-pool of the next finer one over their central half.
Every function here is bit-exact with the JAX package: integer math on the
float's exponent field, power-of-two scales from a table. Functions that
the JAX package feeds with a PRNG key take the random draw instead (the
engine draws it from its ``torch.Generator``), so tests can hand both
packages the same numbers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch
import torch.nn.functional as tnf

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
    decay: float = 0.95  # density_grid_decay (testbed.h:741)

    @property
    def n_cells(self) -> int:
        return self.grid_size ** 3

    @property
    def max_mip(self) -> int:
        return self.n_cascades - 1


class OccupancyGridState(NamedTuple):
    """density (C, G, G, G) float32 (-1 marks culled cells); bitfield of
    the same shape, uint8 0/1; mean_density, a 0-dim float32 tensor over
    cascade 0; ema_step, the number of updates so far (a host int: it
    picks the stride-residue phase without a device sync)."""

    density: torch.Tensor
    bitfield: torch.Tensor
    mean_density: torch.Tensor
    ema_step: int = 0


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


def _cell_xyz(cell_flat: torch.Tensor, G: int) -> torch.Tensor:
    return torch.stack([cell_flat // (G * G), (cell_flat // G) % G, cell_flat % G], -1)


def density_grid_cell_positions(cfg: OccupancyGridConfig, cell_xyz: torch.Tensor,
                                mip: torch.Tensor, jitter: torch.Tensor) -> torch.Tensor:
    """Scene position of ``cell_xyz`` + ``jitter`` ∈ [0, 1)³ at cascade
    ``mip`` (the inverse of :func:`cell_index_at`)."""
    G = cfg.grid_size
    p = (cell_xyz.to(torch.float32) + jitter) / G
    scale = 1.0 / _mip_scales(cfg.n_cascades, jitter.device)  # 2^mip, exact
    return (p - 0.5) * scale[mip.long()][..., None] + 0.5


def all_cells(cfg: OccupancyGridConfig, jitter: torch.Tensor) -> torch.Tensor:
    """Jittered positions (C·G³, 3) of every cell of every cascade once,
    cascade-major (the warm-up sweeps); ``jitter`` is a (C·G³, 3) uniform
    [0, 1) draw."""
    n_cells = cfg.n_cells
    flat = torch.arange(cfg.n_cascades * n_cells, device=jitter.device)
    return density_grid_cell_positions(
        cfg, _cell_xyz(flat % n_cells, cfg.grid_size), flat // n_cells, jitter)


def _check_strides(cfg: OccupancyGridConfig, n_strides: int):
    if cfg.n_cells % n_strides:
        raise ValueError(
            f"n_strides={n_strides} must divide n_cells={cfg.n_cells} "
            "(use a power of two for power-of-two grid sizes)")


def stride_cells(cfg: OccupancyGridConfig, jitter: torch.Tensor, phase: int,
                 n_strides: int) -> torch.Tensor:
    """Residue class ``phase`` of every cascade's flat cell index (cell
    j·n_strides + phase), jittered within the cell: the regular
    round-robin refresh. Positions (C·G³/n_strides, 3), cascade-major;
    ``jitter`` is a draw of that many rows."""
    _check_strides(cfg, n_strides)
    n_per = cfg.n_cells // n_strides
    C = cfg.n_cascades
    dev = jitter.device
    cell_flat = torch.arange(n_per, device=dev) * n_strides + phase
    cell_xyz = _cell_xyz(cell_flat, cfg.grid_size).repeat(C, 1)
    mip = torch.arange(C, device=dev).repeat_interleave(n_per)
    return density_grid_cell_positions(cfg, cell_xyz, mip, jitter)


def place_stride(cfg: OccupancyGridConfig, values: torch.Tensor, phase: int,
                 n_strides: int) -> torch.Tensor:
    """Dense (C, G, G, G) splat of :func:`stride_cells` values: the residue
    class' cells set, every other cell 0."""
    _check_strides(cfg, n_strides)
    G, C = cfg.grid_size, cfg.n_cascades
    full = torch.zeros((C, cfg.n_cells // n_strides, n_strides),
                       dtype=values.dtype, device=values.device)
    full[:, :, phase] = values.reshape(C, -1)
    return full.reshape(C, G, G, G)


def ema_update_density(density: torch.Tensor, splat: torch.Tensor,
                       decay: float) -> torch.Tensor:
    """``max(density·decay, splat)``, keeping the −1 culled marker."""
    return torch.where(density < 0.0, density, torch.maximum(density * decay, splat))


def update_grid_state_dense(cfg: OccupancyGridConfig, state: OccupancyGridState,
                            sampled_density_dense: torch.Tensor) -> OccupancyGridState:
    """Merge a dense (C, G, G, G) splat of activated densities (0 where not
    sampled) into the grid as optical thickness at the finest step, then
    rebuild the mean and the bitfield."""
    tmp = sampled_density_dense * MIN_CONE_STEPSIZE
    density = ema_update_density(state.density, tmp, cfg.decay)
    mean = torch.clamp_min(density[0], 0.0).mean()
    return OccupancyGridState(density, build_bitfield(density, mean), mean,
                              state.ema_step + 1)


def mark_untrained_cells(cfg: OccupancyGridConfig, xforms: torch.Tensor,
                         focal_lengths: torch.Tensor,
                         principal_points: torch.Tensor, resolution: tuple,
                         chunk: int = 1 << 18) -> torch.Tensor:
    """(C, G, G, G) density: 0 at cells some training camera sees, −1
    elsewhere (``mark_untrained_density_grid``). As in the JAX
    package, each camera is five frustum half-spaces and a cell counts as
    seen when its center lies inside all five of one camera's, with the
    cell's bounding radius as margin."""
    G, C = cfg.grid_size, cfg.n_cascades
    W, H = resolution
    n_cells = cfg.n_cells
    right, down, fwd, cam_o = (xforms[:, :, i] for i in range(4))
    tx0 = (principal_points[:, 0] * W / focal_lengths[:, 0])[:, None]
    tx1 = ((1.0 - principal_points[:, 0]) * W / focal_lengths[:, 0])[:, None]
    ty0 = (principal_points[:, 1] * H / focal_lengths[:, 1])[:, None]
    ty1 = ((1.0 - principal_points[:, 1]) * H / focal_lengths[:, 1])[:, None]

    def norm(v):
        return v / torch.linalg.norm(v, dim=-1, keepdim=True)

    normals = torch.stack([norm(fwd * tx0 + right), norm(fwd * tx1 - right),
                           norm(fwd * ty0 + down), norm(fwd * ty1 - down), fwd],
                          dim=1)  # (I, 5, 3)
    n_flat = normals.reshape(-1, 3)
    offsets = torch.sum(n_flat * cam_o.repeat_interleave(5, dim=0), dim=-1)
    n_images = xforms.shape[0]
    scales = 1.0 / _mip_scales(C, xforms.device)  # 2^mip
    vis = []
    for s in range(0, C * n_cells, chunk):
        idx = torch.arange(s, min(s + chunk, C * n_cells), device=xforms.device)
        mip_scale = scales[idx // n_cells]
        cell_xyz = _cell_xyz(idx % n_cells, G).to(torch.float32)
        center = ((cell_xyz + 0.5) / G - 0.5) * mip_scale[:, None] + 0.5
        margin = mip_scale / G * (0.5 * 1.7320508)
        d = center @ n_flat.T - offsets[None, :]
        inside = (d > -margin[:, None]).reshape(-1, n_images, 5)
        vis.append(inside.all(dim=2).any(dim=1))
    vis = torch.cat(vis).reshape(C, G, G, G)
    return torch.where(vis, 0.0, -1.0)


def build_coarse_gate(bitfield: torch.Tensor, pool: int = 4) -> torch.Tensor:
    """(C, G/pool, G/pool, G/pool) uint8 gate of the gated march: each
    cascade's bitfield max-pooled by ``pool``, then dilated by one pooled
    cell in every direction (3³ box). Conservative: a pooled cell is 0 only
    if every fine cell within one pooled cell of it is empty."""
    b = tnf.max_pool3d(bitfield.to(torch.float32)[None], pool, pool)
    b = tnf.max_pool3d(b, 3, 1, padding=1)
    return b[0].to(torch.uint8)

"""Cascaded occupancy grid, the port of ``ngp_tpu/ops/occupancy.py``
(render lookups and the training-time maintenance: frustum culling,
all-cells and stride-residue refresh positions, the reference's
probe-sampled refresh with its max-splat, EMA update, coarse gate, and the
geometry-seeded priors of a mesh or a point cloud).

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

import numpy as np
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


def splat_max(cfg: OccupancyGridConfig, flat_idx: torch.Tensor,
              values: torch.Tensor) -> torch.Tensor:
    """Max-splat of sampled optical thicknesses into a zeroed (C, G, G, G)
    grid (``splat_grid_samples_nerf_max_nearest_neighbor``,
    testbed_nerf.cu:678-707): an atomic max, exact in any order."""
    G, C = cfg.grid_size, cfg.n_cascades
    tmp = torch.zeros(C * G * G * G, dtype=torch.float32, device=values.device)
    tmp.scatter_reduce_(0, flat_idx.long(), values.to(torch.float32), "amax")
    return tmp.reshape(C, G, G, G)


N_PROBES = 10


def sample_update_cells(cfg: OccupancyGridConfig, density: torch.Tensor, n_uniform: int,
                        n_nonuniform: int, mip: torch.Tensor | None = None,
                        probes: torch.Tensor | None = None,
                        jitter: torch.Tensor | None = None,
                        generator: torch.Generator | None = None):
    """The cells a probe-sampled update re-queries
    (``generate_grid_samples_nerf_nonuniform``, testbed_nerf.cu:635-676):
    each of ``n_uniform + n_nonuniform`` samples picks a cascade and tries
    ``N_PROBES`` cells of it, taking the first whose density passes its
    threshold (−0.01 for the uniform ones: any cell not culled;
    ``NERF_MIN_OPTICAL_THICKNESS`` for the rest), else the last. The draws
    (``mip`` (n,) in [0, C), ``probes`` (n, 10) in [0, G³), ``jitter`` (n, 3)
    in [0, 1)) are drawn from ``generator`` where not given. Returns
    (flat cell index (n,) int64, jittered scene positions (n, 3))."""
    G, C = cfg.grid_size, cfg.n_cascades
    n_cells = G * G * G
    n = n_uniform + n_nonuniform
    dev = density.device
    if mip is None:
        mip = torch.randint(0, C, (n,), generator=generator, device=dev)
    if probes is None:
        probes = torch.randint(0, n_cells, (n, N_PROBES), generator=generator, device=dev)
    if jitter is None:
        jitter = torch.rand((n, 3), generator=generator, device=dev)
    mip, probes = mip.to(dev, torch.int64), probes.to(dev, torch.int64)
    vals = density.reshape(-1)[mip[:, None] * n_cells + probes]
    thresh = torch.full((n, 1), NERF_MIN_OPTICAL_THICKNESS, dtype=torch.float32, device=dev)
    thresh[:n_uniform] = -0.01
    ok = vals > thresh
    first = torch.argmax(ok.to(torch.uint8), dim=1)
    pick = torch.where(ok.any(dim=1), first, N_PROBES - 1)
    cell_flat = torch.gather(probes, 1, pick[:, None])[:, 0]
    pos = density_grid_cell_positions(cfg, _cell_xyz(cell_flat, G), mip,
                                      jitter.to(dev, torch.float32))
    return mip * n_cells + cell_flat, pos


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


def update_grid_state(cfg: OccupancyGridConfig, state: OccupancyGridState,
                      flat_idx: torch.Tensor, sampled_density: torch.Tensor
                      ) -> OccupancyGridState:
    """Merge activated densities at the cells ``flat_idx`` into the grid
    (``update_density_grid_nerf``'s tail and
    ``update_density_grid_mean_and_bitfield``, testbed_nerf.cu:3500-3567):
    optical thickness at the finest step, :func:`splat_max`, the EMA, then
    the mean and the bitfield."""
    tmp = splat_max(cfg, flat_idx, sampled_density * MIN_CONE_STEPSIZE)
    density = ema_update_density(state.density, tmp, cfg.decay)
    mean = torch.clamp_min(density[0], 0.0).mean()
    return OccupancyGridState(density, build_bitfield(density, mean), mean,
                              state.ema_step + 1)


def mark_untrained_cells(cfg: OccupancyGridConfig, xforms: torch.Tensor,
                         focal_lengths: torch.Tensor,
                         principal_points: torch.Tensor, resolution: tuple,
                         chunk: int = 1 << 18, visible_init: float = 0.0) -> torch.Tensor:
    """(C, G, G, G) density: ``visible_init`` at cells some training camera
    sees (0, upstream instant-ngp; the fork starts them at 1.0), −1
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
    return torch.where(vis, float(visible_init), -1.0)


# -- geometry-seeded priors (the fork's, host-side, once per scene)


def seed_grid_from_mesh(cfg: OccupancyGridConfig, triangles: np.ndarray) -> np.ndarray:
    """A (C, G, G, G) float32 host prior from a mesh (``(T, 3, 3)`` NGP-space
    triangles; ``Testbed::load_mesh_for_density_grid``,
    testbed_nerf.cu:3176-3300): −1 everywhere but at the cells a triangle
    passes through, which are 0 (trainable). Each triangle is sampled on a
    barycentric lattice at half the finest voxel (``n_sub`` steps along
    its longest edge, 1–256), and every sample marks its cell at each
    cascade. Float32 numpy in the JAX package's order, so that cells on a
    boundary fall as they do there. Pass it to
    ``NerfEngine.init_grid(precomputed_density=...)``."""
    G = cfg.grid_size
    tris = np.asarray(triangles, np.float32)
    density = np.full((cfg.n_cascades, G, G, G), -1.0, np.float32)
    spacing = 0.5 / G
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    longest = np.maximum(np.linalg.norm(e1, axis=-1),
                         np.maximum(np.linalg.norm(e2, axis=-1),
                                    np.linalg.norm(e2 - e1, axis=-1)))
    n_sub = np.clip(np.ceil(longest / spacing).astype(np.int64), 1, 256)
    for n in np.unique(n_sub):
        sel = tris[n_sub == n]
        a, b = np.meshgrid(np.arange(n + 1), np.arange(n + 1))
        keep = (a + b) <= n
        u = (a[keep] / max(n, 1)).astype(np.float32)
        v = (b[keep] / max(n, 1)).astype(np.float32)
        pts = (sel[:, None, 0]
               + u[None, :, None] * (sel[:, None, 1] - sel[:, None, 0])
               + v[None, :, None] * (sel[:, None, 2] - sel[:, None, 0])).reshape(-1, 3)
        for c in range(cfg.n_cascades):
            cell = np.floor(((pts - 0.5) * (2.0 ** -c) + 0.5) * G).astype(np.int64)
            cell = cell[np.all((cell >= 0) & (cell < G), axis=-1)]
            density[c, cell[:, 0], cell[:, 1], cell[:, 2]] = 0.0
    return density


def seed_grid_from_point_cloud(cfg: OccupancyGridConfig, points: np.ndarray,
                               dilation: int = 1, mark_ground_sky: bool = True) -> np.ndarray:
    """A (C, G, G, G) float32 host prior from ``(N, 3)`` NGP-space points
    (``Testbed::build_density_grid_from_point_cloud``,
    testbed_nerf.cu:3302-3407): at each cascade the cells within
    ``dilation`` cells (a (2r+1)³ box) of a point's cell are 0, the rest
    −1; with ``mark_ground_sky`` the last cascade's boundary planes x = 0,
    x = G−1, z = 0 and z = G−1 are 0 as well."""
    G = cfg.grid_size
    pts = np.asarray(points, np.float32)
    density = np.full((cfg.n_cascades, G, G, G), -1.0, np.float32)
    r = int(dilation)
    offs = np.stack(np.meshgrid(*([np.arange(-r, r + 1)] * 3), indexing="ij"),
                    -1).reshape(-1, 3)
    for c in range(cfg.n_cascades):
        cell = np.floor(((pts - 0.5) * (2.0 ** -c) + 0.5) * G).astype(np.int64)
        ok = np.all((cell >= 0) & (cell < G), axis=-1)
        cell = (cell[ok, None, :] + offs[None, :, :]).reshape(-1, 3)
        cell = cell[np.all((cell >= 0) & (cell < G), axis=-1)]
        density[c, cell[:, 0], cell[:, 1], cell[:, 2]] = 0.0
    if mark_ground_sky:
        last = cfg.n_cascades - 1
        density[last, :, :, 0] = 0.0
        density[last, 0, :, :] = 0.0
        density[last, :, :, G - 1] = 0.0
        density[last, G - 1, :, :] = 0.0
    return density


def build_coarse_gate(bitfield: torch.Tensor, pool: int = 4) -> torch.Tensor:
    """(C, G/pool, G/pool, G/pool) uint8 gate of the gated march: each
    cascade's bitfield max-pooled by ``pool``, then dilated by one pooled
    cell in every direction (3³ box). Conservative: a pooled cell is 0 only
    if every fine cell within one pooled cell of it is empty."""
    b = tnf.max_pool3d(bitfield.to(torch.float32)[None], pool, pool)
    b = tnf.max_pool3d(b, 3, 1, padding=1)
    return b[0].to(torch.uint8)

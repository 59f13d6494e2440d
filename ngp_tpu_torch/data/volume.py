"""Density volumes for the volume engine, the port of
``ngp_tpu/data/volume.py``.

The reference streams a NanoVDB FloatGrid and reads it through the tree
accessor (``src/testbed_volume.cu:573-651``); here, as in the JAX package,
the volume is a dense index-space density array, read by a plain gather,
plus what the reference derives at load time: a unit-cube AABB fitted
around the index bounding box, the world→index transform, the 128³
occupancy bitgrid (density > 0.001) and the global majorant of delta
tracking. The derived quantities are computed in numpy exactly as the JAX
package computes them; the density and the bitgrid then move to the
volume's device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ngp_tpu_torch.device import resolve_device

BITGRID_RES = 128
_SLAB = 32  # x-planes procedural_cloud_density computes at once


@dataclass
class DenseVolume:
    density: torch.Tensor  # (X, Y, Z) float32, index space
    world2index_scale: float
    world2index_offset: np.ndarray  # (3,) float32
    aabb_min: np.ndarray  # (3,) float32, unit-cube world space
    aabb_max: np.ndarray
    bitgrid: torch.Tensor  # (128, 128, 128) uint8
    global_majorant: float

    @classmethod
    def from_dense(cls, density: np.ndarray, device="cuda") -> "DenseVolume":
        """The load-time quantities of ``density`` (X, Y, Z): the index box
        [0, shape) scaled by its largest extent and centred at (0.5,)³; the
        bitgrid from 2× supersampled cell centres, max-pooled."""
        device = resolve_device(device)
        density = np.ascontiguousarray(density, np.float32)
        shape = np.asarray(density.shape, np.float32)
        maxsize = float(shape.max())
        scale = 1.0 / maxsize
        half = shape * scale * 0.5
        aabb_min = 0.5 - half
        aabb_max = 0.5 + half
        offset = shape * 0.5 - 0.5 * maxsize

        ss = 2 * BITGRID_RES
        cs = (np.arange(ss) + 0.5) / ss
        axes = [np.clip((cs * maxsize + offset[a]).astype(int), 0, density.shape[a] - 1)
                for a in range(3)]
        inside = [(cs >= aabb_min[a]) & (cs <= aabb_max[a]) for a in range(3)]
        occ = ((density[np.ix_(*axes)] > 0.001)
               & inside[0][:, None, None] & inside[1][None, :, None] & inside[2][None, None, :])
        bit = (occ.reshape(BITGRID_RES, 2, BITGRID_RES, 2, BITGRID_RES, 2)
               .any(axis=(1, 3, 5)).astype(np.uint8))
        return cls(
            density=torch.from_numpy(density).to(device),
            world2index_scale=maxsize,
            world2index_offset=offset.astype(np.float32),
            aabb_min=aabb_min.astype(np.float32),
            aabb_max=aabb_max.astype(np.float32),
            bitgrid=torch.from_numpy(bit).to(device),
            global_majorant=float(density.max()),
        )


def procedural_cloud_density(res: int = 64, seed: int = 0) -> np.ndarray:
    """The density array of the JAX package's ``procedural_cloud``, bit for
    bit (the same ``np.random.default_rng`` draw and float32 operations),
    built 32 x-planes at a time: a fuzzy ellipsoid times 4³ blocks of
    low-frequency noise, below 0.05 set to 0. ``res`` a multiple of 4."""
    if res % 4:
        raise ValueError(f"procedural_cloud needs a resolution divisible by 4, got {res}")
    rng = np.random.default_rng(seed)
    k = 4
    noise = rng.uniform(0.3, 1.0, size=(k, k, k)).astype(np.float32)
    g = np.arange(res).astype(np.float32) / res - 0.5
    t0, t1, t2 = (g / 0.4) ** 2, (g / 0.3) ** 2, (g / 0.35) ** 2
    block = np.arange(res) // (res // k)
    up_yz = noise[:, block][:, :, block]  # (k, res, res)
    out = np.empty((res, res, res), np.float32)
    for x0 in range(0, res, _SLAB):
        x1 = min(x0 + _SLAB, res)
        r = np.sqrt(t0[x0:x1, None, None] + t1[None, :, None] + t2[None, None, :])
        base = np.clip(1.0 - r, 0.0, 1.0)
        d = (base * up_yz[block[x0:x1]] * 4.0).astype(np.float32)
        d[d < 0.05] = 0.0
        out[x0:x1] = d
    return out


def procedural_cloud(res: int = 64, seed: int = 0, device="cuda") -> DenseVolume:
    """The JAX package's stand-in for the reference's ``wdas_cloud`` when no
    ``.nvdb`` asset is present (``ngp_tpu/data/volume.py:procedural_cloud``)."""
    return DenseVolume.from_dense(procedural_cloud_density(res, seed), device)


def load_volume(path: str, device="cuda") -> DenseVolume:
    """A density volume from an ``.nvdb`` (uncompressed FloatGrid) or
    ``.npy`` dense array."""
    if path.endswith(".npy"):
        return DenseVolume.from_dense(np.load(path), device)
    if path.endswith(".nvdb"):
        from ngp_tpu_torch.data.nanovdb_codec import read_nanovdb_dense

        return DenseVolume.from_dense(read_nanovdb_dense(path), device)
    raise ValueError("volume path must be .nvdb or .npy")

"""Ray marching on the exponential lattice, the port of the ungated
``ngp_tpu/ops/marching.py:march_rays``.

Every position the reference's sequential DDA march can visit lies on the
lattice ``t_k = from_steps(n0 + k)``, and a lattice point is sampled iff
its own occupancy test passes (the bitfield's max-pool construction makes
"empty at a coarse mip" imply "empty at every finer mip below it"). So the
march evaluates occupancy at all lattice points at once and keeps the
first K occupied ones per ray: one gather, one cumsum, one scatter.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ngp_tpu_torch.ops.occupancy import (
    MAX_CONE_STEPSIZE,
    MIN_CONE_STEPSIZE,
    mip_from_dt,
    occupied_at,
)


class SteppingSpace(NamedTuple):
    """Closed-form t ↔ step-count transform (``to/from_stepping_space``):
    linear at ``min_step`` near the camera, exponential (factor
    ``1 + cone_angle`` per step) in between, linear at ``max_step`` far
    away. All constants are Python floats, applied in float32."""

    cone_angle: float
    min_step: float
    max_step: float
    a: float
    b: float
    at: float
    bt: float
    log1p_c: float

    @staticmethod
    def make(cone_angle: float, min_step: float = MIN_CONE_STEPSIZE,
             max_step: float = MAX_CONE_STEPSIZE) -> "SteppingSpace":
        if cone_angle <= 1e-5:
            return SteppingSpace(cone_angle, min_step, max_step, 0.0, 0.0, 0.0, 0.0, 0.0)
        log1p_c = math.log(1.0 + cone_angle)
        a = (math.log(min_step) - math.log(log1p_c)) / log1p_c
        b = (math.log(max_step) - math.log(log1p_c)) / log1p_c
        return SteppingSpace(
            cone_angle, min_step, max_step,
            a, b, math.exp(a * log1p_c), math.exp(b * log1p_c), log1p_c,
        )

    def to_steps(self, t: torch.Tensor) -> torch.Tensor:
        if self.cone_angle <= 1e-5:
            return t / self.min_step
        mid = torch.log(torch.clamp_min(t, 1e-20)) / self.log1p_c
        lo = (t - self.at) / self.min_step + self.a
        hi = (t - self.bt) / self.max_step + self.b
        return torch.where(t <= self.at, lo, torch.where(t <= self.bt, mid, hi))

    def from_steps(self, n: torch.Tensor) -> torch.Tensor:
        if self.cone_angle <= 1e-5:
            return n * self.min_step
        mid = torch.exp(n * self.log1p_c)
        lo = (n - self.a) * self.min_step + self.at
        hi = (n - self.b) * self.max_step + self.bt
        return torch.where(n <= self.a, lo, torch.where(n <= self.b, mid, hi))

    def to_steps_scalar(self, t: float) -> float:
        """Host-side scalar version, for static sizing."""
        if self.cone_angle <= 1e-5:
            return t / self.min_step
        if t <= self.at:
            return (t - self.at) / self.min_step + self.a
        if t <= self.bt:
            return math.log(max(t, 1e-20)) / self.log1p_c
        return (t - self.bt) / self.max_step + self.b


def warp_direction(d: torch.Tensor) -> torch.Tensor:
    """Unit direction → [0, 1]³ (``warp_direction``)."""
    return (d + 1.0) * 0.5


class MarchedRays(NamedTuple):
    """Per-ray samples, N rays × K slots; slot k of a ray holds its k-th
    occupied lattice point while ``k < n_samples``."""

    t: torch.Tensor  # (N, K) sample distances along the normalized ray
    dt: torch.Tensor  # (N, K) step sizes
    valid: torch.Tensor  # (N, K) bool
    n_samples: torch.Tensor  # (N,) int32 occupied points kept (≤ K)
    total: torch.Tensor  # (N,) int32 occupied points, uncapped
    complete: torch.Tensor  # (N,) bool left the AABB and all points fit in K
    exited: torch.Tensor  # (N,) bool left the AABB within the lattice


def march_rays(origins: torch.Tensor, dirs: torch.Tensor,
               bitfield: torch.Tensor, aabb_min: torch.Tensor,
               aabb_max: torch.Tensor, stepping: SteppingSpace,
               n0: torch.Tensor, n_lattice: int, n_samples: int,
               max_mip: int) -> MarchedRays:
    """Evaluate occupancy at the ``n_lattice`` (M) lattice points of every
    ray and keep the first ``n_samples`` (K) occupied ones, in march order.
    ``n0`` (N,) is each ray's stepping-space start. Temporaries are
    O(N·M): callers bound N·M.

    Slots past a ray's last kept sample hold lattice point M − 1, as in the
    JAX package, so ``t`` and ``dt`` agree with it in every slot."""
    N = origins.shape[0]
    G = bitfield.shape[1]
    dev = origins.device
    k = torch.arange(n_lattice, dtype=torch.float32, device=dev)
    n = n0[:, None] + k[None, :]  # (N, M)
    t = stepping.from_steps(n)
    dt = stepping.from_steps(n + 1.0) - t
    pos = origins[:, None, :] + dirs[:, None, :] * t[..., None]  # (N, M, 3)
    inside = torch.all((pos >= aabb_min) & (pos <= aabb_max), dim=-1)
    # stop at the first exit (the box is convex; this also guards numerics)
    before_exit = torch.cumsum(~inside, dim=1, dtype=torch.int32) == 0
    exited = ~torch.all(inside, dim=1)
    mip = mip_from_dt(dt, pos, max_mip, G)
    occ = occupied_at(bitfield, pos, mip) & before_exit
    del pos, inside, mip, t, dt

    # slot of each occupied point among its ray's occupied points; points
    # past the K-th go to a dump column that is dropped
    rank = torch.cumsum(occ, dim=1, dtype=torch.int32) - 1
    slot = torch.where(occ & (rank < n_samples), rank, n_samples).long()
    lat = torch.arange(n_lattice, dtype=torch.int64, device=dev).expand(N, -1)
    sel = torch.full((N, n_samples + 1), n_lattice - 1, dtype=torch.int64,
                     device=dev)
    sel.scatter_(1, slot, lat)
    sel = sel[:, :n_samples]

    n_sel = n0[:, None] + sel.to(torch.float32)
    t_c = stepping.from_steps(n_sel)
    dt_c = stepping.from_steps(n_sel + 1.0) - t_c
    total = occ.sum(dim=1, dtype=torch.int32)
    kept = torch.clamp_max(total, n_samples)
    valid = torch.arange(n_samples, device=dev)[None, :] < kept[:, None]
    complete = exited & (total <= n_samples)
    return MarchedRays(t_c, dt_c, valid, kept, total, complete, exited)


def ray_aabb_range(origins: torch.Tensor, dirs: torch.Tensor,
                   aabb_min: torch.Tensor, aabb_max: torch.Tensor):
    """Slab test returning (tmin ≥ 0, tmax); misses have tmin > tmax."""
    inv = 1.0 / dirs
    t0 = (aabb_min - origins) * inv
    t1 = (aabb_max - origins) * inv
    tmin = torch.amax(torch.minimum(t0, t1), dim=-1)
    tmax = torch.amin(torch.maximum(t0, t1), dim=-1)
    return torch.clamp_min(tmin, 0.0), tmax

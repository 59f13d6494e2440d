"""NeRF render engine, the serving subset of ``ngp_tpu/engines/nerf.py``.

Rendering a view: camera rays → exponential-lattice march over the
cascaded occupancy bitfield (``ops/marching.py``) → k-major sample
compaction (``ops/compaction.py``) → ``NerfNetwork`` (hash-grid CUDA kernel,
density MLP, SH, rgb MLP) → front-to-back compositing
(``ops/composite.py``). Training, EMA and optimizer state are not yet
ported: a model's parameters come from a seeded generator
(:meth:`NerfEngine.init_state`) or a reference snapshot
(:meth:`NerfEngine.load_reference_snapshot`).

One deliberate difference from the JAX package: samples that the render
compaction budget drops are removed from ``valid`` before compositing. The
JAX package masks only a local copy (fault C1 in ROADMAP.md), so there a
dropped sample composites with raw output 0, i.e. density exp(0) = 1.
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ngp_tpu_torch.data import ingp_snapshot
from ngp_tpu_torch.data.nerf_loader import NerfDataset
from ngp_tpu_torch.device import resolve_device
from ngp_tpu_torch.geometry.aabb import AABB
from ngp_tpu_torch.geometry.camera import pixel_dirs_cam
from ngp_tpu_torch.interop import load_jax_params
from ngp_tpu_torch.models.factory import create_nerf_network
from ngp_tpu_torch.models.nerf_network import NerfNetwork
from ngp_tpu_torch.ops import occupancy as occ
from ngp_tpu_torch.ops.compaction import compact_rows, compaction_plan, expand_rows
from ngp_tpu_torch.ops.composite import composite, density_activation, rgb_activation
from ngp_tpu_torch.ops.marching import (
    MarchedRays,
    SteppingSpace,
    march_rays,
    ray_aabb_range,
    warp_direction,
)

# Network rows per call: bounds the MLP's (rows, 64) float32 activations.
NETWORK_CHUNK = 1 << 20
# Lattice points per march call: bounds the march's O(rays × lattice)
# temporaries to a few GB.
MARCH_POINTS = 1 << 24


class RenderState(NamedTuple):
    """What rendering reads of a model: its training step and its network
    (inference parameters; the port has no EMA or optimizer state yet)."""

    step: int
    model: NerfNetwork


@dataclass
class NerfEngine:
    config: dict  # reference-format network config
    dataset: NerfDataset
    n_render_samples: int = 192  # K for rendering
    grid_size: int = occ.NERF_GRIDSIZE
    n_steps_per_unit: int = occ.NERF_STEPS
    # The network runs on at most this fraction of the N·K render slots,
    # first in k-major order (1.0 keeps every valid slot).
    render_compaction_frac: float = 0.625
    seed: int = 1337
    min_transmittance_render: float = 0.01
    background_color: tuple = (0.0, 0.0, 0.0)
    device: str = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.config = copy.deepcopy(self.config)
        ds = self.dataset
        aabb_scale = min(int(ds.aabb_scale), 1 << (occ.NERF_CASCADES - 1))
        if aabb_scale & (aabb_scale - 1):
            raise ValueError("aabb_scale must be a power of two")
        self.aabb_scale = aabb_scale
        max_cascade = 0
        while (1 << max_cascade) < aabb_scale:
            max_cascade += 1
        self.max_cascade = max_cascade
        self.grid_cfg = occ.OccupancyGridConfig(self.grid_size, max_cascade + 1)
        # fixed stepping in unit scenes, exponential otherwise
        self.cone_angle = 0.0 if aabb_scale <= 1 else 1.0 / 256.0
        min_step = occ.SQRT3 / self.n_steps_per_unit
        max_step = (min_step * (1 << (occ.NERF_CASCADES - 1))
                    * self.n_steps_per_unit / self.grid_size)
        self.stepping = SteppingSpace.make(self.cone_angle, min_step, max_step)
        self.aabb = AABB.from_scale(float(aabb_scale), self.device)
        # lattice length: a ray entering at t=0 and crossing the whole
        # diagonal; a multiple of 8, as in the JAX package
        diag = occ.SQRT3 * aabb_scale
        span = self.stepping.to_steps_scalar(diag) - self.stepping.to_steps_scalar(0.0)
        self.n_lattice = min(-(-(int(math.ceil(span)) + 2) // 8) * 8, 2048)
        self.rgb_act = "Exponential" if ds.is_hdr else "Logistic"
        self.density_act = "Exponential"
        self._maybe_autocomplete_grid_config()
        self.n_extra_dims = int(ds.n_extra_learnable_dims)
        self.network = self._new_network()
        f32 = dict(dtype=torch.float32, device=self.device)
        self.xforms = torch.as_tensor(np.asarray(ds.xforms[:, 0]), **f32)
        self.focals = torch.as_tensor(np.asarray(ds.focal_lengths), **f32)
        self.pps = torch.as_tensor(np.asarray(ds.principal_points), **f32)
        self.lens = ds.lens
        self.resolution = ds.resolution  # (W, H)
        self.last_render_samples = 0  # network rows of the last render_rays

    def _maybe_autocomplete_grid_config(self):
        """tcnn's grid defaults (``reset_network``): base resolution from
        the table size, per-level scale so the finest level is about
        2048·aabb_scale."""
        enc = self.config.get("encoding", {})
        if "grid" not in enc.get("otype", "").lower():
            return
        if not enc.get("base_resolution"):
            enc["base_resolution"] = 1 << (enc.get("log2_hashmap_size", 15) // 3)
        if not enc.get("per_level_scale"):
            n_levels = enc.get("n_levels", 16)
            if n_levels > 1:
                enc["per_level_scale"] = math.exp(
                    math.log(2048.0 * self.aabb_scale / enc["base_resolution"])
                    / (n_levels - 1)
                )
            else:
                enc["per_level_scale"] = 2.0

    @property
    def ray_chunk(self) -> int:
        """Rays per march call: as many as keep it within ``MARCH_POINTS``
        lattice points."""
        return max(1024, MARCH_POINTS // self.n_lattice)

    def _new_network(self) -> NerfNetwork:
        return create_nerf_network(
            self.config, n_extra_dims=self.n_extra_dims, device=self.device
        )

    # -- model and grid state

    def init_state(self) -> RenderState:
        """A model with parameters drawn from ``torch.Generator`` seeded
        with ``self.seed``."""
        net = self._new_network()
        net.reset_parameters(torch.Generator().manual_seed(self.seed))
        return RenderState(0, net)

    def inference_params(self, state: RenderState) -> NerfNetwork:
        return state.model

    def grid_from_density(self, density: torch.Tensor) -> occ.OccupancyGridState:
        """Occupancy state of a ``(C, G, G, G)`` density grid: the mean over
        cascade 0 and the thresholded, max-pooled bitfield."""
        density = density.to(self.device, torch.float32)
        mean = torch.clamp_min(density[0], 0.0).mean()
        return occ.OccupancyGridState(
            density, occ.build_bitfield(density, mean), mean
        )

    def load_reference_snapshot(self, path: str):
        """Read a reference-format snapshot into ``(RenderState, grid)``.
        The snapshot must describe this engine's architecture."""
        doc = ingp_snapshot.load_ingp(path)
        if "snapshot" not in doc:
            raise ValueError(f"'{path}' does not contain a snapshot")
        snap = doc["snapshot"]
        gsize = int(snap.get("density_grid_size", occ.NERF_GRIDSIZE))
        if gsize != self.grid_size:
            raise ValueError(
                f"snapshot grid size {gsize} != engine grid size {self.grid_size}"
            )
        net = self._new_network()
        load_jax_params(net, ingp_snapshot.params_from_reference(snap, net))
        density = ingp_snapshot.density_grid_from_reference(
            snap["density_grid_binary"], self.grid_cfg.n_cascades, self.grid_size
        )
        state = RenderState(int(snap.get("training_step", 0)), net)
        return state, self.grid_from_density(torch.from_numpy(density))

    # -- rendering

    def _eval_marched(self, model: NerfNetwork, origins, dirs,
                      marched: MarchedRays, budget_frac: float):
        """Network at the marched samples → (rgb (N, K, 3), sigma (N, K),
        marched with ``valid`` cut to the samples evaluated). At most
        ``budget_frac`` of the N·K slots are evaluated, the first in k-major
        order, so an overflow drops the deepest march steps."""
        N, K = marched.t.shape
        budget = N * K
        if budget_frac < 1.0:
            budget = min(-(-int(N * K * budget_frac) // 1024) * 1024, N * K)
        plan = compaction_plan(marched.valid.t().reshape(-1), budget)
        marched = marched._replace(valid=plan.keep.reshape(K, N).t())
        pos = origins[:, None, :] + dirs[:, None, :] * marched.t[..., None]
        pos_km = self.aabb.relative_pos(pos).transpose(0, 1).reshape(K * N, 3)
        pos_c = compact_rows(pos_km, plan)
        dir_c = warp_direction(dirs)[plan.cidx % N]  # k-major slot s is ray s % N
        raw = torch.empty((plan.n_live, 4), dtype=torch.float32, device=origins.device)
        for s in range(0, plan.n_live, NETWORK_CHUNK):
            e = min(s + NETWORK_CHUNK, plan.n_live)
            extra = None
            if self.n_extra_dims > 0:
                extra = torch.zeros((e - s, self.n_extra_dims), device=origins.device)
            raw[s:e] = model(pos_c[s:e], dir_c[s:e], extra=extra)
        self.last_render_samples += plan.n_live
        raw = expand_rows(raw, plan).reshape(K, N, 4).transpose(0, 1)
        rgb = rgb_activation(self.rgb_act)(raw[..., :3])
        sigma = density_activation(self.density_act)(raw[..., 3])
        return rgb, sigma, marched

    def _miss_background(self, dirs: torch.Tensor) -> torch.Tensor:
        """Per-ray background color (no envmap in the port yet)."""
        bg = torch.as_tensor(self.background_color, dtype=torch.float32,
                             device=dirs.device)
        return bg.expand(dirs.shape[0], 3)

    def _finish_shade(self, dirs, marched: MarchedRays, rgb, sigma,
                      mode: str):
        comp = composite(rgb, sigma, marched.dt, marched.t, marched.valid,
                         self.min_transmittance_render)
        if mode == "depth":
            return comp.depth[:, None].expand(-1, 3), comp.depth, comp.opacity
        if mode == "ao":
            return comp.opacity[:, None].expand(-1, 3), comp.depth, comp.opacity
        out_rgb = comp.rgb + comp.transmittance[:, None] * self._miss_background(dirs)
        return out_rgb, comp.depth, comp.opacity

    def _render_chunk(self, model: NerfNetwork, bitfield, origins, dirs,
                      mode: str = "shade"):
        """One chunk of rays → (rgb, depth, opacity)."""
        tmin, tmax = ray_aabb_range(origins, dirs, self.aabb.min, self.aabb.max)
        n0 = self.stepping.to_steps(tmin + 1e-4)
        marched = march_rays(
            origins, dirs, bitfield, self.aabb.min, self.aabb.max,
            self.stepping, n0, self.n_lattice, self.n_render_samples,
            self.grid_cfg.max_mip,
        )
        marched = marched._replace(valid=marched.valid & (marched.t <= tmax[:, None]))
        rgb, sigma, marched = self._eval_marched(
            model, origins, dirs, marched, self.render_compaction_frac
        )
        return self._finish_shade(dirs, marched, rgb, sigma, mode)

    @torch.no_grad()
    def render_rays(self, state: RenderState, grid: occ.OccupancyGridState,
                    origins: torch.Tensor, dirs: torch.Tensor,
                    chunk: int | None = None, mode: str = "shade"):
        """Render rays (N, 3) + unit directions (N, 3) in chunks of
        ``chunk`` rays (default ``ray_chunk``); returns (rgb (N, 3), depth (N,),
        opacity (N,)). ``mode``: ``shade``, ``depth`` or ``ao``."""
        if mode not in ("shade", "depth", "ao"):
            raise ValueError(f"render mode {mode!r} is not yet ported "
                             "(shade | depth | ao)")
        chunk = chunk or self.ray_chunk
        model = self.inference_params(state)
        origins = origins.to(self.device, torch.float32)
        dirs = dirs.to(self.device, torch.float32)
        self.last_render_samples = 0
        outs = [
            self._render_chunk(model, grid.bitfield, origins[s:s + chunk],
                               dirs[s:s + chunk], mode)
            for s in range(0, origins.shape[0], chunk)
        ]
        return tuple(torch.cat([o[i] for o in outs], 0) for i in range(3))

    def view_rays(self, image_index: int, stride: int = 1):
        """Origins and unit directions (H'·W', 3) through the pixel centers
        of dataset view ``image_index``, every ``stride``-th pixel, row by
        row; returns (origins, dirs, (H', W'))."""
        W, H = self.resolution
        xs = np.arange(0, W, stride)
        ys = np.arange(0, H, stride)
        px, py = np.meshgrid(xs, ys)
        uv = torch.as_tensor(
            np.stack([(px + 0.5) / W, (py + 0.5) / H], axis=-1).reshape(-1, 2),
            dtype=torch.float32, device=self.device,
        )
        n = uv.shape[0]
        focal = self.focals[image_index].expand(n, 2)
        pp = self.pps[image_index].expand(n, 2)
        dir_cam = pixel_dirs_cam(self.lens, self.resolution, uv, focal, pp)
        xf = self.xforms[image_index]
        d = dir_cam @ xf[:, :3].T
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        return xf[:, 3].expand(n, 3), d, (len(ys), len(xs))

    def render_image(self, state: RenderState, grid: occ.OccupancyGridState,
                     image_index: int, stride: int = 1, mode: str = "shade"):
        """Render the dataset view ``image_index``, every ``stride``-th
        pixel; returns (H', W', 3) on the engine's device."""
        o, d, hw = self.view_rays(image_index, stride)
        rgb, _, _ = self.render_rays(state, grid, o, d, mode=mode)
        return rgb.reshape(*hw, 3)

"""NeRF train and render engine, the port of ``ngp_tpu/engines/nerf.py``
(training step and loop, occupancy maintenance, error-map importance
sampling, rendering).

A training step: ray batch (pinhole cameras, error-map CDFs) → gated
exponential-lattice march over the cascaded occupancy bitfield
(``ops/marching.py``) → k-major sample compaction to the step's sample
budget (``ops/compaction.py``) → ``NerfNetwork`` (hash-grid CUDA kernel,
density MLP, SH, rgb MLP) → composite and loss (``ops/composite.py``) →
backward, whose grid half runs the backward-addends and segment-sum CUDA
kernels → sparse Adam on the tables, Adam + L2 on the MLPs, EMA
(``optim.py``). The loop interleaves occupancy updates on the reference's
cadence (all cells while warming up, then stride residues) and adapts the
(rays × samples) batch geometry from the measured samples per ray.

Rendering a view: camera rays → march → compaction → network →
front-to-back compositing. One deliberate difference from the JAX
package: samples that the render compaction budget drops are removed from
``valid`` before compositing. The JAX package masks only a local copy
(fault C1 in ROADMAP.md), so there a dropped sample composites with raw
output 0, i.e. density exp(0) = 1.

Held-out evaluation: ``render_view`` renders any camera (its own lens,
``spp`` jittered passes averaged in linear radiance, every
``pixel_stride``-th pixel, thin-lens depth of field) and
``eval_test_transforms`` scores a test dataset's views as the reference's
``--test_transforms`` protocol does (sRGB-clipped PSNR and SSIM, FLIP on
request).

Not yet ported, and refused when asked for: camera, exposure, focal and
distortion refinement, trainable envmap, depth supervision, latent codes
in training, supplied per-pixel rays, a dataset's envmap background,
rolling shutter, the render crop box (``render_aabb``), the decoupled
occupancy schedule and probe-sampled grid updates.
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
from ngp_tpu_torch.geometry.camera import Lens, pixel_dirs_cam, square2disk_shirley
from ngp_tpu_torch.interop import load_jax_params
from ngp_tpu_torch.models.factory import create_nerf_network
from ngp_tpu_torch.models.nerf_network import NerfNetwork
from ngp_tpu_torch.ops import occupancy as occ
from ngp_tpu_torch.ops.compaction import (
    CompactionPlan,
    compact_rows,
    compaction_plan,
    expand_rows,
)
from ngp_tpu_torch.ops.composite import (
    composite,
    density_activation,
    nerf_training_loss,
    rgb_activation,
)
from ngp_tpu_torch.ops.losses import get_loss
from ngp_tpu_torch.ops.marching import (
    MarchedRays,
    SteppingSpace,
    march_rays,
    ray_aabb_range,
    warp_direction,
)
from ngp_tpu_torch.ops.tonemap import linear_to_srgb, srgb_to_linear
from ngp_tpu_torch.optim import (
    OptimizerConfig,
    adam_skip_zero_step,
    adam_step,
    ema_update,
    param_groups,
)
from ngp_tpu_torch.train import TrainState
from ngp_tpu_torch.utils import metrics

# Network rows per call: bounds the MLP's (rows, 64) float32 activations.
NETWORK_CHUNK = 1 << 20
# Lattice points per march call: bounds the march's O(rays × lattice)
# temporaries to a few GB.
MARCH_POINTS = 1 << 24
# Positions per density query of an occupancy update.
DENSITY_CHUNK = 1 << 19

ERROR_MAP_RES = 16  # testbed.h:674
MIN_PDF = 0.01


class RayBatch(NamedTuple):
    origins: torch.Tensor  # (N, 3)
    dirs: torch.Tensor  # (N, 3) unit
    target_rgba: torch.Tensor  # (N, 4) sRGB + straight alpha in [0, 1]
    n0: torch.Tensor  # (N,) jittered stepping-space march start
    img: torch.Tensor  # (N,) source image index
    uv: torch.Tensor  # (N, 2) pixel uv


class ErrorMapState(NamedTuple):
    """Per-image training-error maps that drive importance sampling: loss
    deposits accumulate into ``data``; the CDFs are rebuilt on a growing
    schedule and mixed with uniform mass. ``use_cdf`` (a host bool) is
    False until the first rebuild."""

    data: torch.Tensor  # (I, R, R) accumulated loss
    cdf_x: torch.Tensor  # (I, R, R) conditional CDF over x given y
    cdf_y: torch.Tensor  # (I, R)
    cdf_img: torch.Tensor  # (I,)
    use_cdf: bool


def build_cdfs(data: torch.Tensor):
    """(I, R, R) error map → MIN_PDF-mixed CDFs over x given y, over y, and
    over images (image-level mixing 0.1)."""
    I, R, _ = data.shape
    row = torch.cumsum(data + 1e-10, dim=2)
    row_sum = row[:, :, -1]
    frac = (torch.arange(R, dtype=torch.float32, device=data.device) + 1.0) / R
    cdf_x = (1.0 - MIN_PDF) * row / row_sum[..., None] + MIN_PDF * frac
    col = torch.cumsum(row_sum, dim=1)
    col_sum = col[:, -1]
    cdf_y = (1.0 - MIN_PDF) * col / col_sum[:, None] + MIN_PDF * frac
    img = torch.cumsum(col_sum, dim=0)
    ifrac = (torch.arange(I, dtype=torch.float32, device=data.device) + 1.0) / I
    cdf_img = (1.0 - 0.1) * img / img[-1] + 0.1 * ifrac
    return cdf_x, cdf_y, cdf_img


def sample_discrete(cdf_rows: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Per-row inverse-CDF bin: cdf_rows (N, B) ascending, u (N,) → (N,)
    int64 bin index."""
    return torch.clamp(torch.sum(u[:, None] >= cdf_rows, dim=1), 0,
                       cdf_rows.shape[1] - 1)


@dataclass
class NerfEngine:
    config: dict  # reference-format network config
    dataset: NerfDataset
    batch_size: int = 1 << 18  # sample slots per step (testbed.h:1005)
    min_samples_per_ray: int = 16
    max_samples_per_ray: int = 1024  # NERF_STEPS()
    min_rays_per_batch: int = 64
    adapt_every: int = 16  # batch-geometry re-selection cadence, in steps
    n_render_samples: int = 192  # K for rendering
    grid_size: int = occ.NERF_GRIDSIZE
    n_steps_per_unit: int = occ.NERF_STEPS
    density_grid_decay: float = 0.95  # testbed.h:741
    # The network runs on at most this fraction of the step's sample slots
    # (batch_size), the first valid ones in k-major order.
    compaction_budget_frac: float = 0.625
    # The network runs on at most this fraction of the N·K render slots,
    # first in k-major order (1.0 keeps every valid slot).
    render_compaction_frac: float = 0.625
    seed: int = 1337
    near_distance: float = 0.1  # testbed.h:740
    min_transmittance_render: float = 0.01
    background_color: tuple = (0.0, 0.0, 0.0)
    # Options of the JAX engine that are not yet ported: setting any of
    # them raises.
    optimize_extrinsics: bool = False
    optimize_exposure: bool = False
    optimize_focal_length: bool = False
    optimize_distortion: bool = False
    train_envmap: bool = False
    depth_supervision_lambda: float = 0.0
    device: str = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.config = copy.deepcopy(self.config)
        for name in ("optimize_extrinsics", "optimize_exposure",
                     "optimize_focal_length", "optimize_distortion",
                     "train_envmap", "depth_supervision_lambda"):
            if getattr(self, name):
                raise ValueError(f"{name} is not yet ported")
        ds = self.dataset
        if ds.rays is not None:
            raise ValueError("datasets with supplied per-pixel rays are not yet ported")
        if ds.envmap is not None:
            raise ValueError("a dataset's envmap background is not yet ported")
        if ds.render_aabb is not None:
            raise ValueError("the render crop box (render_aabb) is not yet ported")
        if ds.xforms.shape[1] > 1 and (any(abs(v) > 0 for v in ds.rolling_shutter)
                                       or bool(np.any(ds.xforms[:, 1] != ds.xforms[:, 0]))):
            raise ValueError("rolling shutter and motion blur (start and end "
                             "matrices) are not yet ported")
        aabb_scale = min(int(ds.aabb_scale), 1 << (occ.NERF_CASCADES - 1))
        if aabb_scale & (aabb_scale - 1):
            raise ValueError("aabb_scale must be a power of two")
        self.aabb_scale = aabb_scale
        max_cascade = 0
        while (1 << max_cascade) < aabb_scale:
            max_cascade += 1
        self.max_cascade = max_cascade
        self.grid_cfg = occ.OccupancyGridConfig(self.grid_size, max_cascade + 1,
                                                self.density_grid_decay)
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
        self.network = self._new_network()  # the architecture, zero parameters
        self.loss_fn = get_loss(self.config.get("loss", {}).get("otype", "Huber"))
        # render-only configs may carry no optimizer block: plain Adam then
        self.opt_cfg = OptimizerConfig.from_json(
            self.config.get("optimizer", {"otype": "Adam"}))
        f32 = dict(dtype=torch.float32, device=self.device)
        self.xforms = torch.as_tensor(np.asarray(ds.xforms[:, 0]), **f32)
        self.focals = torch.as_tensor(np.asarray(ds.focal_lengths), **f32)
        self.pps = torch.as_tensor(np.asarray(ds.principal_points), **f32)
        self.images = torch.as_tensor(np.asarray(ds.images), device=self.device)
        self.lens = ds.lens
        self.resolution = ds.resolution  # (W, H)
        self.last_render_samples = 0  # network rows of the last render_rays

        # Batch geometry n_rays × K with K a power of two, adapted from the
        # measured samples per ray (adapt_batch_geometry).
        self._k_max = self._pow2_clamp(
            self.max_samples_per_ray, self.min_samples_per_ray,
            self.batch_size // self.min_rays_per_batch)
        self._k = self._pow2_clamp(self.n_lattice, self.min_samples_per_ray,
                                   self._k_max)
        self._n_rays = max(self.batch_size // self._k, self.min_rays_per_batch)
        # stride-residue period of the regular occupancy refresh:
        # 2·n_cascades rounded up to a power of two (it must divide G³), ≥ 4
        self._grid_strides = 1 << (max(4, 2 * self.grid_cfg.n_cascades) - 1).bit_length()
        self._march_gate_eligible = (self.grid_size % 8 == 0 and self.grid_size >= 16
                                     and self.n_lattice % 8 == 0)
        self._seg_budget: int | None = None
        self._zero_sample_checks = 0
        self._pending_metrics = None
        self.use_importance_sampling = bool(ds.wants_importance_sampling)
        self._emap: ErrorMapState | None = None
        self._emap_interval = 128
        self._emap_next_rebuild = 128
        # every random draw of training comes from this generator
        self.generator = torch.Generator(self.device).manual_seed(self.seed ^ 0x5EED)

    @property
    def samples_per_step(self) -> int:
        """Network sample rows per training step: the compaction budget
        (the reference's batch size of compacted samples)."""
        if self.compaction_budget_frac < 1.0:
            b = -(-int(self.batch_size * self.compaction_budget_frac) // 1024) * 1024
            if 0 < b < self.batch_size:
                return b
        return self.batch_size

    @staticmethod
    def _pow2_clamp(x: float, lo: int, hi: int) -> int:
        b = max(int(math.ceil(max(x, 1)) - 1).bit_length(), 0)
        return int(min(max(1 << b, lo), hi))

    @property
    def batch_geometry(self) -> tuple[int, int]:
        """The current (K samples per ray, rays per step)."""
        return self._k, self._n_rays

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

    def init_state(self) -> TrainState:
        """Step 0: a model with parameters drawn from a CPU
        ``torch.Generator`` seeded with ``self.seed``, zero Adam moments."""
        net = self._new_network()
        net.reset_parameters(torch.Generator().manual_seed(self.seed))
        return TrainState.create(net)

    def init_grid(self) -> occ.OccupancyGridState:
        """Camera-frustum culling: cells no training camera sees are −1
        forever, visible cells start at 0 (upstream instant-ngp)."""
        density = occ.mark_untrained_cells(
            self.grid_cfg, self.xforms, self.focals, self.pps, self.resolution)
        return self.grid_from_density(density)

    def inference_params(self, state: TrainState) -> NerfNetwork:
        return state.inference_model()

    def grid_from_density(self, density: torch.Tensor) -> occ.OccupancyGridState:
        """Occupancy state of a ``(C, G, G, G)`` density grid: the mean over
        cascade 0 and the thresholded, max-pooled bitfield."""
        density = density.to(self.device, torch.float32)
        mean = torch.clamp_min(density[0], 0.0).mean()
        return occ.OccupancyGridState(
            density, occ.build_bitfield(density, mean), mean
        )

    def load_reference_snapshot(self, path: str):
        """Read a reference-format snapshot into ``(TrainState, grid)``
        with fresh optimizer state. The snapshot must describe this
        engine's architecture."""
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
        state = TrainState.create(net, int(snap.get("training_step", 0)))
        return state, self.grid_from_density(torch.from_numpy(density))

    # -- training: rays

    def init_error_map(self) -> ErrorMapState:
        data = torch.zeros((self.images.shape[0], ERROR_MAP_RES, ERROR_MAP_RES),
                           dtype=torch.float32, device=self.device)
        return ErrorMapState(data, *build_cdfs(data), False)

    def rebuild_error_map(self, emap: ErrorMapState) -> ErrorMapState:
        return ErrorMapState(emap.data, *build_cdfs(emap.data), True)

    def _sample_ray_batch(self, n: int, emap: ErrorMapState | None = None):
        """(RayBatch, background (n, 3)): ``n`` (image, pixel) pairs, from
        the error-map CDFs once they are built, else uniform; world rays
        through the pixel centers and their targets; the jittered march
        start; a uniform random training background per ray. Draws from
        ``self.generator``."""
        W, H = self.resolution
        gen, dev = self.generator, self.device
        I = self.images.shape[0]
        if emap is not None and emap.use_cdf:
            R = ERROR_MAP_RES
            u3 = torch.rand((n, 3), generator=gen, device=dev)
            img = sample_discrete(emap.cdf_img[None, :].expand(n, -1), u3[:, 0])
            by = sample_discrete(emap.cdf_y[img], u3[:, 1])
            bx = sample_discrete(emap.cdf_x[img, by], u3[:, 2])
            jit = torch.rand((n, 2), generator=gen, device=dev)
            uv = (torch.stack([bx, by], -1).to(torch.float32) + jit) / R
        else:
            img = torch.randint(0, I, (n,), generator=gen, device=dev)
            uv = torch.rand((n, 2), generator=gen, device=dev)
        wh = torch.tensor([W, H], dtype=torch.float32, device=dev)
        px = torch.floor(uv * wh).to(torch.int64)
        px = torch.minimum(torch.clamp_min(px, 0),
                           torch.tensor([W - 1, H - 1], device=dev))
        uv = (px.to(torch.float32) + 0.5) / wh  # snapped to pixel centers
        rgba = self.images[img, px[:, 1], px[:, 0]].to(torch.float32)
        if self.images.dtype == torch.uint8:
            rgba = rgba / 255.0
        dir_cam = pixel_dirs_cam(self.lens, self.resolution, uv,
                                 self.focals[img], self.pps[img])
        xf = self.xforms[img]
        d = torch.einsum("nij,nj->ni", xf[:, :, :3], dir_cam)
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        o = xf[:, :, 3]
        tmin, _ = ray_aabb_range(o, d, self.aabb.min, self.aabb.max)
        n0 = self.stepping.to_steps(tmin) + torch.rand((n,), generator=gen, device=dev)
        bg = torch.rand((n, 3), generator=gen, device=dev)
        return RayBatch(o, d, rgba, n0, img, uv), bg

    # -- training: the step

    def _network_on_samples(self, model: NerfNetwork, origins, dirs,
                            marched: MarchedRays, plan: CompactionPlan):
        """Raw network output (N, K, 4) at the marched slots: positions laid
        out k-major, compacted to the plan's rows, evaluated in chunks of
        ``NETWORK_CHUNK`` and expanded back (0 at slots not kept)."""
        N, K = marched.t.shape
        pos = origins[:, None, :] + dirs[:, None, :] * marched.t[..., None]
        pos_km = self.aabb.relative_pos(pos).transpose(0, 1).reshape(K * N, 3)
        pos_c = compact_rows(pos_km, plan)
        dir_c = warp_direction(dirs)[plan.cidx % N]  # k-major slot s is ray s % N
        outs = []
        for s in range(0, plan.n_live, NETWORK_CHUNK):
            e = min(s + NETWORK_CHUNK, plan.n_live)
            extra = None
            if self.n_extra_dims > 0:
                extra = torch.zeros((e - s, self.n_extra_dims), device=origins.device)
            outs.append(model(pos_c[s:e], dir_c[s:e], extra=extra))
        raw = torch.cat(outs) if outs else pos_c.new_zeros((0, 4))
        return expand_rows(raw, plan).reshape(K, N, 4).transpose(0, 1)

    def batch_loss_and_grads(self, model: NerfNetwork, grid: occ.OccupancyGridState,
                             batch: RayBatch, bg: torch.Tensor, k: int,
                             emap: ErrorMapState | None = None):
        """March ``batch`` with ``k`` samples per ray, run the network on
        the step's sample budget, and backpropagate the training loss into
        ``model``'s ``.grad`` (cleared first). ``bg`` (N, 3) is the training
        background. Returns (loss, metrics, emap with this batch's per-ray
        losses deposited, or None). Metrics: device tensors ``loss`` (color
        loss / 3), ``measured_samples`` (samples composited),
        ``mean_total``, ``seg_total``; host ints ``n_rays`` and
        ``network_samples``."""
        if self.n_extra_dims > 0:
            raise ValueError("training latent codes (extra learnable dims) is not yet ported")
        n_rays = batch.origins.shape[0]
        gate = occ.build_coarse_gate(grid.bitfield) if self._march_gate_eligible else None
        marched = march_rays(
            batch.origins, batch.dirs, grid.bitfield, self.aabb.min, self.aabb.max,
            self.stepping, batch.n0, self.n_lattice, k, self.grid_cfg.max_mip,
            gate=gate, seg_budget=self._seg_budget, max_points=MARCH_POINTS,
        )
        # The network budget derives from batch_size alone; the slot grid
        # n_rays × k may exceed it (adapt_batch_geometry fills it with rays).
        budget = min(self.samples_per_step, n_rays * k)
        plan = compaction_plan(marched.valid.t().reshape(-1), budget)
        valid_eff = marched.valid & plan.keep.reshape(k, n_rays).t()

        a = batch.target_rgba[:, 3:4]
        target = batch.target_rgba[:, :3] * a + (1.0 - a) * bg
        model.zero_grad(set_to_none=True)
        raw = self._network_on_samples(model, batch.origins, batch.dirs, marched, plan)
        out = nerf_training_loss(
            raw, marched.dt, marched.t, valid_eff, marched.complete, bg, target,
            self.loss_fn, self.rgb_act, self.density_act, grid.mean_density,
            depth_sample=marched.t, near_distance=self.near_distance,
        )
        if out.loss.requires_grad:  # False when no sample reached the network
            out.loss.backward()
        hit = (marched.total > 0).sum()
        metrics = {
            "loss": out.loss_display,
            "measured_samples": out.measured_samples,
            "mean_total": marched.total.sum() / torch.clamp_min(hit, 1),
            "seg_total": (marched.gate_total if marched.gate_total is not None
                          else torch.zeros((), dtype=torch.int32, device=self.device)),
            "n_rays": n_rays,
            "network_samples": plan.n_live,  # rows through the network (host int)
        }
        if emap is None:
            return out.loss.detach(), metrics, None
        # bilinear deposit of each ray's loss into its image's error map
        R = ERROR_MAP_RES
        p = torch.clamp(batch.uv * R - 0.5, 0.0, R - 1.0 - 1e-4)
        p0 = p.to(torch.int64)
        w = p - p0.to(torch.float32)
        data = emap.data.clone()
        for dy in (0, 1):
            for dx in (0, 1):
                wt = (w[:, 0] if dx else 1 - w[:, 0]) * (w[:, 1] if dy else 1 - w[:, 1])
                idx = (batch.img, torch.clamp_max(p0[:, 1] + dy, R - 1),
                       torch.clamp_max(p0[:, 0] + dx, R - 1))
                data.index_put_(idx, wt * out.per_ray_loss, accumulate=True)
        return out.loss.detach(), metrics, emap._replace(data=data)

    def apply_grads(self, state: TrainState) -> None:
        """One optimizer step from the ``.grad`` of ``state.model``: sparse
        Adam on the tables, Adam + L2 on the rest, then the EMA; in place."""
        cfg = self.opt_cfg
        if cfg.ema_decay is not None and state.ema is None:
            state.start_ema()
        groups = param_groups(state.model)
        for name in ("dense", "grid"):
            params = [p for _, p in groups[name]]
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params]
            opt = state.opt_state[name]
            lr = cfg.schedule(opt.count)
            if name == "grid":
                adam_skip_zero_step(params, grads, opt, lr, cfg.b1, cfg.b2, cfg.eps)
            else:
                adam_step(params, grads, opt, lr, cfg.b1, cfg.b2, cfg.eps, cfg.l2_reg)
        if state.ema is not None:
            ema_update(list(state.ema.parameters()), list(state.model.parameters()),
                       cfg.ema_decay, state.step)
        state.step += 1

    def train_step(self, state: TrainState, grid: occ.OccupancyGridState,
                   emap: ErrorMapState | None = None):
        """Sample a batch at the current geometry, take one step; returns
        (emap, metrics)."""
        k, n_rays = self._k, self._n_rays
        batch, bg = self._sample_ray_batch(n_rays, emap)
        _, metrics, emap = self.batch_loss_and_grads(state.model, grid, batch, bg, k, emap)
        self.apply_grads(state)
        return emap, metrics

    def adapt_batch_geometry(self, metrics) -> None:
        """Re-pick (K, n_rays) from a step's metrics: K the power of two
        near 2× the mean samples per ray (down only with a 25% margin),
        rays filling the sample budget (a power of four), and the gated
        march's segment budget from the gate totals. Raises after three
        consecutive checks with no sample (a degenerate scene)."""
        if float(metrics["measured_samples"]) == 0.0:
            self._zero_sample_checks += 1
            if self._zero_sample_checks >= 3:
                raise RuntimeError(
                    "Training generated 0 samples for 3 consecutive checks: the "
                    "scene geometry or occupancy grid is degenerate. Check "
                    "aabb_scale, the camera poses and the transforms' scale/offset.")
            return
        self._zero_sample_checks = 0
        mean_total = max(float(metrics["mean_total"]), 1.0)
        target = self._pow2_clamp(2.0 * mean_total, self.min_samples_per_ray, self._k_max)
        if target > self._k:
            self._k = target
        elif target < self._k:
            with_margin = self._pow2_clamp(2.5 * mean_total, self.min_samples_per_ray,
                                           self._k_max)
            if with_margin < self._k:
                self._k = with_margin
        want = self.samples_per_step / mean_total
        n_rays = 1 << (2 * int(round(math.log2(max(want, 1.0)) / 2.0)))
        self._n_rays = max(self.min_rays_per_batch,
                           min(n_rays, (2 * self.batch_size) // self._k))

        seg_total = float(metrics.get("seg_total", 0.0))
        n_rays_meas = int(metrics.get("n_rays", self._n_rays))
        if self._march_gate_eligible and seg_total > 0:
            per_ray = seg_total / max(n_rays_meas, 1)
            full = self._n_rays * (self.n_lattice // 8)
            want_b = per_ray * self._n_rays * 1.6 + 2048
            grow = 1 << (max(int(want_b), 1) - 1).bit_length()
            if grow >= full:
                self._seg_budget = None
            elif self._seg_budget is None or grow > self._seg_budget:
                self._seg_budget = grow
            else:
                shrink = 1 << (max(int(per_ray * self._n_rays * 2.4 + 2048), 1)
                               - 1).bit_length()
                if shrink < self._seg_budget:
                    self._seg_budget = shrink

    # -- training: occupancy

    @torch.no_grad()
    def chunked_density(self, model: NerfNetwork, pos_w: torch.Tensor,
                        chunk: int = DENSITY_CHUNK) -> torch.Tensor:
        """Raw density (channel 0 of the density MLP) at warped positions,
        ``chunk`` positions at a time."""
        return torch.cat([model.density(pos_w[s:s + chunk])[:, 0]
                          for s in range(0, pos_w.shape[0], chunk)])

    @torch.no_grad()
    def update_grid(self, state: TrainState, grid: occ.OccupancyGridState,
                    warmup: bool, jitter: torch.Tensor | None = None):
        """One occupancy update from the training model: every cell of every
        cascade while warming up, else the residue class ``ema_step mod
        strides``; densities at jittered cell positions, EMA-merged.
        ``jitter`` is the position draw (drawn from ``self.generator``
        when None)."""
        cfg = self.grid_cfg
        G, C = cfg.grid_size, cfg.n_cascades
        n = C * cfg.n_cells if warmup else C * cfg.n_cells // self._grid_strides
        if jitter is None:
            jitter = torch.rand((n, 3), generator=self.generator, device=self.device)
        phase = grid.ema_step % self._grid_strides
        pos = (occ.all_cells(cfg, jitter) if warmup
               else occ.stride_cells(cfg, jitter, phase, self._grid_strides))
        raw = self.chunked_density(state.model, self.aabb.relative_pos(pos))
        sigma = density_activation(self.density_act)(raw)
        splat = (sigma.reshape(C, G, G, G) if warmup
                 else occ.place_stride(cfg, sigma, phase, self._grid_strides))
        return occ.update_grid_state_dense(cfg, grid, splat)

    @torch.no_grad()
    def decay_grid(self, grid: occ.OccupancyGridState) -> occ.OccupancyGridState:
        """A decay-only update: the EMA with an empty splat."""
        return occ.update_grid_state_dense(
            self.grid_cfg, grid, torch.zeros_like(grid.density))

    # -- training: the loop

    def train(self, state: TrainState, grid: occ.OccupancyGridState, n_steps: int):
        """Run ``n_steps`` steps from ``state.step`` with occupancy updates
        on the reference's cadence (every clamp(step/16, 1, 16) steps, all
        cells before step 256), error-map rebuilds every 128 steps growing
        ×1.5, and a batch-geometry update every ``adapt_every`` steps from
        the previous window's metrics (so the check never waits for the
        device). Returns (state, grid, metrics of the last step)."""
        metrics = {}
        if self._emap is None:
            self._emap = self.init_error_map()
        step0 = state.step
        for step in range(step0, step0 + n_steps):
            interval = min(max(step // 16, 1), 16)
            if step % interval == 0:
                grid = self.update_grid(state, grid, warmup=step < 256)
            if self.use_importance_sampling and step >= self._emap_next_rebuild:
                self._emap = self.rebuild_error_map(self._emap)
                self._emap_interval = int(self._emap_interval * 1.5)
                self._emap_next_rebuild = step + self._emap_interval
            self._emap, metrics = self.train_step(state, grid, self._emap)
            if (step + 1) % self.adapt_every == 0:
                prev, self._pending_metrics = self._pending_metrics, metrics
                if prev is not None:
                    self.adapt_batch_geometry(prev)
        return state, grid, metrics

    def psnr(self, state: TrainState, grid: occ.OccupancyGridState,
             image_index: int, stride: int = 1) -> float:
        """PSNR of a rendered training view against its image composited
        over the render background, in the training color space."""
        pred = self.render_image(state, grid, image_index, stride).cpu().numpy()
        img = np.asarray(self.dataset.images[image_index])[::stride, ::stride]
        img = img.astype(np.float32)
        if self.dataset.images.dtype == np.uint8:
            img = img / 255.0
        a = img[..., 3:4]
        bg = np.asarray(self.background_color, np.float32)
        target = img[..., :3] * a + (1.0 - a) * bg
        mse = float(np.mean((pred - target) ** 2))
        return -10.0 * math.log10(max(mse, 1e-12))

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
        raw = self._network_on_samples(model, origins, dirs, marched, plan)
        self.last_render_samples += plan.n_live
        rgb = rgb_activation(self.rgb_act)(raw[..., :3])
        sigma = density_activation(self.density_act)(raw[..., 3])
        return rgb, sigma, marched

    def _miss_background(self, dirs: torch.Tensor) -> torch.Tensor:
        """Per-ray background color (no envmap in the port yet)."""
        bg = torch.as_tensor(self.background_color, dtype=torch.float32,
                             device=dirs.device)
        return bg.expand(dirs.shape[0], 3)

    def _finish_shade(self, dirs, marched: MarchedRays, rgb, sigma,
                      mode: str, min_transmittance: float | None = None):
        if min_transmittance is None:
            min_transmittance = self.min_transmittance_render
        comp = composite(rgb, sigma, marched.dt, marched.t, marched.valid,
                         min_transmittance)
        if mode == "depth":
            return comp.depth[:, None].expand(-1, 3), comp.depth, comp.opacity
        if mode == "ao":
            return comp.opacity[:, None].expand(-1, 3), comp.depth, comp.opacity
        out_rgb = comp.rgb + comp.transmittance[:, None] * self._miss_background(dirs)
        return out_rgb, comp.depth, comp.opacity

    def _render_chunk(self, model: NerfNetwork, bitfield, origins, dirs,
                      mode: str = "shade", min_transmittance: float | None = None):
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
        return self._finish_shade(dirs, marched, rgb, sigma, mode, min_transmittance)

    @torch.no_grad()
    def render_rays(self, state: TrainState, grid: occ.OccupancyGridState,
                    origins: torch.Tensor, dirs: torch.Tensor,
                    chunk: int | None = None, mode: str = "shade",
                    min_transmittance: float | None = None):
        """Render rays (N, 3) + unit directions (N, 3) in chunks of
        ``chunk`` rays (default ``ray_chunk``); returns (rgb (N, 3), depth (N,),
        opacity (N,)). ``mode``: ``shade``, ``depth`` or ``ao``.
        ``min_transmittance`` overrides ``min_transmittance_render`` for
        this call (the reference's eval uses 1e-4)."""
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
                               dirs[s:s + chunk], mode, min_transmittance)
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

    def render_image(self, state: TrainState, grid: occ.OccupancyGridState,
                     image_index: int, stride: int = 1, mode: str = "shade"):
        """Render the dataset view ``image_index``, every ``stride``-th
        pixel; returns (H', W', 3) on the engine's device."""
        o, d, hw = self.view_rays(image_index, stride)
        rgb, _, _ = self.render_rays(state, grid, o, d, mode=mode)
        return rgb.reshape(*hw, 3)

    # -- held-out evaluation

    def render_view(self, state: TrainState, grid: occ.OccupancyGridState,
                    xform, focal, pp=(0.5, 0.5), width: int | None = None,
                    height: int | None = None, spp: int = 1,
                    snap_to_pixel_centers: bool | None = None, seed: int = 0,
                    aperture_size: float = 0.0, focus_z: float = 1.0,
                    pixel_stride: int = 1, lens: Lens | None = None,
                    min_transmittance: float | None = None):
        """Render any camera: ``xform`` (3, 4) camera-to-world, ``focal``
        (fx, fy) in pixels at ``width`` × ``height`` (default the dataset's
        resolution), ``pp`` the principal point in [0, 1]², ``lens`` (default
        the dataset's). ``spp`` passes, each with one sub-pixel offset
        (pixel centers when ``snap_to_pixel_centers``, which defaults to
        ``spp <= 1``), are averaged in linear radiance; ``pixel_stride``
        renders every Nth pixel of the full raster at its true center, in
        register with ``image[::N, ::N]``. ``aperture_size`` > 0 samples a
        thin lens focused at ``focus_z``, one disk sample a ray and pass.
        Offsets and disk samples come from ``np.random.default_rng(seed)``,
        as in the JAX package. Returns (rgb (H', W', 3) in the training
        color space, depth (H', W'), opacity (H', W')) on the engine's
        device.

        Unlike the JAX package's ``render_view``, which undistorts only the
        OpenCV and fisheye lenses, every lens goes through
        ``pixel_dirs_cam`` here (ROADMAP C.ref 8)."""
        W = int(width if width is not None else self.resolution[0])
        H = int(height if height is not None else self.resolution[1])
        lens = self.lens if lens is None else lens
        f32 = dict(dtype=torch.float32, device=self.device)
        xform = torch.as_tensor(np.asarray(xform, np.float32), **f32)
        focal = torch.as_tensor(np.asarray(focal, np.float32).reshape(2), **f32)
        pp = torch.as_tensor(np.asarray(pp, np.float32).reshape(2), **f32)
        px, py = np.meshgrid(np.arange(0, W, pixel_stride), np.arange(0, H, pixel_stride))
        h_out, w_out = px.shape
        base = np.stack([px, py], axis=-1).reshape(-1, 2).astype(np.float32)
        n = base.shape[0]
        snap = (spp <= 1) if snap_to_pixel_centers is None else snap_to_pixel_centers
        linear = self.rgb_act == "Logistic"  # sRGB outputs average in linear
        rng = np.random.default_rng(seed)
        acc_rgb = acc_depth = acc_opacity = 0.0
        for _ in range(max(spp, 1)):
            off = (np.asarray([0.5, 0.5], np.float32) if snap or spp <= 1
                   else rng.random(2).astype(np.float32))
            uv = torch.as_tensor((base + off) / np.asarray([W, H], np.float32), **f32)
            dir_cam = pixel_dirs_cam(lens, (W, H), uv, focal.expand(n, 2), pp.expand(n, 2))
            d = dir_cam @ xform[:, :3].T
            o = xform[:, 3].expand(n, 3)
            if aperture_size > 0.0:
                au = torch.as_tensor(rng.random((n, 2)).astype(np.float32), **f32)
                blur = aperture_size * square2disk_shirley(au * 2.0 - 1.0)
                offset = blur[:, 0:1] * xform[:, 0] + blur[:, 1:2] * xform[:, 1]
                lookat = o + d * focus_z
                o = o + offset
                d = (lookat - o) / focus_z
            d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
            rgb, depth, opacity = self.render_rays(state, grid, o, d,
                                                   min_transmittance=min_transmittance)
            acc_rgb = acc_rgb + (srgb_to_linear(rgb) if linear else rgb)
            acc_depth = acc_depth + depth
            acc_opacity = acc_opacity + opacity
        k = float(max(spp, 1))
        rgb = acc_rgb / k
        if linear:
            rgb = linear_to_srgb(rgb)
        return (rgb.reshape(h_out, w_out, 3), (acc_depth / k).reshape(h_out, w_out),
                (acc_opacity / k).reshape(h_out, w_out))

    def eval_test_transforms(self, state: TrainState, grid: occ.OccupancyGridState,
                             test_dataset: NerfDataset, spp: int = 1, stride: int = 1,
                             max_views: int | None = None, compute_flip: bool = False,
                             save_first_to: str | None = None) -> dict:
        """Score a held-out dataset's views as the reference's
        ``--test_transforms`` protocol does (``scripts/run.py:208-266``):
        each view rendered by ``render_view`` with the test set's own
        intrinsics and lens, pixel-center rays (every ``stride``-th pixel),
        min transmittance 1e-4, over the engine's background; the image
        composited over black; both clipped to [0, 1] in sRGB; MSE, PSNR
        and SSIM per view, FLIP when ``compute_flip``. The test dataset
        must share the training set's scale and offset, as ``load_nerf``
        gives them for one scene's transform files. ``save_first_to``
        writes the first view's render as an 8-bit PNG.

        Returns {"n_views", "psnr" (mean), "min_psnr", "max_psnr", "ssim"
        (mean), "per_view": [{"view", "mse", "psnr", "ssim"[, "flip"]}]
        [, "flip" (mean)]}."""
        from ngp_tpu_torch.data.png import write_png

        n_views = test_dataset.images.shape[0]
        if max_views is not None:
            n_views = min(n_views, max_views)
        W, H = test_dataset.resolution
        per_view = []
        for i in range(n_views):
            rgb, _, _ = self.render_view(
                state, grid, test_dataset.xforms[i, 0], test_dataset.focal_lengths[i],
                test_dataset.principal_points[i], width=W, height=H, spp=spp,
                pixel_stride=stride, lens=test_dataset.lens, min_transmittance=1e-4)
            pred = np.clip(rgb.cpu().numpy(), 0.0, 1.0)
            img = test_dataset.images[i][::stride, ::stride].astype(np.float32)
            if test_dataset.images.dtype == np.uint8:
                img = img / 255.0
            ref = np.clip(img[..., :3] * img[..., 3:4], 0.0, 1.0)
            m = metrics.mse(pred, ref)
            entry = {"view": i, "mse": m, "psnr": metrics.psnr_from_mse(m),
                     "ssim": metrics.ssim(pred, ref)}
            if compute_flip:
                entry["flip"] = metrics.flip(ref, pred)
            per_view.append(entry)
            if i == 0 and save_first_to:
                write_png(save_first_to, (pred * 255).astype(np.uint8))
        psnrs = [e["psnr"] for e in per_view]
        res = {
            "n_views": len(per_view),
            "psnr": float(np.mean(psnrs)),
            "min_psnr": float(np.min(psnrs)),
            "max_psnr": float(np.max(psnrs)),
            "ssim": float(np.mean([e["ssim"] for e in per_view])),
            "per_view": per_view,
        }
        if compute_flip:
            res["flip"] = float(np.mean([e["flip"] for e in per_view]))
        return res

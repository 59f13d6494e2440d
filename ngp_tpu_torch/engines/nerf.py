"""NeRF train and render engine, the port of ``ngp_tpu/engines/nerf.py``
(training step and loop, occupancy maintenance, error-map importance
sampling, rendering).

A training step: ray batch (every lens, error-map CDFs; with rolling
shutter or motion blur each ray's pose lerped between the start and end
poses) → gated exponential-lattice march over the cascaded occupancy
bitfield (``ops/marching.py``) → k-major sample compaction to the step's
sample budget (``ops/compaction.py``) → ``NerfNetwork`` (hash-grid CUDA
kernel, density MLP, SH, rgb MLP) → composite and loss
(``ops/composite.py``) → backward, whose grid half is the fused grid
backward kernel → sparse Adam on the tables, Adam + L2 on the MLPs, EMA
(``optim.py``).

Camera refinement (``optimize_extrinsics``, ``optimize_exposure``,
``optimize_focal_length``, ``optimize_distortion``) trains the state's
camera group (``train.CameraParams``) with the model: the march runs on
the batch's rays, as in the JAX engine, and the network sees each ray
rebuilt from the refined focal length, distortion grid and pose
(``_adjusted_rays``), differentiable in its positions, so that the grid
backward gives d(positions) (the ``hashgrid_input_grad`` kernel) and
d(table) with float32 addends; exposure scales the target's linear
colour. The camera group takes its own decayed Adam with L2
(``optim.CameraOptimizerConfig``). One deliberate difference from the
JAX engine: under a rolling shutter the refined ray starts from the pose
the batch was marched with, where the JAX engine rebuilds it from the
start pose (ROADMAP C.ref 10). The loop interleaves occupancy updates on the reference's
cadence (all cells while warming up, then stride residues) and adapts the
(rays × samples) batch geometry from the measured samples per ray.

Rendering a view: camera rays → march → compaction → network →
front-to-back compositing. The render modes are the JAX package's
(``RENDER_MODES``): shade, depth and ao share that pass; the debug modes
normals (−∇σ/|∇σ|, through the grid's position gradient), positions,
encoding and cost evaluate every valid sample, as the JAX package runs
them uncompacted. One deliberate difference from the JAX
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

Products: native snapshots (``save_snapshot`` / ``load_snapshot``, the JAX
package's format, so each package loads the other's), reference ``.ingp``
snapshots (``save_reference_snapshot`` / ``load_reference_snapshot``) and
a marching-cubes mesh of the density field
(``compute_marching_cubes_mesh``). Training keeps loss and throughput
meters (``self.meters``), optionally logged as JSONL.

Not yet ported, and refused when asked for: trainable envmap, depth
supervision, latent codes in training, supplied per-pixel rays, a
dataset's envmap background, the render crop box (``render_aabb``),
overlays, the decoupled occupancy schedule, probe-sampled grid updates and
mesh vertex optimisation.
"""

from __future__ import annotations

import copy
import math
import time
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ngp_tpu_torch.data import ingp_snapshot
from ngp_tpu_torch.data.nerf_loader import NerfDataset
from ngp_tpu_torch.device import resolve_device
from ngp_tpu_torch.geometry.aabb import AABB
from ngp_tpu_torch.geometry.camera import (
    Lens,
    grid_at_lerp,
    pixel_dirs_cam,
    square2disk_shirley,
)
from ngp_tpu_torch.interop import (
    export_camera_params,
    export_jax_params,
    export_jax_train_state,
    load_jax_params,
    load_jax_train_state,
)
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
from ngp_tpu_torch.optim import CameraOptimizerConfig, OptimizerConfig, camera_schedule
from ngp_tpu_torch.train import CameraParams, TrainState, apply_grads, parameters_frozen
from ngp_tpu_torch.utils import metrics
from ngp_tpu_torch.utils.meters import MetricsLogger, TrainMeters

# Network rows per call: bounds the MLP's (rows, 64) float32 activations.
NETWORK_CHUNK = 1 << 20
# Lattice points per march call: bounds the march's O(rays × lattice)
# temporaries to a few GB.
MARCH_POINTS = 1 << 24
# Positions per density query of an occupancy update.
DENSITY_CHUNK = 1 << 19

ERROR_MAP_RES = 16  # testbed.h:674
# ERenderMode (common.h:110-122) as the JAX engine's render_rays takes them;
# the first three share the shade pass, the rest are debug modes
RENDER_MODES = ("shade", "depth", "ao", "normals", "positions", "encoding", "cost")
# march steps a ray of the cost mode reaches at full heat
COST_STEPS = 128.0
MIN_PDF = 0.01


class RayBatch(NamedTuple):
    origins: torch.Tensor  # (N, 3)
    dirs: torch.Tensor  # (N, 3) unit
    target_rgba: torch.Tensor  # (N, 4) sRGB + straight alpha in [0, 1]
    n0: torch.Tensor  # (N,) jittered stepping-space march start
    img: torch.Tensor  # (N,) source image index
    uv: torch.Tensor  # (N, 2) pixel uv
    # (N, 3, 4) each ray's camera pose (lerped to its shutter time under a
    # rolling shutter); None: the start pose of its image
    xforms: torch.Tensor | None = None


def _mat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Batched (..., 3, 3) rotations → (..., 4) unit quaternions (w, x, y,
    z), the JAX engine's branch-free Shepperd construction: all four
    candidate forms, each with a finite pivot, and the one of the largest
    pivot picked."""
    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    qw2 = torch.clamp_min(1.0 + m00 + m11 + m22, 0.0)
    qx2 = torch.clamp_min(1.0 + m00 - m11 - m22, 0.0)
    qy2 = torch.clamp_min(1.0 - m00 + m11 - m22, 0.0)
    qz2 = torch.clamp_min(1.0 - m00 - m11 + m22, 0.0)
    pick = torch.argmax(torch.stack([qw2, qx2, qy2, qz2], -1), dim=-1)
    s_w = 0.5 / torch.sqrt(torch.clamp_min(qw2, 1e-12))
    s_x = 0.5 / torch.sqrt(torch.clamp_min(qx2, 1e-12))
    s_y = 0.5 / torch.sqrt(torch.clamp_min(qy2, 1e-12))
    s_z = 0.5 / torch.sqrt(torch.clamp_min(qz2, 1e-12))
    q_w = torch.stack([0.25 / s_w, (m[..., 2, 1] - m[..., 1, 2]) * s_w,
                       (m[..., 0, 2] - m[..., 2, 0]) * s_w,
                       (m[..., 1, 0] - m[..., 0, 1]) * s_w], -1)
    q_x = torch.stack([(m[..., 2, 1] - m[..., 1, 2]) * s_x, 0.25 / s_x,
                       (m[..., 0, 1] + m[..., 1, 0]) * s_x,
                       (m[..., 0, 2] + m[..., 2, 0]) * s_x], -1)
    q_y = torch.stack([(m[..., 0, 2] - m[..., 2, 0]) * s_y,
                       (m[..., 0, 1] + m[..., 1, 0]) * s_y, 0.25 / s_y,
                       (m[..., 1, 2] + m[..., 2, 1]) * s_y], -1)
    q_z = torch.stack([(m[..., 1, 0] - m[..., 0, 1]) * s_z,
                       (m[..., 0, 2] + m[..., 2, 0]) * s_z,
                       (m[..., 1, 2] + m[..., 2, 1]) * s_z, 0.25 / s_z], -1)
    cands = torch.stack([q_w, q_x, q_y, q_z], -2)
    q = torch.gather(cands, -2, pick[..., None, None].expand(*pick.shape, 1, 4))[..., 0, :]
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def _quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def _lerp_xforms(xf_a: torch.Tensor, xf_b: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Per-ray poses (N, 3, 4) at shutter times ``t`` (N,) between ``xf_a``
    and ``xf_b`` (N, 3, 4): the translation lerped, the rotation slerped
    along the shorter arc, nlerp where the arc's sine is below 1e-4
    (``get_xform_given_rolling_shutter``, common_device.cuh:401-408)."""
    pos = xf_a[:, :, 3] + (xf_b[:, :, 3] - xf_a[:, :, 3]) * t[:, None]
    qa = _mat_to_quat(xf_a[:, :, :3])
    qb = _mat_to_quat(xf_b[:, :, :3])
    dot = torch.sum(qa * qb, dim=-1, keepdim=True)
    qb = torch.where(dot < 0, -qb, qb)
    dot = torch.abs(dot)
    theta = torch.arccos(torch.clamp(dot, -1.0, 1.0))
    sin_t = torch.sin(theta)
    small = sin_t < 1e-4
    safe_sin = torch.where(small, torch.ones_like(sin_t), sin_t)
    tt = t[:, None]
    wa = torch.where(small, 1.0 - tt, torch.sin((1.0 - tt) * theta) / safe_sin)
    wb = torch.where(small, tt, torch.sin(tt * theta) / safe_sin)
    q = wa * qa + wb * qb
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return torch.cat([_quat_to_mat(q), pos[:, :, None]], dim=-1)


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
    # Camera refinement (testbed.h:708-727): per-image pose and exposure
    # offsets, a log-scale focal multiplier and a lens-distortion grid of
    # camera-space direction offsets ((H, W), testbed.h:713), trained by the
    # camera group's own Adam at extrinsic_learning_rate with L2 toward zero.
    optimize_extrinsics: bool = False
    optimize_exposure: bool = False
    optimize_focal_length: bool = False
    optimize_distortion: bool = False
    distortion_resolution: tuple = (32, 32)
    extrinsic_learning_rate: float = 1e-3
    extrinsic_l2_reg: float = 1e-4
    # Accepted and ignored, as the JAX engine does: the camera group's L2 is
    # extrinsic_l2_reg on every leaf, exposure included.
    exposure_l2_reg: float = 0.0
    # Options of the JAX engine that are not yet ported: setting any of
    # them raises.
    train_envmap: bool = False
    depth_supervision_lambda: float = 0.0
    device: str = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.config = copy.deepcopy(self.config)
        for name in ("train_envmap", "depth_supervision_lambda"):
            if getattr(self, name):
                raise ValueError(f"{name} is not yet ported")
        ds = self.dataset
        if ds.rays is not None:
            raise ValueError("datasets with supplied per-pixel rays are not yet ported")
        if ds.envmap is not None:
            raise ValueError("a dataset's envmap background is not yet ported")
        if ds.render_aabb is not None:
            raise ValueError("the render crop box (render_aabb) is not yet ported")
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
        # the network sees rays rebuilt from refined intrinsics or poses
        self._refined_rays = (self.optimize_extrinsics or self.optimize_focal_length
                              or self.optimize_distortion)
        self.camera_opt = None  # the camera group's rule; None: frozen
        if self._refined_rays or self.optimize_exposure:
            self.camera_opt = CameraOptimizerConfig(
                float(self.extrinsic_l2_reg),
                camera_schedule(self.extrinsic_learning_rate, self.opt_cfg.schedule))
        f32 = dict(dtype=torch.float32, device=self.device)
        self.xforms = torch.as_tensor(np.asarray(ds.xforms[:, 0]), **f32)
        # Rolling shutter and motion blur: the end poses are kept only where
        # they move something (get_xform_given_rolling_shutter,
        # common_device.cuh:401); the shutter vector as float32 values.
        self.rolling_shutter = tuple(float(np.float32(v)) for v in ds.rolling_shutter)
        self.xforms_end = None
        if ds.xforms.shape[1] > 1 and (any(abs(v) > 0 for v in ds.rolling_shutter)
                                       or bool(np.any(ds.xforms[:, 1] != ds.xforms[:, 0]))):
            self.xforms_end = torch.as_tensor(np.asarray(ds.xforms[:, 1]), **f32)
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
        self._pending_window = None  # the adapt window read one window late
        self.meters: TrainMeters | None = None
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

    def _new_camera(self) -> CameraParams:
        """A zero camera group at the JAX engine's shapes."""
        return CameraParams(self.images.shape[0], tuple(self.distortion_resolution),
                            max(self.n_extra_dims, 1), self.device)

    # -- model and grid state

    def init_state(self) -> TrainState:
        """Step 0: a model with parameters drawn from a CPU
        ``torch.Generator`` seeded with ``self.seed``, a zero camera group,
        zero Adam moments."""
        net = self._new_network()
        net.reset_parameters(torch.Generator().manual_seed(self.seed))
        state = TrainState.create(net, camera=self._new_camera())
        state.camera_still = True  # zero, as its EMA will start
        return state

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
        state = TrainState.create(net, int(snap.get("training_step", 0)),
                                  camera=self._new_camera())
        return state, self.grid_from_density(torch.from_numpy(density))

    def save_reference_snapshot(self, path: str, state: TrainState,
                                grid: occ.OccupancyGridState, compress: bool = True) -> None:
        """Write a reference-format ``.ingp`` / ``.msgpack`` snapshot
        (``Testbed::save_snapshot``, ``src/testbed.cu:4873-4937``): the
        network config with a ``snapshot`` key holding the served
        parameters in tcnn's float16 layout and the float16 density grid in
        Morton order, as the JAX package writes it."""
        doc = dict(self.config)
        doc["snapshot"] = {
            "version": ingp_snapshot.SNAPSHOT_FORMAT_VERSION,
            "mode": "nerf",
            "training_step": int(state.step),
            "loss": 0.0,
            "density_grid_size": self.grid_size,
            "density_grid_binary": ingp_snapshot.density_grid_to_reference(
                grid.density.cpu().numpy()),
            "n_params": ingp_snapshot.reference_n_params(self.network),
            "params_type": "__half",
            "params_binary": ingp_snapshot.params_to_reference(
                export_jax_params(self.inference_params(state)), self.network),
            "nerf": {"aabb_scale": self.aabb_scale},
        }
        ingp_snapshot.save_ingp(path, doc, compress=compress)

    # -- native snapshots (the JAX package's format)

    def _jax_param_tree(self, model: NerfNetwork, camera: CameraParams) -> dict:
        """The JAX engine's parameter tree of ``model`` and ``camera`` (its
        ``latents`` zero): keys sorted, as the JAX package's tree maps leave
        them."""
        def ordered(tree):
            if isinstance(tree, dict):
                return {k: ordered(tree[k]) for k in sorted(tree)}
            if isinstance(tree, list):
                return [ordered(v) for v in tree]
            return tree

        group = {**export_camera_params(camera),
                 "latents": camera.latents.cpu().numpy().copy()}
        return ordered({"camera": group, "model": export_jax_params(model)})

    def _check_camera(self, params: dict) -> None:
        if "envmap" in params:
            raise ValueError("a trainable envmap is not yet ported (ROADMAP A5c)")
        latents = params.get("camera", {}).get("latents")
        if self.n_extra_dims > 0 and latents is not None and np.any(np.asarray(latents) != 0):
            # unused without extra dims, where the JAX engine draws them
            raise ValueError("training latent codes is not yet ported (ROADMAP A5c): "
                             "the snapshot's camera.latents is not zero")

    def save_snapshot(self, path: str, state: TrainState, grid: occ.OccupancyGridState,
                      include_optimizer: bool = False) -> None:
        """Write a native snapshot (``utils/snapshot.py``; zlib-compressed
        for ``.ingp``) with the JAX engine's keys and dtypes: training step
        (int32), parameters and EMA parameters as the JAX engine's trees
        (the ``camera`` group included), the density grid (float16)
        and its mean (float32), ``aabb_scale`` and the loss EMA. With
        ``include_optimizer`` also ``opt_state``, in the port's own layout
        (``interop.export_jax_train_state``'s ``"opt"`` tree)."""
        from ngp_tpu_torch.utils.snapshot import save_snapshot

        snap = {
            "training_step": np.asarray(state.step, np.int32),
            "params": self._jax_param_tree(state.model, state.camera),
            "ema_params": self._jax_param_tree(state.inference_model(),
                                               state.inference_camera()),
            "density_grid": grid.density.cpu().numpy().astype(np.float16),
            "density_grid_mean": np.asarray(grid.mean_density.cpu().numpy(), np.float32),
            "aabb_scale": self.aabb_scale,
            # restored on load, as the reference does (testbed.cu:5037-5038)
            "loss_ema": self.meters.loss_ema if self.meters is not None else 0.0,
        }
        if include_optimizer:
            snap["opt_state"] = export_jax_train_state(state)["opt"]
        save_snapshot(path, {"mode": "nerf", "network_config": self.config,
                             "snapshot": snap})

    def load_snapshot(self, path: str):
        """Read a native snapshot, the port's or the JAX package's, into
        ``(TrainState, grid)``. The density grid's bitfield is rebuilt from
        the stored (float16) densities and mean. Optimizer moments are
        restored where the snapshot holds them in the port's layout; else
        (none, or the JAX package's optax tree) they start at zero, as the
        JAX package's ``load_snapshot`` starts them. The camera group and
        its EMA come from the snapshot's ``camera`` trees; their latents
        stay zero (a snapshot whose latents are not zero while the network
        has extra dims is refused: training latents is not yet ported, nor
        is an envmap)."""
        from ngp_tpu_torch.utils.snapshot import load_snapshot

        snap = load_snapshot(path)["snapshot"]
        for tree in ("params", "ema_params"):
            self._check_camera(snap[tree])
        step = int(snap["training_step"])
        has_ema = self.opt_cfg.ema_decay is not None
        cam = snap["params"]["camera"]
        # the snapshot's shapes, as the JAX engine keeps them (a snapshot of
        # another view count loads; only refinement indexes the group)
        camera = CameraParams(np.shape(cam["pos"])[0], np.shape(cam["distortion"])[:2],
                              max(self.n_extra_dims, 1), self.device)
        tree = {"step": step, "params": snap["params"]["model"],
                "ema": snap["ema_params"]["model"] if has_ema else None,
                "camera": cam,
                "camera_ema": snap["ema_params"]["camera"] if has_ema else None}
        opt = snap.get("opt_state")
        # the port's layout; none, or the JAX package's optax tree: zero moments
        port_layout = isinstance(opt, dict) and set(opt) in ({"dense", "grid"},
                                                             {"dense", "grid", "camera"})
        tree["opt"] = opt if port_layout else {}
        state = load_jax_train_state(self._new_network(), tree, camera=camera)
        density = torch.as_tensor(snap["density_grid"].astype(np.float32), device=self.device)
        mean = torch.as_tensor(snap["density_grid_mean"], dtype=torch.float32,
                               device=self.device)
        grid = occ.OccupancyGridState(density, occ.build_bitfield(density, mean), mean)
        if "loss_ema" in snap:
            self.meters = TrainMeters()
            self.meters.loss_ema = float(snap["loss_ema"])
            self.meters.n_loss_updates = 1
        return state, grid

    # -- mesh export (compute_marching_cubes_mesh, python_api.cu:101-125)

    def compute_marching_cubes_mesh(self, state: TrainState, resolution: int = 256,
                                    density_thresh: float = 2.5, aabb=None):
        """An isosurface of the raw density output (the reference meshes
        raw network values, GUI threshold 2.5) on a ``resolution``³ lattice
        spanning ``aabb`` (default the scene box), the corners included.
        The density queries run through ``chunked_density`` on the
        engine's device; the marching cubes run on the host. Returns
        (verts (V, 3) float32 in scene space, faces (F, 3) int32)."""
        from ngp_tpu_torch.ops.marching_cubes import marching_cubes

        lo, hi = aabb if aabb is not None else (self.aabb.min, self.aabb.max)
        lo = np.asarray(lo.cpu() if isinstance(lo, torch.Tensor) else lo, np.float32)
        hi = np.asarray(hi.cpu() if isinstance(hi, torch.Tensor) else hi, np.float32)
        n = resolution
        axes = [np.linspace(lo[d], hi[d], n, dtype=np.float32) for d in range(3)]
        points = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
        pos_w = self.aabb.relative_pos(torch.as_tensor(points, device=self.device))
        raw = self.chunked_density(self.inference_params(state), pos_w).cpu().numpy()
        return marching_cubes(raw.reshape(n, n, n), density_thresh, origin=lo,
                              spacing=(hi - lo) / (n - 1))

    # -- training: rays

    def init_error_map(self) -> ErrorMapState:
        data = torch.zeros((self.images.shape[0], ERROR_MAP_RES, ERROR_MAP_RES),
                           dtype=torch.float32, device=self.device)
        return ErrorMapState(data, *build_cdfs(data), False)

    def rebuild_error_map(self, emap: ErrorMapState) -> ErrorMapState:
        return ErrorMapState(emap.data, *build_cdfs(emap.data), True)

    def _camera_rays(self, img: torch.Tensor, uv: torch.Tensor,
                     tblur: torch.Tensor | None = None):
        """World rays through ``uv`` (n, 2) of dataset views ``img`` (n,):
        (origins, unit dirs, poses (n, 3, 4)). Under a rolling shutter or
        motion blur each ray's pose is lerped from its view's start to its
        end pose at the shutter time rs0 + rs1·u + rs2·v + rs3·``tblur``
        (``tblur`` (n,) uniform in [0, 1); the JAX engine's
        ``_sample_ray_batch``)."""
        xf = self.xforms[img]
        if self.xforms_end is not None:
            rs = self.rolling_shutter
            t = rs[0] + rs[1] * uv[:, 0] + rs[2] * uv[:, 1] + rs[3] * tblur
            xf = _lerp_xforms(xf, self.xforms_end[img], t)
        dir_cam = pixel_dirs_cam(self.lens, self.resolution, uv, self.focals[img],
                                 self.pps[img])
        d = torch.einsum("nij,nj->ni", xf[:, :, :3], dir_cam)
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        return xf[:, :, 3], d, xf

    def _sample_ray_batch(self, n: int, emap: ErrorMapState | None = None):
        """(RayBatch, background (n, 3)): ``n`` (image, pixel) pairs, from
        the error-map CDFs once they are built, else uniform; world rays
        through the pixel centers (each at its own shutter time under a
        rolling shutter) and their targets; the jittered march start; a
        uniform random training background per ray. Draws from
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
        tblur = None
        if self.xforms_end is not None:
            tblur = torch.rand((n,), generator=gen, device=dev)
        o, d, xf = self._camera_rays(img, uv, tblur)
        tmin, _ = ray_aabb_range(o, d, self.aabb.min, self.aabb.max)
        n0 = self.stepping.to_steps(tmin) + torch.rand((n,), generator=gen, device=dev)
        bg = torch.rand((n, 3), generator=gen, device=dev)
        return RayBatch(o, d, rgba, n0, img, uv, xf), bg

    # -- training: the step

    @staticmethod
    def _rodrigues(rotvec: torch.Tensor) -> torch.Tensor:
        """Batched rotation vectors (..., 3) → rotation matrices (..., 3, 3)
        (the reference's RotationAdamOptimizer composition,
        ``adam_optimizer.h``): I + a·K + b·K², a = sin θ/θ, b = (1 − cos θ)/θ²,
        their Taylor forms below θ² = 1e-8; both branches finite, so that the
        gradient is finite at the zero rotation."""
        t2 = torch.sum(rotvec * rotvec, dim=-1, keepdim=True)  # θ²
        small = t2 < 1e-8
        t2s = torch.clamp_min(t2, 1e-8)
        theta = torch.sqrt(t2s)
        a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(theta) / theta)
        b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(theta)) / t2s)
        vx, vy, vz = rotvec[..., 0], rotvec[..., 1], rotvec[..., 2]
        zeros = torch.zeros_like(vx)
        K = torch.stack([torch.stack([zeros, -vz, vy], -1),
                         torch.stack([vz, zeros, -vx], -1),
                         torch.stack([-vy, vx, zeros], -1)], -2)
        eye = torch.eye(3, dtype=rotvec.dtype, device=rotvec.device).expand(K.shape)
        return eye + a[..., None] * K + b[..., None] * (K @ K)

    def _adjusted_rays(self, camera: CameraParams, batch: RayBatch):
        """The batch's rays rebuilt from the refined camera (differentiable
        in ``camera``): the focal length times exp(``focal``), the lens,
        ``distortion`` bilinear at uv added to the camera-space direction's
        xy (where refined), the pose rotated by Rodrigues(``rot``) and
        moved by ``pos``. The pose is the one the batch was marched with:
        the JAX engine's ``_adjusted_rays`` takes the start pose even under
        a rolling shutter (ROADMAP C.ref 10). Returns (origins, unit
        dirs)."""
        img, uv = batch.img, batch.uv
        focal = self.focals[img] * torch.exp(camera.focal)[None, :]
        dir_cam = pixel_dirs_cam(self.lens, self.resolution, uv, focal, self.pps[img])
        if self.optimize_distortion:
            # dir.xy += distortion.at_lerp(uv) (common_device.cuh:492)
            dir_cam = torch.cat([dir_cam[:, :2] + grid_at_lerp(camera.distortion, uv),
                                 dir_cam[:, 2:]], dim=-1)
        xf = batch.xforms if batch.xforms is not None else self.xforms[img]
        rot = self._rodrigues(camera.rot[img]) @ xf[:, :, :3]
        d = torch.einsum("nij,nj->ni", rot, dir_cam)
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        return xf[:, :, 3] + camera.pos[img], d

    def _network_on_samples(self, model: NerfNetwork, origins, dirs,
                            marched: MarchedRays, plan: CompactionPlan,
                            differentiable_inputs: bool = False):
        """Raw network output (N, K, 4) at the marched slots: positions laid
        out k-major, compacted to the plan's rows, evaluated in chunks of
        ``NETWORK_CHUNK`` and expanded back (0 at slots not kept).
        ``differentiable_inputs``: gradients reach ``origins`` and ``dirs``
        through the grid's position gradient and the direction encoding."""
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
            outs.append(model(pos_c[s:e], dir_c[s:e], extra=extra,
                              differentiable_inputs=differentiable_inputs))
        raw = torch.cat(outs) if outs else pos_c.new_zeros((0, 4))
        return expand_rows(raw, plan).reshape(K, N, 4).transpose(0, 1)

    def batch_loss_and_grads(self, model: NerfNetwork, grid: occ.OccupancyGridState,
                             batch: RayBatch, bg: torch.Tensor, k: int,
                             emap: ErrorMapState | None = None,
                             camera: CameraParams | None = None):
        """March ``batch`` with ``k`` samples per ray, run the network on
        the step's sample budget, and backpropagate the training loss into
        ``model``'s ``.grad`` (cleared first), and into ``camera``'s (the
        state's camera group, needed while refinement is on) through the
        refined rays and the exposure of the targets. ``bg`` (N, 3) is the
        training background. Returns (loss, metrics, emap with this batch's
        per-ray losses deposited, or None). Metrics: device tensors
        ``loss`` (color loss / 3), ``measured_samples`` (samples
        composited), ``mean_total``, ``seg_total``; host ints ``n_rays``
        and ``network_samples``."""
        if self.n_extra_dims > 0:
            raise ValueError("training latent codes (extra learnable dims) is not yet ported")
        if self.camera_opt is not None and camera is None:
            raise ValueError("camera refinement trains the state's camera group: pass camera=")
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

        model.zero_grad(set_to_none=True)
        o, d = batch.origins, batch.dirs
        rgb_t = batch.target_rgba[:, :3]
        if camera is not None:
            camera.zero_grad(set_to_none=True)
            if self._refined_rays:
                o, d = self._adjusted_rays(camera, batch)
            if self.optimize_exposure:
                # the target's linear colour times 2^exposure, re-encoded
                scale = torch.exp2(camera.exposure[batch.img])
                rgb_t = linear_to_srgb(srgb_to_linear(rgb_t) * scale)
        a = batch.target_rgba[:, 3:4]
        target = rgb_t * a + (1.0 - a) * bg
        raw = self._network_on_samples(model, o, d, marched, plan,
                                       differentiable_inputs=self._refined_rays)
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
        Adam on the tables, Adam + L2 on the rest, the camera group's rule
        while refinement is on (else it stays as it is), then the EMA; in
        place (``train.apply_grads``, the generic trainer's step)."""
        apply_grads(state, self.opt_cfg, self.camera_opt)

    def train_step(self, state: TrainState, grid: occ.OccupancyGridState,
                   emap: ErrorMapState | None = None):
        """Sample a batch at the current geometry, take one step; returns
        (emap, metrics)."""
        k, n_rays = self._k, self._n_rays
        batch, bg = self._sample_ray_batch(n_rays, emap)
        _, metrics, emap = self.batch_loss_and_grads(state.model, grid, batch, bg, k, emap,
                                                     camera=state.camera)
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

    def train(self, state: TrainState, grid: occ.OccupancyGridState, n_steps: int,
              log_every: int = 0, metrics_file: str | None = None):
        """Run ``n_steps`` steps from ``state.step`` with occupancy updates
        on the reference's cadence (every clamp(step/16, 1, 16) steps, all
        cells before step 256), error-map rebuilds every 128 steps growing
        ×1.5, and, every ``adapt_every`` steps, the previous window's
        metrics read on the host (so the read never waits for the device):
        they update ``self.meters``, a line of ``metrics_file`` (JSONL,
        appended; the last window is read at the end of the call when a file
        is given) and the batch geometry. ``log_every`` prints a step's
        loss every that many steps (a device sync each). Returns (state,
        grid, metrics of the last step)."""
        if self.meters is None:
            self.meters = TrainMeters()
        logger = MetricsLogger(metrics_file) if metrics_file else None
        try:
            state, grid, metrics = self._train_steps(state, grid, n_steps, log_every, logger)
            if logger is not None:
                prev, self._pending_window = self._pending_window, None
                if prev is not None:
                    self._process_window(prev, logger)
        finally:
            if logger is not None:
                logger.close()
        return state, grid, metrics

    def _train_steps(self, state: TrainState, grid: occ.OccupancyGridState, n_steps: int,
                     log_every: int, logger: MetricsLogger | None):
        win_t0, win_steps = time.monotonic(), 0
        metrics = {}
        if self._emap is None:
            self._emap = self.init_error_map()
        step0 = state.step
        if self.camera_opt is None and not state.camera_still:
            # a frozen group (a loaded one, say): its EMA update is skipped
            # once it and its EMA are found zero (one device sync)
            cams = [state.camera] + ([state.camera_ema] if state.camera_ema is not None else [])
            state.camera_still = not bool(
                torch.stack([p.any() for c in cams for p in c.parameters()]).any())
        for step in range(step0, step0 + n_steps):
            interval = min(max(step // 16, 1), 16)
            if step % interval == 0:
                grid = self.update_grid(state, grid, warmup=step < 256)
            if self.use_importance_sampling and step >= self._emap_next_rebuild:
                self._emap = self.rebuild_error_map(self._emap)
                self._emap_interval = int(self._emap_interval * 1.5)
                self._emap_next_rebuild = step + self._emap_interval
            self._emap, metrics = self.train_step(state, grid, self._emap)
            win_steps += 1
            if (step + 1) % self.adapt_every == 0:
                window = {"metrics": metrics, "steps": win_steps,
                          "rays": float(self._n_rays) * win_steps,
                          "wall": time.monotonic() - win_t0, "step": step + 1}
                prev, self._pending_window = self._pending_window, window
                if prev is not None:
                    self._process_window(prev, logger)
                win_t0, win_steps = time.monotonic(), 0
            if log_every and step % log_every == 0:
                print(f"step {step}: loss={float(metrics['loss']):.5f} "
                      f"samples={int(metrics['measured_samples'])} k={self._k} "
                      f"({self.meters.samples_per_s.value / 1e6:.2f} Msamples/s)")
        return state, grid, metrics

    def _process_window(self, win: dict, logger: MetricsLogger | None) -> None:
        """One adapt window's metrics on the host (one copy): the meters,
        the log line, the batch geometry."""
        m = dict(win["metrics"])
        keys = [k for k, v in m.items() if isinstance(v, torch.Tensor)]
        if keys:
            host = torch.stack([m[k].to(torch.float64) for k in keys]).tolist()
            m.update(zip(keys, host))
        loss_ema = self.meters.update_loss(float(m["loss"]))
        self.meters.update_window(win["steps"], float(m["measured_samples"]) * win["steps"],
                                  win["rays"], win["wall"])
        if logger is not None:
            logger.log(win["step"], loss=float(m["loss"]), loss_ema=loss_ema,
                       samples_per_s=self.meters.samples_per_s.value,
                       rays_per_s=self.meters.rays_per_s.value,
                       step_ms=self.meters.step_ms.value, k=self._k)
        self.adapt_batch_geometry(m)

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
        if mode in ("shade", "depth", "ao"):
            rgb, sigma, marched = self._eval_marched(
                model, origins, dirs, marched, self.render_compaction_frac
            )
            return self._finish_shade(dirs, marched, rgb, sigma, mode, min_transmittance)
        # The debug modes evaluate every valid sample (the JAX package runs
        # them uncompacted, so no budget drops one).
        rgb, sigma, marched = self._eval_marched(model, origins, dirs, marched, 1.0)
        if mode == "cost":
            _, depth, opacity = self._finish_shade(dirs, marched, rgb, sigma, "depth",
                                                   min_transmittance)
            heat = marched.n_samples.to(torch.float32) / COST_STEPS
            return heat[:, None].expand(-1, 3), depth, opacity
        pos = origins[:, None, :] + dirs[:, None, :] * marched.t[..., None]
        pos_w = self.aabb.relative_pos(pos)
        valid = marched.valid
        if mode == "positions":
            colors = pos_w[valid]
        elif mode == "encoding":
            colors = torch.cat([torch.sigmoid(model.pos_encoding(p)[:, :3] * 20.0)
                                for p in pos_w[valid].split(NETWORK_CHUNK)])
        else:
            colors = (self._density_normals(model, pos_w[valid]) + 1.0) * 0.5
        rgb = torch.zeros_like(pos_w)
        rgb[valid] = colors
        return self._finish_shade(dirs, marched, rgb, sigma, "shade", min_transmittance)

    def _density_normals(self, model: NerfNetwork, pos_w: torch.Tensor) -> torch.Tensor:
        """−∇σ/|∇σ| (n, 3) at warped positions ``pos_w`` (n, 3), σ the
        activated density, its gradient through the grid's position
        gradient (float32 table reads, the JAX package's
        ``differentiable_inputs`` path), ``NETWORK_CHUNK`` rows at a time.
        The model's parameters are frozen meanwhile, so the backward
        computes no table gradient."""
        act = density_activation(self.density_act)
        grads = []
        with torch.enable_grad(), parameters_frozen(model):
            for p in pos_w.split(NETWORK_CHUNK):
                p = p.detach().requires_grad_(True)
                sigma = act(model.density(p, differentiable_inputs=True)[:, 0])
                grads.append(torch.autograd.grad(sigma.sum(), p)[0])
        g = torch.cat(grads)
        return -g / torch.clamp_min(torch.linalg.norm(g, dim=-1, keepdim=True), 1e-9)

    @torch.no_grad()
    def render_rays(self, state: TrainState, grid: occ.OccupancyGridState,
                    origins: torch.Tensor, dirs: torch.Tensor,
                    chunk: int | None = None, mode: str = "shade",
                    min_transmittance: float | None = None):
        """Render rays (N, 3) + unit directions (N, 3) in chunks of
        ``chunk`` rays (default ``ray_chunk``); returns (rgb (N, 3), depth (N,),
        opacity (N,)). ``mode``: one of ``RENDER_MODES`` (the JAX
        package's ``_render_chunk``): ``shade``; ``depth`` and ``ao`` (the
        composited depth or opacity as grey); ``normals`` (−∇σ/|∇σ| mapped
        to [0, 1]), ``positions`` (warped sample positions) and
        ``encoding`` (sigmoid of 20× the first three grid features), each
        composited like color over the background; ``cost`` (march steps
        / 128 as grey). ``min_transmittance`` overrides
        ``min_transmittance_render`` for this call (the reference's eval
        uses 1e-4)."""
        if mode not in RENDER_MODES:
            raise ValueError(f"unknown render mode {mode!r} ({' | '.join(RENDER_MODES)})")
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

    def view_rays(self, image_index: int, stride: int = 1,
                  distortion: torch.Tensor | None = None):
        """Origins and unit directions (H'·W', 3) through the pixel centers
        of dataset view ``image_index``, every ``stride``-th pixel, row by
        row, with the (H, W, 2) lens-distortion grid ``distortion`` added
        to the camera-space directions' xy where given; returns (origins,
        dirs, (H', W'))."""
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
        if distortion is not None:
            dir_cam = torch.cat([dir_cam[:, :2] + grid_at_lerp(distortion, uv),
                                 dir_cam[:, 2:]], dim=-1)
        xf = self.xforms[image_index]
        d = dir_cam @ xf[:, :3].T
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        return xf[:, 3].expand(n, 3), d, (len(ys), len(xs))

    def render_image(self, state: TrainState, grid: occ.OccupancyGridState,
                     image_index: int, stride: int = 1, mode: str = "shade",
                     overlay: str | None = None):
        """Render the dataset view ``image_index``, every ``stride``-th
        pixel, in render ``mode``; returns (H', W', 3) on the engine's
        device. While distortion is refined the view goes through the
        served (EMA) distortion grid, as the reference renders with its
        lens distortion by default (testbed_nerf.cu:2776-2779); learned
        poses, exposures and focal lengths reach no render, as in the JAX
        engine. Overlays are not yet ported."""
        if overlay is not None:
            raise NotImplementedError(f"overlay {overlay!r} is not yet ported (ROADMAP A6)")
        distortion = None
        if self.optimize_distortion:
            distortion = state.inference_camera().distortion.detach()
        o, d, hw = self.view_rays(image_index, stride, distortion)
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


def losses_on_one_batch(runs) -> list[float]:
    """The training loss of each trained ``(engine, state, grid)`` of
    ``runs`` on one batch, drawn by the first engine at its batch geometry;
    the gradients it leaves are cleared. Two runs whose engines draw from
    streams of their own take their last steps on different rays, so their
    last-step losses are not a comparison of the two models; these are."""
    eng = runs[0][0]
    k, n_rays = eng.batch_geometry
    batch, bg = eng._sample_ray_batch(n_rays)
    losses = []
    for engine, state, grid in runs:
        loss = engine.batch_loss_and_grads(state.model, grid, batch, bg, k,
                                           camera=state.camera)[0]
        losses.append(float(loss))
        state.model.zero_grad(set_to_none=True)
        state.camera.zero_grad(set_to_none=True)
    return losses

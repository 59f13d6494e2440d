"""Signed distance fields, the port of ``ngp_tpu/engines/sdf.py`` (the
reference's ``src/testbed_sdf.cu``).

A hash-encoded MLP regresses position → signed distance, supervised by
exact signed distances from the triangle BVH (``geometry/triangle_bvh.py``;
its traversal kernels on the card). A training batch follows
``generate_training_samples_sdf`` (``testbed_sdf.cu:1187-1275``): 4/8
points on the surface (distance 0), 3/8 surface points moved along
logistic offsets, 1/8 uniform in the mesh's box, their distances from the
BVH (the watertight sign by default). A step is
``train.Trainer.training_step``. The score is the sign-agreement IoU
(``calculate_iou``, ``testbed_sdf.cu:1329-1364``). Frames are sphere traced
(``SphereTracer::trace``, ``testbed_sdf.cu:707-799``) and shaded in the
reference's modes; normals are the model's position gradient (the grid's
``hashgrid_input_grad`` on the card) or finite differences of the BVH's
distances.

Random draws come from ``torch.Generator``s on the engine's device seeded
from (seed, step), so they are not the JAX package's draws: each draw sits
behind a function that takes its uniforms or permutation as arguments
(``generate_training_samples(uniforms=...)``, ``training_batch``,
``step_permutation``), which a comparison with the JAX package can feed.

With ``use_octree`` (forced on by a Takikawa encoding) the engine builds
the triangle octree of the mesh (``geometry/triangle_octree.py``, depth
``octree_depth``, or the encoding's ``n_levels`` where that is 0, as the
JAX engine takes it): the uniform share of a batch is drawn in random
finest-depth voxels, the IoU counts the model right outside them, and the
tracers step at least the octree's empty-space skip distance. The BVH and
the octree are built on the host by the C++ builders of
``hostsrc/ngp_host.cpp``, their seconds in ``bvh_build_s`` and
``octree_build_s``.
"""

from __future__ import annotations

import copy
import math
import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ngp_tpu_torch.device import resolve_device
from ngp_tpu_torch.geometry.camera import lookat_rays
from ngp_tpu_torch.geometry.mesh import Mesh, load_mesh
from ngp_tpu_torch.geometry.triangle_bvh import (
    build_bvh,
    signed_distance_raystab,
    signed_distance_watertight,
    signed_distance_winding,
)
from ngp_tpu_torch.geometry.triangle_octree import TriangleOctree
from ngp_tpu_torch.models.encodings import GridEncoding
from ngp_tpu_torch.models.takikawa import TakikawaEncoding
from ngp_tpu_torch.models.factory import (
    NetworkWithInputEncoding,
    create_loss,
    create_network_with_input_encoding,
)
from ngp_tpu_torch.ops.image_sampler import step_seed
from ngp_tpu_torch.ops.marching import ray_aabb_range
from ngp_tpu_torch.ops.shading import (
    BRDFParams,
    evaluate_shading,
    soft_shadow_visibility_update,
)
from ngp_tpu_torch.train import Trainer, TrainState, parameters_frozen
from ngp_tpu_torch.utils.meters import TrainMeters

MARCH_ITER = 256  # the JAX package's lockstep bound (the reference: 10000)
# sphere-trace iterations between the host's reads of which rays are alive
# (it then gathers the alive rays, and evaluates only those until the next)
TRACE_CHECK_EVERY = 16
CHUNK = 1 << 18  # positions a network call evaluates at once
SIGN_MODES = ("watertight", "raystab", "winding")
RENDER_MODES = ("headlight", "shade", "ao", "normals", "positions", "cost")
_DATA_STREAM = 0xD15  # the JAX engine's training key, PRNGKey(seed ^ 0xD15)
_IOU_SEED = 99  # the JAX engine's calculate_iou key, PRNGKey(99)


@dataclass
class SdfEngine:
    """``SdfEngine(config, mesh, batch_size=2^18, ..., sign_mode=
    "watertight", seed=1337, device="cuda")``: ``mesh`` a normalized
    ``geometry/mesh.Mesh``. Fields as the JAX engine's; shading defaults
    follow ``testbed.h:602,798``."""

    config: dict
    mesh: Mesh
    batch_size: int = 1 << 18
    zero_offset: float = 0.0  # testbed.h:830
    distance_scale: float = 0.95  # testbed.h:831
    surface_offset_scale: float = 1.0  # testbed.h:843
    maximum_distance: float = 1e-4
    data_refresh_interval: int = 16
    sun_dir: tuple = (0.57735, 0.57735, 0.57735)
    up_dir: tuple = (0.0, 1.0, 0.0)
    shadow_sharpness: float = 2048.0
    brdf: BRDFParams | None = None
    use_octree: bool = False
    octree_depth: int = 0
    sign_mode: str = "watertight"
    seed: int = 1337
    device: str = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.config = copy.deepcopy(self.config)
        if self.sign_mode not in SIGN_MODES:
            raise ValueError(f"unknown sign_mode {self.sign_mode!r} ({' | '.join(SIGN_MODES)})")
        dev = self.device
        enc_cfg = self.config.get("encoding", {})
        self.octree: TriangleOctree | None = None
        self.octree_build_s = 0.0
        if self.use_octree or enc_cfg.get("otype", "").lower() == "takikawa":
            depth = self.octree_depth or int(enc_cfg.get("n_levels", 8))
            t0 = time.perf_counter()
            self.octree = TriangleOctree.build(self.mesh.triangles, depth, device=dev)
            self.octree_build_s = time.perf_counter() - t0
            self.use_octree = True
        self.trainer = Trainer(create_loss(self.config.get("loss", {"otype": "MAPE"})),
                               self.config["optimizer"])
        t0 = time.perf_counter()
        self.bvh = build_bvh(self.mesh.triangles, dev)
        self.bvh_build_s = time.perf_counter() - t0
        self.triangles = torch.as_tensor(self.mesh.triangles, device=dev)
        self.cdf = torch.as_tensor(self.mesh.area_cdf(), device=dev)
        self.aabb_min = torch.as_tensor(self.mesh.aabb_min, device=dev)
        self.aabb_max = torch.as_tensor(self.mesh.aabb_max, device=dev)
        self.bounding_radius = math.sqrt(3.0) / 2.0
        if self.brdf is None:
            self.brdf = BRDFParams()
        # pyngp override_sdf_training_data (python_api.cu:69-99): when set,
        # training takes these (points, distances) instead of the BVH's
        self.override_training_data: tuple | None = None
        self.meters = TrainMeters()

    @classmethod
    def from_file(cls, config: dict, path: str, **kw) -> "SdfEngine":
        return cls(config, load_mesh(path), **kw)

    def _new_network(self) -> NetworkWithInputEncoding:
        return create_network_with_input_encoding(3, 1, self.config, self.device,
                                                  self.octree)

    def init_state(self) -> TrainState:
        """Step 0: a model with parameters drawn from a CPU
        ``torch.Generator`` seeded with ``self.seed``, zero Adam moments."""
        net = self._new_network()
        net.reset_parameters(torch.Generator().manual_seed(self.seed))
        return TrainState.create(net)

    # -- ground truth

    def signed_distance(self, points: torch.Tensor) -> torch.Tensor:
        """The BVH's signed distance of ``points`` (P, 3) in ``sign_mode``."""
        if self.sign_mode == "raystab":
            return signed_distance_raystab(self.bvh, points)
        if self.sign_mode == "winding":
            return signed_distance_winding(self.bvh, points)
        return signed_distance_watertight(self.bvh, points)

    # -- training data (generate_training_samples_sdf)

    @staticmethod
    def sample_counts(n: int, uniform_only: bool = False) -> tuple[int, int, int]:
        """(on the surface, offset from it, uniform) of a batch of ``n``."""
        if uniform_only:
            return 0, 0, n
        base = n // 8
        return base * 4, base * 3, n - base * 7

    def _generator(self, seed: int, step: int) -> torch.Generator:
        return torch.Generator(self.device).manual_seed(step_seed(seed, step))

    def draw_uniforms(self, n: int, generator: torch.Generator,
                      uniform_only: bool = False):
        """The uniforms a batch of ``n`` consumes, the JAX engine's three
        draws: (surface (n_surface + n_offset, 3) in [0, 1), offset
        (n_offset, 3) in [1e-6, 1 − 1e-6), box (n_uniform, 3) in [0, 1));
        with an octree the third is the leaf draws (pick, u) of
        ``TriangleOctree.draw_uniform``."""
        n_exact, n_offset, n_uniform = self.sample_counts(n, uniform_only)

        def rand(rows):
            return torch.rand((rows, 3), generator=generator, device=self.device)

        surface, offset = rand(n_exact + n_offset), 1e-6 + rand(n_offset) * (1.0 - 2e-6)
        if self.octree is not None:
            return surface, offset, self.octree.draw_uniform(n_uniform, generator)
        return surface, offset, rand(n_uniform)

    def generate_training_samples(self, n: int, generator: torch.Generator | None = None,
                                  uniform_only: bool = False, uniforms=None):
        """(positions (n, 3), signed distances (n,)) on the device, from
        ``uniforms`` (as :meth:`draw_uniforms` returns them) or drawn from
        ``generator``."""
        if uniforms is None:
            uniforms = self.draw_uniforms(n, generator, uniform_only)
        u, uu, ub = uniforms
        n_exact = u.shape[0] - uu.shape[0]
        ti = torch.clamp(torch.searchsorted(self.cdf, u[:, 0].contiguous()), 0,
                         self.mesh.n_triangles - 1)
        tri = self.triangles[ti]
        su = torch.sqrt(u[:, 1])[:, None]
        v = u[:, 2][:, None]
        surf = tri[:, 0] * (1 - su) + tri[:, 1] * (su * (1 - v)) + tri[:, 2] * (su * v)
        # logistic offsets (generate_random_logistic): stddev =
        # bounding_radius / 1024 · surface_offset_scale
        std = self.bounding_radius / 1024.0 * self.surface_offset_scale
        s = std * math.sqrt(3.0) / math.pi
        offset_pos = surf[n_exact:] + s * torch.log(uu / (1.0 - uu))
        if self.octree is not None:
            # uniform in random octree leaves (uniform_octree_sample_kernel,
            # testbed_sdf.cu:436-471)
            uni = self.octree.sample_uniform(*ub)
        else:
            lo = self.aabb_min - self.zero_offset
            hi = self.aabb_max + self.zero_offset
            uni = lo + ub * (hi - lo)
        query = torch.cat([offset_pos, uni])
        sd = self.signed_distance(query)
        positions = torch.cat([surf[:n_exact], query])
        distances = torch.cat([torch.zeros((n_exact,), dtype=sd.dtype, device=sd.device), sd])
        return positions, distances

    def training_batch(self, step: int):
        """The batch a data refresh at ``step`` draws."""
        gen = self._generator(self.seed ^ _DATA_STREAM, 10_000_000 + step)
        return self.generate_training_samples(self.batch_size, gen)

    def step_permutation(self, step: int, n: int) -> torch.Tensor:
        """The order in which step ``step`` takes the batch's rows."""
        gen = self._generator(self.seed ^ _DATA_STREAM, step)
        return torch.randperm(n, generator=gen, device=self.device)

    # -- training (train_sdf + training_prep_sdf)

    def train(self, state: TrainState, n_steps: int,
              log_every: int = 0) -> tuple[TrainState, torch.Tensor]:
        """``n_steps`` steps on ``state`` (in place): a new batch at the
        call's first step and every ``data_refresh_interval`` steps, each
        step's rows in a new order. Returns ``state`` and the steps' losses
        (n_steps,) on the device; the meters read the last once.
        ``log_every`` prints the JAX engine's line ``sdf step {step}:
        loss={loss:.6f}`` at each step divisible by it (a host
        synchronisation there; none when 0)."""
        pos = dist = None
        losses = []
        t0 = time.monotonic()
        for step in range(state.step, state.step + n_steps):
            if self.override_training_data is not None:
                pos, dist = self.override_training_data
            elif pos is None or step % self.data_refresh_interval == 0:
                pos, dist = self.training_batch(step)
            perm = self.step_permutation(step, pos.shape[0])
            losses.append(self.trainer.training_step(state, pos[perm], dist[perm][:, None]))
            if log_every and step % log_every == 0:
                print(f"sdf step {step}: loss={float(losses[-1]):.6f}")
        if not losses:
            return state, torch.zeros((0,), dtype=torch.float32, device=self.device)
        losses = torch.stack(losses)
        self.meters.update_loss(float(losses[-1]))  # one sync per call
        self.meters.update_window(n_steps, float(self.batch_size) * n_steps, 0.0,
                                  time.monotonic() - t0)
        return state, losses

    # -- evaluation (calculate_iou)

    @torch.no_grad()
    def _model_sdf(self, model, points: torch.Tensor) -> torch.Tensor:
        return torch.cat([model(p)[:, 0] for p in points.split(CHUNK)])

    @torch.no_grad()
    def calculate_iou(self, state: TrainState, n_samples: int = 1 << 18,
                      generator: torch.Generator | None = None, uniforms=None) -> float:
        """Intersection over union of the inside sets (signed distance
        below 0) of the served model and the BVH over ``n_samples``
        uniform points in the mesh's box (with an octree: in its leaves,
        and the model counted right outside them, as
        ``compare_signs_kernel``, ``testbed_sdf.cu:474-483``)."""
        if uniforms is None and generator is None:
            generator = self._generator(_IOU_SEED, 0)
        pos, gt = self.generate_training_samples(n_samples, generator, True, uniforms)
        pred = self._model_sdf(state.inference_model(), pos)
        inside_gt, inside_pred = gt < 0, pred < 0
        if self.octree is not None:
            inside_pred = torch.where(self.octree.contains(pos), inside_pred, inside_gt)
        inter = torch.sum(inside_gt & inside_pred)
        union = torch.sum(inside_gt | inside_pred)
        return float(inter) / max(float(union), 1.0)

    # -- rendering (SphereTracer)

    def _sdf_fn(self, model, gt_bvh: bool):
        if gt_bvh:
            return self.signed_distance
        return lambda p: self._model_sdf(model, p)

    def _march(self, sdf, pos, dirs, carry: dict, update):
        """Sphere trace every ray of ``pos`` along ``dirs`` (N, 3) until it
        converges (|d| below ``maximum_distance``), leaves the mesh's box
        or ``MARCH_ITER`` iterations pass, as the JAX engine's lockstep
        loop does; ``update(carry, d, alive)`` advances the per-ray
        ``carry`` tensors (in place, of the rays given) with each
        iteration's scaled distance before ``alive`` changes. Every
        ``TRACE_CHECK_EVERY`` iterations the alive rays are gathered and
        only those are evaluated until the next gather: a ray's path
        depends on nothing but the ray. With an octree a step is at least
        its skip distance (``TriangleOctree.skip_distance``; the JAX
        engine's stand-in for the reference's ``ray_intersect`` re-entry,
        ``advance_pos_kernel_sdf``, ``testbed_sdf.cu:183-186``). Returns
        (positions, hit)."""
        pos = pos.clone()
        alive = torch.ones(pos.shape[:1], dtype=torch.bool, device=pos.device)
        hit = torch.zeros_like(alive)
        it = 0
        while it < MARCH_ITER:
            idx = alive.nonzero()[:, 0]
            if idx.numel() == 0:
                break
            p, d, a, h = pos[idx], dirs[idx], alive[idx], hit[idx]
            c = {k: v[idx] for k, v in carry.items()}
            for _ in range(min(TRACE_CHECK_EVERY, MARCH_ITER - it)):
                dist = (sdf(p) - self.zero_offset) * self.distance_scale
                if self.octree is not None:
                    dist = torch.maximum(dist, self.octree.skip_distance(p))
                newp = p + dist[:, None] * d
                update(c, dist, a)
                converged = a & (torch.abs(dist) < self.maximum_distance)
                inside = torch.all((newp >= self.aabb_min) & (newp <= self.aabb_max), dim=-1)
                h = h | converged
                p = torch.where(a[:, None], newp, p)
                a = a & ~converged & inside
                it += 1
            pos[idx], alive[idx], hit[idx] = p, a, h
            for k, v in c.items():
                carry[k][idx] = v
        return pos, hit

    def _trace(self, model, origins, dirs, gt_bvh: bool):
        """Sphere trace from the mesh box's entry (1e-4 inside); returns
        (positions, hit, steps (int32, iterations each ray was alive))."""
        tmin, tmax = ray_aabb_range(origins, dirs, self.aabb_min, self.aabb_max)
        valid = tmin <= tmax
        pos = origins + dirs * (tmin[:, None] + 1e-4)
        steps = torch.zeros(pos.shape[:1], dtype=torch.int32, device=pos.device)
        idx = valid.nonzero()[:, 0]

        def count(c, dist, alive):
            c["steps"] += alive.to(torch.int32)

        carry = {"steps": steps[idx]}
        p, h = self._march(self._sdf_fn(model, gt_bvh), pos[idx], dirs[idx], carry, count)
        hit = torch.zeros_like(valid)
        pos[idx], hit[idx], steps[idx] = p, h, carry["steps"]
        return pos, hit, steps

    def _light_dir(self) -> torch.Tensor:
        L = torch.as_tensor(self.sun_dir, dtype=torch.float32, device=self.device)
        return L / torch.linalg.norm(L)

    def _trace_shadow(self, model, pos, normals, view_dirs, gt_bvh: bool):
        """Soft-shadow factor per surface point: sphere trace from 1e-3
        off the surface (on the viewer's side) toward the sun, keeping
        Quilez's minimum visibility (``prepare_shadow_rays`` and the shadow
        branch of ``advance_pos_kernel_sdf``, ``testbed_sdf.cu:196-206,
        233-297``). Visibility in [0, 1]; 0 where the shadow ray hits."""
        nf = torch.where(torch.sum(normals * view_dirs, dim=-1, keepdim=True) > 0,
                         -normals, normals)
        o = pos + nf * 1e-3
        dirs = self._light_dir().expand_as(o)
        n = o.shape[0]
        carry = {"min_vis": torch.ones(n, device=o.device),
                 "prev_d": torch.full((n,), 1e20, device=o.device),
                 "total_d": torch.zeros(n, device=o.device)}

        def visibility(c, dist, alive):
            mv, pd, td = soft_shadow_visibility_update(
                c["min_vis"], c["prev_d"], c["total_d"], dist, self.shadow_sharpness)
            for k, v in (("min_vis", mv), ("prev_d", pd), ("total_d", td)):
                c[k] = torch.where(alive, v, c[k])

        _, hit_again = self._march(self._sdf_fn(model, gt_bvh), o, dirs, carry, visibility)
        return torch.where(hit_again, 0.0, torch.clamp(carry["min_vis"], 0.0, 1.0))

    def _normals(self, model, pos, gt_bvh: bool) -> torch.Tensor:
        """Unit normals at ``pos``: the model's position gradient (a grid's
        or the Takikawa encoding's float32 ``differentiable_inputs`` path,
        parameters frozen so that no table gradient runs), or central
        differences of the BVH's distances 1e-3 apart. (The JAX engine
        differentiates a Takikawa encoding through ``grid_gather_blend``,
        whose VJP gives the positions none: its normals are 0 there,
        ROADMAP C.ref 15.)"""
        if gt_bvh:
            eps = 1e-3
            offsets = torch.eye(3, device=pos.device) * eps
            sd = self.signed_distance(torch.cat([pos + offsets[i] for i in range(3)]
                                                + [pos - offsets[i] for i in range(3)]))
            plus, minus = sd.reshape(6, -1)[:3], sd.reshape(6, -1)[3:]
            n = (plus - minus).T
        else:
            enc_kw = ({"differentiable_inputs": True}
                      if isinstance(model.encoding, (GridEncoding, TakikawaEncoding)) else {})
            grads = []
            with torch.enable_grad(), parameters_frozen(model):
                for p in pos.split(CHUNK):
                    p = p.detach().requires_grad_(True)
                    y = model.network(model.encoding(p, **enc_kw))[:, 0]
                    grads.append(torch.autograd.grad(y.sum(), p)[0])
            n = torch.cat(grads) if grads else torch.zeros_like(pos)
        return n / torch.clamp_min(torch.linalg.norm(n, dim=-1, keepdim=True), 1e-9)

    def _shade(self, model, pos, dirs, steps, gt_bvh: bool, mode: str, shadow: bool):
        """Colours of surface points (``shade_kernel_sdf``,
        ``testbed_sdf.cu:297-375``): headlight (a diffuse headlight),
        shade (the Disney BRDF under sun and sky, sphere-traced soft
        shadows with ``shadow``), ao (0.92^steps), normals, positions,
        cost (steps / 30)."""
        if mode == "ao":
            return (0.92 ** steps.to(torch.float32))[:, None].expand_as(pos)
        if mode == "cost":
            return (steps.to(torch.float32) / 30.0)[:, None].expand_as(pos)
        if mode == "positions":
            return (pos - 0.5) / 2.0 + 0.5
        n = self._normals(model, pos, gt_bvh)
        if mode == "normals":
            return 0.5 * n + 0.5
        if mode == "headlight":
            ndotl = torch.clamp(-torch.sum(n * dirs, dim=-1), 0.0, 1.0)
            base = torch.tensor([0.8, 0.75, 0.7], device=pos.device)
            return base[None, :] * (0.2 + 0.8 * ndotl)[:, None]
        L = self._light_dir()
        up = torch.as_tensor(self.up_dir, dtype=torch.float32, device=pos.device)
        shadow_factor = (self._trace_shadow(model, pos, n, dirs, gt_bvh) if shadow
                         else torch.ones(pos.shape[0], device=pos.device))
        skyam = -torch.sum(n * up, dim=-1) * 0.5 + 0.5
        suncol = (torch.tensor([255.0, 225.0, 195.0], device=pos.device) / 255.0 * 4.0
                  ) * shadow_factor[:, None]
        skycol = (torch.tensor([195.0, 215.0, 255.0], device=pos.device) / 255.0 * 4.0
                  ) * skyam[:, None]
        base = torch.as_tensor(self.brdf.basecolor, dtype=torch.float32, device=pos.device)
        base = (base * base).expand_as(pos)
        amb = torch.as_tensor(self.brdf.ambientcolor, dtype=torch.float32,
                              device=pos.device) * skycol
        return evaluate_shading(base, amb, suncol, L, -dirs, n, self.brdf)

    @torch.no_grad()
    def render_rays(self, state: TrainState, origins: torch.Tensor, dirs: torch.Tensor,
                    gt_bvh: bool = False, mode: str = "headlight", shadow: bool = False):
        """Sphere trace and shade rays ``origins`` and unit ``dirs`` (N, 3)
        through the served model, or the BVH's distances with ``gt_bvh``;
        ``mode`` one of ``RENDER_MODES``, ``shadow`` adds the shadow rays
        of the shade mode. Returns (rgb (N, 3), black off the surface;
        depth (N,), the distance from the origin to where the ray
        stopped; hit (N,))."""
        if mode not in RENDER_MODES:
            raise ValueError(f"unknown SDF render mode {mode!r} ({' | '.join(RENDER_MODES)})")
        model = state.inference_model()
        origins = origins.to(self.device, torch.float32)
        dirs = dirs.to(self.device, torch.float32)
        pos, hit, steps = self._trace(model, origins, dirs, gt_bvh)
        rgb = torch.zeros_like(pos)
        idx = hit.nonzero()[:, 0]
        rgb[idx] = self._shade(model, pos[idx], dirs[idx], steps[idx], gt_bvh, mode,
                               shadow).to(rgb.dtype)
        depth = torch.linalg.norm(pos - origins, dim=-1)
        return rgb, depth, hit

    def camera_rays(self, eye, lookat, resolution=(256, 256), fov_deg: float = 45.0):
        """Pinhole rays (origins, unit dirs) (H·W, 3) float32 on the host,
        as the JAX engine's ``render_image`` makes them
        (``geometry/camera.lookat_rays``)."""
        return lookat_rays(eye, lookat, resolution, fov_deg)

    def render_image(self, state: TrainState, eye, lookat, resolution=(256, 256),
                     fov_deg: float = 45.0, gt_bvh: bool = False, mode: str = "headlight",
                     shadow: bool = False):
        """A W × H frame from ``eye`` toward ``lookat``: (rgb (H, W, 3),
        hit (H, W)) on the device."""
        W, H = resolution
        o, d = self.camera_rays(eye, lookat, resolution, fov_deg)
        rgb, _, hit = self.render_rays(state, torch.from_numpy(o), torch.from_numpy(d),
                                       gt_bvh, mode=mode, shadow=shadow)
        return rgb.reshape(H, W, 3), hit.reshape(H, W)

    # -- mesh export

    @torch.no_grad()
    def compute_marching_cubes_mesh(self, state: TrainState, resolution: int = 256):
        """The learned surface (zero level set) over a ``resolution``³
        lattice spanning the mesh's box: (verts, faces) numpy."""
        from ngp_tpu_torch.ops.marching_cubes import marching_cubes

        model = state.inference_model()
        lo = np.asarray(self.mesh.aabb_min)
        hi = np.asarray(self.mesh.aabb_max)
        n = resolution
        axes = [torch.from_numpy(np.linspace(lo[d], hi[d], n, dtype=np.float32)).to(self.device)
                for d in range(3)]
        field = torch.empty((n ** 3,), dtype=torch.float32, device=self.device)
        for s in range(0, n ** 3, CHUNK):
            i = torch.arange(s, min(s + CHUNK, n ** 3), device=self.device)
            pts = torch.stack([axes[0][i // (n * n)], axes[1][(i // n) % n], axes[2][i % n]], -1)
            field[s:s + CHUNK] = model(pts)[:, 0]
        field = -field.reshape(n, n, n).cpu().numpy()  # inside-positive
        return marching_cubes(field, 0.0, origin=lo, spacing=(hi - lo) / (n - 1))

    # -- native snapshots (the JAX package's document)

    def save_snapshot(self, path: str, state: TrainState) -> None:
        """Write the JAX engine's sdf snapshot (``utils/snapshot.py``):
        mode, network config, training step (int32), parameters and served
        (EMA) parameters as JAX trees, the mesh's scale."""
        from ngp_tpu_torch.interop import export_jax_params
        from ngp_tpu_torch.utils.snapshot import save_snapshot

        save_snapshot(path, {
            "mode": "sdf",
            "network_config": self.config,
            "snapshot": {
                "training_step": np.asarray(state.step, np.int32),
                "params": export_jax_params(state.model),
                "ema_params": export_jax_params(state.inference_model()),
                "mesh_scale": self.mesh.mesh_scale,
            },
        })

    def load_snapshot(self, path: str) -> TrainState:
        """Read an sdf snapshot, the port's or the JAX package's. Optimizer
        moments start at zero, as the JAX package's ``load_snapshot``
        starts them."""
        from ngp_tpu_torch.interop import load_jax_params
        from ngp_tpu_torch.utils.snapshot import load_snapshot

        snap: dict[str, Any] = load_snapshot(path)["snapshot"]
        net = load_jax_params(self._new_network(), snap["params"])
        state = TrainState.create(net, int(snap["training_step"]))
        if self.trainer.opt_cfg.ema_decay is not None:
            state.ema = load_jax_params(copy.deepcopy(net), snap["ema_params"]
                                        ).requires_grad_(False)
        return state

"""Volumes, the port of ``ngp_tpu/engines/volume.py`` (the reference's
``src/testbed_volume.cu``).

A hash-encoded MLP learns position → (radiance rgb, density), supervised
by a delta-tracking path tracer over a density volume
(``data/volume.DenseVolume``). A step path-traces ``batch_size / 4``
episodes from random points on a sphere of radius 2 toward random points
of the volume's box (``volume_generate_training_data_kernel``,
``testbed_volume.cu:87-156``), records up to 4 interaction vertices each
with the volume's jittered density there, and supervises every vertex with
the sky seen along the episode's final direction times its throughput
(rgb) and that density. The loss is the JAX engine's masked mean: the L2
of all ``batch_size`` slots, unfilled ones (at the origin) included, times
the filled mask, summed, over the filled count, over 4. A frame
delta-tracks the learned field, or the volume itself (``gt``), and adds
the sky behind what is left of each ray's transmittance.

The walks run in ``ops/volume_walk.py``: a step's training data (the
episodes' starts, their walks and the sky targets) as one kernel launch;
a ground-truth frame as one launch; a learned frame as
rounds of an event wavefront, each one kernel launch that advances every
live ray to its next event, then the network at the events only and the
composite, the live rays gathered every ``RENDER_CHECK_EVERY`` rounds.

Random draws come from the walks' counter-based stream, keyed (seed ^
0x701, step) for training and (7, 0) for frames, as the JAX engine keys
``PRNGKey(seed ^ 0x701)`` folded with the step and ``PRNGKey(7)``; they are
not the JAX package's numbers. Each draw sits behind an argument that a
comparison with the JAX package can feed (``generate_training_data(draws=,
start=)``, ``render_rays(draws=)``).
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ngp_tpu_torch.data.volume import DenseVolume
from ngp_tpu_torch.device import resolve_device
from ngp_tpu_torch.geometry.camera import lookat_rays
from ngp_tpu_torch.models.factory import (
    NetworkWithInputEncoding,
    create_loss,
    create_network_with_input_encoding,
)
from ngp_tpu_torch.ops.marching import ray_aabb_range
from ngp_tpu_torch.ops.volume_walk import (
    MAX_TRAIN_VERTICES,
    WalkVolume,
    draw_key,
    extinction,
    proc_envmap,
    volume_render_walk,
    volume_train_walk,
)
from ngp_tpu_torch.train import Trainer, TrainState, apply_grads
from ngp_tpu_torch.utils.meters import TrainMeters

CHUNK = 1 << 18  # positions a network call of a frame evaluates at once
RENDER_CHECK_EVERY = 16  # learned-frame rounds between gathers of the live rays
_DATA_STREAM = 0x701  # the JAX engine's training key, PRNGKey(seed ^ 0x701)
_FRAME_SEED = 7  # the JAX engine's frame key, PRNGKey(7)


@dataclass
class VolumeEngine:
    """``VolumeEngine(config, volume, batch_size=2^16, ..., seed=1337,
    device="cuda")``: fields and defaults as the JAX engine's
    (``testbed.h:885-887``)."""

    config: dict
    volume: DenseVolume
    batch_size: int = 1 << 16
    albedo: float = 0.95
    scattering: float = 0.0
    inv_distance_scale: float = 100.0
    sky_color: tuple = (0.0, 0.0, 0.0)
    sun_dir: tuple = (0.57735, 0.57735, 0.57735)
    up_dir: tuple = (0.0, 1.0, 0.0)
    seed: int = 1337
    device: str = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.config = copy.deepcopy(self.config)
        self.trainer = Trainer(create_loss(self.config.get("loss", {"otype": "L2"})),
                               self.config["optimizer"])
        self.distance_scale = 1.0 / max(self.inv_distance_scale, 0.01)
        self.walk = WalkVolume.of(self.volume, self.distance_scale, self.device)
        self.aabb_min, self.aabb_max = self.walk.aabb_min, self.walk.aabb_max
        self.meters = TrainMeters()

    def _new_network(self) -> NetworkWithInputEncoding:
        return create_network_with_input_encoding(3, 4, self.config, self.device)

    def init_state(self) -> TrainState:
        """Step 0: a model with parameters drawn from a CPU
        ``torch.Generator`` seeded with ``self.seed``, zero Adam moments."""
        net = self._new_network()
        net.reset_parameters(torch.Generator().manual_seed(self.seed))
        return TrainState.create(net)

    @property
    def envmap(self) -> tuple:
        """The procedural sky's parameters: (up, sun direction, sky colour)."""
        return self.up_dir, self.sun_dir, self.sky_color

    def _sky(self, dirs: torch.Tensor) -> torch.Tensor:
        return proc_envmap(dirs, *self.envmap)

    # -- training data (volume_generate_training_data_kernel)

    def generate_training_data(self, step: int, n_episodes: int | None = None, draws=None,
                               start=None):
        """Path-trace ``n_episodes`` (``batch_size / 4`` by default) with the
        draws of ``step``: (positions (E·4, 3), targets (E·4, 4) [rgb,
        density], valid (E·4,) bool); on the card one launch of the
        training walk kernel. ``start`` (normal (E, 3), uniform (E, 3))
        replaces the starts' draws and ``draws``
        (``ops/volume_walk.ArrayDraws``) the walk's, both on the CPU only."""
        E = n_episodes if n_episodes is not None else self.batch_size // MAX_TRAIN_VERTICES
        key = draw_key(self.seed ^ _DATA_STREAM, step)
        return volume_train_walk(self.walk, key, E, self.albedo, self.scattering, self.envmap,
                                 start, draws)

    # -- training

    def loss(self, model, positions, targets, valid) -> torch.Tensor:
        """The JAX engine's masked mean (``engines/volume.py:213-217``)."""
        per = self.trainer.loss_fn(targets, model(positions)) * valid[:, None]
        return torch.sum(per) / torch.clamp_min(torch.sum(valid), 1) / per.shape[-1]

    def training_step(self, state: TrainState, batch=None) -> torch.Tensor:
        """One update of ``state`` in place on the data of its step (or
        ``batch``, as ``generate_training_data`` returns it); returns the
        loss before the update, on the device (no host synchronisation)."""
        positions, targets, valid = batch if batch is not None else \
            self.generate_training_data(state.step)
        model = state.model
        model.zero_grad(set_to_none=True)
        loss = self.loss(model, positions, targets, valid)
        loss.backward()
        apply_grads(state, self.trainer.opt_cfg)
        model.zero_grad(set_to_none=True)  # a table's d(table) is table-sized
        return loss.detach()

    def train(self, state: TrainState, n_steps: int,
              log_every: int = 0) -> tuple[TrainState, torch.Tensor]:
        """``n_steps`` steps on ``state`` (in place). Returns ``state`` and
        the steps' losses (n_steps,) on the device; the meters read the
        last once. ``log_every`` prints the JAX engine's line
        ``volume step {step}: loss={loss:.5f}`` at each step divisible by
        it (a host synchronisation there; none when 0)."""
        t0 = time.monotonic()
        losses = []
        for _ in range(n_steps):
            step = state.step
            losses.append(self.training_step(state))
            if log_every and step % log_every == 0:
                print(f"volume step {step}: loss={float(losses[-1]):.5f}")
        if not losses:
            return state, torch.zeros((0,), dtype=torch.float32, device=self.device)
        losses = torch.stack(losses)
        self.meters.update_loss(float(losses[-1]))  # one sync per call
        self.meters.update_window(n_steps, float(self.batch_size) * n_steps, 0.0,
                                  time.monotonic() - t0)
        return state, losses

    # -- rendering (volume_render_kernel_gt / volume_render_kernel_step)

    @torch.no_grad()
    def _network(self, model, pos: torch.Tensor) -> torch.Tensor:
        return torch.cat([model(p) for p in pos.split(CHUNK)])

    @torch.no_grad()
    def render_rays(self, state: TrainState, origins: torch.Tensor, dirs: torch.Tensor,
                    gt: bool = False, draws=None):
        """Delta-track rays ``origins``, unit ``dirs`` (B, 3) through the
        served model, or the volume's own density with ``gt``, from the
        AABB's entry (1e-6 inside), then add the sky behind the remaining
        transmittance. Returns (rgb (B, 3), opacity (B,)). ``draws``
        (``ops/volume_walk.ArrayDraws``, CPU only) replaces the frame's
        stream."""
        origins = origins.to(self.device, torch.float32)
        dirs = dirs.to(self.device, torch.float32).contiguous()
        key = draw_key(_FRAME_SEED, 0)
        tmin, tmax = ray_aabb_range(origins, dirs, self.aabb_min, self.aabb_max)
        pos = (origins + dirs * (tmin + 1e-6)[:, None]).contiguous()
        alive = tmin <= tmax
        if gt:
            col, opa = volume_render_walk(self.walk, pos, dirs, alive, key, True, draws=draws)
        else:
            col, opa = self._render_learned(state.inference_model(), pos, dirs, alive, key,
                                            draws)
        return col + (1.0 - opa)[:, None] * self._sky(dirs), opa

    def _render_learned(self, model, pos, dirs, alive, key, draws):
        """The event wavefront: rounds of the walk kernel, each followed by
        the network at the rays it left at an event and their composite,
        ``a = clip(density/majorant, 0, 1)·(1 − opa)``; a ray stops once
        opa > 0.99. The rays still live are gathered every
        ``RENDER_CHECK_EVERY`` rounds; the frame ends at a round without an
        event."""
        B = pos.shape[0]
        col = torch.zeros((B, 3), dtype=torch.float32, device=self.device)
        opa = torch.zeros((B,), dtype=torch.float32, device=self.device)
        ids = alive.nonzero()[:, 0]
        p, d, a = pos[ids], dirs[ids], alive[ids]
        it = torch.zeros(ids.shape, dtype=torch.int32, device=self.device)
        rounds = 0
        while ids.numel():
            p, a, it, event = volume_render_walk(self.walk, p, d, a, key, False, it, ids,
                                                 draws)
            rounds += 1
            at = event.nonzero()[:, 0]
            if at.numel() == 0:
                break
            rays = ids[at]
            out = self._network(model, p[at])
            ext = torch.clamp(extinction(self.walk, out[:, 3]), 0.0, 1.0)
            add = ext * (1.0 - opa[rays])
            col[rays] = col[rays] + out[:, :3] * add[:, None]
            opa[rays] = opa[rays] + add
            a[at] = opa[rays] <= 0.99
            if rounds % RENDER_CHECK_EVERY == 0:
                live = a.nonzero()[:, 0]
                ids, p, d, a, it = ids[live], p[live], d[live], a[live], it[live]
        return col, opa

    def camera_rays(self, eye, lookat, resolution=(128, 128), fov_deg: float = 45.0):
        """Pinhole rays (origins, unit dirs) (H·W, 3) float32 on the host,
        as the JAX engine's ``render_image`` makes them
        (``geometry/camera.lookat_rays``)."""
        return lookat_rays(eye, lookat, resolution, fov_deg)

    def render_image(self, state: TrainState, eye, lookat, resolution=(128, 128),
                     fov_deg: float = 45.0, gt: bool = False):
        """A W × H frame from ``eye`` toward ``lookat``: (rgb (H, W, 3),
        opacity (H, W)) on the device."""
        W, H = resolution
        o, d = self.camera_rays(eye, lookat, resolution, fov_deg)
        col, opa = self.render_rays(state, torch.from_numpy(o), torch.from_numpy(d), gt)
        return col.reshape(H, W, 3), opa.reshape(H, W)

    # -- native snapshots (the JAX package's document)

    def save_snapshot(self, path: str, state: TrainState) -> None:
        """Write the JAX engine's volume snapshot (``utils/snapshot.py``):
        mode, network config, training step (int32), parameters and served
        (EMA) parameters as JAX trees, the global majorant."""
        from ngp_tpu_torch.interop import export_jax_params
        from ngp_tpu_torch.utils.snapshot import save_snapshot

        save_snapshot(path, {
            "mode": "volume",
            "network_config": self.config,
            "snapshot": {
                "training_step": np.asarray(state.step, np.int32),
                "params": export_jax_params(state.model),
                "ema_params": export_jax_params(state.inference_model()),
                "global_majorant": self.volume.global_majorant,
            },
        })

    def load_snapshot(self, path: str) -> TrainState:
        """Read a volume snapshot, the port's or the JAX package's. Optimizer
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

"""Training state and the generic supervised trainer, the port of
``ngp_tpu/train.py`` (tcnn's ``Trainer``: the reference's image, SDF and
volume modes call ``m_trainer->training_step(input, target)``, e.g.
``testbed_image.cu:214-285``)."""

from __future__ import annotations

import contextlib
import copy
from dataclasses import dataclass
from typing import Callable

import torch
from torch import nn

from ngp_tpu_torch.optim import (
    GROUPS,
    AdamState,
    CameraOptimizerConfig,
    OptimizerConfig,
    adam_init,
    adam_skip_zero_step,
    adam_step,
    ema_update,
    param_groups,
)


class CameraParams(nn.Module):
    """The NeRF engine's camera group, the JAX engine's ``params["camera"]``:
    per-image position offsets ``pos`` (I, 3) and rotation vectors ``rot``
    (I, 3) applied to the dataset's poses, per-image exposures ``exposure``
    (I, 3) in stops, a log-scale focal multiplier ``focal`` (2,) and a
    lens-distortion grid ``distortion`` (H, W, 2) of camera-space direction
    offsets; all zero at the start. ``latents`` (I, E) is a buffer held at
    zero: training latent codes is not yet ported (ROADMAP A5c)."""

    NAMES = ("distortion", "exposure", "focal", "pos", "rot")

    def __init__(self, n_images: int, distortion_resolution=(32, 32),
                 n_latents: int = 1, device="cuda"):
        super().__init__()
        f32 = dict(dtype=torch.float32, device=device)
        shapes = {"distortion": (*distortion_resolution, 2), "exposure": (n_images, 3),
                  "focal": (2,), "pos": (n_images, 3), "rot": (n_images, 3)}
        for name in self.NAMES:
            setattr(self, name, nn.Parameter(torch.zeros(shapes[name], **f32)))
        self.register_buffer("latents", torch.zeros((n_images, n_latents), **f32))


@dataclass
class TrainState:
    """The training step, the model (parameters being trained), the Adam
    state of each group (``"dense"``, ``"grid"``; see ``optim.py``; and
    ``"camera"`` where there is a camera group) and the EMA copy of the
    model served for inference. The engine updates all of them in place;
    ``step`` counts the updates applied.

    ``ema`` is None until the first update copies the model into it (the
    JAX package's ``ema_init`` at the parameters the first update starts
    from) and stays None without an ``Ema`` optimizer; until then the
    model itself is served.

    ``camera`` is the NeRF engine's :class:`CameraParams` (None for the
    other engines) and ``camera_ema`` its EMA copy, which the JAX
    package's EMA covers as it covers the whole parameter tree.
    ``camera_still`` is set where the camera group is frozen and it and its
    EMA are zero, so that the EMA update cannot move them and is skipped;
    a step of the camera group clears it, as must any other write to
    either."""

    step: int
    model: nn.Module
    opt_state: dict[str, AdamState]
    ema: nn.Module | None
    camera: nn.Module | None = None
    camera_ema: nn.Module | None = None
    camera_still: bool = False

    @staticmethod
    def create(model: nn.Module, step: int = 0,
               camera: nn.Module | None = None) -> "TrainState":
        """Zero moments and no EMA copy yet."""
        groups = param_groups(model)
        opt = {g: adam_init([p for _, p in groups[g]]) for g in GROUPS}
        if camera is not None:
            opt["camera"] = adam_init(list(camera.parameters()))
        return TrainState(step, model, opt, None, camera)

    def start_ema(self):
        """Copy the model (and the camera group) into the EMA (before the
        first update)."""
        self.ema = copy.deepcopy(self.model).requires_grad_(False)
        if self.camera is not None:
            self.camera_ema = copy.deepcopy(self.camera).requires_grad_(False)

    def inference_model(self) -> nn.Module:
        """The EMA-averaged model where there is one, else the model."""
        return self.ema if self.ema is not None else self.model

    def inference_camera(self) -> nn.Module | None:
        """The EMA-averaged camera group where there is one, else the
        camera group."""
        return self.camera_ema if self.camera_ema is not None else self.camera


class Trainer:
    """A model's supervised step: forward, an elementwise loss averaged
    over all its elements (tcnn normalises by the number of loss
    elements), backward, then the ``Ema{ExponentialDecay{Adam}}`` stack of
    ``optimizer_cfg``: sparse Adam on encoding tables, Adam + L2 on the
    rest, then the EMA. ``loss_fn(target, prediction)`` is elementwise;
    the model's outputs beyond the targets' width are not trained.
    ``TrainState.create(model)`` starts a state, and
    ``TrainState.inference_model()`` serves the EMA."""

    def __init__(self, loss_fn: Callable, optimizer_cfg: dict):
        self.loss_fn = loss_fn
        self.opt_cfg = OptimizerConfig.from_json(optimizer_cfg)

    def loss(self, model: nn.Module, inputs: torch.Tensor,
             targets: torch.Tensor) -> torch.Tensor:
        pred = model(inputs)
        return torch.mean(self.loss_fn(targets, pred[..., : targets.shape[-1]]))

    def training_step(self, state: TrainState, inputs: torch.Tensor,
                      targets: torch.Tensor) -> torch.Tensor:
        """One update of ``state`` in place; returns the loss before it as
        a tensor on the model's device (no host synchronisation)."""
        state.model.zero_grad(set_to_none=True)
        loss = self.loss(state.model, inputs, targets)
        loss.backward()
        self.apply_grads(state)
        state.model.zero_grad(set_to_none=True)  # a table's d(table) is table-sized
        return loss.detach()

    def apply_grads(self, state: TrainState) -> None:
        """One optimizer step from the ``.grad`` of ``state.model``, then
        the EMA; in place (:func:`apply_grads`)."""
        apply_grads(state, self.opt_cfg)


def apply_grads(state: TrainState, cfg: OptimizerConfig,
                camera_cfg: CameraOptimizerConfig | None = None) -> None:
    """One step of ``cfg``'s optimizer stack from the ``.grad`` of
    ``state.model``: sparse Adam on the tables, Adam + L2 on the rest, then
    the EMA; in place. The step of every engine (``Trainer``, the NeRF
    engine). With ``camera_cfg`` the camera group takes its own step too
    (the NeRF engine while refinement is on); a camera group without one
    stays as it is. The EMA covers the camera group where there is one,
    unless ``state.camera_still``."""
    if cfg.ema_decay is not None and state.ema is None:
        state.start_ema()
    groups = param_groups(state.model)
    for name in GROUPS:
        params = [p for _, p in groups[name]]
        opt = state.opt_state[name]
        lr = cfg.schedule(opt.count)
        if name == "grid":
            adam_skip_zero_step(params, _grads(params), opt, lr, cfg.b1, cfg.b2, cfg.eps)
        else:
            adam_step(params, _grads(params), opt, lr, cfg.b1, cfg.b2, cfg.eps, cfg.l2_reg)
    if camera_cfg is not None:
        params = list(state.camera.parameters())
        opt = state.opt_state["camera"]
        adam_step(params, _grads(params), opt, camera_cfg.schedule(opt.count), camera_cfg.b1,
                  camera_cfg.b2, camera_cfg.eps, camera_cfg.l2_reg)
        state.camera_still = False
    if state.ema is not None:
        ema_update(list(state.ema.parameters()), list(state.model.parameters()),
                   cfg.ema_decay, state.step)
        if state.camera_ema is not None and not state.camera_still:
            ema_update(list(state.camera_ema.parameters()), list(state.camera.parameters()),
                       cfg.ema_decay, state.step)
    state.step += 1


def _grads(params) -> list:
    return [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]


@contextlib.contextmanager
def parameters_frozen(model: nn.Module):
    """``model``'s parameters with ``requires_grad`` off inside the block,
    restored after. A custom autograd Function's ``needs_input_grad``
    follows ``requires_grad``, not the inputs an ``autograd.grad`` call asks
    for: frozen, a gradient with respect to positions launches no
    d(table) backward."""
    params = [p for p in model.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)

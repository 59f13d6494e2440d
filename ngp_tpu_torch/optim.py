"""tcnn's nested ``Ema{ExponentialDecay{Adam}}`` optimizer, the port of
``ngp_tpu/optim.py`` as plain tensor functions that update in place.

Two parameter groups, labelled as the JAX package labels them: encoding
tables (``"grid"``) take Adam whose moments and step are skipped where the
gradient is exactly zero (the instant-ngp paper's sparse update); every
other parameter (``"dense"``, the MLP weights) takes optax's
``scale_by_adam`` (bias-corrected moments, ε outside the square root),
then ``add_decayed_weights(l2_reg)``, then the learning rate. That is not
``torch.optim.Adam``: its weight decay enters the gradient before the
moments. The EMA copy warms up: decay min(d, (1 + step)/(10 + step)).

The NeRF engine's camera group (``train.CameraParams``) has a rule of
its own, the JAX engine's ``camera_tx``: ``scale_by_adam(0.9, 0.99,
1e-8)``, then ``add_decayed_weights(extrinsic_l2_reg)``, then the
learning rate of :func:`camera_schedule` (:class:`CameraOptimizerConfig`).

Scalars that depend on the step (bias corrections, learning rate, EMA
decay) are rounded to float32 as the JAX package computes them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, ClassVar

import numpy as np
import torch
from torch import nn

GROUPS = ("dense", "grid")


def exponential_decay_schedule(cfg: dict, base_lr: float) -> Callable[[int], float]:
    """tcnn ``ExponentialDecay``: ``base_lr`` until ``decay_start``, then
    multiplied by ``decay_base`` every ``decay_interval`` steps (continuous
    exponent), held from ``decay_end`` on if given."""
    decay_start = cfg.get("decay_start", 0)
    decay_interval = cfg.get("decay_interval", 10000)
    decay_base = cfg.get("decay_base", 1.0)
    decay_end = cfg.get("decay_end", None)

    def schedule(step: int) -> float:
        t = np.float32(max(float(step) - decay_start, 0.0))
        if decay_end is not None:
            t = min(t, np.float32(decay_end - decay_start))
        e = t / np.float32(decay_interval)
        return float(np.float32(base_lr) * np.float32(decay_base) ** e)

    return schedule


@dataclass(frozen=True)
class OptimizerConfig:
    b1: float
    b2: float
    eps: float
    l2_reg: float
    schedule: Callable[[int], float]
    ema_decay: float | None

    @staticmethod
    def from_json(opt_cfg: dict) -> "OptimizerConfig":
        """Peel the reference config's ``Ema`` and ``ExponentialDecay``
        wrappers down to its ``Adam`` block."""
        ema_decay = None
        if opt_cfg.get("otype", "").lower() == "ema":
            ema_decay = float(opt_cfg.get("decay", 0.99))
            opt_cfg = opt_cfg["nested"]
        sched_cfgs = []
        while opt_cfg.get("otype", "").lower() == "exponentialdecay":
            sched_cfgs.append(opt_cfg)
            opt_cfg = opt_cfg["nested"]
        otype = opt_cfg.get("otype", "Adam").lower()
        if otype not in ("adam", "shampoo"):
            raise ValueError(f"unsupported optimizer {otype!r}")
        base_lr = float(opt_cfg.get("learning_rate", 1e-3))
        schedule = lambda step: float(np.float32(base_lr))  # noqa: E731
        for c in reversed(sched_cfgs):
            schedule = exponential_decay_schedule(c, base_lr)
        return OptimizerConfig(
            b1=float(opt_cfg.get("beta1", 0.9)),
            b2=float(opt_cfg.get("beta2", 0.999)),
            eps=float(opt_cfg.get("epsilon", 1e-8)),
            l2_reg=float(opt_cfg.get("l2_reg", 0.0)),
            schedule=schedule,
            ema_decay=ema_decay,
        )


def camera_schedule(extrinsic_learning_rate: float,
                    lr_schedule: Callable[[int], float]) -> Callable[[int], float]:
    """The camera group's learning rate at update ``count``, in float32:
    max(extrinsic_learning_rate/16 · 0.33^(count // 2048),
    lr_schedule(count)/1000). The reference steps its camera Adam once every
    16 training steps at ``extrinsic_learning_rate``, decayed ×0.33 every
    128 of its steps; this rule steps every training step (JAX engine
    ``cam_schedule``)."""
    base = np.float32(extrinsic_learning_rate / 16.0)

    def schedule(count: int) -> float:
        decayed = base * np.float32(0.33) ** np.float32(count // 2048)
        floor = np.float32(lr_schedule(count)) / np.float32(1000.0)
        return float(max(np.float32(decayed), floor))

    return schedule


@dataclass(frozen=True)
class CameraOptimizerConfig:
    """The camera group's rule: Adam (``b1``, ``b2``, ``eps``: the JAX
    engine's constants), then ``l2_reg``·p, then ``schedule(count)``."""

    l2_reg: float
    schedule: Callable[[int], float]
    b1: ClassVar[float] = 0.9
    b2: ClassVar[float] = 0.99
    eps: ClassVar[float] = 1e-8


@dataclass
class AdamState:
    """One group's Adam state: the update count and first and second
    moments, one tensor per parameter in the group's order."""

    count: int = 0
    mu: list = field(default_factory=list)
    nu: list = field(default_factory=list)


def param_groups(model: nn.Module) -> dict[str, list[tuple[str, nn.Parameter]]]:
    """``{"dense": [...], "grid": [...]}`` of (name, parameter): a
    parameter whose name has a ``table`` component is an encoding table."""
    groups = {g: [] for g in GROUPS}
    for name, p in model.named_parameters():
        groups["grid" if "table" in name.split(".") else "dense"].append((name, p))
    return groups


def adam_init(params) -> AdamState:
    return AdamState(0, [torch.zeros_like(p) for p in params],
                     [torch.zeros_like(p) for p in params])


def _bias_correction(b: float, count: int) -> float:
    return float(np.float32(1.0) - np.float32(b) ** np.float32(count))


@torch.no_grad()
def adam_step(params, grads, state: AdamState, lr: float, b1: float, b2: float,
              eps: float, l2_reg: float = 0.0) -> None:
    """optax ``scale_by_adam`` → ``add_decayed_weights(l2_reg)`` →
    ``scale_by_learning_rate(lr)`` → ``apply_updates``, in place."""
    state.count += 1
    bc1, bc2 = _bias_correction(b1, state.count), _bias_correction(b2, state.count)
    for p, g, m, v in zip(params, grads, state.mu, state.nu):
        m.copy_((1.0 - b1) * g + b1 * m)
        v.copy_((1.0 - b2) * (g * g) + b2 * v)
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if l2_reg:
            u = u + l2_reg * p
        p.add_(-lr * u)


@torch.no_grad()
def adam_skip_zero_step(params, grads, state: AdamState, lr: float, b1: float,
                        b2: float, eps: float) -> None:
    """The JAX package's ``scale_by_adam_skip_zero`` then the learning
    rate, in place: where a gradient entry is exactly 0 its moments and
    its parameter stay as they are."""
    state.count += 1
    bc1, bc2 = _bias_correction(b1, state.count), _bias_correction(b2, state.count)
    for p, g, m, v in zip(params, grads, state.mu, state.nu):
        live = g != 0.0
        m.copy_(torch.where(live, b1 * m + (1.0 - b1) * g, m))
        v.copy_(torch.where(live, b2 * v + (1.0 - b2) * g * g, v))
        step = torch.where(live, (m / bc1) / (torch.sqrt(v / bc2) + eps), 0.0)
        p.add_(-lr * step)


def ema_decay_at(decay: float, step: int) -> float:
    """tcnn's warm-up: min(decay, (1 + step)/(10 + step)), in float32."""
    warm = np.float32(1.0 + step) / np.float32(10.0 + step)
    return float(min(np.float32(decay), warm))


@torch.no_grad()
def ema_update(ema_params, params, decay: float, step: int) -> None:
    """``ema ← ema·d + p·(1 − d)`` in place, d = :func:`ema_decay_at`."""
    d = ema_decay_at(decay, step)
    one_minus = float(np.float32(1.0) - np.float32(d))
    for e, p in zip(ema_params, params):
        e.copy_(e * d + p * one_minus)

"""Activations and front-to-back compositing, the forward of
``ngp_tpu/ops/composite.py``."""

from __future__ import annotations

from typing import NamedTuple

import torch


def density_activation_exp(x: torch.Tensor) -> torch.Tensor:
    """exp clamped at e^30 (forward of the reference's density activation)."""
    return torch.exp(torch.clamp_max(x, 30.0))


def rgb_activation_exp(x: torch.Tensor) -> torch.Tensor:
    """exp clamped to ±10."""
    return torch.exp(torch.clamp(x, -10.0, 10.0))


_ACTIVATIONS_RGB = {
    "none": lambda x: x,
    "relu": torch.relu,
    "logistic": torch.sigmoid,
    "exponential": rgb_activation_exp,
}

_ACTIVATIONS_DENSITY = {
    "none": lambda x: x,
    "relu": torch.relu,
    "logistic": torch.sigmoid,
    "exponential": density_activation_exp,
}


def rgb_activation(name: str):
    return _ACTIVATIONS_RGB[name.lower()]


def density_activation(name: str):
    return _ACTIVATIONS_DENSITY[name.lower()]


class CompositedRays(NamedTuple):
    rgb: torch.Tensor  # (N, 3) accumulated color, no background
    depth: torch.Tensor  # (N,) weighted depth
    opacity: torch.Tensor  # (N,) 1 - final transmittance
    transmittance: torch.Tensor  # (N,) after the last used sample
    weights: torch.Tensor  # (N, K) compositing weights
    used: torch.Tensor  # (N, K) samples composited (T ≥ min_transmittance)


def composite(rgb_samples: torch.Tensor, sigma: torch.Tensor,
              dt: torch.Tensor, t_mid: torch.Tensor, valid: torch.Tensor,
              min_transmittance: float = 1e-4) -> CompositedRays:
    """``alpha = 1 - exp(-sigma·dt)`` (0 at invalid slots), transmittance
    ``T`` the exclusive product of ``1 - alpha`` taken in log space;
    samples after ``T`` falls below ``min_transmittance`` are cut, as in the
    reference's early-out."""
    alpha = torch.where(
        valid, torch.clamp(1.0 - torch.exp(-sigma * dt), 0.0, 1.0 - 1e-7), 0.0
    )
    log_one_minus = torch.log1p(-alpha)
    logT = torch.cat(
        [torch.zeros_like(alpha[:, :1]), torch.cumsum(log_one_minus[:, :-1], dim=1)],
        dim=1,
    )
    T = torch.exp(logT)
    used = valid & (T >= min_transmittance)
    w = torch.where(used, alpha * T, 0.0)
    rgb = torch.einsum("nk,nkc->nc", w, rgb_samples)
    depth = torch.sum(w * t_mid, dim=1)
    T_final = torch.exp(torch.sum(torch.where(used, log_one_minus, 0.0), dim=1))
    return CompositedRays(rgb, depth, 1.0 - T_final, T_final, w, used)

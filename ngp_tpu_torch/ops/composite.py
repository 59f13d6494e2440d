"""Activations, front-to-back compositing and the NeRF training loss, the
port of ``ngp_tpu/ops/composite.py``. Autograd through the composite gives
the reference kernel's hand-written gradients (its "suffix trick" is the
transpose of the log-space cumulative product); the density activation
carries its own clamped derivative."""

from __future__ import annotations

from typing import NamedTuple

import torch


class _DensityExp(torch.autograd.Function):
    """exp clamped at e^30; derivative exp(clip(x, −15, 15)), the
    reference's asymmetric clamp (the JAX package's custom JVP)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(torch.clamp_max(x, 30.0))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.exp(torch.clamp(x, -15.0, 15.0)) * g


def density_activation_exp(x: torch.Tensor) -> torch.Tensor:
    """Density activation: forward exp clamped at e^30, derivative
    exp(clip(x, −15, 15))."""
    return _DensityExp.apply(x)


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


class TrainingLoss(NamedTuple):
    loss: torch.Tensor  # () scalar to differentiate
    loss_display: torch.Tensor  # () mean color loss / 3
    per_ray_loss: torch.Tensor  # (N,) color loss / 3, detached
    rgb_ray: torch.Tensor  # (N, 3)
    depth_ray: torch.Tensor  # (N,)
    measured_samples: torch.Tensor  # () int, samples composited


def nerf_training_loss(raw, dt, t_mid, valid, complete, background, target,
                       loss_fn, rgb_act: str, density_act: str,
                       mean_density: torch.Tensor,
                       depth_sample: torch.Tensor | None = None,
                       near_distance: float = 0.0,
                       target_depth: torch.Tensor | None = None,
                       depth_lambda: float = 0.0) -> TrainingLoss:
    """Scalar training loss whose gradient matches the reference kernel
    (``compute_loss_kernel_train_nerf``, ``testbed_nerf.cu:1660-2012``):

    - per-ray color loss summed over channels, averaged over rays;
    - for Exponential rgb only, the output L2 penalty 1e-4·relu(raw)²/2;
    - the density L1 bootstrap −1e-4 per negative raw density of a used
      sample while ``mean_density`` < 0.01;
    - with ``depth_lambda`` > 0, λ·L1 between the composited depth and
      ``target_depth`` for rays that have one (> 0);
    - with ``near_distance`` > 0, +1e-4 per raw density of a used sample
      closer than it (and above −10).

    ``raw`` (N, K, 4) raw network output; ``dt``, ``t_mid``, ``valid``
    (N, K); ``complete`` (N,) adds the background; ``background`` and
    ``target`` (N, 3) in the loss color space."""
    n_rays = raw.shape[0]
    rgb = rgb_activation(rgb_act)(raw[..., :3])
    sigma = density_activation(density_act)(raw[..., 3])
    comp = composite(rgb, sigma, dt, t_mid, valid)

    add_bg = complete & (comp.transmittance > 0.0)
    rgb_ray = comp.rgb + torch.where(add_bg, comp.transmittance, 0.0)[:, None] * background
    color_loss = torch.sum(loss_fn(target, rgb_ray), dim=-1)  # (N,)
    loss = torch.mean(color_loss)

    raw_sigma = raw[..., 3]
    used = comp.used
    if rgb_act.lower() == "exponential":
        reg = 0.5e-4 * torch.sum(
            torch.where(used[..., None], torch.relu(raw[..., :3]) ** 2, 0.0))
        loss = loss + reg / n_rays

    density_l1 = 1e-4 * torch.sum(torch.where(used, torch.relu(-raw_sigma), 0.0))
    loss = loss + torch.where(mean_density < 0.01, density_l1, 0.0) / n_rays

    if depth_lambda > 0.0 and target_depth is not None:
        has_d = target_depth > 0.0
        depth_err = torch.abs(target_depth - comp.depth)
        loss = loss + depth_lambda * torch.sum(torch.where(has_d, depth_err, 0.0)) / n_rays

    if near_distance > 0.0 and depth_sample is not None:
        near = used & (depth_sample < near_distance) & (raw_sigma > -10.0)
        loss = loss + 1e-4 * torch.sum(torch.where(near, raw_sigma, 0.0)) / n_rays

    return TrainingLoss(
        loss, torch.mean(color_loss).detach() / 3.0, color_loss.detach() / 3.0,
        rgb_ray, comp.depth, torch.sum(used),
    )

"""sRGB transfer curves, the port of ``srgb_to_linear`` and
``linear_to_srgb`` of ``ngp_tpu/ops/tonemap.py`` (the reference's
``common_device.cuh:75-122``). The tonemapping operators are not yet
ported."""

from __future__ import annotations

import torch


def srgb_to_linear(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x <= 0.0031308, 12.92 * x,
                       1.055 * torch.clamp_min(x, 1e-9) ** (1.0 / 2.4) - 0.055)

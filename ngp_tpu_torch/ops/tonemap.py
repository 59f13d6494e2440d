"""Colour-space conversions and tonemapping curves on tensors, the port of
``ngp_tpu/ops/tonemap.py``: the sRGB curves of the reference's
``common_device.cuh:75-122`` and the ACES, Hable and Reinhard operators of
``src/render_buffer.cu``'s ``tonemap`` (``render_frame_epilogue``)."""

from __future__ import annotations

import torch


def srgb_to_linear(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x <= 0.0031308, 12.92 * x,
                       1.055 * torch.clamp_min(x, 1e-9) ** (1.0 / 2.4) - 0.055)


def tonemap_reinhard(x: torch.Tensor) -> torch.Tensor:
    return x / (x + 1.0)


def tonemap_aces(x: torch.Tensor) -> torch.Tensor:
    """Narkowicz's ACES fit, as the reference's render buffer uses it."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def tonemap_hable(x: torch.Tensor) -> torch.Tensor:
    def f(v):
        A, B, C, D, E, F = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
        return ((v * (A * v + C * B) + D * E) / (v * (A * v + B) + D * F)) - E / F

    white = torch.tensor(11.2, dtype=x.dtype, device=x.device)
    return f(x) / f(white)


TONEMAPS = {
    "identity": lambda x: x,
    "reinhard": tonemap_reinhard,
    "aces": tonemap_aces,
    "hable": tonemap_hable,
}


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    return 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]

"""The lat-long environment map read, the port of ``ngp_tpu/ops/envmap.py``
(``envmap.cuh``): directions are swizzled ``(z, -x, y)``, mapped with
``dir_to_spherical_unorm`` (``random_val.cuh:61-71``) to ``(theta/π,
phi/2π + 0.5)``, then read bilinearly at ``(phi·(W−1), theta·(H−1))``
with the x index wrapped and the y index clamped (``envmap.cuh:29-56``).

Plain PyTorch: the forward is a 4-corner gather, and autograd's transpose
of it is the 4-corner deposit of ``deposit_envmap_gradient``
(``envmap.cuh:58-96``). About 4·n_rays elements a step, far off the hot
path; no TPU kernel computes it.

The map holds linear HDR colour. The NeRF engine trains it through the
sRGB background mix (``linear_to_srgb`` of the mixed background inside
the differentiated loss), as the JAX engine does.
"""

from __future__ import annotations

import math

import torch


def dir_to_latlong_uv(dirs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Unit directions (N, 3) → (theta_norm, phi_norm) in [0, 1]², after the
    ``(z, -x, y)`` swizzle (``envmap.cuh:30``)."""
    dz, dnx, dy = dirs[:, 2], -dirs[:, 0], dirs[:, 1]
    theta = torch.arccos(torch.clamp(dy, -1.0, 1.0)) / math.pi
    phi = torch.atan2(dnx, dz) / (2.0 * math.pi) + 0.5
    return theta, phi


def read_envmap(envmap: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Bilinear lat-long lookup: ``envmap`` (H, W, 4) linear HDR, ``dirs``
    (N, 3) unit world directions → (N, 4), differentiable in ``envmap``."""
    H, W, _ = envmap.shape
    theta, phi = dir_to_latlong_uv(dirs)
    fx = phi * (W - 1)
    fy = theta * (H - 1)
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    wx = (fx - x0)[:, None]
    wy = (fy - y0)[:, None]
    x0, y0 = x0.to(torch.int64), y0.to(torch.int64)

    def at(xi, yi):
        xi = torch.where(xi < 0, xi + W, torch.where(xi >= W, xi - W, xi))
        return envmap[torch.clamp(yi, 0, H - 1), xi]

    return ((1 - wx) * (1 - wy) * at(x0, y0)
            + wx * (1 - wy) * at(x0 + 1, y0)
            + (1 - wx) * wy * at(x0, y0 + 1)
            + wx * wy * at(x0 + 1, y0 + 1))

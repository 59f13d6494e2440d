"""Camera lenses and pixel directions, the port of the pinhole subset of
``ngp_tpu/geometry/camera.py`` and ``NerfEngine._pixel_dirs_cam``.

The other lens modes (OpenCV, OpenCV fisheye, F-theta, lat-long,
equirectangular) are not yet ported and raise."""

from __future__ import annotations

from typing import NamedTuple

import torch

# Lens modes, mirroring ELensMode (common.h)
LENS_PINHOLE = 0
LENS_OPENCV = 1
LENS_OPENCV_FISHEYE = 2
LENS_FTHETA = 3
LENS_LATLONG = 4
LENS_EQUIRECT = 5


class Lens(NamedTuple):
    mode: int = LENS_PINHOLE
    params: tuple = (0.0,) * 7


def pixel_dirs_cam(lens: Lens, resolution, uv: torch.Tensor,
                   focal: torch.Tensor, pp: torch.Tensor) -> torch.Tensor:
    """Camera-space directions (N, 3) for ``uv`` (N, 2) in [0, 1]² with
    per-ray ``focal`` (N, 2) in pixels and principal point ``pp`` (N, 2):
    the pinhole branch of the reference's ``uv_to_ray``, unnormalized with
    z = 1. ``resolution`` is (W, H)."""
    if lens.mode != LENS_PINHOLE:
        raise ValueError(f"lens mode {lens.mode} is not yet ported (pinhole only)")
    W, H = resolution
    x = (uv[:, 0] - pp[:, 0]) * W / focal[:, 0]
    y = (uv[:, 1] - pp[:, 1]) * H / focal[:, 1]
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)

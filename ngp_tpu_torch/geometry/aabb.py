"""Axis-aligned bounding boxes, the port of ``ngp_tpu/geometry/aabb.py``
(the subset rendering needs). Boxes are ``(min, max)`` float32 (3,)
tensors; operations broadcast over leading axes."""

from __future__ import annotations

from typing import NamedTuple

import torch


class AABB(NamedTuple):
    min: torch.Tensor  # (3,)
    max: torch.Tensor  # (3,)

    @staticmethod
    def from_scale(aabb_scale: float, device="cpu") -> "AABB":
        """The reference's NeRF box: the unit cube inflated around 0.5 by
        ``aabb_scale`` (``load_nerf_post``)."""
        h = 0.5 * aabb_scale
        return AABB(
            torch.full((3,), 0.5 - h, dtype=torch.float32, device=device),
            torch.full((3,), 0.5 + h, dtype=torch.float32, device=device),
        )

    def diag(self) -> torch.Tensor:
        return self.max - self.min

    def relative_pos(self, pos: torch.Tensor) -> torch.Tensor:
        """Warp a scene position into [0, 1]³ (``warp_position``)."""
        return (pos - self.min) / self.diag()

"""Foveated-rendering warp, the port of ``ngp_tpu/geometry/foveation.py``
(the reference's ``FoveationPiecewiseQuadratic`` and ``Foveation``,
common_device.cuh:158-288): a 1-D warp from the render buffer's [0, 1]
coordinate to the full image's, linear (slope ``am``) around the focus and
quadratic toward the edges. The coefficients come from the reference's
20-step bisection on the host (Python floats); ``warp``, ``unwarp`` and
``density`` act on float32 tensors of any shape.

``NerfEngine.render_view_foveated`` renders a small buffer whose pixels
are warped toward the focus and resamples it to full resolution.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class PiecewiseQuadratic:
    al: float = 0.0
    bl: float = 0.0
    cl: float = 0.0
    am: float = 1.0
    bm: float = 0.0
    ar: float = 0.0
    br: float = 0.0
    cr: float = 0.0
    switch_left: float = 0.0
    switch_right: float = 1.0
    inv_switch_left: float = 0.0
    inv_switch_right: float = 1.0

    @staticmethod
    def make(center_pixel_steepness: float, center_y: float,
             center_radius: float) -> "PiecewiseQuadratic":
        """The reference's constructor (common_device.cuh:160-222):
        ``center_pixel_steepness`` the buffer's density at the focus,
        ``center_y`` the focus in the full image, ``center_radius`` the
        half-width of its band."""
        am = center_pixel_steepness
        cir = center_radius * am
        lsw = max(center_y - cir, 0.0)
        rsw = min(center_y + cir, 1.0)
        d = (rsw - lsw) / am / 2.0
        bm = 0.0
        m_min, m_max = 0.0, 1.0
        for _ in range(20):
            m = (m_min + m_max) / 2.0
            l = m - d  # noqa: E741
            r = m + d
            bm = -((am - 1.0) * l * l) / (r * r - 2.0 * r + l * l + 1.0)
            if ((lsw - bm) / am + (rsw - bm) / am) / 2.0 > m:
                m_min = m
            else:
                m_max = m
        l = (lsw - bm) / am  # noqa: E741
        r = (rsw - bm) / am
        if (l == 0.0 and r == 1.0) or am == 1.0:
            return PiecewiseQuadratic()
        den = r * r - 2.0 * r + l * l + 1.0
        bm = -((am - 1.0) * l * l) / den
        return PiecewiseQuadratic(
            al=(am - 1.0) / den,
            bl=(am * (r * r - 2.0 * r + 1.0) + am * l * l + (2.0 - 2.0 * am) * l) / den,
            cl=0.0, am=am, bm=bm, ar=-(am - 1.0) / den,
            br=(am * (r * r + 1.0) - 2.0 * r + am * l * l) / den,
            cr=-(am * r * r - r * r + (am - 1.0) * l * l) / den,
            switch_left=l, switch_right=r,
            inv_switch_left=am * l + bm, inv_switch_right=am * r + bm,
        )

    def warp(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.clamp(x, 0.0, 1.0)
        left = self.al * x * x + self.bl * x + self.cl
        mid = self.am * x + self.bm
        right = self.ar * x * x + self.br * x + self.cr
        return torch.where(x < self.switch_left, left,
                           torch.where(x > self.switch_right, right, mid))

    def unwarp(self, y: torch.Tensor) -> torch.Tensor:
        y = torch.clamp(y, 0.0, 1.0)
        mid = (y - self.bm) / self.am
        if self.al == 0.0 and self.ar == 0.0:
            return mid

        def root(a, b, c):
            disc = torch.clamp_min(-4.0 * a * c + 4.0 * a * y + b * b, 0.0)
            return (torch.sqrt(disc) - b) / (2.0 * a if a != 0.0 else 1.0)

        return torch.where(y < self.inv_switch_left, root(self.al, self.bl, self.cl),
                           torch.where(y > self.inv_switch_right,
                                       root(self.ar, self.br, self.cr), mid))

    def density(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.clamp(x, 0.0, 1.0)
        return torch.where(x < self.switch_left, 2.0 * self.al * x + self.bl,
                           torch.where(x > self.switch_right, 2.0 * self.ar * x + self.br,
                                       torch.full_like(x, self.am)))


@dataclass(frozen=True)
class Foveation:
    """Independent x and y warps (``Foveation``, common_device.cuh:268-288)."""

    warp_x: PiecewiseQuadratic
    warp_y: PiecewiseQuadratic

    @staticmethod
    def make(steepness, center, radius) -> "Foveation":
        """Each argument a scalar or an (x, y) pair."""
        sx, sy = (steepness, steepness) if np.isscalar(steepness) else steepness
        cx, cy = (center, center) if np.isscalar(center) else center
        rx, ry = (radius, radius) if np.isscalar(radius) else radius
        return Foveation(PiecewiseQuadratic.make(sx, cx, rx),
                         PiecewiseQuadratic.make(sy, cy, ry))

    def warp(self, uv: torch.Tensor) -> torch.Tensor:
        return torch.stack([self.warp_x.warp(uv[..., 0]), self.warp_y.warp(uv[..., 1])], -1)

    def unwarp(self, uv: torch.Tensor) -> torch.Tensor:
        return torch.stack([self.warp_x.unwarp(uv[..., 0]),
                            self.warp_y.unwarp(uv[..., 1])], -1)

    def density(self, uv: torch.Tensor) -> torch.Tensor:
        return self.warp_x.density(uv[..., 0]) * self.warp_y.density(uv[..., 1])

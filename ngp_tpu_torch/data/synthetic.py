"""A synthetic scene that needs no file: an opaque sphere of radius 0.2 at
the scene center, color (0.9, 0.3, 0.2), seen by a ring of pinhole cameras.
The port's copy of the JAX package's ``__graft_entry__._tiny_sphere_dataset``
(the bench's fallback scene when no capture is present)."""

from __future__ import annotations

import math

import numpy as np

from ngp_tpu_torch.data.nerf_loader import NerfDataset
from ngp_tpu_torch.geometry.camera import Lens


def tiny_sphere_dataset(n_views: int = 6, res: int = 32) -> NerfDataset:
    """``n_views`` res×res RGBA views from eyes on a circle of radius 1.1
    around the center at height 0.3·1.1, looking at the center; focal
    length ``res`` pixels."""
    center = np.asarray([0.5, 0.5, 0.5], np.float32)
    focal = float(res)

    def lookat(eye):
        f = center - eye
        f /= np.linalg.norm(f)
        up = np.asarray([0.0, 0.0, 1.0], np.float32)
        r = np.cross(f, up)
        r /= np.linalg.norm(r)
        d = np.cross(f, r)
        m = np.zeros((3, 4), np.float32)
        m[:, 0], m[:, 1], m[:, 2], m[:, 3] = r, d, f, eye
        return m

    xforms, images = [], []
    for i in range(n_views):
        ang = 2 * math.pi * i / n_views
        eye = center + np.asarray([math.cos(ang), math.sin(ang), 0.3], np.float32) * 1.1
        xf = lookat(eye)
        u = (np.arange(res) + 0.5) / res
        uu, vv = np.meshgrid(u, u)
        x = (uu - 0.5) * res / focal
        y = (vv - 0.5) * res / focal
        dc = np.stack([x, y, np.ones_like(x)], -1)
        d = dc @ xf[:, :3].T
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        oc = xf[:, 3] - center
        b = np.einsum("hwc,c->hw", d, oc)
        hit = b * b - (oc @ oc - 0.04) > 0
        img = np.zeros((res, res, 4), np.float32)
        img[hit] = (0.9, 0.3, 0.2, 1.0)
        images.append((img * 255).astype(np.uint8))
        xforms.append(np.stack([xf, xf]))

    return NerfDataset(
        images=np.stack(images),
        xforms=np.stack(xforms),
        focal_lengths=np.full((n_views, 2), focal, np.float32),
        principal_points=np.full((n_views, 2), 0.5, np.float32),
        lens=Lens(),
        resolution=(res, res),
        aabb_scale=1,
    )

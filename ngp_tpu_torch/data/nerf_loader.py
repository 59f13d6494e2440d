"""The NeRF dataset container, the port of ``NerfDataset`` in
``ngp_tpu/data/nerf_loader.py``. Loading ``transforms.json`` with its
images (``load_nerf``) is not yet ported: it needs image decoding."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ngp_tpu_torch.geometry.camera import Lens


@dataclass
class NerfDataset:
    """Host-side dataset in NGP conventions; all images share a
    resolution."""

    images: np.ndarray  # (N, H, W, 4) uint8 sRGB+A (or float16 if HDR)
    xforms: np.ndarray  # (N, 2, 3, 4) float32 start/end camera-to-world
    focal_lengths: np.ndarray  # (N, 2) pixels
    principal_points: np.ndarray  # (N, 2) in [0, 1]
    lens: Lens
    resolution: tuple  # (W, H)
    aabb_scale: int = 1
    is_hdr: bool = False
    n_extra_learnable_dims: int = 0

    @property
    def n_images(self) -> int:
        return self.images.shape[0]

"""Image loading, the port of ``ngp_tpu/data/image_loader.py``: EXR
(float, linear colours), PNG through the port's own decoder (sRGB →
linear), and the raw ``.bin`` gigapixel format (int32 height, int32 width,
then half RGBA)."""

from __future__ import annotations

import struct

import numpy as np

from ngp_tpu_torch.data.exr import read_exr
from ngp_tpu_torch.data.png import read_png_rgba


def srgb_to_linear_np(x: np.ndarray) -> np.ndarray:
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def load_image(path: str) -> np.ndarray:
    """Returns (H, W, 4) float32 in *linear* color (alpha=1 where missing).
    Formats: ``.exr``, ``.bin`` and PNG (JPEG is not yet ported)."""
    p = path.lower()
    if p.endswith(".exr"):
        img = read_exr(path)
    elif p.endswith(".bin"):
        img = load_binary_image(path)
    elif p.endswith(".png"):
        arr = read_png_rgba(path).astype(np.float32) / 255.0
        img = arr.copy()
        img[..., :3] = srgb_to_linear_np(arr[..., :3])
    else:
        raise NotImplementedError(f"{path}: only PNG, EXR and .bin images are read "
                                  "(JPEG is not yet ported)")
    if img.shape[-1] == 3:
        img = np.concatenate([img, np.ones_like(img[..., :1])], axis=-1)
    elif img.shape[-1] < 3:
        img = np.concatenate(
            [np.repeat(img[..., :1], 3, axis=-1), np.ones_like(img[..., :1])], -1
        )
    return img.astype(np.float32)


def load_binary_image(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        h, w = struct.unpack("<ii", f.read(8))
        data = np.frombuffer(f.read(h * w * 4 * 2), np.float16)
    return data.reshape(h, w, 4).astype(np.float32)


def save_binary_image(path: str, img: np.ndarray) -> None:
    h, w = img.shape[:2]
    if img.shape[-1] == 3:
        img = np.concatenate([img, np.ones_like(img[..., :1])], axis=-1)
    with open(path, "wb") as f:
        f.write(struct.pack("<ii", h, w))
        f.write(img.astype(np.float16).tobytes())

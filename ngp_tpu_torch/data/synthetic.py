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


# The written capture's scene: an opaque sphere in NGP space whose albedo
# varies smoothly with the surface normal n: channel i is
# 0.5 + 0.4·sin(3·n·axis_i + phase_i).
CAPTURE_CENTER = (0.5, 0.5, 0.5)
CAPTURE_RADIUS = 0.25
CAPTURE_TRAIN_VIEWS = 24
CAPTURE_TEST_VIEWS = 4
_ALBEDO_AXES = np.asarray([[0.8, 0.6, 0.0], [0.0, 0.6, -0.8], [0.6, 0.0, 0.8]], np.float32)
_ALBEDO_PHASES = np.asarray([0.3, 1.7, 4.1], np.float32)


def _capture_lookat(eye: np.ndarray) -> np.ndarray:
    """NGP camera-to-world (3, 4) from ``eye`` toward the center, +z up."""
    fwd = np.asarray(CAPTURE_CENTER, np.float32) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray([0.0, 0.0, 1.0], np.float32))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    return np.stack([right, down, fwd, eye], axis=1).astype(np.float32)


def _capture_eyes(n: int, heights, distance: float, phase: float) -> list:
    """``n`` eyes at ``distance`` from the center, at angles
    2π(k + phase)/n, cycling through ``heights`` (z before scaling)."""
    eyes = []
    for k in range(n):
        a = 2.0 * math.pi * (k + phase) / n
        v = np.asarray([math.cos(a), math.sin(a), heights[k % len(heights)]], np.float32)
        eyes.append(np.asarray(CAPTURE_CENTER, np.float32) + distance * v / np.linalg.norm(v))
    return eyes


def _render_capture_view(xform: np.ndarray, res: int, focal, pp_uv, lens: Lens,
                        device="cpu") -> np.ndarray:
    """(res, res, 4) uint8 sRGB + alpha of the capture's sphere, seen by
    camera ``xform`` (NGP, 3 × 4) through ``lens`` at the pixel centers, by
    the port's ``uv_to_ray``: albedo where the ray hits, transparent black
    elsewhere."""
    import torch

    from ngp_tpu_torch.geometry.camera import uv_to_ray

    u = (torch.arange(res, dtype=torch.float32, device=device) + 0.5) / res
    uv = torch.stack(torch.meshgrid(u, u, indexing="xy"), -1).reshape(-1, 2)
    o, d = uv_to_ray(uv, (res, res), focal, torch.as_tensor(xform, device=device),
                     pp_uv, lens)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    oc = o - torch.as_tensor(CAPTURE_CENTER, device=device)
    b = (d * oc).sum(-1)
    disc = b * b - ((oc * oc).sum(-1) - CAPTURE_RADIUS ** 2)
    hit = disc > 0
    t = -b - torch.sqrt(torch.clamp_min(disc, 0.0))
    normal = (oc + t[:, None] * d) / CAPTURE_RADIUS
    axes = torch.as_tensor(_ALBEDO_AXES, device=device)
    phases = torch.as_tensor(_ALBEDO_PHASES, device=device)
    rgb = 0.5 + 0.4 * torch.sin(3.0 * normal @ axes.T + phases)
    rgba = torch.cat([rgb, torch.ones_like(rgb[:, :1])], -1) * hit[:, None]
    img = (torch.clamp(rgba, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
    return img.reshape(res, res, 4).cpu().numpy()


def write_sphere_capture(out_dir: str, res: int = 800, device="cpu") -> tuple[str, str]:
    """Write a capture of the textured sphere in the transforms dialect of
    instant-ngp's fox scene, with PNG frames: ``transforms_train.json`` and
    ``transforms_test.json`` in ``out_dir``, frames ``train/r_<i>.png`` and
    ``test/r_<i>.png`` (``file_path`` without extension), res × res RGBA
    (``CAPTURE_TRAIN_VIEWS`` and ``CAPTURE_TEST_VIEWS`` of them),
    written by ``data/png.py`` with the five filter types cycled row by row.

    Top-level keys: ``fl_x``, ``fl_y``, an off-center ``cx``/``cy``, the
    OpenCV lens ``k1 = -0.1, k2 = 0.02, p1 = 1e-3, p2 = -1e-3``,
    ``aabb_scale`` 2; the default scale 0.33 and offset 0.5 map the NeRF
    matrices to NGP space. Train eyes lie on two rings (heights 0.35 and
    −0.15 before normalizing, distance 1.2 from the center), half of them
    on each; test eyes lie halfway between train eyes in angle, at the
    middle height. Returns the two json paths."""
    import json
    import os

    from ngp_tpu_torch.data.nerf_loader import NERF_SCALE, ngp_matrix_to_nerf
    from ngp_tpu_torch.data.png import write_png
    from ngp_tpu_torch.geometry.camera import LENS_OPENCV

    distortion = {"k1": -0.1, "k2": 0.02, "p1": 1e-3, "p2": -1e-3}
    lens = Lens(LENS_OPENCV, tuple(distortion.values()) + (0.0, 0.0, 0.0))
    focal = (1.375 * res, 1.38 * res)
    cx, cy = 0.515 * res, 0.489 * res
    offset = np.full(3, 0.5, np.float32)
    meta = {"fl_x": focal[0], "fl_y": focal[1], "cx": cx, "cy": cy, "w": res, "h": res,
            **distortion, "aabb_scale": 2}
    sets = {
        "train": _capture_eyes(CAPTURE_TRAIN_VIEWS, (0.35, -0.15), 1.2, 0.0),
        "test": _capture_eyes(CAPTURE_TEST_VIEWS, (0.1,), 1.2,
                              0.5 * CAPTURE_TEST_VIEWS / CAPTURE_TRAIN_VIEWS),
    }
    paths = []
    for split, eyes in sets.items():
        os.makedirs(os.path.join(out_dir, split), exist_ok=True)
        frames = []
        for i, eye in enumerate(eyes):
            xf = _capture_lookat(eye)
            img = _render_capture_view(xf, res, focal, (cx / res, cy / res), lens, device)
            write_png(os.path.join(out_dir, split, f"r_{i}.png"), img)
            m = np.eye(4)
            m[:3] = ngp_matrix_to_nerf(xf, NERF_SCALE, offset)
            frames.append({"file_path": f"./{split}/r_{i}", "transform_matrix": m.tolist()})
        path = os.path.join(out_dir, f"transforms_{split}.json")
        with open(path, "w") as f:
            json.dump({**meta, "frames": frames}, f, indent=1)
        paths.append(path)
    return tuple(paths)

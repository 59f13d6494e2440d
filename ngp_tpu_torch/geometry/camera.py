"""Camera lenses and ray generation, the port of
``ngp_tpu/geometry/camera.py`` and ``NerfEngine._pixel_dirs_cam``:
pinhole, OpenCV (Brown) and OpenCV-fisheye distortion with iterative
undistortion, F-theta, lat-long and equirectangular lenses, screen-center
offsets and thin-lens aperture sampling, in the NGP camera-matrix
convention (3×4, columns right, down, forward, origin).

Undistortion is the JAX package's fixed-count Newton iteration: 10 steps
from the distorted point, each solving the 2×2 system with the
distortion's Jacobian. The JAX package takes the Jacobian by autodiff; here
it is in closed form (``torch.func``'s forward mode costs milliseconds of
host time a call, and training rays undistort every step). Newton
converges to the same fixed point, so the two agree to float32 rounding.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
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


def lookat_rays(eye, lookat, resolution, fov_deg: float):
    """Pinhole rays (origins, unit dirs) (H·W, 3) float32 numpy, row-major,
    y down, ``fov_deg`` across the width, from ``eye`` toward ``lookat``
    with world up +y: the JAX SDF and volume engines' ``render_image``
    cameras."""
    W, H = resolution
    eye = np.asarray(eye, np.float32)
    fwd = np.asarray(lookat, np.float32) - eye
    fwd /= np.linalg.norm(fwd)
    up = np.asarray([0, 1, 0], np.float32)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    f = 0.5 / math.tan(0.5 * math.radians(fov_deg))
    px, py = np.meshgrid((np.arange(W) + 0.5) / W - 0.5, (np.arange(H) + 0.5) / H - 0.5)
    d = (px[..., None] * right + py[..., None] * down + f * fwd).reshape(-1, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.repeat(eye[None], len(d), axis=0), d.astype(np.float32)


def fov_to_focal_length(resolution_px: float, degrees: float) -> float:
    return 0.5 * resolution_px / np.tan(0.5 * np.radians(degrees))


def focal_length_to_fov(resolution_px: float, focal: float) -> float:
    return float(2.0 * np.degrees(np.arctan(0.5 * resolution_px / focal)))


def opencv_lens_distortion_delta(params, u, v):
    """Brown radial/tangential distortion delta (k1, k2, p1, p2)
    (``common_device.cuh:290-303``)."""
    k1, k2, p1, p2 = params[0], params[1], params[2], params[3]
    u2, v2, uv = u * u, v * v, u * v
    r2 = u2 + v2
    radial = k1 * r2 + k2 * r2 * r2
    du = u * radial + 2.0 * p1 * uv + p2 * (r2 + 2.0 * u2)
    dv = v * radial + 2.0 * p2 * uv + p1 * (r2 + 2.0 * v2)
    return du, dv


def opencv_fisheye_lens_distortion_delta(params, u, v):
    """Equidistant fisheye distortion delta (k1..k4)."""
    k1, k2, k3, k4 = params[0], params[1], params[2], params[3]
    r = torch.sqrt(u * u + v * v)
    safe_r = torch.clamp_min(r, 1e-12)
    theta = torch.atan(safe_r)
    t2 = theta * theta
    thetad = theta * (1 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    scale = torch.where(r > 1e-12, thetad / safe_r - 1.0, torch.zeros_like(r))
    return u * scale, v * scale


def opencv_lens_distortion_jacobian(params, u, v):
    """∂(du, dv)/∂(u, v) of :func:`opencv_lens_distortion_delta`, as
    (∂du/∂u, ∂du/∂v, ∂dv/∂u, ∂dv/∂v)."""
    k1, k2, p1, p2 = params[0], params[1], params[2], params[3]
    r2 = u * u + v * v
    radial = k1 * r2 + k2 * r2 * r2
    g = 2.0 * (k1 + 2.0 * k2 * r2)  # ∂radial/∂u = g·u
    cross = g * u * v
    return (radial + g * u * u + 2.0 * p1 * v + 6.0 * p2 * u,
            cross + 2.0 * p1 * u + 2.0 * p2 * v,
            cross + 2.0 * p2 * v + 2.0 * p1 * u,
            radial + g * v * v + 2.0 * p2 * u + 6.0 * p1 * v)


def opencv_fisheye_lens_distortion_jacobian(params, u, v):
    """∂(du, dv)/∂(u, v) of :func:`opencv_fisheye_lens_distortion_delta`;
    0 at r ≤ 1e-12, where the delta is held at 0."""
    k1, k2, k3, k4 = params[0], params[1], params[2], params[3]
    r = torch.sqrt(u * u + v * v)
    safe_r = torch.clamp_min(r, 1e-12)
    theta = torch.atan(safe_r)
    t2 = theta * theta
    thetad = theta * (1 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    scale = thetad / safe_r - 1.0
    dthetad = (1 + t2 * (3 * k1 + t2 * (5 * k2 + t2 * (7 * k3 + t2 * 9 * k4)))) / (1 + r * r)
    ds_r = (dthetad * safe_r - thetad) / (safe_r * safe_r * safe_r)  # ∂scale/∂r / r
    live = r > 1e-12
    zero = torch.zeros_like(r)
    cross = torch.where(live, ds_r * u * v, zero)
    return (torch.where(live, scale + ds_r * u * u, zero), cross, cross,
            torch.where(live, scale + ds_r * v * v, zero))


_JACOBIANS = {
    opencv_lens_distortion_delta: opencv_lens_distortion_jacobian,
    opencv_fisheye_lens_distortion_delta: opencv_fisheye_lens_distortion_jacobian,
}


def iterative_undistortion(delta_fn, params, u, v, iters: int = 10):
    """Invert ``x ↦ x + delta(x)`` by ``iters`` Newton steps from x = (u, v),
    each with the per-point 2×2 Jacobian in closed form; ``delta_fn`` is
    one of the two OpenCV distortion deltas."""
    jac_fn = _JACOBIANS[delta_fn]
    x, y = u, v
    for _ in range(iters):
        du, dv = delta_fn(params, x, y)
        ru, rv = x + du - u, y + dv - v
        j00, j01, j10, j11 = jac_fn(params, x, y)
        j00, j11 = 1.0 + j00, 1.0 + j11
        det = j00 * j11 - j01 * j10
        x, y = x - (j11 * ru - j01 * rv) / det, y - (-j10 * ru + j00 * rv) / det
    return x, y


def latlong_to_dir(uv):
    theta = (uv[..., 1] - 0.5) * math.pi
    phi = (uv[..., 0] - 0.5) * 2.0 * math.pi
    ct, st = torch.cos(theta), torch.sin(theta)
    cp, sp = torch.cos(phi), torch.sin(phi)
    return torch.stack([sp * ct, st, cp * ct], dim=-1)


def equirectangular_to_dir(uv):
    ct = (uv[..., 1] - 0.5) * 2.0
    st = torch.sqrt(torch.clamp_min(1.0 - ct * ct, 0.0))
    phi = (uv[..., 0] - 0.5) * 2.0 * math.pi
    return torch.stack([torch.sin(phi) * st, ct, torch.cos(phi) * st], dim=-1)


def f_theta_undistortion(uv_centered, params):
    """F-theta lens: polynomial angle model (r0..r4, resx, resy)."""
    xpix = uv_centered[..., 0] * params[5]
    ypix = uv_centered[..., 1] * params[6]
    norm = torch.sqrt(xpix * xpix + ypix * ypix)
    alpha = params[0] + norm * (
        params[1] + norm * (params[2] + norm * (params[3] + norm * params[4]))
    )
    sin_a, cos_a = torch.sin(alpha), torch.cos(alpha)
    safe = torch.clamp_min(norm, 1e-12)
    return torch.stack([sin_a / safe * xpix, sin_a / safe * ypix, cos_a], dim=-1)


def square2disk_shirley(uv):
    """Shirley's concentric square→disk map, for aperture sampling."""
    a, b = uv[..., 0], uv[..., 1]
    cond = torch.abs(a) > torch.abs(b)
    r = torch.where(cond, a, b)
    one = torch.ones_like(a)
    zero = torch.zeros_like(a)
    phi = torch.where(
        cond,
        (math.pi / 4.0) * torch.where(torch.abs(a) > 1e-12,
                                      b / torch.where(a == 0, one, a), zero),
        (math.pi / 2.0) - (math.pi / 4.0) * torch.where(
            torch.abs(b) > 1e-12, a / torch.where(b == 0, one, b), zero),
    )
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)


def grid_at_lerp(grid: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear lookup of a (H, W, C) uv-grid at uv ∈ [0, 1]², as
    ``Buffer2DView::at_lerp`` (common.h:384-399): the sample position is
    ``uv · resolution`` (no half-texel offset), corners clamped."""
    H, W = grid.shape[:2]
    fx = uv[..., 0] * W
    fy = uv[..., 1] * H
    x0 = torch.floor(fx).to(torch.int64)
    y0 = torch.floor(fy).to(torch.int64)
    wx = (fx - x0)[..., None]
    wy = (fy - y0)[..., None]

    def at(xi, yi):
        return grid[torch.clamp(yi, 0, H - 1), torch.clamp(xi, 0, W - 1)]

    return ((1 - wx) * (1 - wy) * at(x0, y0) + wx * (1 - wy) * at(x0 + 1, y0)
            + (1 - wx) * wy * at(x0, y0 + 1) + wx * wy * at(x0 + 1, y0 + 1))


def _lens_params(lens: Lens) -> tuple:
    """The lens parameters as float32 values in Python floats: scalar
    operands need no device copy (a tensor made from host values on a CUDA
    device would cost a copy and a stream sync at every call)."""
    return tuple(float(np.float32(p)) for p in lens.params)


def pixel_dirs_cam(lens: Lens, resolution, uv: torch.Tensor,
                   focal: torch.Tensor, pp: torch.Tensor) -> torch.Tensor:
    """Camera-space directions (N, 3) for ``uv`` (N, 2) in [0, 1]² with
    per-ray ``focal`` (N, 2) in pixels and principal point ``pp`` (N, 2),
    every lens of the reference's ``uv_to_ray``: pinhole, OpenCV and
    fisheye give unnormalized z = 1 directions, F-theta, lat-long and
    equirectangular unit ones. ``resolution`` is (W, H)."""
    params = _lens_params(lens)
    if lens.mode == LENS_FTHETA:
        return f_theta_undistortion(uv - pp, params)
    if lens.mode == LENS_LATLONG:
        return latlong_to_dir(uv)
    if lens.mode == LENS_EQUIRECT:
        return equirectangular_to_dir(uv)
    W, H = resolution
    x = (uv[:, 0] - pp[:, 0]) * W / focal[:, 0]
    y = (uv[:, 1] - pp[:, 1]) * H / focal[:, 1]
    if lens.mode == LENS_OPENCV:
        x, y = iterative_undistortion(opencv_lens_distortion_delta, params, x, y)
    elif lens.mode == LENS_OPENCV_FISHEYE:
        x, y = iterative_undistortion(opencv_fisheye_lens_distortion_delta, params, x, y)
    elif lens.mode != LENS_PINHOLE:
        raise ValueError(f"unknown lens mode {lens.mode}")
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def uv_to_ray(uv: torch.Tensor, resolution, focal_length, camera_matrix,
              screen_center, lens: Lens = Lens(), aperture_size: float = 0.0,
              focus_z: float = 1.0, aperture_uv: torch.Tensor | None = None,
              near_distance: float = 0.0):
    """World-space rays from uv (..., 2) in [0, 1]² (``uv_to_ray``,
    common_device.cuh:443-510): ``focal_length`` (2,) in pixels,
    ``camera_matrix`` (..., 3, 4) or (3, 4), ``screen_center`` (2,) in uv
    units; thin-lens depth of field when ``aperture_size`` > 0 and
    ``aperture_uv`` (..., 2) in [0, 1) is given. Returns
    (origin, direction); the direction is not normalized (z = 1 in camera
    space for the pinhole-family lenses)."""
    W, H = resolution
    params = _lens_params(lens)
    focal_length = torch.as_tensor(focal_length, dtype=torch.float32, device=uv.device)
    screen_center = torch.as_tensor(screen_center, dtype=torch.float32, device=uv.device)
    if lens.mode == LENS_FTHETA:
        dir_cam = f_theta_undistortion(uv - screen_center, params)
    elif lens.mode == LENS_LATLONG:
        dir_cam = latlong_to_dir(uv)
    elif lens.mode == LENS_EQUIRECT:
        dir_cam = equirectangular_to_dir(uv)
    else:
        x = (uv[..., 0] - screen_center[0]) * W / focal_length[0]
        y = (uv[..., 1] - screen_center[1]) * H / focal_length[1]
        if lens.mode == LENS_OPENCV:
            x, y = iterative_undistortion(opencv_lens_distortion_delta, params, x, y)
        elif lens.mode == LENS_OPENCV_FISHEYE:
            x, y = iterative_undistortion(opencv_fisheye_lens_distortion_delta,
                                          params, x, y)
        dir_cam = torch.stack([x, y, torch.ones_like(x)], dim=-1)

    camera_matrix = torch.as_tensor(camera_matrix, dtype=torch.float32, device=uv.device)
    rot = camera_matrix[..., :3, :3]
    origin = torch.broadcast_to(camera_matrix[..., :3, 3], dir_cam.shape[:-1] + (3,))
    direction = torch.einsum("...ij,...j->...i", rot, dir_cam)

    if aperture_size > 0.0 and aperture_uv is not None:
        lookat = origin + direction * focus_z
        blur = aperture_size * square2disk_shirley(aperture_uv * 2.0 - 1.0)
        offset = torch.einsum("...ij,...j->...i", rot[..., :, :2], blur)
        origin = origin + offset
        direction = (lookat - origin) / focus_z

    origin = origin + direction * near_distance
    return origin, direction


def pixel_to_uv(pixel_xy: torch.Tensor, resolution, jitter: torch.Tensor | None = None):
    """Pixel index → uv; with ``jitter=None`` snaps to pixel centers."""
    W, H = resolution
    off = 0.5 if jitter is None else jitter
    wh = torch.tensor([W, H], dtype=torch.float32, device=pixel_xy.device)
    return (pixel_xy.to(torch.float32) + off) / wh

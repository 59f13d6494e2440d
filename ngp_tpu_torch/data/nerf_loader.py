"""NeRF dataset loading, the port of ``ngp_tpu/data/nerf_loader.py``:
``transforms.json`` in the NGP dialect (the reference's
``src/nerf_loader.cu:259-730``), read with the port's own PNG, JPEG and
EXR codecs (``data/png.py``, ``data/jpeg.py``, ``data/exr.py``).

- Scene scale 0.33 and offset (0.5, 0.5, 0.5) by default, or the fit of a
  given ``aabb`` into the unit cube; the NeRF→NGP axis conversion (negate
  the Y/Z basis columns, cycle rows xyz←yzx).
- Intrinsics from ``fl_*``, ``camera_angle_*`` or ``*_fov``; principal
  point ``cx``/``cy``; OpenCV ``k1, k2, p1, p2`` or fisheye ``k1..k4``.
- ``aabb_scale`` (a power of two ≤ 128), ``up``, ``render_aabb``,
  ``n_extra_learnable_dims``, ``sharpness`` culling, start/end matrices,
  ``rolling_shutter``; 16-bit depth maps; the ``sharpen`` filter on HDR
  frames; per-frame ``rays_*.dat``; an environment map.
- Several json files in one directory are one dataset.

Frames are PNG (8 or 16 bit), JPEG or EXR. A thread pool reads the PNG
and EXR files, and C++ threads decode the JPEG files; images stay uint8
sRGB with alpha (float16 for EXR) host arrays.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import warnings
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from ngp_tpu_torch.data.exr import read_exr
from ngp_tpu_torch.data.jpeg import JPEG_SUFFIXES, read_jpeg_rgba, read_jpegs_rgba
from ngp_tpu_torch.data.png import read_png, read_png_rgba, read_pngs_rgba
from ngp_tpu_torch.geometry.camera import (
    LENS_OPENCV,
    LENS_OPENCV_FISHEYE,
    LENS_PINHOLE,
    Lens,
)

NERF_SCALE = 0.33  # nerf_loader.h:27


def nerf_matrix_to_ngp(m: np.ndarray, scale: float, offset: np.ndarray) -> np.ndarray:
    """(3, 4) NeRF camera-to-world → NGP convention (nerf_loader.h:120-140)."""
    out = m.astype(np.float32).copy()
    out[:, 1] *= -1.0
    out[:, 2] *= -1.0
    out[:, 3] = out[:, 3] * scale + offset
    # cycle rows: new row0 = old row1, row1 = old row2, row2 = old row0
    return out[[1, 2, 0], :]


def ngp_matrix_to_nerf(m: np.ndarray, scale: float, offset: np.ndarray) -> np.ndarray:
    out = m.astype(np.float32).copy()
    out = out[[2, 0, 1], :]
    out[:, 1] *= -1.0
    out[:, 2] *= -1.0
    out[:, 3] = (out[:, 3] - offset) / scale
    return out


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
    scale: float = NERF_SCALE
    offset: np.ndarray = field(default_factory=lambda: np.full(3, 0.5, np.float32))
    aabb_scale: int = 1
    up: np.ndarray = field(default_factory=lambda: np.array([0, 1, 0], np.float32))
    paths: list = field(default_factory=list)
    is_hdr: bool = False
    n_extra_learnable_dims: int = 0
    # error-map importance sampling of training rays (the JAX package's
    # default)
    wants_importance_sampling: bool = True
    render_aabb: tuple | None = None  # ((3,), (3,)) in NGP space
    # (N, H, W) float32 NGP-scale z-depths (raw · integer_depth_scale ·
    # scale), 0 where absent (src/nerf_loader.cu:711, copy_depth :81-89)
    depths: np.ndarray | None = None
    sharpness: np.ndarray | None = None
    rolling_shutter: tuple = (0.0, 0.0, 0.0, 0.0)  # (offset, sx, sy, duration)
    envmap: np.ndarray | None = None  # (He, We, 4) float32 lat-long HDR
    # (N, H, W, 6) NGP-space per-pixel origin + direction (light-field
    # datasets, rays_<name>.dat; src/nerf_loader.cu:623-645)
    rays: np.ndarray | None = None

    @property
    def n_images(self) -> int:
        return self.images.shape[0]

    def subset(self, indices) -> "NerfDataset":
        """The dataset restricted to ``indices`` (a train/holdout split)."""
        idx = np.asarray(indices, np.int64)
        return dataclasses.replace(
            self,
            images=self.images[idx],
            xforms=self.xforms[idx],
            focal_lengths=self.focal_lengths[idx],
            principal_points=self.principal_points[idx],
            paths=[self.paths[i] for i in idx] if self.paths else [],
            depths=self.depths[idx] if self.depths is not None else None,
            sharpness=self.sharpness[idx] if self.sharpness is not None else None,
            rays=self.rays[idx] if self.rays is not None else None,
        )

    def nerf_direction_to_ngp(self, d: np.ndarray) -> np.ndarray:
        return d[..., [1, 2, 0]]

    def nerf_position_to_ngp(self, p: np.ndarray) -> np.ndarray:
        return (p * self.scale + self.offset)[..., [1, 2, 0]]

    def ngp_position_to_nerf(self, p: np.ndarray) -> np.ndarray:
        return (p[..., [2, 0, 1]] - self.offset) / self.scale


def _resolve_path(base: str, rel: str) -> str:
    p = rel if os.path.isabs(rel) else os.path.join(base, rel)
    if os.path.exists(p):
        return p
    for ext in (".png", ".jpg", ".jpeg", ".exr"):
        if os.path.exists(p + ext):
            return p + ext
    return p


def _load_exr_frame(path: str) -> np.ndarray:
    img = read_exr(path)
    if img.shape[-1] == 3:
        img = np.concatenate([img, np.ones_like(img[..., :1])], -1)
    return img.astype(np.float16)


def _load_frame_images(paths: list) -> list:
    """(H, W, 4) per frame: uint8 sRGB + alpha for PNG and JPEG, float16
    for EXR. Threads read and inflate the PNG files and read the EXR files;
    the PNG rows are then unfiltered in batches (``data/png.py``); the JPEG
    files are decoded one a C++ thread (``data/jpeg.py``)."""
    for p in paths:
        if not p.lower().endswith((".png", ".exr", *JPEG_SUFFIXES)):
            raise NotImplementedError(
                f"{p}: frames are read from PNG, JPEG and EXR only (ROADMAP A2)")
    png = [i for i, p in enumerate(paths) if p.lower().endswith(".png")]
    jpg = [i for i, p in enumerate(paths) if p.lower().endswith(JPEG_SUFFIXES)]
    exr = [i for i, p in enumerate(paths) if p.lower().endswith(".exr")]
    images = [None] * len(paths)
    for i, img in zip(png, read_pngs_rgba([paths[i] for i in png])):
        images[i] = img
    for i, img in zip(jpg, read_jpegs_rgba([paths[i] for i in jpg])):
        images[i] = img
    with ThreadPoolExecutor(max_workers=16) as pool:
        for i, img in zip(exr, pool.map(_load_exr_frame, [paths[i] for i in exr])):
            images[i] = img
    return images


def _focal_from_json(j: dict, axis: str, res: float, other: float | None) -> float | None:
    if f"fl_{axis}" in j:
        return float(j[f"fl_{axis}"])
    if f"camera_angle_{axis}" in j:
        return 0.5 * res / math.tan(0.5 * float(j[f"camera_angle_{axis}"]))
    if f"{axis}_fov" in j:
        return 0.5 * res / math.tan(0.5 * math.radians(float(j[f"{axis}_fov"])))
    return other


def _sharpness_keep(frames: list, thresh: float) -> list:
    """Frames whose sharpness exceeds ``thresh`` times the mean over a
    window of 20 around them (nerf_loader.cu:335-372)."""
    sh = np.array([float(fr.get("sharpness", 1.0)) for fr in frames])
    n = len(frames)
    return [fr for i, fr in enumerate(frames)
            if sh[i] > thresh * sh[max(0, i - 10):min(n, i + 10)].mean()]


def _sharpen(images: np.ndarray, amount: float) -> np.ndarray:
    """The reference's 5-point unsharp filter on HDR frames (``sharpen``
    kernel, nerf_loader.cu:93-113, center weight 4 + 1/amount :977), with
    its flat-index edge handling kept for parity: up/left clamp to flat
    index 0, down/right wrap modulo the image."""
    n, H, W = images.shape[:3]
    center_w = 4.0 + 1.0 / amount
    inv_totalw = 1.0 / (center_w - 4.0)
    n_pix = H * W
    flat = images.reshape(n, n_pix, 4).astype(np.float32)
    idx = np.arange(n_pix)
    left = np.maximum(idx - 1, 0)
    up = np.maximum(idx - W, 0)
    right = np.where(idx + 1 >= n_pix, idx + 1 - n_pix, idx + 1)
    down = np.where(idx + W >= n_pix, idx + W - n_pix, idx + W)
    out = (flat * center_w - flat[:, left] - flat[:, up] - flat[:, right]
           - flat[:, down]) * inv_totalw
    return np.maximum(out, 0.0).reshape(images.shape).astype(images.dtype)


def _load_depths(top: dict, frames_all: list, H: int, W: int, scale: float):
    """16-bit depth maps scaled by ``integer_depth_scale``, then the scene
    scale (src/nerf_loader.cu:471-472, 609-619), or None."""
    depth_scale = float(top.get("integer_depth_scale", -1.0))
    if not (depth_scale > 0 and bool(top.get("enable_depth_loading", True))):
        return None
    maps = np.zeros((len(frames_all), H, W), np.float32)
    any_depth = False
    for i, (_, base, fr) in enumerate(frames_all):
        if "depth_path" not in fr:
            continue
        dp = _resolve_path(base, fr["depth_path"])
        if not os.path.exists(dp):
            continue
        if not dp.lower().endswith(".png"):
            raise NotImplementedError(f"{dp}: depth maps are read from PNG only")
        d = read_png(dp).astype(np.float32)
        if d.ndim == 3:
            d = d[..., 0]
        if d.shape != (H, W):
            raise ValueError(f"depth image {dp} has wrong resolution")
        maps[i] = d * depth_scale * scale
        any_depth = True
    return maps if any_depth else None


def _load_rays(top: dict, frames_all: list, H: int, W: int, scale: float,
               offset: np.ndarray):
    """Per-pixel rays from ``rays_<imagename>.dat`` beside each image
    (n_pixels × (origin, direction) float32; src/nerf_loader.cu:623-645),
    converted NeRF→NGP as ``nerf_ray_to_ngp`` (nerf_loader.h:173-189).
    Only when every frame has one."""
    if not bool(top.get("enable_ray_loading", True)):
        return None
    ray_paths = []
    for _, base, fr in frames_all:
        img_path = _resolve_path(base, fr["file_path"])
        stem = os.path.splitext(os.path.basename(img_path))[0]
        rp = os.path.join(os.path.dirname(img_path), f"rays_{stem}.dat")
        ray_paths.append(rp if os.path.exists(rp) else None)
    if any(ray_paths) and not all(ray_paths):
        warnings.warn("some frames have rays_*.dat files but not all: "
                      "ignoring supplied rays")
    if not (any(ray_paths) and all(ray_paths)):
        return None
    rays = np.zeros((len(ray_paths), H, W, 6), np.float32)
    for i, rp in enumerate(ray_paths):
        raw = np.fromfile(rp, np.float32)
        if raw.size < H * W * 6:
            raise ValueError(f"rays file {rp} too short")
        r = raw[:H * W * 6].reshape(H, W, 6)
        o = r[..., :3] * scale + offset
        rays[i, ..., :3] = o[..., [1, 2, 0]]
        rays[i, ..., 3:] = r[..., 3:][..., [1, 2, 0]]
    return rays


def _load_envmap(top: dict, json_dir: str):
    """The lat-long environment map (src/nerf_loader.cu:516-528): EXR as
    linear float, PNG or JPEG as RGBA / 255; RGBA (He, We, 4) float32, or
    None."""
    if "envmap" not in top:
        return None
    ep = _resolve_path(json_dir, top["envmap"])
    if not os.path.exists(ep):
        return None
    if ep.lower().endswith(".exr"):
        envmap = read_exr(ep).astype(np.float32)
    elif ep.lower().endswith(".png"):
        envmap = read_png_rgba(ep).astype(np.float32) / 255.0
    elif ep.lower().endswith(JPEG_SUFFIXES):
        envmap = read_jpeg_rgba(ep).astype(np.float32) / 255.0
    else:
        raise NotImplementedError(
            f"{ep}: the envmap is read from EXR, PNG or JPEG only (ROADMAP A2)")
    if envmap.shape[-1] == 3:
        envmap = np.concatenate([envmap, np.ones_like(envmap[..., :1])], -1)
    return envmap


def load_nerf(path: str) -> NerfDataset:
    """Load a dataset from a ``transforms.json`` path, or from a directory
    whose json files together describe it (sorted by name; the first gives
    the dataset-wide keys)."""
    if os.path.isdir(path):
        jsons = sorted(os.path.join(path, f) for f in os.listdir(path)
                       if f.endswith(".json"))
        if not jsons:
            raise FileNotFoundError(f"no transforms json in {path}")
    else:
        jsons = [path]

    frames_all = []
    top = None
    for jp in jsons:
        with open(jp) as f:
            j = json.load(f)
        if top is None:
            top = j
        base = os.path.dirname(jp)
        frames = j.get("frames", [])
        thresh = float(j.get("sharpness_discard_threshold", 0.0))
        if frames and "sharpness" in frames[0] and thresh > 0:
            frames = _sharpness_keep(frames, thresh)
        # frames whose image is missing are skipped, as the reference does
        # (nerf_loader.cu:365)
        frames_all += [(j, base, fr) for fr in frames
                       if os.path.exists(_resolve_path(base, fr["file_path"]))]

    scale = float(top.get("scale", NERF_SCALE))
    offset = np.asarray(top.get("offset", [0.5, 0.5, 0.5]), np.float32)
    if offset.ndim == 0:
        offset = np.full(3, float(offset), np.float32)
    aabb_scale = int(top.get("aabb_scale", 1))
    # fail at load time, as load_nerf_post does (testbed_nerf.cu:3080-3092)
    if aabb_scale < 1 or aabb_scale & (aabb_scale - 1):
        raise ValueError(f"NeRF dataset's `aabb_scale` must be a power of two, "
                         f"but is {aabb_scale}.")
    if aabb_scale > 128:
        raise ValueError(f"NeRF dataset must have `aabb_scale <= 128`, but is "
                         f"{aabb_scale}.")
    if "aabb" in top:
        # fit the given aabb into the unit cube (nerf_loader.cu:489-494)
        aabb = np.asarray(top["aabb"], np.float32)
        length = max(1e-6, float(np.abs(aabb[1] - aabb[0]).max()))
        scale = 1.0 / length
        offset = ((aabb[1] + aabb[0]) * 0.5) * -scale + 0.5

    paths = [_resolve_path(base, fr["file_path"]) for (_, base, fr) in frames_all]
    images = _load_frame_images(paths)

    H, W = images[0].shape[:2]
    if any(im.shape[:2] != (H, W) for im in images):
        raise NotImplementedError("mixed image resolutions are not supported")
    is_hdr = images[0].dtype == np.float16
    images = np.stack(images)

    n = len(frames_all)
    xforms = np.zeros((n, 2, 3, 4), np.float32)
    focals = np.zeros((n, 2), np.float32)
    pps = np.zeros((n, 2), np.float32)
    lens_mode, lens_params = LENS_PINHOLE, [0.0] * 7
    for i, (j, _, fr) in enumerate(frames_all):
        def get(key, default=None):
            return fr.get(key, j.get(key, default))

        fx = _focal_from_json({**j, **fr}, "x", W, None)
        fy = _focal_from_json({**j, **fr}, "y", H, fx)
        if fx is None and fy is not None:
            fx = fy
        if fx is None:
            raise ValueError("no focal length in transforms.json")
        focals[i] = (fx, fy)
        pps[i] = (float(get("cx", W / 2)) / W, float(get("cy", H / 2)) / H)

        if any(get(k) for k in ("k1", "k2", "p1", "p2", "k3", "k4")):
            if get("is_fisheye", False):
                lens_mode = LENS_OPENCV_FISHEYE
                keys = ("k1", "k2", "k3", "k4")
            else:
                lens_mode = LENS_OPENCV
                keys = ("k1", "k2", "p1", "p2")
            lens_params = [float(get(k, 0)) for k in keys] + [0.0, 0.0, 0.0]

        if "transform_matrix_start" in fr:
            ms = np.asarray(fr["transform_matrix_start"], np.float32)[:3, :4]
            me = np.asarray(fr["transform_matrix_end"], np.float32)[:3, :4]
        else:
            ms = me = np.asarray(fr["transform_matrix"], np.float32)[:3, :4]
        xforms[i, 0] = nerf_matrix_to_ngp(ms, scale, offset)
        xforms[i, 1] = nerf_matrix_to_ngp(me, scale, offset)

    render_aabb = None
    if "render_aabb" in top:
        ra = np.asarray(top["render_aabb"], np.float32)
        render_aabb = (ra[0] * scale + offset, ra[1] * scale + offset)

    up = np.asarray(top.get("up", [0, 0, 1]), np.float32)[[1, 2, 0]]  # nerf→ngp

    sharpness = None
    if frames_all and "sharpness" in frames_all[0][2]:
        sharpness = np.array([float(fr.get("sharpness", 1.0)) for (_, _, fr) in frames_all],
                             np.float32)

    # rolling shutter / motion blur: a per-dataset vec4 lerping each frame's
    # start and end matrices per ray (src/testbed_nerf.cu:2270-2273)
    rs = top.get("rolling_shutter", [0.0, 0.0, 0.0, 0.0])
    rolling_shutter = tuple(float(v) for v in (list(rs) + [0.0] * 4)[:4])

    sharpen_amount = float(top.get("sharpen", 0.0))
    if sharpen_amount > 0 and is_hdr:
        images = _sharpen(images, sharpen_amount)

    return NerfDataset(
        images=images,
        xforms=xforms,
        focal_lengths=focals,
        principal_points=pps,
        lens=Lens(mode=lens_mode, params=tuple(lens_params)),
        resolution=(W, H),
        scale=scale,
        offset=offset,
        aabb_scale=aabb_scale,
        up=up,
        paths=paths,
        is_hdr=is_hdr,
        n_extra_learnable_dims=int(top.get("n_extra_learnable_dims", 0)),
        render_aabb=render_aabb,
        depths=_load_depths(top, frames_all, H, W, scale),
        sharpness=sharpness,
        rolling_shutter=rolling_shutter,
        envmap=_load_envmap(top, os.path.dirname(jsons[0])),
        rays=_load_rays(top, frames_all, H, W, scale, offset),
    )

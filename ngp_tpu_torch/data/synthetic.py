"""Synthetic data that needs no file: an opaque sphere of radius 0.2 at
the scene center, color (0.9, 0.3, 0.2), seen by a ring of pinhole cameras
(the port's copy of the JAX package's ``__graft_entry__._tiny_sphere_dataset``,
the bench's fallback scene when no capture is present), a written sphere
capture (with depth maps, supplied rays, a sky, an environment map or
per-view brightness on request), a procedural gigapixel image (the formula
of ``scripts/bench_gigapixel.py``) and a written bumpy-sphere mesh for SDF
mode."""

from __future__ import annotations

import math

import numpy as np
import torch

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


# the depth PNGs' unit: NeRF units a 16-bit step (the loader multiplies by
# integer_depth_scale, then the scene scale)
CAPTURE_DEPTH_SCALE = 1e-4
# the envmap PNG's resolution (H, W)
CAPTURE_ENVMAP_RES = (64, 128)


def sky_srgb(d):
    """The analytic sky's sRGB colour (..., 3) along unit NGP directions
    ``d`` (..., 3), numpy or torch: a gradient in the height d_z (the JAX
    package's ``tests/test_envmap.py:_sky_srgb``)."""
    t = (d[..., 2] + 1.0) * 0.5
    lib = np if isinstance(d, np.ndarray) else torch
    return lib.stack([0.2 + 0.6 * t, 0.4 + 0.2 * t, 0.8 - 0.5 * t], -1)


def capture_view(xform: np.ndarray, res: int, focal, pp_uv, lens: Lens, device="cpu",
                 sky: bool = False, brightness: float = 1.0) -> dict:
    """The capture's sphere seen by camera ``xform`` (NGP, 3 × 4) through
    ``lens`` at the pixel centers, by the port's ``uv_to_ray``:
    ``"rgba"`` (res, res, 4) uint8 sRGB + alpha, the albedo times
    ``brightness`` where the ray hits and transparent black elsewhere (the
    analytic sky, opaque, with ``sky``); ``"distance"`` (res, res) float32
    along the unit ray to the hit and ``"z"`` its camera-space z-depth, 0
    where the ray misses; ``"origins"`` and ``"dirs"`` (res, res, 3) the
    rays in NGP space, the directions as ``uv_to_ray`` gives them
    (camera-space z = 1)."""
    from ngp_tpu_torch.geometry.camera import uv_to_ray

    u = (torch.arange(res, dtype=torch.float32, device=device) + 0.5) / res
    uv = torch.stack(torch.meshgrid(u, u, indexing="xy"), -1).reshape(-1, 2)
    o, d_cam = uv_to_ray(uv, (res, res), focal, torch.as_tensor(xform, device=device),
                         pp_uv, lens)
    norm = torch.linalg.norm(d_cam, dim=-1, keepdim=True)
    d = d_cam / norm
    oc = o - torch.as_tensor(CAPTURE_CENTER, device=device)
    b = (d * oc).sum(-1)
    disc = b * b - ((oc * oc).sum(-1) - CAPTURE_RADIUS ** 2)
    hit = disc > 0
    t = -b - torch.sqrt(torch.clamp_min(disc, 0.0))
    normal = (oc + t[:, None] * d) / CAPTURE_RADIUS
    axes = torch.as_tensor(_ALBEDO_AXES, device=device)
    phases = torch.as_tensor(_ALBEDO_PHASES, device=device)
    rgb = 0.5 + 0.4 * torch.sin(3.0 * normal @ axes.T + phases)
    if brightness != 1.0:
        rgb = rgb * brightness
    rgba = torch.cat([rgb, torch.ones_like(rgb[:, :1])], -1) * hit[:, None]
    if sky:
        sky_rgba = torch.cat([sky_srgb(d), torch.ones_like(rgb[:, :1])], -1)
        rgba = torch.where(hit[:, None], rgba, sky_rgba)
    img = (torch.clamp(rgba, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
    dist = torch.where(hit, t, 0.0)
    host = lambda x, c: x.reshape(res, res, c).squeeze(-1).cpu().numpy()  # noqa: E731
    return {"rgba": host(img, 4), "distance": host(dist, 1),
            "z": host(dist / norm[:, 0], 1), "origins": host(o.expand_as(d_cam), 3),
            "dirs": host(d_cam, 3)}


def _render_capture_view(xform: np.ndarray, res: int, focal, pp_uv, lens: Lens,
                         device="cpu") -> np.ndarray:
    """(res, res, 4) uint8 of :func:`capture_view`."""
    return capture_view(xform, res, focal, pp_uv, lens, device)["rgba"]


def envmap_image(H: int, W: int) -> np.ndarray:
    """(H, W, 4) float32 lat-long map of the analytic sky in linear light,
    alpha 1: texel (y, x) holds the sky along the direction
    ``ops/envmap.read_envmap`` reads there (theta = y/(H−1), phi =
    x/(W−1))."""
    from ngp_tpu_torch.ops.tonemap import srgb_to_linear

    theta = np.pi * np.arange(H, dtype=np.float64) / max(H - 1, 1)
    phi = 2.0 * np.pi * (np.arange(W, dtype=np.float64) / max(W - 1, 1) - 0.5)
    th, ph = np.meshgrid(theta, phi, indexing="ij")
    # the inverse of dir_to_latlong_uv's (z, -x, y) swizzle
    d = np.stack([-np.sin(th) * np.sin(ph), np.cos(th), np.sin(th) * np.cos(ph)], -1)
    rgb = srgb_to_linear(torch.from_numpy(sky_srgb(d).astype(np.float32))).numpy()
    return np.concatenate([rgb, np.ones((H, W, 1), np.float32)], -1)


def write_sphere_capture(out_dir: str, res: int = 800, device="cpu", depth: bool = False,
                         rays: bool = False, sky: bool = False, envmap: bool = False,
                         brightness_seed: int | None = None,
                         n_extra_learnable_dims: int = 0, aabb_scale: int = 2,
                         distance: float = 1.2) -> tuple[str, str]:
    """Write a capture of the textured sphere in the transforms dialect of
    instant-ngp's fox scene, with PNG frames: ``transforms_train.json`` and
    ``transforms_test.json`` in ``out_dir``, frames ``train/r_<i>.png`` and
    ``test/r_<i>.png`` (``file_path`` without extension), res × res RGBA
    (``CAPTURE_TRAIN_VIEWS`` and ``CAPTURE_TEST_VIEWS`` of them),
    written by ``data/png.py`` with the five filter types cycled row by row.

    Top-level keys: ``fl_x``, ``fl_y``, an off-center ``cx``/``cy``, the
    OpenCV lens ``k1 = -0.1, k2 = 0.02, p1 = 1e-3, p2 = -1e-3``,
    ``aabb_scale`` (2: the cameras inside the scene box; at 1 outside
    it); the default scale 0.33 and offset 0.5 map the NeRF
    matrices to NGP space. Train eyes lie on two rings (heights 0.35 and
    −0.15 before normalizing, ``distance`` from the center), half of them
    on each; test eyes lie halfway between train eyes in angle, at the
    middle height.

    Options: ``depth`` writes a 16-bit z-depth PNG a frame
    (``<split>/depth_<i>.png``, ``depth_path``, ``integer_depth_scale``
    ``CAPTURE_DEPTH_SCALE``; 0 where the ray misses); ``rays`` writes
    ``rays_r_<i>.dat`` beside each frame, the camera model's rays at the
    pixel centres in NeRF space (float32 origin and direction a pixel, the
    inverse of the loader's ``nerf_ray_to_ngp``); ``sky`` puts the opaque
    analytic sky (:func:`sky_srgb`) behind the sphere; ``envmap`` writes
    ``envmap.png`` (:func:`envmap_image` at ``CAPTURE_ENVMAP_RES``, 8-bit)
    and names it in the json; ``brightness_seed`` scales each frame's
    albedo by a factor uniform in [0.6, 1.4] from that numpy seed (an
    appearance change a view); ``n_extra_learnable_dims`` is written as
    the key of that name. Returns the two json paths."""
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
            **distortion, "aabb_scale": aabb_scale}
    if depth:
        meta["integer_depth_scale"] = CAPTURE_DEPTH_SCALE
    os.makedirs(out_dir, exist_ok=True)
    if envmap:
        meta["envmap"] = "envmap.png"
        rgba = np.clip(envmap_image(*CAPTURE_ENVMAP_RES) * 255.0 + 0.5, 0, 255)
        write_png(os.path.join(out_dir, "envmap.png"), rgba.astype(np.uint8))
    if n_extra_learnable_dims:
        meta["n_extra_learnable_dims"] = int(n_extra_learnable_dims)
    sets = {
        "train": _capture_eyes(CAPTURE_TRAIN_VIEWS, (0.35, -0.15), distance, 0.0),
        "test": _capture_eyes(CAPTURE_TEST_VIEWS, (0.1,), distance,
                              0.5 * CAPTURE_TEST_VIEWS / CAPTURE_TRAIN_VIEWS),
    }
    rng = np.random.default_rng(brightness_seed) if brightness_seed is not None else None
    paths = []
    for split, eyes in sets.items():
        os.makedirs(os.path.join(out_dir, split), exist_ok=True)
        frames = []
        for i, eye in enumerate(eyes):
            xf = _capture_lookat(eye)
            bright = float(rng.uniform(0.6, 1.4)) if rng is not None else 1.0
            view = capture_view(xf, res, focal, (cx / res, cy / res), lens, device, sky=sky,
                                brightness=bright)
            write_png(os.path.join(out_dir, split, f"r_{i}.png"), view["rgba"])
            m = np.eye(4)
            m[:3] = ngp_matrix_to_nerf(xf, NERF_SCALE, offset)
            frame = {"file_path": f"./{split}/r_{i}", "transform_matrix": m.tolist()}
            if depth:
                units = view["z"] / (CAPTURE_DEPTH_SCALE * NERF_SCALE)
                write_png(os.path.join(out_dir, split, f"depth_{i}.png"),
                          np.clip(np.round(units), 0, 65535).astype(np.uint16))
                frame["depth_path"] = f"./{split}/depth_{i}.png"
            if rays:
                # nerf_ray_to_ngp inverted: (o_ngp[[2, 0, 1]] − offset)/scale
                o = (view["origins"][..., [2, 0, 1]] - offset) / NERF_SCALE
                d = view["dirs"][..., [2, 0, 1]]
                np.concatenate([o, d], -1).astype(np.float32).tofile(
                    os.path.join(out_dir, split, f"rays_r_{i}.dat"))
            frames.append(frame)
        path = os.path.join(out_dir, f"transforms_{split}.json")
        with open(path, "w") as f:
            json.dump({**meta, "frames": frames}, f, indent=1)
        paths.append(path)
    return tuple(paths)


def gigapixel_image(side: int, device="cpu", dtype=torch.float16) -> torch.Tensor:
    """(side, side, 4) linear RGBA with structure at many scales (radial
    waves, anisotropic stripes, a smooth colour field), computed in
    float32 on ``device`` in blocks of 1024 rows and stored as ``dtype``:
    the formula of ``scripts/bench_gigapixel.py:synth_image``, whose
    10240² image is 104.9 MP."""
    img = torch.empty((side, side, 4), dtype=dtype, device=device)
    xs = (torch.arange(side, dtype=torch.float32, device=device) + 0.5) / side
    for y0 in range(0, side, 1024):
        y1 = min(y0 + 1024, side)
        ys = (torch.arange(y0, y1, dtype=torch.float32, device=device) + 0.5) / side
        Y, X = torch.meshgrid(ys, xs, indexing="ij")
        r = torch.hypot(X - 0.5, Y - 0.5)
        v1 = 0.5 + 0.5 * torch.sin(640.0 * math.pi * r) * torch.exp(-3.0 * r)
        v2 = 0.5 + 0.5 * torch.sin(220.0 * math.pi * (X + 0.35 * torch.sin(6 * math.pi * Y)))
        v3 = 0.5 + 0.5 * torch.cos(14.0 * math.pi * X) * torch.sin(10.0 * math.pi * Y)
        img[y0:y1] = torch.stack([v1, 0.6 * v2 + 0.4 * v3, 0.5 * v1 + 0.5 * v3,
                                  torch.ones_like(v1)], dim=-1).to(dtype)
    return img


def write_gigapixel_bin(path: str, side: int, device="cpu") -> str:
    """Write :func:`gigapixel_image` of ``side`` as a ``.bin`` image (int32
    height and width, then float16 RGBA; ``data/image_loader.py``)."""
    from ngp_tpu_torch.data.image_loader import save_binary_image

    save_binary_image(path, gigapixel_image(side, device, torch.float16).cpu().numpy())
    return path


# the icosahedron: 12 unit vertices, 20 faces wound counter-clockwise seen
# from outside
_ICO_T = (1.0 + 5.0 ** 0.5) / 2.0
_ICO_VERTS = [(-1, _ICO_T, 0), (1, _ICO_T, 0), (-1, -_ICO_T, 0), (1, -_ICO_T, 0),
              (0, -1, _ICO_T), (0, 1, _ICO_T), (0, -1, -_ICO_T), (0, 1, -_ICO_T),
              (_ICO_T, 0, -1), (_ICO_T, 0, 1), (-_ICO_T, 0, -1), (-_ICO_T, 0, 1)]
_ICO_FACES = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
              (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
              (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
              (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]


def icosphere(subdivisions: int) -> tuple[np.ndarray, np.ndarray]:
    """Unit icosphere: (V, 3) float64 vertices, (20·4^subdivisions, 3)
    int64 faces wound outward. Each subdivision splits a face into four
    at its edges' midpoints (shared by the two faces of an edge), pushed
    out to the sphere."""
    v = np.asarray(_ICO_VERTS, np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.asarray(_ICO_FACES, np.int64)
    for _ in range(subdivisions):
        edges = np.sort(np.stack([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], 1), -1)
        uniq, inv = np.unique(edges.reshape(-1, 2), axis=0, return_inverse=True)
        mid = v[uniq].mean(axis=1)
        mid /= np.linalg.norm(mid, axis=1, keepdims=True)
        m = len(v) + inv.reshape(-1, 3)  # midpoints of edges ab, bc, ca
        a, b, c = f.T
        ab, bc, ca = m.T
        f = np.concatenate([np.stack(t, 1) for t in
                            ((a, ab, ca), (ab, b, bc), (ca, bc, c), (ab, bc, ca))])
        v = np.concatenate([v, mid])
    return v, f


def bumpy_sphere(subdivisions: int = 7) -> tuple[np.ndarray, np.ndarray]:
    """The icosphere's vertices moved radially to r = 0.3·(1 + 0.15·sin 6θ ·
    cos 4φ) (θ polar, φ azimuth), as float32, and its faces. A vertex is
    shared by its faces and moves once, so the mesh stays closed."""
    v, f = icosphere(subdivisions)
    theta = np.arccos(np.clip(v[:, 2], -1.0, 1.0))
    phi = np.arctan2(v[:, 1], v[:, 0])
    r = 0.3 * (1.0 + 0.15 * np.sin(6.0 * theta) * np.cos(4.0 * phi))
    return (v * r[:, None]).astype(np.float32), f


def write_bumpy_sphere_mesh(path: str, subdivisions: int = 7) -> str:
    """Write :func:`bumpy_sphere` as an indexed ASCII OBJ (``v`` and ``f``
    lines, 1-based, every float32 coordinate exactly): at the default 7
    subdivisions 327,680 triangles, the size class of the reference's
    armadillo (345,944)."""
    v, f = bumpy_sphere(subdivisions)
    with open(path, "w") as out:
        out.write("".join("v %.9g %.9g %.9g\n" % tuple(p) for p in v.tolist()))
        out.write("".join("f %d %d %d\n" % tuple(t) for t in (f + 1).tolist()))
    return path


def write_sphere_prior(out_dir: str, fmt: str, subdivisions: int = 4, n_points: int = 20000,
                       seed: int = 0) -> str:
    """Write the capture sphere's surface (``CAPTURE_CENTER``,
    ``CAPTURE_RADIUS``) as the geometry prior ``Testbed`` seeds the density
    grid from: ``<out_dir>/<name>.obj`` (``fmt`` "obj": an icosphere of
    ``subdivisions``) or ``<out_dir>/<name>.xyz`` ("xyz": ``n_points``
    points uniform on the surface from a numpy ``seed``), ``<name>`` the
    directory's own name, in the capture's raw (NeRF) coordinates at
    scale 0.33 and offset 0.5: the inverse of the fork's transforms, the
    mesh's (x, y, z) → (−z, y, x) cycle then scale and offset, the points'
    scale and offset then columns [1, 2, 0]. Returns the path."""
    import os

    from ngp_tpu_torch.data.nerf_loader import NERF_SCALE

    name = os.path.basename(os.path.normpath(out_dir))
    center = np.asarray(CAPTURE_CENTER, np.float64)
    offset = np.full(3, 0.5)
    if fmt == "obj":
        unit, faces = icosphere(subdivisions)
        w = (center + CAPTURE_RADIUS * unit - offset) / NERF_SCALE  # (−z, y, x) of raw
        raw = np.stack([w[:, 2], w[:, 1], -w[:, 0]], -1)
        path = os.path.join(out_dir, name + ".obj")
        with open(path, "w") as out:
            out.write("".join("v %.9g %.9g %.9g\n" % tuple(p) for p in raw.tolist()))
            out.write("".join("f %d %d %d\n" % tuple(t) for t in (faces + 1).tolist()))
        return path
    if fmt != "xyz":
        raise ValueError(f"unknown prior format {fmt!r} (obj | xyz)")
    d = np.random.default_rng(seed).normal(size=(n_points, 3))
    ngp = center + CAPTURE_RADIUS * d / np.linalg.norm(d, axis=1, keepdims=True)
    raw = (ngp[:, [2, 0, 1]] - offset) / NERF_SCALE
    path = os.path.join(out_dir, name + ".xyz")
    with open(path, "w") as out:
        out.write("# the capture sphere's surface, raw coordinates\n")
        out.write("".join("%.9g %.9g %.9g\n" % tuple(p) for p in raw.tolist()))
    return path

"""Dataset conversion, the port of ``ngp_tpu/data/convert.py``: COLMAP /
NSVF / Record3D / NeRFCapture → ``transforms.json``, function for function
(numpy only), so that a converted scene equals the JAX package's.

The conventions are the reference's conversion scripts'
(``scripts/colmap2nerf.py``, ``nsvf2nerf.py``, ``record3d2nerf.py``,
``nerfcapture2nerf.py``):

- COLMAP: camera-model table (``colmap2nerf.py:205-270``), w2c → c2w
  inversion, the yzx axis cycle + world flip (``:324-329``), up-vector
  reorientation to +z, "center of attention" from pairwise closest ray
  points, translation scale 4/avglen (``:352-386``).
- NSVF: bbox.txt centroid/scale, pose/*.txt c2w with the y/z flip + swap
  (``nsvf2nerf.py:104-151``); the first image's size from its PNG IHDR or
  JPEG frame header.
- Record3D: ``metadata`` quaternion+position poses, K^T intrinsics,
  min-line-dist center + 4/avglen scale (``record3d2nerf.py:39-85``).
- NeRFCapture: per-frame intrinsics + transform matrices saved by the DDS
  listener (``nerfcapture2nerf.py:88-130``).
- Sharpness: variance-of-Laplacian on grayscale (``colmap2nerf.py:145-148``),
  the frames read by the port's PNG and JPEG decoders and made grey by
  PIL's ``convert("L")`` rule, so the value equals the JAX package's.

The entry points are ``python -m ngp_tpu_torch.scripts.colmap2nerf``,
``nsvf2nerf`` and ``record3d2nerf``.
"""

from __future__ import annotations

import json
import math
import os
import struct
from glob import glob

import numpy as np

from ngp_tpu_torch.data.jpeg import JPEG_SUFFIXES, jpeg_size, read_jpeg
from ngp_tpu_torch.data.png import SIGNATURE as PNG_SIGNATURE
from ngp_tpu_torch.data.png import read_png_rgba


# ---- small math helpers (standard public formulas) ----

def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    """COLMAP-convention quaternion (w, x, y, z) → rotation matrix."""
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def rotmat_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Smallest rotation taking unit-ish vector a to b (Rodrigues)."""
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    if c < -1 + 1e-10:  # antiparallel: perturb
        return rotmat_between(a + np.random.uniform(-1e-2, 1e-2, 3), b)
    s2 = float(np.dot(v, v))
    k = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + k + k @ k * ((1 - c) / (s2 + 1e-10))


def closest_point_2_lines(oa, da, ob, db):
    """Point closest to two rays + a weight that → 0 when parallel."""
    da = da / np.linalg.norm(da)
    db = db / np.linalg.norm(db)
    c = np.cross(da, db)
    denom = float(np.dot(c, c))
    t = ob - oa
    ta = np.linalg.det(np.stack([t, db, c])) / (denom + 1e-10)
    tb = np.linalg.det(np.stack([t, da, c])) / (denom + 1e-10)
    ta, tb = min(ta, 0.0), min(tb, 0.0)
    return (oa + ta * da + ob + tb * db) * 0.5, denom


def _grey(img: np.ndarray) -> np.ndarray:
    """PIL's ``convert("L")`` of decoded samples: a (H, W) grey image as
    it is; RGB(A) by ``(19595 R + 38470 G + 7471 B + 0x8000) >> 16``."""
    if img.ndim == 2:
        return img
    rgb = img[..., :3].astype(np.int32)
    return (rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000) >> 16


def sharpness(image_path: str) -> float:
    """Variance of the Laplacian on grayscale (the reference uses
    cv2.Laplacian — same operator), the PNG or JPEG file made grey as
    PIL's ``Image.open(path).convert("L")`` makes it."""
    p = image_path.lower()
    if p.endswith(".png"):
        img = read_png_rgba(image_path)
    elif p.endswith(JPEG_SUFFIXES):
        img = read_jpeg(image_path)
    else:
        raise NotImplementedError(f"{image_path}: sharpness reads PNG and JPEG images only "
                                  "(ROADMAP A2)")
    g = _grey(img).astype(np.float64)
    lap = (
        -4.0 * g[1:-1, 1:-1]
        + g[:-2, 1:-1]
        + g[2:, 1:-1]
        + g[1:-1, :-2]
        + g[1:-1, 2:]
    )
    return float(lap.var())


def image_size(path: str) -> tuple:
    """(width, height) of a PNG (its IHDR) or a JPEG (its frame header),
    as PIL's ``Image.size``."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] == PNG_SIGNATURE:
        return struct.unpack(">II", head[16:24])
    return jpeg_size(path)


def center_of_attention(frames: list[dict]) -> np.ndarray:
    """Weighted pairwise closest point of all camera view rays."""
    totw, totp = 0.0, np.zeros(3)
    mats = [np.asarray(f["transform_matrix"])[0:3, :] for f in frames]
    for mf in mats:
        for mg in mats:
            p, w = closest_point_2_lines(mf[:, 3], mf[:, 2], mg[:, 3], mg[:, 2])
            if w > 1e-5:
                totp += p * w
                totw += w
    return totp / totw if totw > 0 else totp


def reorient_and_rescale(frames: list[dict], target_avg_dist: float = 4.0):
    """In-place: rotate the average camera up-vector to +z, translate the
    center of attention to the origin, scale avg camera distance to 4."""
    up = np.zeros(3)
    for f in frames:
        up += np.asarray(f["transform_matrix"])[0:3, 1]
    R = np.pad(rotmat_between(up, np.array([0.0, 0.0, 1.0])), [(0, 1), (0, 1)])
    R[-1, -1] = 1
    for f in frames:
        f["transform_matrix"] = R @ np.asarray(f["transform_matrix"])
    center = center_of_attention(frames)
    for f in frames:
        f["transform_matrix"][0:3, 3] -= center
    avglen = np.mean(
        [np.linalg.norm(f["transform_matrix"][0:3, 3]) for f in frames]
    )
    for f in frames:
        f["transform_matrix"][0:3, 3] *= target_avg_dist / max(avglen, 1e-9)
    return frames


def min_line_dist_center(frames: list[dict]) -> np.ndarray:
    """Least-squares point closest to all view rays (record3d variant)."""
    o = np.stack([np.asarray(f["transform_matrix"])[:3, 3] for f in frames])
    d = np.stack([np.asarray(f["transform_matrix"])[:3, 2] for f in frames])
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    A = np.eye(3)[None] - d[:, :, None] * d[:, None, :]
    b = (A @ o[:, :, None]).mean(0)
    return np.linalg.solve((np.transpose(A, (0, 2, 1)) @ A).mean(0), b)[:, 0]


# ---- COLMAP ----

_COLMAP_MODELS = {
    # model → (fl_y?, cx, cy, distortion slots in order)
    "SIMPLE_PINHOLE": ("f", "cx", "cy"),
    "PINHOLE": ("fx", "fy", "cx", "cy"),
    "SIMPLE_RADIAL": ("f", "cx", "cy", "k1"),
    "RADIAL": ("f", "cx", "cy", "k1", "k2"),
    "OPENCV": ("fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2"),
    "SIMPLE_RADIAL_FISHEYE": ("f", "cx", "cy", "k1"),
    "RADIAL_FISHEYE": ("f", "cx", "cy", "k1", "k2"),
    "OPENCV_FISHEYE": ("fx", "fy", "cx", "cy", "k1", "k2", "k3", "k4"),
}


def parse_colmap_cameras(path: str) -> dict:
    """Parse COLMAP ``cameras.txt`` → intrinsics dict (last camera wins,
    like the reference, which assumes a single shared camera)."""
    out = None
    with open(path) as f:
        for line in f:
            if not line.strip() or line.startswith("#"):
                continue
            els = line.split()
            model = els[1]
            if model not in _COLMAP_MODELS:
                raise ValueError(f"unknown COLMAP camera model {model!r}")
            w, h = float(els[2]), float(els[3])
            names = _COLMAP_MODELS[model]
            vals = dict(zip(names, map(float, els[4 : 4 + len(names)])))
            fl_x = vals.get("fx", vals.get("f"))
            fl_y = vals.get("fy", fl_x)
            out = {
                "w": w,
                "h": h,
                "fl_x": fl_x,
                "fl_y": fl_y,
                "cx": vals.get("cx", w / 2),
                "cy": vals.get("cy", h / 2),
                "k1": vals.get("k1", 0.0),
                "k2": vals.get("k2", 0.0),
                "k3": vals.get("k3", 0.0),
                "k4": vals.get("k4", 0.0),
                "p1": vals.get("p1", 0.0),
                "p2": vals.get("p2", 0.0),
                "is_fisheye": model.endswith("FISHEYE"),
            }
    if out is None:
        raise ValueError(f"no cameras in {path}")
    out["camera_angle_x"] = math.atan(out["w"] / (out["fl_x"] * 2)) * 2
    out["camera_angle_y"] = math.atan(out["h"] / (out["fl_y"] * 2)) * 2
    return out


def parse_colmap_images(path: str):
    """Parse COLMAP ``images.txt`` → [(name, qvec wxyz, tvec)], pose lines
    only (every image entry is two lines; the 2D-point line is skipped)."""
    out = []
    with open(path) as f:
        expecting_pose = True
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if expecting_pose:
                els = line.split()
                qvec = np.array(list(map(float, els[1:5])))
                tvec = np.array(list(map(float, els[5:8])))
                name = "_".join(els[9:])
                out.append((name, qvec, tvec))
            expecting_pose = not expecting_pose
    return out


def colmap_to_transforms(
    text_dir: str,
    image_dir: str = "images",
    aabb_scale: int = 32,
    skip_early: int = 0,
    keep_colmap_coords: bool = False,
    compute_sharpness: bool = True,
) -> dict:
    """COLMAP text export → transforms dict (``colmap2nerf.py:192-391``)."""
    out = parse_colmap_cameras(os.path.join(text_dir, "cameras.txt"))
    out.update({"aabb_scale": int(aabb_scale), "frames": []})

    for name, qvec, tvec in parse_colmap_images(
        os.path.join(text_dir, "images.txt")
    )[skip_early:]:
        rel = os.path.join(image_dir, name)
        # COLMAP stores world→camera as (qvec wxyz, tvec); invert → c2w.
        m = np.eye(4)
        m[:3, :3] = qvec2rotmat(qvec)
        m[:3, 3] = tvec
        c2w = np.linalg.inv(m)
        if not keep_colmap_coords:
            c2w[0:3, 2] *= -1  # flip y and z axes
            c2w[0:3, 1] *= -1
            c2w = c2w[[1, 0, 2, 3], :]
            c2w[2, :] *= -1  # flip world upside down
        frame = {"file_path": rel, "transform_matrix": c2w}
        if compute_sharpness and os.path.exists(rel):
            frame["sharpness"] = sharpness(rel)
        out["frames"].append(frame)

    if keep_colmap_coords:
        flip = np.diag([1.0, -1.0, -1.0, 1.0])
        for f in out["frames"]:
            f["transform_matrix"] = f["transform_matrix"] @ flip
    else:
        reorient_and_rescale(out["frames"])

    for f in out["frames"]:
        f["transform_matrix"] = np.asarray(f["transform_matrix"]).tolist()
    return out


# ---- NSVF ----

def nsvf_to_transforms(scene_dir: str, aabb_scale: int = 2) -> dict:
    """NSVF-format scene (``intrinsics.txt``, ``bbox.txt``, ``pose/*.txt``,
    ``rgb/*``) → transforms dict (``nsvf2nerf.py:75-160``). Splits by the
    NSVF ``0_``/``1_``/``2_`` train/val/test filename prefixes; returns
    ``{"train": ..., "val": ..., "test": ...}`` (present splits only)."""
    rgb_dir = os.path.join(scene_dir, "rgb")
    files = sorted(
        glob(os.path.join(rgb_dir, "*.png")) + glob(os.path.join(rgb_dir, "*.jpg"))
    )
    if not files:
        raise ValueError(f"no images under {rgb_dir}")
    w, h = image_size(files[0])

    els = list(
        map(float, " ".join(open(os.path.join(scene_dir, "intrinsics.txt"))
                            .read().split("\n")).split())
    )
    if len(els) >= 16:  # full 4x4 K matrix
        fl_x, fl_y, cx, cy = els[0], els[5], els[2], els[6]
    else:  # f cx cy ...
        fl_x = fl_y = els[0]
        cx, cy = els[1], els[2]

    bbox = list(map(float, open(os.path.join(scene_dir, "bbox.txt"))
                    .read().split()))[:6]
    centroid = np.array(
        [(bbox[0] + bbox[3]) / 2, (bbox[1] + bbox[4]) / 2, (bbox[2] + bbox[5]) / 2]
    )
    radius = max(
        (bbox[3] - bbox[0]) / 2, (bbox[4] - bbox[1]) / 2, (bbox[5] - bbox[2]) / 2
    )
    scale = 0.5 / radius

    base = {
        "camera_angle_x": math.atan(w / (fl_x * 2)) * 2,
        "camera_angle_y": math.atan(h / (fl_y * 2)) * 2,
        "fl_x": fl_x, "fl_y": fl_y, "cx": cx, "cy": cy, "w": w, "h": h,
        "k1": 0.0, "k2": 0.0, "p1": 0.0, "p2": 0.0,
        "scale": 1, "offset": [0.5, 0.5, 0.5], "aabb_scale": int(aabb_scale),
    }

    splits: dict[str, dict] = {}
    names = {"0": "train", "1": "val", "2": "test"}
    for img_f in files:
        stem = os.path.splitext(os.path.basename(img_f))[0]
        split = names.get(stem.split("_")[0], "train")
        pose_f = os.path.join(scene_dir, "pose", stem + ".txt")
        m = np.array(list(map(float, open(pose_f).read().split()))).reshape(4, 4)
        c2w = m.copy()
        c2w[0:3, 3] = (c2w[0:3, 3] - centroid) * scale
        c2w[0:3, 2] *= -1
        c2w[0:3, 1] *= -1
        c2w = c2w[[0, 2, 1, 3], :]  # swap y and z
        c2w[2, :] *= -1
        splits.setdefault(split, {**base, "frames": []})["frames"].append(
            {"file_path": img_f, "transform_matrix": c2w.tolist()}
        )
    return splits


# ---- Record3D ----

def _quat_xyzw_to_rotmat(q):
    x, y, z, w = q
    return qvec2rotmat(np.array([w, x, y, z]))


def record3d_to_transforms(
    scene_dir: str, subsample: int = 1, aabb_scale: int = 16
) -> dict:
    """Record3D capture (``metadata`` json + ``rgbd/*.jpg``) → transforms
    dict (``record3d2nerf.py:95-175``, non-rotated portrait path)."""
    with open(os.path.join(scene_dir, "metadata")) as f:
        meta = json.load(f)
    poses = np.asarray(meta["poses"])  # (N, 7) [qx qy qz qw tx ty tz]
    n = len(glob(os.path.join(scene_dir, "rgbd", "*.jpg")))
    K = np.asarray(meta["K"]).reshape(3, 3).T
    out = {
        "fl_x": K[0, 0], "fl_y": K[1, 1], "cx": K[0, 2], "cy": K[1, 2],
        "w": meta["w"], "h": meta["h"],
        "aabb_scale": int(aabb_scale), "scale": 1.0, "frames": [],
    }
    out["camera_angle_x"] = 2 * math.atan(out["w"] / (2 * out["fl_x"]))
    out["camera_angle_y"] = 2 * math.atan(out["h"] / (2 * out["fl_y"]))
    for i in range(0, min(n, len(poses)), subsample):
        c2w = np.eye(4)
        c2w[:3, :3] = _quat_xyzw_to_rotmat(poses[i, :4])
        c2w[:3, 3] = poses[i, 4:7]
        out["frames"].append(
            {"file_path": f"./rgbd/{i}.jpg", "transform_matrix": c2w}
        )
    center = min_line_dist_center(out["frames"])
    avglen = np.mean(
        [
            np.linalg.norm(np.asarray(f["transform_matrix"])[:3, 3] - center)
            for f in out["frames"]
        ]
    )
    for f in out["frames"]:
        m = np.asarray(f["transform_matrix"])
        m[:3, 3] = (m[:3, 3] - center) * (4.0 / max(avglen, 1e-9))
        f["transform_matrix"] = m.tolist()
    return out


# ---- NeRFCapture ----

def nerfcapture_to_transforms(
    frames: list[dict], w: int, h: int, aabb_scale: int = 16,
    depth_scale: float | None = None,
) -> dict:
    """Assemble a transforms dict from NeRFCapture-style per-frame records
    (each with fl_x/fl_y/cx/cy, file_path, transform_matrix 4×4 row-major,
    optional depth_path) — the offline half of ``nerfcapture2nerf.py``
    (the DDS network listener is out of scope; any producer of these
    records can feed this)."""
    out = {
        "w": w,
        "h": h,
        "fl_x": float(np.mean([f["fl_x"] for f in frames])),
        "fl_y": float(np.mean([f["fl_y"] for f in frames])),
        "cx": float(np.mean([f["cx"] for f in frames])),
        "cy": float(np.mean([f["cy"] for f in frames])),
        "aabb_scale": int(aabb_scale),
        "frames": [],
    }
    out["camera_angle_x"] = 2 * math.atan(w / (2 * out["fl_x"]))
    if depth_scale is not None:
        out["integer_depth_scale"] = float(depth_scale) / 65535.0
    for f in frames:
        rec = {
            "file_path": f["file_path"],
            "transform_matrix": np.asarray(f["transform_matrix"]).tolist(),
        }
        if "depth_path" in f:
            rec["depth_path"] = f["depth_path"]
        out["frames"].append(rec)
    return out

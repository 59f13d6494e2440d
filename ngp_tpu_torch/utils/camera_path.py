"""Camera paths, the port's numpy copy of ``ngp_tpu/utils/camera_path.py``:
keyframes, cubic-B-spline evaluation and JSON interop (the reference's
``camera_path.h`` / ``src/camera_path.cu``, without the ImGuizmo editor;
paths are edited as JSON or built in code). ``ngp_tpu_torch.run`` renders
a path as video frames.

Keyframes hold (quaternion R, position T, slice, scale, fov,
aperture_size); ``eval_camera_path(t)`` blends four neighbors with the
reference's uniform cubic B-spline weights (``camera_path.cu:63-71``), with
shortest-path quaternion handling. The JSON schema matches the reference's
(``{"path": [{"R": [...], "T": [...], ...}], "loop": ..., "time": ...}``)
so saved paths interchange.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np


def quat_normalize(q: np.ndarray) -> np.ndarray:
    return q / max(np.linalg.norm(q), 1e-12)


def quat_to_mat(q: np.ndarray) -> np.ndarray:
    """(x, y, z, w) quaternion → 3×3 rotation (glm layout)."""
    x, y, z, w = quat_normalize(q)
    return np.asarray(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ],
        np.float32,
    )


def mat_to_quat(m: np.ndarray) -> np.ndarray:
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(m)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(m[i, i] - m[j, j] - m[k, k] + 1.0, 1e-12)) * 2
        q = np.zeros(4)
        q[i] = 0.25 * s
        q[3] = (m[k, j] - m[j, k]) / s
        q[j] = (m[j, i] + m[i, j]) / s
        q[k] = (m[k, i] + m[i, k]) / s
        x, y, z, w = q
    return quat_normalize(np.asarray([x, y, z, w], np.float32))


@dataclass
class CameraKeyframe:
    R: np.ndarray  # quaternion (x, y, z, w)
    T: np.ndarray  # (3,)
    slice: float = 0.0
    scale: float = 1.0
    fov: float = 50.0
    aperture_size: float = 0.0

    @classmethod
    def from_matrix(cls, m, **kw) -> "CameraKeyframe":
        m = np.asarray(m, np.float32)
        return cls(R=mat_to_quat(m[:3, :3]), T=m[:3, 3].copy(), **kw)

    def matrix(self) -> np.ndarray:
        out = np.zeros((3, 4), np.float32)
        out[:, :3] = quat_to_mat(self.R)
        out[:, 3] = self.T
        return out

    def scaled(self, f: float) -> "CameraKeyframe":
        return CameraKeyframe(
            self.R * f, self.T * f, self.slice * f, self.scale * f,
            self.fov * f, self.aperture_size * f,
        )

    def added(self, o: "CameraKeyframe") -> "CameraKeyframe":
        R2 = o.R if float(np.dot(self.R, o.R)) >= 0 else -o.R
        return CameraKeyframe(
            self.R + R2, self.T + o.T, self.slice + o.slice,
            self.scale + o.scale, self.fov + o.fov,
            self.aperture_size + o.aperture_size,
        )


def spline(t: float, p0, p1, p2, p3) -> CameraKeyframe:
    """Uniform cubic B-spline blend (``camera_path.cu:63-71``)."""
    tt = t * t
    ttt = tt * t
    a = (1 - t) ** 3 / 6.0
    b = (3 * ttt - 6 * tt + 4) / 6.0
    c = (-3 * ttt + 3 * tt + 3 * t + 1) / 6.0
    d = ttt / 6.0
    out = p0.scaled(a).added(p1.scaled(b)).added(p2.scaled(c)).added(p3.scaled(d))
    out.R = quat_normalize(out.R)
    return out


@dataclass
class CameraPath:
    keyframes: list = field(default_factory=list)
    loop: bool = False

    def get_keyframe(self, i: int) -> CameraKeyframe:
        n = len(self.keyframes)
        if self.loop:
            return self.keyframes[(i + n) % n]
        return self.keyframes[int(np.clip(i, 0, n - 1))]

    def eval_camera_path(self, t: float) -> CameraKeyframe:
        """t ∈ [0, 1] → interpolated keyframe (``eval_camera_path``)."""
        if not self.keyframes:
            raise ValueError("empty camera path")
        n = len(self.keyframes)
        t = t * (n if self.loop else n - 1)
        i = int(np.floor(t))
        f = t - i
        return spline(
            f,
            self.get_keyframe(i - 1), self.get_keyframe(i),
            self.get_keyframe(i + 1), self.get_keyframe(i + 2),
        )

    # -- JSON interop (camera_path.cu:74-139)

    def save(self, path: str) -> None:
        doc = {
            "loop": self.loop,
            "time": 0.0,
            "path": [
                {
                    "R": [float(v) for v in k.R],
                    "T": [float(v) for v in k.T],
                    "slice": k.slice,
                    "scale": k.scale,
                    "fov": k.fov,
                    "aperture_size": k.aperture_size,
                }
                for k in self.keyframes
            ],
        }
        with open(path, "w") as f:
            json.dump(doc, f, indent=2)

    @classmethod
    def load(cls, path: str) -> "CameraPath":
        with open(path) as f:
            doc = json.load(f)
        out = cls(loop=bool(doc.get("loop", False)))
        for el in doc.get("path", []):
            out.keyframes.append(
                CameraKeyframe(
                    R=np.asarray(el["R"], np.float32),
                    T=np.asarray(el["T"], np.float32),
                    slice=float(el.get("slice", 0.0)),
                    scale=float(el.get("scale", 1.0)),
                    fov=float(el.get("fov", 50.0)),
                    aperture_size=float(el.get("aperture_size", 0.0)),
                )
            )
        return out


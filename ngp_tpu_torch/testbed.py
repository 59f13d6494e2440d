"""The ``Testbed`` orchestrator for NeRF, SDFs, images and volumes, the port of
``ngp_tpu/testbed.py`` (the reference's ``Testbed`` class and ``pyngp``
surface, ``src/testbed.cu``, ``src/python_api.cu:266-696``).

The mode comes from the scene path as in ``mode_from_scene``
(``src/common.cu:144-173``): a directory or ``transforms.json`` is NeRF,
``.obj``/``.stl`` SDF, ``.nvdb``/``.npy`` a volume, image files an image.
All four modes are ported. In NeRF mode ``Testbed`` loads a capture,
trains, renders, evaluates, exports a mesh and saves and loads snapshots
through ``engines/nerf.py:NerfEngine``;
in SDF mode it loads an ASCII ``.obj`` or binary ``.stl`` mesh, trains,
scores the IoU, renders, exports a mesh and saves and loads snapshots
through ``engines/sdf.py:SdfEngine``; in image mode it loads a ``.png``,
``.jpg``, ``.exr`` or ``.bin`` image, trains, renders, scores and saves and loads
snapshots through ``engines/image.py:ImageEngine``; in volume mode it
loads an ``.nvdb`` (uncompressed FloatGrid) or ``.npy`` density volume,
trains, renders and saves and loads snapshots through
``engines/volume.py:VolumeEngine``. All run on the card unless built with
``device="cpu"``.

NeRF options go to the engine as keywords (``Testbed(scene,
train_envmap=True, depth_supervision_lambda=0.5, optimize_exposure=True,
reference_prep_cadence=False, ...)``); a capture's depth maps, envmap,
supplied rays and ``n_extra_learnable_dims`` come with it, and a
``<name>.obj`` mesh or ``<name>.xyz`` point cloud beside it (``<name>`` the
capture's directory) seeds the density grid (the fork's geometry prior).
``render_aabb`` gets and sets the engine's render crop box.

Not yet ported, and refused: ``frame()`` (the viewer's heartbeat, A11).
"""

from __future__ import annotations

import copy
import dataclasses
import os
from typing import Any

import numpy as np
import torch

from ngp_tpu_torch.config import load_config

MODES = ("nerf", "sdf", "image", "volume")
# the SDF camera of render() when no eye or lookat is given, and its field
# of view, as the JAX package's Testbed places it
SDF_EYE, SDF_LOOKAT, SDF_FOV_DEG = (0.5, 0.5, 2.0), (0.5, 0.5, 0.5), 50.0
# the volume camera of render() when no eye or lookat is given
VOLUME_EYE, VOLUME_LOOKAT = (0.5, 0.5, 2.2), (0.5, 0.5, 0.5)

# instant-ngp's configs/nerf/base.json, configs/sdf/base.json and
# configs/image/base.json, and the volume config, as the JAX package's
# Testbed holds them
_DEFAULT_CONFIGS = {
    "nerf": {
        "loss": {"otype": "Huber"},
        "optimizer": {
            "otype": "Ema", "decay": 0.95,
            "nested": {
                "otype": "ExponentialDecay", "decay_start": 20000,
                "decay_interval": 10000, "decay_base": 0.33,
                "nested": {"otype": "Adam", "learning_rate": 1e-2, "beta1": 0.9,
                           "beta2": 0.99, "epsilon": 1e-15, "l2_reg": 1e-6},
            },
        },
        "encoding": {"otype": "HashGrid", "n_levels": 16,
                     "n_features_per_level": 2, "log2_hashmap_size": 19,
                     "base_resolution": 16},
        "network": {"otype": "FullyFusedMLP", "activation": "ReLU",
                    "output_activation": "None", "n_neurons": 64,
                    "n_hidden_layers": 1},
        "dir_encoding": {"otype": "Composite", "nested": [
            {"n_dims_to_encode": 3, "otype": "SphericalHarmonics", "degree": 4},
            {"otype": "Identity"},
        ]},
        "rgb_network": {"otype": "FullyFusedMLP", "activation": "ReLU",
                        "output_activation": "None", "n_neurons": 64,
                        "n_hidden_layers": 2},
    },
    "sdf": {
        "loss": {"otype": "MAPE"},
        "optimizer": {
            "otype": "Ema", "decay": 0.95,
            "nested": {
                "otype": "ExponentialDecay", "decay_start": 10000,
                "decay_interval": 5000, "decay_base": 0.33,
                "nested": {"otype": "Adam", "learning_rate": 1e-4, "beta1": 0.9,
                           "beta2": 0.99, "epsilon": 1e-15, "l2_reg": 1e-6},
            },
        },
        "encoding": {"otype": "HashGrid", "n_levels": 16,
                     "n_features_per_level": 2, "log2_hashmap_size": 19,
                     "base_resolution": 16},
        "network": {"otype": "FullyFusedMLP", "activation": "ReLU",
                    "output_activation": "None", "n_neurons": 64,
                    "n_hidden_layers": 2},
    },
    "image": {
        "loss": {"otype": "RelativeL2"},
        "optimizer": {
            "otype": "Ema", "decay": 0.99,
            "nested": {
                "otype": "ExponentialDecay", "decay_start": 10000,
                "decay_interval": 5000, "decay_base": 0.33,
                "nested": {"otype": "Adam", "learning_rate": 1e-2, "beta1": 0.9,
                           "beta2": 0.99, "epsilon": 1e-8, "l2_reg": 1e-6},
            },
        },
        "encoding": {"otype": "HashGrid", "n_levels": 16,
                     "n_features_per_level": 2, "log2_hashmap_size": 24,
                     "base_resolution": 16},
        "network": {"otype": "FullyFusedMLP", "activation": "ReLU",
                    "output_activation": "None", "n_neurons": 64,
                    "n_hidden_layers": 2},
    },
    "volume": {
        "loss": {"otype": "L2"},
        "optimizer": {
            "otype": "Ema", "decay": 0.95,
            "nested": {
                "otype": "ExponentialDecay", "decay_start": 10000,
                "decay_interval": 5000, "decay_base": 0.33,
                "nested": {"otype": "Adam", "learning_rate": 1e-4, "beta1": 0.9,
                           "beta2": 0.99, "epsilon": 1e-15, "l2_reg": 1e-6},
            },
        },
        "encoding": {"otype": "HashGrid", "n_levels": 16,
                     "n_features_per_level": 2, "log2_hashmap_size": 19,
                     "base_resolution": 16},
        "network": {"otype": "FullyFusedMLP", "activation": "ReLU",
                    "output_activation": "ReLU", "n_neurons": 64,
                    "n_hidden_layers": 2},
    },
}


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not yet ported (ROADMAP {item})")


def mode_from_scene(path: str) -> str | None:
    """``mode_from_scene`` (``src/common.cu:144-173``)."""
    if os.path.isdir(path):
        return "nerf"
    ext = os.path.splitext(path)[1].lower().lstrip(".")
    if ext == "json":
        return "nerf"
    if ext in ("obj", "stl"):
        return "sdf"
    if ext in ("nvdb", "npy"):
        return "volume"
    if ext in ("exr", "bin", "png", "jpg", "jpeg", "bmp", "tga", "hdr"):
        return "image"
    return None


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")


def default_config(mode: str) -> dict:
    _check_mode(mode)
    return copy.deepcopy(_DEFAULT_CONFIGS[mode])


class Testbed:
    """``Testbed(mode=None, scene=None, config=None, **engine_kwargs)``.

    ``engine_kwargs`` go to the mode's engine (``NerfEngine``,
    ``SdfEngine``, ``ImageEngine``, ``VolumeEngine``) where it has such a
    field (``device``, ``seed``, ``batch_size``, ...); ``frame_subset``
    trains on those views of a NeRF scene only. Methods mirror the pyngp surface:
    ``load_training_data``, ``reload_network_from_json``, ``train``,
    ``render``, ``psnr`` (NeRF), ``calculate_iou`` and
    ``override_sdf_training_data`` (SDF), ``compute_image_mse`` (image),
    ``save_snapshot`` / ``load_snapshot``, ``compute_marching_cubes_mesh``
    (NeRF, SDF), ``training_step``, ``loss``."""

    def __init__(self, mode: str | None = None, scene: str | None = None,
                 config: str | dict | None = None, **engine_kwargs):
        if mode is not None:
            _check_mode(mode)
        self.mode = mode
        self.scene: str | None = None
        self.engine: Any = None
        self.state = None
        self.grid = None
        self.loss = float("nan")
        self._engine_kwargs = engine_kwargs
        self.network_config: dict | None = None
        if config is not None:
            self.reload_network_from_json(config, rebuild=False)
        if scene is not None:
            self.load_training_data(scene)

    # -- data and config loading

    def load_training_data(self, path: str) -> None:
        mode = self.mode or mode_from_scene(path)
        if mode is None:
            raise ValueError(f"cannot infer mode from scene path {path!r}")
        _check_mode(mode)
        self.mode = mode
        self.scene = path
        self.network_config = self.network_config or default_config(mode)
        self._build_engine(self.network_config)

    def reload_network_from_json(self, config: str | dict, rebuild: bool = True) -> None:
        if isinstance(config, str):
            config = load_config(config)
        self.network_config = config
        if rebuild and self.mode is not None and self.scene:
            self._build_engine(config)

    def _nerf_geometry_prior(self, ds, grid_cfg):
        """The fork's geometry-seeded occupancy (``Testbed::load_nerf``,
        ``src/testbed_nerf.cu:3115-3159``): a ``<name>.obj`` mesh or, where
        there is none, a ``<name>.xyz`` point cloud in the capture's
        directory ``<name>`` gives a (C, G, G, G) prior for ``init_grid``;
        None without either. The mesh's raw vertices are cycled (x, y, z) →
        (−z, y, x), then scaled and offset (load_mesh_for_density_grid,
        :3205-3212); the points scaled and offset, then cycled to columns
        [1, 2, 0] (build_density_grid_from_point_cloud, :3322-3327)."""
        from ngp_tpu_torch.ops import occupancy as occ

        base = self.scene if os.path.isdir(self.scene) else os.path.dirname(self.scene)
        name = os.path.basename(os.path.normpath(base))
        obj = os.path.join(base, name + ".obj")
        xyz = os.path.join(base, name + ".xyz")
        offset = np.asarray(ds.offset, np.float32)
        if os.path.exists(obj):
            from ngp_tpu_torch.geometry.mesh import load_mesh_file

            v = load_mesh_file(obj).reshape(-1, 3)
            v = np.stack([-v[:, 2], v[:, 1], v[:, 0]], -1)
            v = ds.scale * v + offset
            return occ.seed_grid_from_mesh(grid_cfg, v.reshape(-1, 3, 3))
        if os.path.exists(xyz):
            from ngp_tpu_torch.geometry.mesh import load_xyz

            pts = ds.scale * load_xyz(xyz) + offset
            return occ.seed_grid_from_point_cloud(grid_cfg, pts[:, [1, 2, 0]])
        return None

    def _engine_fields(self, engine_cls) -> dict:
        fields = {f.name for f in dataclasses.fields(engine_cls)}
        return {k: v for k, v in self._engine_kwargs.items() if k in fields}

    def _build_engine(self, cfg: dict) -> None:
        if self.mode == "image":
            from ngp_tpu_torch.data.image_loader import load_image
            from ngp_tpu_torch.engines.image import ImageEngine

            self.engine = ImageEngine(copy.deepcopy(cfg), load_image(self.scene),
                                      **self._engine_fields(ImageEngine))
            self.state = self.engine.init_state()
            return
        if self.mode == "sdf":
            from ngp_tpu_torch.engines.sdf import SdfEngine

            self.engine = SdfEngine.from_file(copy.deepcopy(cfg), self.scene,
                                              **self._engine_fields(SdfEngine))
            self.state = self.engine.init_state()
            return
        if self.mode == "volume":
            from ngp_tpu_torch.data.volume import load_volume
            from ngp_tpu_torch.engines.volume import VolumeEngine

            fields = self._engine_fields(VolumeEngine)
            volume = load_volume(self.scene, fields.get("device", "cuda"))
            self.engine = VolumeEngine(copy.deepcopy(cfg), volume, **fields)
            self.state = self.engine.init_state()
            return
        from ngp_tpu_torch.data.nerf_loader import load_nerf
        from ngp_tpu_torch.engines.nerf import NerfEngine

        kw = self._engine_kwargs
        ds = load_nerf(self.scene)
        if kw.get("frame_subset") is not None:
            ds = ds.subset(kw["frame_subset"])
        self.engine = NerfEngine(copy.deepcopy(cfg), ds, **self._engine_fields(NerfEngine))
        self.state = self.engine.init_state()
        self.grid = self.engine.init_grid(
            precomputed_density=self._nerf_geometry_prior(ds, self.engine.grid_cfg))

    # -- training

    @property
    def training_step(self) -> int:
        return int(self.state.step) if self.state is not None else 0

    def train(self, n_steps: int) -> None:
        if self.mode in ("image", "sdf", "volume"):
            self.state, losses = self.engine.train(self.state, n_steps)
            if len(losses):
                self.loss = float(losses[-1])
            return
        self.state, self.grid, metrics = self.engine.train(self.state, self.grid, n_steps)
        if metrics:
            self.loss = float(metrics["loss"])

    def frame(self, *args, **kwargs) -> dict:
        raise not_ported("frame() (the viewer's heartbeat)", "A11")

    # -- the training set, edited in place (pyngp's nerf.training surface)

    @property
    def n_images(self) -> int:
        return int(self.engine.images.shape[0])

    def set_camera_extrinsics(self, frame_idx: int, camera_to_world,
                              convert_to_ngp: bool = True) -> None:
        """Overwrite one training camera's pose: ``camera_to_world`` (3, 4)
        or (4, 4), converted from the NeRF convention with the dataset's
        scale and offset when ``convert_to_ngp``."""
        from ngp_tpu_torch.data.nerf_loader import nerf_matrix_to_ngp

        m = np.asarray(camera_to_world, np.float32)[:3, :4]
        ds = self.engine.dataset
        if convert_to_ngp:
            m = nerf_matrix_to_ngp(m, ds.scale, np.asarray(ds.offset))
        self.engine.xforms[frame_idx] = torch.as_tensor(m, device=self.engine.device)

    def get_camera_extrinsics(self, frame_idx: int,
                              convert_to_nerf: bool = True) -> np.ndarray:
        from ngp_tpu_torch.data.nerf_loader import ngp_matrix_to_nerf

        m = self.engine.xforms[frame_idx].cpu().numpy()
        ds = self.engine.dataset
        if convert_to_nerf:
            m = ngp_matrix_to_nerf(m, ds.scale, np.asarray(ds.offset))
        return m

    def set_camera_intrinsics(self, frame_idx: int, fx: float | None = None,
                              fy: float | None = None, cx: float | None = None,
                              cy: float | None = None) -> None:
        """Overwrite one training camera's focal lengths and principal
        point, in pixels."""
        W, H = self.engine.resolution
        for i, v in ((0, fx), (1, fy)):
            if v is not None:
                self.engine.focals[frame_idx, i] = v
        for i, v, size in ((0, cx, W), (1, cy, H)):
            if v is not None:
                self.engine.pps[frame_idx, i] = v / size

    def set_image(self, frame_idx: int, img: np.ndarray, depth: np.ndarray | None = None) -> None:
        """Replace one training image ((H, W, 3 | 4), float in [0, 1] or
        uint8) and, where the engine holds depth maps (depth supervision
        on a capture with depths), its depth map ((H, W) NGP-scale
        z-depths); elsewhere ``depth`` is ignored, as in the JAX package."""
        images = self.engine.images
        img = np.asarray(img)
        if img.shape[-1] == 3:
            alpha = np.full_like(img[..., :1], 255 if img.dtype == np.uint8 else 1)
            img = np.concatenate([img, alpha], -1)
        if images.dtype == torch.uint8 and img.dtype != np.uint8:
            img = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
        images[frame_idx] = torch.as_tensor(img, device=images.device).to(images.dtype)
        depths = self.engine.depths
        if depth is not None and depths is not None:
            depths[frame_idx] = torch.as_tensor(np.asarray(depth), device=depths.device,
                                                dtype=depths.dtype)

    # -- rendering

    def render(self, width: int, height: int, spp: int = 1, camera_matrix=None,
               eye=None, lookat=None, fov_deg: float = 50.0,
               training_view: int | None = None, start_matrix=None,
               end_matrix=None, shutter_fraction: float = 0.0) -> np.ndarray:
        """Render (H, W, 3) float32, ``pyngp.Testbed.render``. NeRF: the
        dataset view ``training_view`` at its own resolution, or a pinhole
        camera ``camera_matrix`` (NGP space; default ``start_matrix``, else
        training view 0) with a vertical field of view of ``fov_deg``; with
        an ``end_matrix`` that differs from it, a rolling shutter: pixel
        row y (its center v = (y + 0.5)/H) sees the pose lerped to time
        v·``shutter_fraction`` (the JAX package's ``_lerp_xforms``);
        ``spp``, ``eye`` and ``lookat`` do not apply, as in the JAX package.
        SDF: the headlight shade from ``eye`` (default [0.5, 0.5, 2.0])
        toward ``lookat`` (default [0.5, 0.5, 0.5]) with a horizontal field
        of view of ``fov_deg``. Volume: the learned field from ``eye``
        (default [0.5, 0.5, 2.2]) toward ``lookat`` (default [0.5, 0.5,
        0.5]), ``fov_deg`` across the width. Image: the fitted image at
        width × height texel centres, linear colours; the camera arguments
        do not apply."""
        if self.mode == "image":
            return self.engine.render(self.state, width, height).cpu().numpy()
        if self.mode == "sdf":
            eye = SDF_EYE if eye is None else eye
            lookat = SDF_LOOKAT if lookat is None else lookat
            img, _ = self.engine.render_image(self.state, eye, lookat,
                                              resolution=(width, height), fov_deg=fov_deg)
            return img.cpu().numpy()
        if self.mode == "volume":
            eye = VOLUME_EYE if eye is None else eye
            lookat = VOLUME_LOOKAT if lookat is None else lookat
            img, _ = self.engine.render_image(self.state, eye, lookat,
                                              resolution=(width, height), fov_deg=fov_deg)
            return img.cpu().numpy()
        if training_view is not None:
            return self.engine.render_image(self.state, self.grid, training_view).cpu().numpy()
        if camera_matrix is None:
            camera_matrix = (start_matrix if start_matrix is not None
                             else self.engine.xforms[0].cpu().numpy())
        W, H = width, height
        f = 0.5 * H / np.tan(0.5 * np.radians(fov_deg))
        px, py = np.meshgrid((np.arange(W) + 0.5) / W, (np.arange(H) + 0.5) / H)
        x = (px - 0.5) * W / f
        y = (py - 0.5) * H / f
        dc = np.stack([x, y, np.ones_like(x)], -1).reshape(-1, 3)
        m = np.asarray(camera_matrix, np.float32)[:3, :4]
        me = None if end_matrix is None else np.asarray(end_matrix, np.float32)[:3, :4]
        if me is not None and not np.array_equal(me, m):
            from ngp_tpu_torch.engines.nerf import _lerp_xforms

            dev, n = self.engine.device, dc.shape[0]
            t = torch.as_tensor((py.reshape(-1) * float(shutter_fraction)).astype(np.float32),
                                device=dev)
            xf = _lerp_xforms(torch.tensor(m, device=dev).expand(n, 3, 4),
                              torch.tensor(me, device=dev).expand(n, 3, 4), t)
            d = torch.einsum("nij,nj->ni", xf[:, :, :3],
                             torch.as_tensor(dc.astype(np.float32), device=dev))
            d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
            o = xf[:, :, 3]
        else:  # a still camera (an end pose equal to the start moves nothing)
            d = dc @ m[:, :3].T
            d /= np.linalg.norm(d, axis=-1, keepdims=True)
            o = torch.as_tensor(np.broadcast_to(m[:, 3], d.shape).astype(np.float32))
            d = torch.as_tensor(d.astype(np.float32))
        rgb, _, _ = self.engine.render_rays(self.state, self.grid, o, d)
        return rgb.cpu().numpy().reshape(H, W, 3)

    @property
    def render_aabb(self):
        """The render crop box ``(min, max)`` in NGP space, or None for the
        scene box (``m_render_aabb``; pyngp's ``render_aabb``)."""
        self._require("nerf", "render_aabb")
        return self.engine.render_aabb

    @render_aabb.setter
    def render_aabb(self, box) -> None:
        self._require("nerf", "render_aabb")
        self.engine.render_aabb = None if box is None else tuple(
            np.asarray(b, np.float32) for b in box)

    # -- evaluation and products

    def _require(self, mode: str, what: str) -> None:
        if self.mode != mode:
            raise ValueError(f"{what} needs {mode} mode, not {self.mode}")

    def psnr(self, view: int = 0, stride: int = 1) -> float:
        self._require("nerf", "psnr")
        return self.engine.psnr(self.state, self.grid, view, stride)

    def calculate_iou(self, n_samples: int = 1 << 17) -> float:
        """The SDF's sign-agreement IoU over ``n_samples`` uniform points
        (``SdfEngine.calculate_iou``)."""
        self._require("sdf", "calculate_iou")
        return self.engine.calculate_iou(self.state, n_samples)

    def override_sdf_training_data(self, points, distances) -> None:
        """Train the SDF on these (points (N, 3), distances (N,)) instead of
        the BVH's samples (``python_api.cu:69-99``)."""
        self._require("sdf", "override_sdf_training_data")
        dev = self.engine.device
        self.engine.override_training_data = (
            torch.as_tensor(np.asarray(points, np.float32), device=dev),
            torch.as_tensor(np.asarray(distances, np.float32), device=dev))

    def compute_image_mse(self) -> float:
        """The fitted image's MSE over every texel in the training colour
        space (``ImageEngine.compute_mse``)."""
        self._require("image", "compute_image_mse")
        return float(self.engine.compute_mse(self.state))

    def compute_marching_cubes_mesh(self, resolution: int = 256, thresh: float = 2.5):
        """NeRF: the density's ``thresh`` level set; SDF: the zero level
        set (``thresh`` does not apply)."""
        if self.mode == "sdf":
            return self.engine.compute_marching_cubes_mesh(self.state, resolution)
        if self.mode != "nerf":
            raise ValueError(f"mesh export needs nerf or sdf mode, not {self.mode}")
        return self.engine.compute_marching_cubes_mesh(self.state, resolution, thresh)

    def save_snapshot(self, path: str) -> None:
        if self.mode in ("image", "sdf", "volume"):
            self.engine.save_snapshot(path, self.state)
        else:
            self.engine.save_snapshot(path, self.state, self.grid)

    def load_snapshot(self, path: str) -> None:
        if self.mode in ("image", "sdf", "volume"):
            self.state = self.engine.load_snapshot(path)
        else:
            self.state, self.grid = self.engine.load_snapshot(path)

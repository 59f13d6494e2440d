"""The Block-NeRF street pipeline, the port of ``ngp_tpu/blocknerf.py``: the
fork trains one NeRF per city block and plays a drive-through back by
hot-swapping block models (``Testbed::train_street_view_nerf``,
``src/testbed.cu:377-418``; block snapshots ``:505-611``; playback
``:3606-3675``).

- :func:`load_block_nerf_data`: ``blocks/<b>/pose.csv`` (a header, then
  rows of image, fx, fy, cx, cy and the 12 row-major entries of a
  camera-to-world matrix) and ``setting.json`` (scale, default 0.02;
  aabb_scale, default 4; training_steps; n_extra_learnable_dims), frames
  from ``images/`` read by the port's PNG, JPEG and EXR readers; the
  offset puts the middle camera at (0.5,)³, and the camera AABB stays in
  raw world coordinates (``src/nerf_loader.cu:731-905``).
- :func:`train_street_view_nerf`: a NeRF a block and its block snapshot
  (:func:`save_block_nerf`: parameters, the float16 density grid, scale and
  offset, the camera and NeRF AABBs), each block on its own or every n-th
  (``block_shard``).
- :class:`BlockNerfRenderer`: loads the block snapshots (the port's or the
  JAX package's), picks the block whose camera AABB is nearest a raw-world
  pose and renders it through one engine, whose weights and grid it swaps
  in.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from ngp_tpu_torch.data.nerf_loader import NerfDataset, _load_frame_images, nerf_matrix_to_ngp
from ngp_tpu_torch.engines.nerf import NerfEngine, _lerp_xforms
from ngp_tpu_torch.geometry.camera import Lens
from ngp_tpu_torch.utils.snapshot import load_snapshot, save_snapshot


def _pose_rows(pose_csv: str) -> list:
    """The rows of a ``pose.csv`` after its header, split at commas with
    empty fields dropped; blank rows skipped."""
    with open(pose_csv) as f:
        lines = [line.strip() for line in f.readlines()][1:]
    rows = [[p.strip() for p in line.split(",") if p.strip() != ""] for line in lines]
    return [r for r in rows if r]


def _row_matrix(parts: list) -> np.ndarray:
    return np.asarray([float(v) for v in parts[5:17]], np.float32).reshape(3, 4)


def load_block_nerf_data(root: str, block_name: str) -> NerfDataset:
    """The block's dataset, with ``camera_aabb`` ((3,) min, (3,) max of the
    raw camera positions) and ``n_training_steps`` set on it."""
    block_path = os.path.join(root, "blocks", block_name)
    pose_csv = os.path.join(block_path, "pose.csv")
    paths, mats, focals, pps = [], [], [], []
    for parts in _pose_rows(pose_csv):
        if len(parts) < 17:
            raise ValueError(f"bad pose.csv row in {pose_csv}: {parts!r}")
        paths.append(os.path.join(root, "images", parts[0]))
        focals.append((float(parts[1]), float(parts[2])))
        pps.append((float(parts[3]), float(parts[4])))
        mats.append(_row_matrix(parts))
    if not paths:
        raise ValueError(f"no rows in {pose_csv}")

    setting_path = os.path.join(block_path, "setting.json")
    if not os.path.exists(setting_path):
        setting_path = os.path.join(root, "blocks", "setting.json")
    with open(setting_path) as f:
        setting = json.load(f)
    scale = float(setting.get("scale", 0.02))
    aabb_scale = int(setting.get("aabb_scale", 4))
    n_training_steps = int(setting.get("training_steps", 10000))
    n_extra = int(setting.get("n_extra_learnable_dims", 0))

    cam_pos = np.stack([m[:, 3] for m in mats])
    cam_aabb = (cam_pos.min(axis=0), cam_pos.max(axis=0))
    center = cam_pos[len(cam_pos) // 2] * scale
    offset = np.float32(0.5) - center.astype(np.float32)

    images = np.stack(_load_frame_images(paths))
    H, W = images.shape[1:3]
    xforms = np.zeros((len(paths), 2, 3, 4), np.float32)
    for i, m in enumerate(mats):
        # the fork negates columns 1 and 2 and then calls nerf_matrix_to_ngp,
        # which negates them again: negate here to cancel ours
        m2 = m.copy()
        m2[:, 1] *= -1.0
        m2[:, 2] *= -1.0
        xforms[i, 0] = xforms[i, 1] = nerf_matrix_to_ngp(m2, scale, offset)
    ds = NerfDataset(
        images=images,
        xforms=xforms,
        focal_lengths=np.asarray(focals, np.float32),
        principal_points=np.asarray(pps, np.float32) / np.asarray([W, H], np.float32),
        lens=Lens(),
        resolution=(W, H),
        scale=scale,
        offset=offset,
        aabb_scale=aabb_scale,
        paths=paths,
        n_extra_learnable_dims=n_extra,
    )
    ds.camera_aabb = cam_aabb  # raw world coordinates, as the fork keeps them
    ds.n_training_steps = n_training_steps
    return ds


def list_blocks(root: str) -> list[str]:
    bdir = os.path.join(root, "blocks")
    return sorted(b for b in os.listdir(bdir)
                  if b.startswith("b") and os.path.isdir(os.path.join(bdir, b)))


def playback_world_poses(root: str, n_frames: int) -> np.ndarray:
    """A drive-through of ``n_frames`` poses along every block's recorded
    cameras in order (the fork's playback, ``testbed.cu:3606-3675``): the
    pose lerped (rotation slerped, ``engines/nerf._lerp_xforms``) between
    consecutive recorded poses at evenly spaced times, then the positions
    smoothed by a (¼, ½, ¼) pass where there are more than 4 frames.
    Returns (n_frames, 3, 4) float32 raw-world matrices in ``pose.csv``'s
    convention, as :meth:`BlockNerfRenderer.render_at` takes them."""
    mats = [_row_matrix(parts) for block in list_blocks(root)
            for parts in _pose_rows(os.path.join(root, "blocks", block, "pose.csv"))]
    if len(mats) < 2:
        return np.repeat(np.asarray(mats, np.float32), n_frames, axis=0)
    mats = np.stack(mats)
    P = mats.shape[0]
    t = np.linspace(0.0, P - 1.0, n_frames)
    i0 = np.clip(t.astype(np.int64), 0, P - 2)
    frac = (t - i0).astype(np.float32)
    out = _lerp_xforms(torch.from_numpy(mats[i0]), torch.from_numpy(mats[i0 + 1]),
                       torch.from_numpy(frac)).numpy()
    if n_frames > 4:
        pos = out[:, :, 3]
        sm = pos.copy()
        sm[1:-1] = 0.25 * pos[:-2] + 0.5 * pos[1:-1] + 0.25 * pos[2:]
        out[:, :, 3] = sm
    return out


def save_block_nerf(path: str, engine: NerfEngine, state, grid, dataset) -> None:
    """The block snapshot (``save_block_nerf``, ``testbed.cu:505-545``): the
    JAX package's block keys (training step, parameters and EMA parameters
    as the JAX engine's trees, the float16 density grid and its mean, the
    ``nerf`` scene values) with the raw-world camera AABB and the NeRF AABB
    (the render box in raw world coordinates)."""
    render_aabb = (engine.aabb.min.cpu().numpy(), engine.aabb.max.cpu().numpy())
    nerf_aabb = ((render_aabb[0] - dataset.offset) / dataset.scale,
                 (render_aabb[1] - dataset.offset) / dataset.scale)
    save_snapshot(path, {
        "mode": "nerf",
        "network_config": engine.config,
        "snapshot": {
            "training_step": np.asarray(state.step, np.int32),
            "params": engine._jax_param_tree(state.model, state.camera, state.envmap),
            "ema_params": engine._jax_param_tree(state.inference_model(),
                                                 state.inference_camera(),
                                                 state.inference_envmap()),
            "density_grid": grid.density.cpu().numpy().astype(np.float16),
            "density_grid_mean": np.asarray(grid.mean_density.cpu().numpy(), np.float32),
            "nerf": {
                "aabb_scale": engine.aabb_scale,
                "scale": float(dataset.scale),
                "offset": np.asarray(dataset.offset),
                "n_extra_learnable_dims": dataset.n_extra_learnable_dims,
            },
            "camera_aabb": np.asarray(dataset.camera_aabb),
            "nerf_aabb": np.asarray(nerf_aabb),
        },
    })


def train_street_view_nerf(root: str, config: dict | None = None,
                           n_steps_override: int | None = None, log=print,
                           block_shard: tuple[int, int] | None = None, **engine_kwargs):
    """Train every ``blocks/b*`` (``train_street_view_nerf``) at ``config``
    (default: ``Testbed``'s NeRF config, instant-ngp's base.json) for its
    ``training_steps`` (or ``n_steps_override``) and write
    ``blocks/<b>/nerf.ingp``; returns the snapshots' paths.
    ``engine_kwargs`` go to ``NerfEngine`` (``device``, ``batch_size``,
    ...). ``block_shard=(i, n)`` trains every n-th block from block i:
    blocks are independent, so n processes split a city (the fork trains
    them one after another)."""
    from ngp_tpu_torch.testbed import default_config

    blocks = list_blocks(root)
    if block_shard is not None:
        i, n_shards = block_shard
        blocks = blocks[i::n_shards]
    out = []
    for block in blocks:
        log(f"Training block: {block}")
        ds = load_block_nerf_data(root, block)
        engine = NerfEngine(dict(config or default_config("nerf")), ds, **engine_kwargs)
        state, grid = engine.init_state(), engine.init_grid()
        n = n_steps_override or ds.n_training_steps
        state, grid, metrics = engine.train(state, grid, n)
        log(f"  block {block}: {n} steps, loss={float(metrics['loss']):.5f}")
        snap = os.path.join(root, "blocks", block, "nerf.ingp")
        save_block_nerf(snap, engine, state, grid, ds)
        out.append(snap)
    return out


@dataclass
class BlockNerfModel:
    path: str
    camera_aabb: np.ndarray  # (2, 3) raw world
    nerf_aabb: np.ndarray
    scale: float
    offset: np.ndarray
    aabb_scale: int
    config: dict

    def camera_center(self) -> np.ndarray:
        return self.camera_aabb.mean(axis=0)


class BlockNerfRenderer:
    """Playback: the block whose camera AABB is nearest the query pose
    (``Testbed::frame``'s playback, ``testbed.cu:3606-3675``), rendered
    through one engine (``set_block_nerf``). ``engine_kwargs`` go to
    ``NerfEngine``. ``swaps`` counts the block loads, ``swap_s`` their
    seconds."""

    def __init__(self, root: str, **engine_kwargs):
        self.root = root
        self.models: list[BlockNerfModel] = []
        self._engine_kwargs = engine_kwargs
        for block in list_blocks(root):
            p = os.path.join(root, "blocks", block, "nerf.ingp")
            if not os.path.exists(p):
                continue
            doc = load_snapshot(p)
            snap = doc["snapshot"]
            self.models.append(BlockNerfModel(
                path=p,
                camera_aabb=np.asarray(snap["camera_aabb"], np.float32),
                nerf_aabb=np.asarray(snap["nerf_aabb"], np.float32),
                scale=float(snap["nerf"]["scale"]),
                offset=np.asarray(snap["nerf"]["offset"], np.float32),
                aabb_scale=int(snap["nerf"]["aabb_scale"]),
                config=doc["network_config"],
            ))
        if not self.models:
            raise ValueError(f"no block snapshots under {root}/blocks")
        self._active: int | None = None
        self._engine: NerfEngine | None = None
        self._state = None
        self._grid = None
        self.swaps, self.swap_s = 0, 0.0

    def pick_block(self, world_pos: np.ndarray) -> int:
        """The block nearest ``world_pos`` by distance to its camera AABB
        (the first on a tie)."""
        best, best_d = 0, np.inf
        for i, m in enumerate(self.models):
            lo, hi = m.camera_aabb
            q = np.maximum(np.maximum(lo - world_pos, 0), world_pos - hi)
            d = float(np.linalg.norm(q))
            if d < best_d:
                best, best_d = i, d
        return best

    def set_block_nerf(self, index: int) -> None:
        """Make block ``index`` the served one: its weights and grid loaded
        into the engine, which is built anew only where the block's config
        or aabb_scale differs from the engine's."""
        if index == self._active:
            return
        t0 = time.perf_counter()
        m = self.models[index]
        if (self._engine is None or self._engine.aabb_scale != m.aabb_scale
                or self._engine.config != m.config):
            stub = NerfDataset(
                images=np.zeros((1, 8, 8, 4), np.uint8),
                xforms=np.zeros((1, 2, 3, 4), np.float32),
                focal_lengths=np.full((1, 2), 8.0, np.float32),
                principal_points=np.full((1, 2), 0.5, np.float32),
                lens=Lens(), resolution=(8, 8), scale=m.scale, offset=m.offset,
                aabb_scale=m.aabb_scale)
            self._engine = NerfEngine(dict(m.config), stub, **self._engine_kwargs)
        self._state, self._grid = self._engine.load_snapshot(m.path)
        self._active = index
        self.swaps += 1
        self.swap_s += time.perf_counter() - t0

    def render_at(self, world_xform: np.ndarray, width: int, height: int,
                  fov_deg: float = 50.0):
        """Render the (3, 4) raw-world camera-to-world ``world_xform``
        (``pose.csv``'s convention) through the nearest block with a
        vertical field of view of ``fov_deg``: ((H, W, 3) float32 host
        image, the block's index)."""
        idx = self.pick_block(np.asarray(world_xform)[:, 3])
        self.set_block_nerf(idx)
        m = self.models[idx]
        w = np.asarray(world_xform, np.float32).copy()
        w[:, 1] *= -1.0  # cancel nerf_matrix_to_ngp's column flips:
        w[:, 2] *= -1.0  # pose.csv matrices keep their signs
        ngp_xform = nerf_matrix_to_ngp(w, m.scale, m.offset)
        f = 0.5 * height / np.tan(0.5 * np.radians(fov_deg))
        px, py = np.meshgrid((np.arange(width) + 0.5) / width,
                             (np.arange(height) + 0.5) / height)
        x = (px - 0.5) * width / f
        y = (py - 0.5) * height / f
        dc = np.stack([x, y, np.ones_like(x)], -1).reshape(-1, 3)
        d = dc @ ngp_xform[:, :3].T
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        o = np.broadcast_to(ngp_xform[:, 3], d.shape)
        rgb, _, _ = self._engine.render_rays(
            self._state, self._grid, torch.from_numpy(o.astype(np.float32)),
            torch.from_numpy(d.astype(np.float32)))
        return rgb.cpu().numpy().reshape(height, width, 3), idx

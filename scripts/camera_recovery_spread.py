"""How camera refinement fares against frozen cameras in the JAX package and
in the PyTorch port, on the CPU, at each seed given.

``tests/test_nerf_engine.py::test_camera_refinement_recovers_pose_noise``
(and ``tests/test_torch_camera.py``'s copy) trains the sphere scene twice
from noisy poses (position noise σ = 0.01, numpy seed 4), frozen and with
``optimize_extrinsics``, 250 steps each, and gates the last step's loss:
refined < 1.2 × frozen. ``test_distortion_map_recovers_lens_offset``
does the same with views rendered through a constant direction offset
and an 8×8 ``optimize_distortion`` grid, 300 steps. This script runs
either test's two trainings in either or both packages (each with its own
draws) for each engine seed given, in calls of 10 steps, and prints per
seed and package:

* ``final_ratio``: the last step's loss, refined over frozen (the JAX
  test's gate). The JAX engine draws step s from ``fold_in(key, 2s)``,
  so two runs of one seed train their last step on the same rays (once
  their batch geometries agree); the port draws from one generator
  stream, so its two runs' last batches differ;
* ``paired_ratio`` (the port): both trained states' loss on one batch
  drawn after training, with the refined engine's samples a ray, refined
  over frozen: the last-step comparison the JAX gate makes;
* ``mean_ratio``: the mean loss of the last 50 steps' calls (one loss
  read every 10 steps), refined over frozen;
* ``offset_corr``: for the pose test, the correlation of the learned
  position offsets with −noise; for the distortion test, the learned
  grid's mean offset (x, y) (the true one is (0.03, −0.02)).

    JAX_PLATFORMS=cpu python scripts/camera_recovery_spread.py 21 22 23
    JAX_PLATFORMS=cpu python scripts/camera_recovery_spread.py --test distortion 23 24

About a minute a seed and package on a development CPU.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

TRUE_OFF = np.asarray([0.03, -0.02], np.float32)


def _distorted_images(ds):
    from test_nerf_engine import FOCAL, RES, SPHERE_C, SPHERE_R, SPHERE_RGB

    u = (np.arange(RES) + 0.5) / RES
    uu, vv = np.meshgrid(u, u)
    x = (uu - 0.5) * RES / FOCAL + TRUE_OFF[0]
    y = (vv - 0.5) * RES / FOCAL + TRUE_OFF[1]
    dir_cam = np.stack([x, y, np.ones_like(x)], -1)
    images = []
    for xform in ds.xforms[:, 0]:
        d = dir_cam @ xform[:, :3].T
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        oc = xform[:, 3] - SPHERE_C
        b = np.einsum("hwc,c->hw", d, oc)
        hit = b * b - (np.dot(oc, oc) - SPHERE_R ** 2) > 0
        img = np.zeros((RES, RES, 4), np.float32)
        img[hit, :3] = SPHERE_RGB
        img[hit, 3] = 1.0
        images.append((img * 255).astype(np.uint8))
    return np.stack(images)


def _dataset(test: str):
    from test_nerf_engine import _make_dataset

    ds = _make_dataset()
    noise = None
    if test == "pose":
        noise = np.random.default_rng(4).normal(0, 0.01, (ds.n_images, 3)).astype(np.float32)
        ds.xforms[:, :, :, 3] += noise[:, None, :]
    else:
        ds.images = _distorted_images(ds)
    return ds, noise


def run(package: str, test: str, seed: int) -> dict:
    from test_nerf_engine import CONFIG

    ds, noise = _dataset(test)
    n_steps = 250 if test == "pose" else 300
    flag = "optimize_extrinsics" if test == "pose" else "optimize_distortion"
    kw = dict(batch_size=1 << 13, grid_size=16, n_steps_per_unit=128,
              density_grid_decay=0.8, seed=seed)
    if test == "distortion":
        kw["distortion_resolution"] = (8, 8)
    out, engines = {}, {}
    for opt in (False, True):
        if package == "jax":
            from ngp_tpu.engines.nerf import NerfEngine

            eng = NerfEngine(dict(CONFIG), ds, **kw, **{flag: opt})
        else:
            import torch

            from ngp_tpu_torch.data.nerf_loader import NerfDataset
            from ngp_tpu_torch.engines.nerf import NerfEngine
            from ngp_tpu_torch.geometry.camera import Lens

            torch.set_num_threads(1)
            pds = NerfDataset(ds.images, ds.xforms, ds.focal_lengths, ds.principal_points,
                              Lens(), ds.resolution, ds.aabb_scale)
            eng = NerfEngine(dict(CONFIG), pds, device="cpu", **kw, **{flag: opt})
        state, grid = eng.init_state(), eng.init_grid()
        losses = []
        for _ in range(n_steps // 10):
            state, grid, m = eng.train(state, grid, 10)
            losses.append(float(m["loss"]))
        if package == "jax":
            cam = {k: np.asarray(v) for k, v in state.params["camera"].items()}
        else:
            cam = {k: getattr(state.camera, k).detach().numpy() for k in ("pos", "distortion")}
        out[opt] = (losses, cam)
        engines[opt] = (eng, state, grid)
    (lf, _), (lr, cam) = out[False], out[True]
    res = {"package": package, "test": test, "seed": seed,
           "final_ratio": lr[-1] / lf[-1], "mean_ratio": float(np.mean(lr[-5:]) / np.mean(lf[-5:])),
           "final_losses": [lr[-1], lf[-1]]}
    if package == "port":
        from ngp_tpu_torch.engines.nerf import losses_on_one_batch

        loss_r, loss_f = losses_on_one_batch([engines[True], engines[False]])
        res["paired_ratio"] = loss_r / loss_f
    if test == "pose":
        res["offset_corr"] = float(np.corrcoef(cam["pos"].ravel(), -noise.ravel())[0, 1])
    else:
        res["offset_corr"] = cam["distortion"].reshape(-1, 2).mean(0).tolist()
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("seeds", nargs="+", type=int)
    ap.add_argument("--test", choices=("pose", "distortion"), default="pose")
    ap.add_argument("--packages", nargs="+", choices=("jax", "port"), default=["jax", "port"])
    args = ap.parse_args()
    for seed in args.seeds:
        for package in args.packages:
            print(run(package, args.test, seed), flush=True)


if __name__ == "__main__":
    main()

"""How well a volume fit's density follows the ground truth, in the JAX
package and in the PyTorch port, on the CPU, at each seed given.

``tests/test_volume.py::test_volume_fit`` gates the JAX fit on the
correlation of the served density with the jittered ground truth at 4,096
uniform points of the box, above 0.5. This script runs a fit in either or
both packages (each with its own draws and initial parameters) and prints,
per seed, package and checkpoint, three correlations of the served density
with the jittered ground truth, at the same points and jitter for both:

* ``uniform_corr``: at 4,096 uniform points of the box (the test's gate);
* ``occupied_corr``: at those of the points whose 128³ bit cell is
  occupied (the cloud and its rim; ``n_occupied`` of them);
* ``vertex_corr``: at the recorded vertices of a step neither run reaches,
  against their targets (the distribution training sees).

Beside them the mean served density over the empty and the occupied points
and the mean ground truth over the occupied ones.

Two configurations:

* ``--config test`` (default): ``tests/test_volume.py``'s (L=6, T=2^14,
  Adam at 1e-3) on the procedural cloud at 32³, 2^12 slots a step, 150
  steps; about 1 minute a seed for the JAX package and 4 for the port:

      JAX_PLATFORMS=cpu python scripts/volume_fit_spread.py 5 6 7 8

* ``--config testbed``: the Testbed's volume config (L=16, F=2, T=2^19, a
  64-wide MLP, Ema over ExponentialDecay over Adam at 1e-4), each package's
  own copy of it, at 2^16 slots a step unless ``--batch`` says otherwise;
  ``--res`` sets the cloud's resolution and ``--steps`` the checkpoints:

      JAX_PLATFORMS=cpu python scripts/volume_fit_spread.py --config testbed \\
          --batch 4096 --steps 250,500,1000 --packages jax 1337

``--device cuda`` runs the port on the card (the port alone: the JAX
package does not run there), e.g. at the card's volume config:

      python scripts/volume_fit_spread.py --config testbed --packages port \\
          --device cuda --steps 250,1000 1337 5 6

The ground truth and the points are made on the host either way. One JSON
line a seed, package and checkpoint.
"""

from __future__ import annotations

import argparse
import copy
import functools
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tests"))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

HELDOUT_STEP = 10_000_000
N_POINTS = 4096
HELDOUT_EPISODES = 1 << 12


def _corr(a, b) -> float:
    return float(np.corrcoef(a, b)[0, 1]) if len(a) > 1 else float("nan")


def _scores(pred, gt, occupied, vertex_pred, vertex_target) -> dict:
    return {"uniform_corr": _corr(pred, gt),
            "occupied_corr": _corr(pred[occupied], gt[occupied]),
            "vertex_corr": _corr(vertex_pred, vertex_target),
            "n_occupied": int(occupied.sum()), "n_vertices": int(len(vertex_pred)),
            "pred_mean_empty": float(pred[~occupied].mean()),
            "pred_mean_occupied": float(pred[occupied].mean()),
            "gt_mean_occupied": float(gt[occupied].mean())}


@functools.lru_cache(maxsize=None)
def _cloud(package: str, res: int, device: str):
    if package == "jax":
        from ngp_tpu.data.volume import procedural_cloud as jax_cloud
        return jax_cloud(res=res)
    from ngp_tpu_torch.data.volume import procedural_cloud
    return procedural_cloud(res, device=device)


def _run_jax(cfg, res, batch, seed, checkpoints, pts):
    import jax
    import jax.numpy as jnp

    from ngp_tpu.engines.volume import VolumeEngine

    eng = VolumeEngine(copy.deepcopy(cfg), _cloud("jax", res, "cpu"), batch_size=batch,
                       seed=seed)
    state, done, rows = eng.init_state(), 0, []
    t0 = time.monotonic()
    for steps in checkpoints:
        state, _ = eng.train(state, steps - done)
        done = steps
        params = eng.trainer.inference_params(state)
        pred = np.asarray(eng.model(params, jnp.asarray(pts)))[:, 3]
        pos, targets, valid = map(np.asarray, eng.generate_training_data(
            jax.random.fold_in(jax.random.PRNGKey(seed ^ 0x701), HELDOUT_STEP),
            HELDOUT_EPISODES))
        vertex = np.asarray(eng.model(params, jnp.asarray(pos[valid])))[:, 3]
        rows.append((steps, pred, vertex, targets[valid, 3], time.monotonic() - t0))
    return rows


def _run_port(cfg, res, batch, seed, checkpoints, pts, device):
    import torch

    from ngp_tpu_torch.engines.volume import VolumeEngine

    eng = VolumeEngine(cfg, _cloud("port", res, device), batch_size=batch, seed=seed,
                       device=device)
    state, done, rows = eng.init_state(), 0, []
    t0 = time.monotonic()
    for steps in checkpoints:
        state, _ = eng.train(state, steps - done)
        done = steps
        with torch.no_grad():
            model = state.inference_model()
            pred = model(torch.from_numpy(pts).to(device))[:, 3].cpu().numpy()
            pos, targets, valid = eng.generate_training_data(HELDOUT_STEP, HELDOUT_EPISODES)
            vertex = model(pos[valid])[:, 3].cpu().numpy()
        rows.append((steps, pred, vertex, targets[valid, 3].cpu().numpy(),
                     time.monotonic() - t0))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("seeds", type=int, nargs="*", default=[5])
    ap.add_argument("--config", choices=("test", "testbed"), default="test")
    ap.add_argument("--res", type=int, default=None, help="cloud resolution (32, or 512)")
    ap.add_argument("--batch", type=int, default=None, help="slots a step (2^12, or 2^16)")
    ap.add_argument("--steps", default=None, help="checkpoints, e.g. 100,250 (150, or 1000)")
    ap.add_argument("--packages", default="jax,port")
    ap.add_argument("--device", default="cpu", help="the port's device (cpu or cuda)")
    args = ap.parse_args(argv)
    packages = args.packages.split(",")
    if args.device != "cpu" and "jax" in packages:
        ap.error("the JAX package runs on the CPU only: --packages port with --device")

    import torch

    from ngp_tpu_torch.data.volume import procedural_cloud
    from ngp_tpu_torch.ops.volume_walk import WalkVolume, bit_occupied, density_at

    torch.set_num_threads(1)
    if args.config == "test":
        from test_volume import CONFIG
        jax_cfg = port_cfg = CONFIG
        res, batch, steps = 32, 1 << 12, "150"
    else:
        from ngp_tpu_torch.testbed import default_config
        port_cfg = jax_cfg = default_config("volume")
        if "jax" in packages:
            from ngp_tpu.testbed import _DEFAULT_CONFIGS as JAX_CONFIGS
            jax_cfg = JAX_CONFIGS["volume"]
        res, batch, steps = 512, 1 << 16, "1000"
    res = args.res or res
    batch = args.batch or batch
    checkpoints = sorted(int(s) for s in (args.steps or steps).split(","))

    vol = WalkVolume.of(procedural_cloud(res, device="cpu"), 0.01, "cpu")
    rng = np.random.default_rng(3)
    lo, hi = vol.aabb_min.numpy(), vol.aabb_max.numpy()
    pts = (lo + rng.uniform(size=(N_POINTS, 3)) * (hi - lo)).astype(np.float32)
    jitter = torch.from_numpy(rng.uniform(size=(N_POINTS, 3)).astype(np.float32))
    gt = density_at(vol, torch.from_numpy(pts), jitter).numpy()
    occupied = bit_occupied(vol, torch.from_numpy(pts)).numpy()
    del vol

    runs = {"jax": lambda s: _run_jax(jax_cfg, res, batch, s, checkpoints, pts),
            "port": lambda s: _run_port(port_cfg, res, batch, s, checkpoints, pts, args.device)}
    for seed in args.seeds:
        for package in packages:
            for steps, pred, vertex, target, seconds in runs[package](seed):
                print(json.dumps({
                    "package": package, "device": "cpu" if package == "jax" else args.device,
                    "seed": seed, "config": args.config, "res": res,
                    "batch": batch, "steps": steps, "seconds": round(seconds, 1),
                    **_scores(pred, gt, occupied, vertex, target)}), flush=True)


if __name__ == "__main__":
    main()

"""The Block-NeRF street pipeline (``ngp_tpu_torch/blocknerf.py`` and
``python -m ngp_tpu_torch.scripts.blocknerf``) against the JAX package's
``ngp_tpu/blocknerf.py`` on the CPU, on ``tests/test_blocknerf.py``'s
two-block street at 40×40 (each block a coloured sphere at its own world
location, 10 views a block).

- ``load_block_nerf_data``: array for array with the JAX loader (images,
  poses, intrinsics, scale, offset, aabb_scale, camera AABB, steps).
- ``playback_world_poses`` within 1e-6 (float32 slerps in another order).
- ``pick_block`` identical, and block snapshots cross both ways: the JAX
  renderer loads the port's, the port's loads the JAX package's.
- ``render_at`` on the same weights within ``GOLDEN_TOL`` = 2e-4, the port's
  render bound (``tests/test_torch_snapshot.py``), every marched sample
  evaluated (``render_compaction_frac`` 1.0: this early grid overflows the
  default budget, where the JAX package composites the dropped samples as
  fog, ROADMAP C.ref 1).
- ``train_street_view_nerf`` a few steps a block through ``block_shard``,
  and the CLI on ``--device cpu``.
- A slow-marked twin of the JAX package's playback test: 350 steps a block
  and the right block and colour at each block's check pose.
"""

import json
import math
import os
import shutil

import numpy as np
import pytest
import torch

import test_blocknerf as jbt
from ngp_tpu import blocknerf as jb
from ngp_tpu_torch import blocknerf as pb
from ngp_tpu_torch.data.png import read_png, write_png

# One intra-op thread, as in every port test module (test_torch_capture.py).
torch.set_num_threads(1)

GOLDEN_TOL = 2e-4
# the JAX playback test's narrow network and engine settings
ENGINE = dict(batch_size=1 << 12, grid_size=32, n_steps_per_unit=256, seed=9)
RENDER = dict(batch_size=1 << 12, grid_size=32, n_steps_per_unit=256, n_render_samples=128,
              render_compaction_frac=1.0)
STEPS = 4


def _config(package):
    cfg = package.default_config("nerf")
    cfg["encoding"].update({"n_levels": 8, "log2_hashmap_size": 15, "per_level_scale": 1.5})
    return cfg


def write_street(root: str, views: int = 10, steps: int = 350) -> str:
    """``tests/test_blocknerf.py``'s street written by the port's PNG
    writer: ``images/``, ``blocks/b0`` and ``blocks/b1``."""
    os.makedirs(os.path.join(root, "images"))
    for bname, spec in jbt.BLOCKS.items():
        bdir = os.path.join(root, "blocks", bname)
        os.makedirs(bdir)
        rows = ["image,fx,fy,cx,cy,m00,m01,m02,m03,m10,m11,m12,m13,m20,m21,m22,m23"]
        for i in range(views):
            ang = 2 * math.pi * i / views
            eye = spec["center"] + np.asarray([math.cos(ang), math.sin(ang), 0.35]) * 40.0
            xf = jbt._lookat_nerf(eye, spec["center"])
            name = f"{bname}_{i:02d}.png"
            write_png(os.path.join(root, "images", name),
                      jbt._render_gt(xf, spec["center"], spec["rgb"]))
            vals = ",".join(f"{v:.8f}" for v in xf.reshape(-1))
            rows.append(f"{name},{jbt.FOCAL},{jbt.FOCAL},{jbt.RES / 2},{jbt.RES / 2},{vals}")
        with open(os.path.join(bdir, "pose.csv"), "w") as f:
            f.write("\n".join(rows))
        with open(os.path.join(bdir, "setting.json"), "w") as f:
            json.dump({"scale": 0.005, "aabb_scale": 1, "training_steps": steps}, f)
    return root


@pytest.fixture(scope="module")
def street(tmp_path_factory):
    return write_street(str(tmp_path_factory.mktemp("street")))


def test_load_block_data_matches_jax(street):
    assert pb.list_blocks(street) == jb.list_blocks(street) == ["b0", "b1"]
    for block in ("b0", "b1"):
        got, want = pb.load_block_nerf_data(street, block), jb.load_block_nerf_data(street, block)
        for k in ("images", "xforms", "focal_lengths", "principal_points", "offset"):
            a, b = getattr(got, k), np.asarray(getattr(want, k))
            assert a.dtype == b.dtype and np.array_equal(a, b), k
        for k in ("resolution", "scale", "aabb_scale", "n_extra_learnable_dims", "paths",
                  "n_training_steps", "n_images"):
            assert getattr(got, k) == getattr(want, k), k
        assert got.lens.mode == want.lens.mode
        for a, b in zip(got.camera_aabb, want.camera_aabb):
            assert np.array_equal(a, b)
    assert got.n_training_steps == 350 and got.images.shape == (10, 40, 40, 4)


def test_playback_world_poses_match_jax(street):
    for n in (1, 4, 61):
        got, want = pb.playback_world_poses(street, n), jb.playback_world_poses(street, n)
        assert got.shape == want.shape == (n, 3, 4) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def trained(street, tmp_path_factory):
    """Both blocks trained ``STEPS`` steps by the port, one shard each
    (``block_shard`` (0, 2) then (1, 2)); then a copy of the street whose
    block snapshots the JAX package wrote from those weights (its engine
    loading the port's snapshot, its ``save_block_nerf`` writing)."""
    from ngp_tpu.engines.nerf import NerfEngine as JaxNerfEngine
    from ngp_tpu_torch import testbed

    logs = []
    snaps = []
    for shard in ((0, 2), (1, 2)):
        snaps += pb.train_street_view_nerf(street, config=_config(testbed), n_steps_override=STEPS,
                                           log=logs.append, block_shard=shard, device="cpu",
                                           **ENGINE)
    jax_root = str(tmp_path_factory.mktemp("jax_street"))
    shutil.copytree(street, jax_root, dirs_exist_ok=True)
    for block in ("b0", "b1"):
        ds = jb.load_block_nerf_data(jax_root, block)
        eng = JaxNerfEngine(_config(testbed), ds, **ENGINE)
        state, grid = eng.load_snapshot(os.path.join(street, "blocks", block, "nerf.ingp"))
        jb.save_block_nerf(os.path.join(jax_root, "blocks", block, "nerf.ingp"), eng, state, grid,
                           ds)
    return {"snaps": snaps, "logs": logs, "jax_root": jax_root}


def test_train_street_view_nerf_shards(street, trained):
    """Each shard trains its own block and writes its snapshot, with the
    JAX block snapshot's keys."""
    from ngp_tpu_torch.utils.snapshot import load_snapshot

    assert trained["snaps"] == [os.path.join(street, "blocks", b, "nerf.ingp")
                                for b in ("b0", "b1")]
    assert trained["logs"][0] == "Training block: b0" and trained["logs"][2] == "Training block: b1"
    assert trained["logs"][1].startswith(f"  block b0: {STEPS} steps, loss=")
    for block in ("b0", "b1"):
        port = load_snapshot(os.path.join(street, "blocks", block, "nerf.ingp"))
        jax = load_snapshot(os.path.join(trained["jax_root"], "blocks", block, "nerf.ingp"))
        assert sorted(port["snapshot"]) == sorted(jax["snapshot"])
        assert sorted(port["snapshot"]["nerf"]) == sorted(jax["snapshot"]["nerf"])
        assert int(port["snapshot"]["training_step"]) == STEPS
        for k in ("camera_aabb", "nerf_aabb", "density_grid"):
            a, b = np.asarray(port["snapshot"][k]), np.asarray(jax["snapshot"][k])
            assert a.dtype == b.dtype and np.array_equal(a, b), k
        assert port["snapshot"]["nerf"]["scale"] == jax["snapshot"]["nerf"]["scale"]


def _check_poses():
    return [jbt._lookat_nerf(spec["center"] + np.asarray([40.0, 0.0, 14.0]), spec["center"])
            for spec in jbt.BLOCKS.values()]


@pytest.mark.parametrize("written_by", ["port", "jax"])
def test_render_at_matches_jax(street, trained, written_by):
    """Both renderers on one set of block snapshots (the port's, or the
    JAX package's of the same weights): the same block picked at every
    pose, frames within ``GOLDEN_TOL``; one engine serves both blocks and
    is swapped only when the block changes."""
    root = street if written_by == "port" else trained["jax_root"]
    pr = pb.BlockNerfRenderer(root, device="cpu", **RENDER)
    jr = jb.BlockNerfRenderer(root, **RENDER)
    for m, jm in zip(pr.models, jr.models):
        for k in ("camera_aabb", "nerf_aabb", "offset"):
            assert np.array_equal(getattr(m, k), getattr(jm, k)), k
        assert (m.scale, m.aabb_scale, m.config) == (jm.scale, jm.aabb_scale, jm.config)
    for p in ([0.0, 0.0, 0.0], [200.0, 5.0, 0.0], [100.0, 0.0, 0.0], [99.0, 0.0, 0.0],
              [101.0, 0.0, 50.0], [-400.0, 0.0, 0.0], [600.0, 30.0, -9.0]):
        assert pr.pick_block(np.asarray(p)) == jr.pick_block(np.asarray(p)), p
    assert pr.pick_block(np.asarray([0.0, 0.0, 0.0])) == 0
    assert pr.pick_block(np.asarray([200.0, 5.0, 0.0])) == 1
    engines = set()
    for bi, xf in enumerate(_check_poses()):
        img, picked = pr.render_at(xf, 24, 16)
        want, jpicked = jr.render_at(xf, 24, 16)
        engines.add(id(pr._engine))
        assert picked == jpicked == bi
        assert img.shape == (16, 24, 3) and img.dtype == np.float32
        np.testing.assert_allclose(img, np.asarray(want), rtol=GOLDEN_TOL, atol=GOLDEN_TOL)
    pr.render_at(_check_poses()[1], 8, 8)
    assert len(engines) == 1 and pr.swaps == 2 and pr.swap_s > 0


def test_blocknerf_cli(street, tmp_path, monkeypatch, capsys):
    """``python -m ngp_tpu_torch.scripts.blocknerf --train --render`` on the
    CPU (a narrow ``--network``; the engine's grid narrowed to 32³ from
    here): the JAX CLI's lines, ``frame_%04d.png`` frames, the launches
    line last."""
    from ngp_tpu_torch import testbed
    from ngp_tpu_torch.scripts import blocknerf as cli

    root = str(tmp_path / "street")
    shutil.copytree(street, root)
    for block in ("b0", "b1"):
        os.remove(os.path.join(root, "blocks", block, "nerf.ingp"))
    net = tmp_path / "net.json"
    net.write_text(json.dumps(_config(testbed)))
    engine = pb.NerfEngine
    monkeypatch.setattr(pb, "NerfEngine", lambda *a, **kw: engine(*a, **{**kw, "grid_size": 32}))
    out = tmp_path / "frames"
    cli.main(["--data", root, "--train", "--render", "--n_steps", "2", "--batch_size", "4096",
              "--network", str(net), "--out", str(out), "--width", "24", "--height", "16",
              "--n_frames", "3", "--block_shard", "0/1", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "Training block: b0" and lines[1].startswith("  block b0: 2 steps, loss=")
    assert lines[4:6] == ["trained 2 blocks", f"rendered 3 frames to {out}"]
    assert lines[-1].startswith("kernel launches: {")
    assert sorted(os.listdir(out)) == [f"frame_{i:04d}.png" for i in range(3)]
    assert read_png(str(out / "frame_0002.png")).shape == (16, 24, 3)
    with pytest.raises(SystemExit):
        cli.main(["--data", root])


@pytest.mark.slow
def test_blocknerf_train_and_playback(tmp_path):
    """The JAX package's ``test_blocknerf_train_and_playback`` on the port:
    350 steps a block, then at each block's check pose the right block and
    its colour's dominant channel above 0.3."""
    from ngp_tpu_torch import testbed

    street = write_street(str(tmp_path / "street"))
    snaps = pb.train_street_view_nerf(street, config=_config(testbed), device="cpu",
                                      density_grid_decay=0.8, **{**ENGINE, "batch_size": 1 << 14})
    assert len(snaps) == 2 and all(os.path.exists(s) for s in snaps)
    r = pb.BlockNerfRenderer(street, device="cpu", **{**RENDER, "batch_size": 1 << 14})
    for bi, (bname, spec) in enumerate(jbt.BLOCKS.items()):
        img, picked = r.render_at(_check_poses()[bi], 40, 40)
        assert picked == bi
        c = img[20, 20]
        want = np.asarray(spec["rgb"]) / 255.0
        assert np.argmax(c) == np.argmax(want), (bname, c)
        assert c[np.argmax(want)] > 0.3, (bname, c)

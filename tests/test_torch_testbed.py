"""The port's ``Testbed`` and ``run`` CLI and the small modules they use,
against the JAX package on the CPU: tonemap operators, marching cubes and
its writers, the mesh of a trained density field, camera paths, meters,
config files, ``Testbed`` in nerf mode, the CLI end to end, and what the
port refuses.

Sizes are small: a written 32² sphere capture, a 4-level 2^12 grid with
16-wide MLPs (a ``--network`` json with a ``"parent"``), a 32³ occupancy
grid. Tolerances are stated in each test.
"""

import json
import os
import re
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ngp_tpu.ops import marching_cubes as jmc
from ngp_tpu.ops import tonemap as jtonemap
from ngp_tpu.utils import camera_path as jcp
from ngp_tpu.utils import meters as jmeters
from ngp_tpu_torch.ops import marching_cubes as pmc
from ngp_tpu_torch.ops import tonemap as ptonemap
from ngp_tpu_torch.utils import camera_path as pcp
from ngp_tpu_torch.utils import meters as pmeters

# One intra-op thread: with two, torch's CPU sqrt (MKL's vsSqrt, split across
# the intra-op threads) now and then returned one thread's chunk ~3e-4 off
# on an AVX-512 Xeon (torch 2.13, MKL 2024.2), never with one
# (scripts/torch_sqrt_threads.py counts it).
# Every port test module sets the same count, so that a pytest worker's
# count does not depend on which module it imported last.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = 32  # occupancy grid of every engine here (the CLI's default is 128)

SMALL_PARENT = {
    "loss": {"otype": "Huber"},
    "optimizer": {"otype": "Ema", "decay": 0.95, "nested": {
        "otype": "ExponentialDecay", "decay_start": 20000, "decay_interval": 10000,
        "decay_base": 0.33, "nested": {"otype": "Adam", "learning_rate": 1e-2, "beta1": 0.9,
                                       "beta2": 0.99, "epsilon": 1e-15, "l2_reg": 1e-6}}},
    "encoding": {"otype": "HashGrid", "n_levels": 16, "n_features_per_level": 2,
                 "log2_hashmap_size": 19, "base_resolution": 16},
    "network": {"otype": "FullyFusedMLP", "activation": "ReLU", "output_activation": "None",
                "n_neurons": 16, "n_hidden_layers": 1},
    "dir_encoding": {"otype": "Composite", "nested": [
        {"n_dims_to_encode": 3, "otype": "SphericalHarmonics", "degree": 4},
        {"otype": "Identity"}]},
    "rgb_network": {"otype": "FullyFusedMLP", "activation": "ReLU",
                    "output_activation": "None", "n_neurons": 16, "n_hidden_layers": 2},
}
SMALL_CHILD = """{
  // the parent's network, a small grid
  "parent": "parent.json",
  "encoding": {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
               "log2_hashmap_size": 12, "base_resolution": 16}
}
"""


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A written 32² capture and a small network config file."""
    from ngp_tpu_torch.data.synthetic import write_sphere_capture

    root = tmp_path_factory.mktemp("testbed")
    train_json, test_json = write_sphere_capture(str(root / "cap"), res=32)
    (root / "parent.json").write_text(json.dumps(SMALL_PARENT))
    (root / "net.json").write_text(SMALL_CHILD)
    return {"train": train_json, "test": test_json, "network": str(root / "net.json"),
            "root": root}


# -- small modules against the JAX package


def test_tonemap_operators_match_jax():
    """Within 1e-6 (the same float32 formulas)."""
    x = np.linspace(0.0, 20.0, 20001, dtype=np.float32)
    for name, op in ptonemap.TONEMAPS.items():
        want = np.asarray(jtonemap.TONEMAPS[name](jnp.asarray(x)))
        np.testing.assert_allclose(op(torch.from_numpy(x)).numpy(), want, rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    rgb = np.random.default_rng(0).random((7, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(ptonemap.luminance(torch.from_numpy(rgb)).numpy(),
                               np.asarray(jtonemap.luminance(jnp.asarray(rgb))),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_marching_cubes_and_writers_match_jax(tmp_path, seed):
    """A noisy ball from a numpy seed, with an origin and spacing: vertices
    and faces equal, and the OBJ and PLY files byte for byte."""
    rng = np.random.default_rng(seed)
    n = 20
    r = np.linspace(-1, 1, n, dtype=np.float32)
    x, y, z = np.meshgrid(r, r, r, indexing="ij")
    field = 3.0 - 4.0 * np.sqrt(x * x + y * y + z * z) + rng.normal(0, 0.3, x.shape)
    field = field.astype(np.float32)
    kw = dict(origin=np.asarray([-1, -1, -1], np.float32),
              spacing=np.full(3, 2.0 / (n - 1), np.float32))
    pv, pf = pmc.marching_cubes(field, 1.0, **kw)
    jv, jf = jmc.marching_cubes(field, 1.0, **kw)
    assert len(pf) > 100
    np.testing.assert_array_equal(pv, jv)
    np.testing.assert_array_equal(pf, jf)
    for writer in ("save_obj", "save_ply"):
        getattr(pmc, writer)(str(tmp_path / "p"), pv, pf)
        getattr(jmc, writer)(str(tmp_path / "j"), jv, jf)
        assert (tmp_path / "p").read_bytes() == (tmp_path / "j").read_bytes(), writer


@pytest.mark.parametrize("thresh", [0.0, 1.0])
def test_compute_marching_cubes_mesh_matches_jax(thresh):
    """The golden snapshot's raw density field meshed by both engines at
    32³ (below the GUI's 2.5, where its 48 training steps leave a few faces
    only): equal vertex and face counts and faces, vertices within 1e-5 of
    the JAX ones (measured 3e-8: the raw densities differ in the last bits,
    bf16-rounded operands multiplied in float32 in another order, and a
    vertex moves by that over the density's change along its edge)."""
    from golden.make_golden import build_engine
    from test_torch_render import GOLDEN_INGP, port_golden_engine

    peng, jeng = port_golden_engine(), build_engine()
    pstate, _ = peng.load_reference_snapshot(GOLDEN_INGP)
    jstate, _ = jeng.load_reference_snapshot(GOLDEN_INGP)
    pv, pf = peng.compute_marching_cubes_mesh(pstate, 32, thresh)
    jv, jf = jeng.compute_marching_cubes_mesh(jstate, 32, thresh)
    assert len(pf) > 500
    assert pv.shape == jv.shape and pf.shape == jf.shape
    np.testing.assert_array_equal(pf, jf)
    np.testing.assert_allclose(pv, jv, rtol=0, atol=1e-5)
    lo, hi = peng.aabb.min.numpy(), peng.aabb.max.numpy()
    assert (pv >= lo).all() and (pv <= hi).all()


@pytest.mark.parametrize("loop", [False, True])
def test_camera_path_matches_jax(tmp_path, loop):
    """Keyframes from matrices, the spline at 41 times, JSON both ways:
    equal bit for bit (the same numpy code)."""
    rng = np.random.default_rng(4)
    mats = []
    for _ in range(4):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        q *= np.sign(np.linalg.det(q))
        mats.append(np.concatenate([q, rng.normal(size=(3, 1))], 1).astype(np.float32))
    kw = [dict(fov=40.0 + i, scale=1.0 + 0.1 * i, aperture_size=0.01 * i) for i in range(4)]
    ppath = pcp.CameraPath([pcp.CameraKeyframe.from_matrix(m, **k) for m, k in zip(mats, kw)],
                           loop=loop)
    jpath = jcp.CameraPath([jcp.CameraKeyframe.from_matrix(m, **k) for m, k in zip(mats, kw)],
                           loop=loop)
    ppath.save(str(tmp_path / "p.json"))
    jpath.save(str(tmp_path / "j.json"))
    assert (tmp_path / "p.json").read_text() == (tmp_path / "j.json").read_text()
    for path_p, path_j in ((ppath, jpath),
                           (pcp.CameraPath.load(str(tmp_path / "j.json")),
                            jcp.CameraPath.load(str(tmp_path / "p.json")))):
        for t in np.linspace(0, 1, 41):
            a, b = path_p.eval_camera_path(float(t)), path_j.eval_camera_path(float(t))
            np.testing.assert_array_equal(a.matrix(), b.matrix())
            assert (a.fov, a.scale, a.slice, a.aperture_size) == \
                (b.fov, b.scale, b.slice, b.aperture_size)


def test_meters_and_metrics_lines_match_jax(tmp_path, monkeypatch):
    """The same loss and window sequence into both packages' meters, on
    one stepped clock: equal values; both loggers write equal lines (wall
    clock fixed)."""
    clock = [0.0]
    monkeypatch.setattr(pmeters.time, "monotonic", lambda: clock[0])
    rng = np.random.default_rng(5)
    pm, jm = pmeters.TrainMeters(), jmeters.TrainMeters()
    pe, je = pmeters.Ema(0.7), jmeters.Ema(0.7)
    for i in range(300):
        loss = float(rng.random())
        assert pm.update_loss(loss) == jm.update_loss(loss)
        clock[0] = 0.25 * i
        win = (16, float(rng.integers(1, 1 << 18)), 4096.0 * 16, float(rng.random()) + 0.1)
        pm.update_window(*win, prep_s=0.01 * i)
        jm.update_window(*win, prep_s=0.01 * i)
        assert pe.update(loss, now=0.1 * i) == je.update(loss, now=0.1 * i)
    assert pm.snapshot_dict() == jm.snapshot_dict()
    assert pm.loss_graph == jm.loss_graph and len(pm.loss_graph) == 256
    assert pm.psnr == jm.psnr
    monkeypatch.setattr(pmeters.time, "time", lambda: 1234.5)
    lines = []
    for mod in (pmeters, jmeters):
        path = str(tmp_path / f"{mod.__name__.split('.')[0]}.jsonl")
        logger = mod.MetricsLogger(path)
        for step in (16, 32):
            logger.log(step, loss=np.float32(0.25), k=64, samples_per_s=1.5e6)
        logger.close()
        lines.append(open(path).read())
    assert lines[0] == lines[1] and lines[0].count("\n") == 2


def test_config_files_match_jax(scene):
    """``//`` comments outside strings, ``"parent"`` inheritance (the
    child's top-level keys win) and the recursive merge."""
    from ngp_tpu import config as jconfig
    from ngp_tpu_torch import config as pconfig

    text = '{"a": "x//y\\"//", // comment\n "b": [1, 2], "c": {"d": 1, "e": 2}}'
    assert pconfig.loads_jsonc(text) == jconfig.loads_jsonc(text) == {
        "a": 'x//y"//', "b": [1, 2], "c": {"d": 1, "e": 2}}
    got = pconfig.load_config(scene["network"])
    assert got == jconfig.load_config(scene["network"])
    assert got["encoding"]["n_levels"] == 4 and got["network"]["n_neurons"] == 16
    assert "parent" not in got
    over = {"c": {"e": 3}, "f": [4]}
    assert pconfig.merge(got, over) == jconfig.merge(got, over)


def test_default_config_and_modes_match_jax(tmp_path):
    from ngp_tpu import testbed as jtb
    from ngp_tpu_torch import testbed as ptb

    assert ptb.default_config("nerf") == jtb.default_config("nerf")
    assert ptb.MODES == jtb.MODES
    for path in ("scene.json", "scene.obj", "a.STL", "v.nvdb", "v.npy", "img.png",
                 "img.exr", "g.bin", "x.txt", str(tmp_path)):
        assert ptb.mode_from_scene(path) == jtb.mode_from_scene(path), path


# -- Testbed against the JAX package's


@pytest.fixture(scope="module")
def testbeds(scene, tmp_path_factory):
    """Both packages' Testbeds on the written capture with the small
    network; the port trains 30 steps and saves a native snapshot, and
    both load it (the same weights and float16 grid). Renders evaluate
    every marched sample (``render_compaction_frac`` 1.0): this early grid
    overflows the default budget, and there the JAX package composites the
    dropped samples as fog (ROADMAP C.ref 1), the port does not."""
    from ngp_tpu.testbed import Testbed as JaxTestbed
    from ngp_tpu_torch.testbed import Testbed

    kw = dict(grid_size=GRID, batch_size=1 << 14, seed=3, render_compaction_frac=1.0)
    ptb = Testbed(scene=scene["train"], config=scene["network"], device="cpu", **kw)
    ptb.train(30)
    snap = str(tmp_path_factory.mktemp("snap") / "s.ingp")
    ptb.save_snapshot(snap)
    ptb.load_snapshot(snap)
    jtb = JaxTestbed(scene=scene["train"], config=scene["network"], **kw)
    jtb.load_snapshot(snap)
    return ptb, jtb


def test_testbed_render_matches_jax(testbeds):
    """``render`` with a camera matrix (60° field of view, 40 × 24) and of
    a training view: within 2e-4 (the golden render's bound)."""
    ptb, jtb = testbeds
    assert ptb.training_step == jtb.training_step == 30
    assert ptb.n_images == jtb.n_images == 24
    m = np.asarray(jtb.engine.data.xforms[3])
    got = ptb.render(40, 24, camera_matrix=m, fov_deg=60.0)
    want = jtb.render(40, 24, camera_matrix=m, fov_deg=60.0)
    assert got.shape == want.shape == (24, 40, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
    np.testing.assert_allclose(ptb.render(8, 8, training_view=2),
                               jtb.render(8, 8, training_view=2), rtol=0, atol=2e-4)


def test_testbed_render_with_end_matrix_matches_jax(testbeds):
    """``render`` with a rolling shutter from training view 3's pose to
    view 4's (40 × 24, ``shutter_fraction`` 0.5): within 2e-4 of the JAX
    Testbed's; with the end pose equal to the start, exactly the still
    render."""
    ptb, jtb = testbeds
    m0 = np.asarray(jtb.engine.data.xforms[3])
    m1 = np.asarray(jtb.engine.data.xforms[4])
    got = ptb.render(40, 24, camera_matrix=m0, end_matrix=m1, shutter_fraction=0.5,
                     fov_deg=60.0)
    want = jtb.render(40, 24, camera_matrix=m0, end_matrix=m1, shutter_fraction=0.5,
                      fov_deg=60.0)
    assert got.shape == want.shape == (24, 40, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
    still = ptb.render(40, 24, camera_matrix=m0, fov_deg=60.0)
    assert np.abs(got - still).max() > 1e-2  # the shutter moved the rows
    np.testing.assert_array_equal(
        ptb.render(40, 24, camera_matrix=m0, end_matrix=m0.copy(), shutter_fraction=0.5,
                   fov_deg=60.0), still)


def test_testbed_cameras_and_psnr_match_jax(testbeds):
    """A training camera's pose and intrinsics overwritten in both: the
    poses read back equal (NeRF and NGP conventions), the focal lengths
    and principal points equal bit for bit, and the PSNR of that view
    within 0.01 dB; then restored."""
    ptb, jtb = testbeds
    view = 5
    nerf = jtb.get_camera_extrinsics(view)
    np.testing.assert_array_equal(ptb.get_camera_extrinsics(view), nerf)
    np.testing.assert_array_equal(ptb.get_camera_extrinsics(view, convert_to_nerf=False),
                                  np.asarray(jtb.engine.data.xforms[view]))
    moved = nerf.copy()
    moved[:, 3] += np.asarray([0.05, -0.02, 0.03], np.float32)
    for tb in (ptb, jtb):
        tb.set_camera_extrinsics(view, moved)
        tb.set_camera_intrinsics(view, fx=31.0, cy=17.25)
    np.testing.assert_array_equal(ptb.get_camera_extrinsics(view), jtb.get_camera_extrinsics(view))
    np.testing.assert_array_equal(ptb.engine.focals.numpy(), np.asarray(jtb.engine.data.focals))
    np.testing.assert_array_equal(ptb.engine.pps.numpy(), np.asarray(jtb.engine.data.pps))
    assert abs(ptb.psnr(view, stride=2) - jtb.psnr(view, stride=2)) <= 0.01
    assert abs(ptb.psnr(0) - jtb.psnr(0)) <= 0.01
    img = np.random.default_rng(6).random((32, 32, 3)).astype(np.float32)
    ptb.set_image(view, img)
    jtb.set_image(view, img)
    np.testing.assert_array_equal(ptb.engine.images.numpy(), np.asarray(jtb.engine.data.images))


def test_testbed_reload_network_rebuilds(scene):
    """``reload_network_from_json`` with a dict rebuilds the engine: the new
    architecture, step 0; a ``--network`` file path loads through
    ``load_config``."""
    from ngp_tpu_torch.testbed import Testbed

    tb = Testbed(scene=scene["train"], config=scene["network"], device="cpu", grid_size=GRID)
    assert tb.engine.network.pos_encoding.n_levels == 4
    tb.train(3)
    cfg = json.loads(json.dumps(tb.network_config))
    cfg["encoding"]["n_levels"] = 2
    tb.reload_network_from_json(cfg)
    assert tb.engine.network.pos_encoding.n_levels == 2 and tb.training_step == 0
    tb.reload_network_from_json(scene["network"])
    assert tb.engine.network.pos_encoding.n_levels == 4


# -- the CLI end to end


def _run(capsys, *args):
    from ngp_tpu_torch import run

    run.main([*map(str, args), "--device", "cpu"])
    return capsys.readouterr().out


@pytest.fixture
def small_engines(monkeypatch):
    """The CLI's Testbed with a 32³ occupancy grid and a 2^14-sample batch
    (engine keywords the CLI does not expose)."""
    from ngp_tpu_torch import testbed

    init = testbed.Testbed.__init__

    def small(self, *args, **kw):
        kw.setdefault("grid_size", GRID)
        init(self, *args, **kw)

    monkeypatch.setattr(testbed.Testbed, "__init__", small)


def test_run_cli_end_to_end(scene, tmp_path, capsys, small_engines):
    """``run.main`` on the CPU: 50 steps with a profiled window and a
    metrics file, held-out eval, snapshot, screenshot, mesh, two camera-path
    frames; then the snapshot reloaded with no training (the held-out
    PSNR within 0.05 dB: the grid passes through float16), and scored on
    every fourth view held out. The printed lines are the JAX CLI's."""
    from ngp_tpu_torch.data.png import read_png

    out = tmp_path / "out"
    path = tmp_path / "path.json"
    path.write_text(json.dumps({"loop": False, "path": [
        {"R": [0, 0, 0, 1], "T": [0.5, 0.5, -0.7], "fov": 40.0},
        {"R": [0, 0.3826834, 0, 0.9238795], "T": [0.0, 0.5, -0.4], "fov": 40.0}]}))
    first = _run(capsys, scene["train"], "--network", scene["network"], "--n_steps", 50,
                 "--batch_size", 1 << 14, "--test_transforms", scene["test"],
                 "--save_snapshot", out / "scene.ingp", "--screenshot", out / "shot.png",
                 "--save_mesh", out / "mesh.ply", "--marching_cubes_res", 24,
                 "--marching_cubes_density_thresh", 0.5, "--video_camera_path", path,
                 "--video_n_seconds", 1, "--video_fps", 2, "--video_w", 24,
                 "--video_h", 16, "--video_output", out / "frames",
                 "--profile", out / "trace.json", "--metrics_file", out / "m.jsonl",
                 "--tonemap", "aces", "--exposure", 0.5)
    lines = first.splitlines()
    assert lines[0] == f"profiler trace written to {out / 'trace.json'}"
    assert re.fullmatch(r"trained 50 steps in \S+s \(\S+ steps/s\), loss=\d+\.\d{6}", lines[1])
    assert re.fullmatch(r"PSNR \(train view 0\): \d+\.\d\d dB", lines[2])
    held = re.fullmatch(r"test_transforms: PSNR=(\S+) \[min=\S+ max=\S+\] SSIM=\S+ "
                        r"over 4 views", lines[3])
    assert held
    assert re.fullmatch(r"rendered 2 frames in \S+s", lines[4])
    assert lines[5:7] == [f"saved snapshot to {out / 'scene.ingp'}", f"wrote {out / 'shot.png'}"]
    mesh = re.fullmatch(rf"wrote {re.escape(str(out / 'mesh.ply'))} \((\d+) verts, (\d+) faces\)",
                        lines[7])
    assert mesh
    assert json.loads(lines[8].split("kernel launches: ")[1])["hashgrid_encode"] == 0
    assert len(lines) == 9
    assert json.load(open(out / "trace.json"))["traceEvents"]
    records = [json.loads(ln) for ln in open(out / "m.jsonl")]
    assert [r["step"] for r in records] == [16, 32, 48]  # the last read at the end
    assert read_png(str(out / "shot.png")).shape == (32, 32, 3)
    assert [read_png(str(out / "frames" / f"frame_{i:04d}.png")).shape
            for i in range(2)] == [(16, 24, 3)] * 2
    head = open(out / "mesh.ply").read().split("end_header\n")[0]
    assert f"element vertex {mesh.group(1)}" in head and f"element face {mesh.group(2)}" in head

    second = _run(capsys, scene["train"], "--network", scene["network"], "--n_steps", 0,
                  "--load_snapshot", out / "scene.ingp", "--test_transforms", scene["test"])
    lines = second.splitlines()
    assert lines[0] == "loaded snapshot at step 50"
    reheld = re.fullmatch(r"test_transforms: PSNR=(\S+) .*", lines[2])
    assert abs(float(reheld.group(1)) - float(held.group(1))) <= 0.05
    third = _run(capsys, scene["train"], "--network", scene["network"], "--n_steps", 0,
                 "--load_snapshot", out / "scene.ingp", "--holdout_every", 4)
    lines = third.splitlines()
    assert lines[0] == "holdout: training on 18 views, evaluating on 6"
    assert re.fullmatch(r"holdout\(every 4\): PSNR=\S+ \[min=\S+ max=\S+\] SSIM=\S+ over 6 views",
                        lines[3])


# -- what the port refuses


def test_refusals(scene, testbeds, tmp_path, capsys, small_engines):
    """Each names the ROADMAP item that ports it."""
    from ngp_tpu_torch import run
    from ngp_tpu_torch.testbed import Testbed, default_config

    ptb, _ = testbeds
    # the volume mode is ported (tests/test_torch_volume.py): only a missing
    # file is refused
    assert Testbed(mode="volume").mode == "volume" and default_config("volume")["encoding"]
    with pytest.raises(FileNotFoundError):
        Testbed(scene=str(tmp_path / "volume.nvdb"), device="cpu")
    # frame() is ported (tests/test_torch_frame_viewer.py): a heartbeat
    # that neither trains nor renders changes nothing but the meters
    step = ptb.training_step
    out = ptb.frame(n_train_steps=0, render=False)
    assert out["image"] is None and out["training_step"] == step and ptb.frame_meters
    # the render crop box (A6) is ported: it round trips through the
    # engine as float32 arrays (tests/test_torch_render_surface.py holds
    # its frames to the JAX package's)
    assert ptb.render_aabb is None
    ptb.render_aabb = (np.zeros(3), np.ones(3))
    lo, hi = ptb.render_aabb
    assert lo.dtype == hi.dtype == np.float32 and (lo == 0).all() and (hi == 1).all()
    assert ptb.engine.render_aabb is ptb.render_aabb
    ptb.render_aabb = None
    assert ptb.engine.render_aabb is None
    # depth maps in set_image (A5c) are ported: without depth supervision
    # the engine holds none and the map is ignored, as in the JAX package
    # (tests/test_torch_supervision.py holds both cases to it)
    frame0 = ptb.engine.images[0].clone()
    ptb.set_image(0, np.zeros((32, 32, 3), np.float32), depth=np.zeros((32, 32)))
    assert ptb.engine.depths is None and not ptb.engine.images[0, ..., :3].any()
    ptb.engine.images[0] = frame0
    # a geometry prior beside the capture (A5d) is ported: it seeds the
    # grid (tests/test_torch_occupancy_schedule.py holds it to the JAX
    # Testbed's); one triangle leaves trainable only the cells it crosses
    prior = tmp_path / "prior"
    shutil.copytree(os.path.dirname(scene["train"]), prior)
    (prior / "prior.obj").write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    seeded = Testbed(scene=str(prior / "transforms_train.json"), config=scene["network"],
                     device="cpu", grid_size=GRID, batch_size=1 << 12)
    plain = seeded.engine.init_grid()
    assert (seeded.grid.density < 0).sum() > (plain.density < 0).sum()
    assert (seeded.grid.density[plain.density < 0] == -1).all()
    assert 0 < int((seeded.grid.density == 0).sum()) < int((plain.density == 0).sum())
    # JPEG screenshots (A11) are ported (tests/test_torch_jpeg_encode.py
    # holds them to the JAX CLI's bytes); another type raises
    with pytest.raises(ValueError, match=".png, .jpg and .exr"):
        run.write_image(str(tmp_path / "x.tga"), np.zeros((4, 4, 3)))
    # overlays (A6) are ported: the left half is the ground truth
    over = ptb.engine.render_image(ptb.state, ptb.grid, 0, stride=8, overlay="gt")
    gt = ptb.engine.images[0, ::8, ::8, :3].to(torch.float32) / 255.0
    assert torch.equal(over[:, :2], gt[:, :2])
    # the normals mode is ported: the CLI writes its screenshot
    from ngp_tpu_torch.data.png import read_png

    run.main([scene["train"], "--network", scene["network"], "--n_steps", "0",
              "--device", "cpu", "--screenshot", str(tmp_path / "n.png"),
              "--render_mode", "normals"])
    assert f"wrote {tmp_path / 'n.png'}" in capsys.readouterr().out
    shot = read_png(str(tmp_path / "n.png"))
    assert shot.shape == (32, 32, 3) and np.isfinite(shot.astype(np.float32)).all()


def test_entry_points_run_on_the_card_unless_asked(scene):
    """``Testbed`` and the CLI default to the card: without one they raise
    instead of falling back to the CPU."""
    from ngp_tpu_torch import run
    from ngp_tpu_torch.testbed import Testbed

    assert run.parse_args(["scene.json"]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device 'cuda' requested"):
            run.main([scene["train"], "--n_steps", "0"])
        with pytest.raises(RuntimeError, match="device 'cuda' requested"):
            Testbed(scene=scene["train"])


def test_port_imports_neither_jax_nor_the_jax_package():
    """No module of ``ngp_tpu_torch`` and not ``chip_smoke.py`` imports
    ``jax`` or ``ngp_tpu``."""
    pattern = re.compile(r"^\s*(?:import|from)\s+(?:jax|ngp_tpu)(?:[\s.,]|$)", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "ngp_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 30
    offenders = [f for f in files if pattern.search(open(f).read())]
    assert not offenders, offenders

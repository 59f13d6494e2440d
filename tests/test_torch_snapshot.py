"""Snapshots across packages, on the CPU: the port's msgpack writer against
``msgpack``, the write half of the reference ``.ingp`` codec and the native
snapshot format against the JAX package's, each package loading what the
other wrote, camera groups that are not zero crossing both ways, and the
refusals.

Tolerances: bytes, parameters, moments and grids exact (both packages
write the same float16 and float32 values); renders of a crossed snapshot
2e-4 against the golden render (the JAX package's own golden bound).
"""

import os
import re
import zlib

import msgpack
import numpy as np
import pytest
import torch

import jax

from ngp_tpu.data import ingp_snapshot as jingp
from ngp_tpu.utils import snapshot as jsnapshot
from ngp_tpu_torch.data import ingp_snapshot as pingp
from ngp_tpu_torch.data import msgpack_lite
from ngp_tpu_torch.interop import export_jax_params, load_jax_params
from ngp_tpu_torch.train import CameraParams
from ngp_tpu_torch.utils import snapshot as psnapshot

# One intra-op thread: with two, torch's CPU sqrt (MKL's vsSqrt, split across
# the intra-op threads) now and then returned one thread's chunk ~3e-4 off
# on an AVX-512 Xeon (torch 2.13, MKL 2024.2), never with one
# (scripts/torch_sqrt_threads.py counts it).
# Every port test module sets the same count, so that a pytest worker's
# count does not depend on which module it imported last.
torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
GOLDEN_INGP = os.path.join(GOLDEN, "golden.ingp")
GOLDEN_TOL = 2e-4

EDGE_CASES = {
    "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
             -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63],
    "floats": [0.0, -0.0, 0.5, -1.25e300, float("inf"), float("-inf"), 1e-310],
    "empty": [[], {}, "", b"", ()],
    "str": ["a" * 31, "b" * 32, "c" * 255, "d" * 256, "e" * 65535, "f" * 65536, "é" * 40000],
    "bin": [b"x" * 255, b"y" * 256, b"z" * 65535, b"w" * 65536, bytearray(b"ab"),
            memoryview(b"cd")],
    "containers": [list(range(15)), list(range(16)), list(range(65536)),
                   {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
                   {str(i): None for i in range(65536)}, (1, (2, [3, {"k": (4,)}]))],
    "consts": [None, True, False, {1: "int key", "k": [None, True]}],
}


def _port_golden_engine(**kw):
    from test_torch_render import port_golden_engine

    return port_golden_engine(**kw)


@pytest.fixture(scope="module")
def golden():
    """The golden snapshot loaded by both packages."""
    from golden.make_golden import build_engine

    peng, jeng = _port_golden_engine(), build_engine()
    return (peng, *peng.load_reference_snapshot(GOLDEN_INGP),
            jeng, *jeng.load_reference_snapshot(GOLDEN_INGP))


def _golden_render():
    return np.load(os.path.join(GOLDEN, "golden.npz"))["render"]


def _assert_trees_equal(got, want, path="tree"):
    """Equal structure (dict keys, list lengths) and equal array leaves."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), (path, list(got), list(want))
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_equal(g, w, f"{path}[{i}]")
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape, (path, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=path)


# -- msgpack writer


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_packb_matches_msgpack_on_edge_cases(case):
    for value in EDGE_CASES[case]:
        want = msgpack.packb(value, use_bin_type=True)
        assert msgpack_lite.packb(value) == want, repr(value)[:60]
        assert msgpack_lite.unpackb(want) == msgpack.unpackb(
            want, raw=False, strict_map_key=False)


def test_packb_refuses_what_msgpack_refuses():
    for bad in (2**64, -2**63 - 1):
        with pytest.raises(OverflowError):
            msgpack_lite.packb(bad)
    for bad in (np.int64(3), np.float32(1.0), object(), {1, 2}):
        with pytest.raises(TypeError):
            msgpack_lite.packb(bad)


def test_packb_matches_msgpack_on_snapshot_documents(golden, tmp_path):
    """The golden reference snapshot's document, the port's reference and
    native documents of the golden state (a native one with its optimizer
    state), byte for byte."""
    peng, pstate, pgrid = golden[:3]
    with open(GOLDEN_INGP, "rb") as f:
        docs = [msgpack_lite.unpackb(zlib.decompress(f.read()))]
    peng.save_reference_snapshot(str(tmp_path / "r.msgpack"), pstate, pgrid)
    peng.save_snapshot(str(tmp_path / "n.msgpack"), pstate, pgrid, include_optimizer=True)
    for name in ("r.msgpack", "n.msgpack"):
        blob = (tmp_path / name).read_bytes()
        doc = msgpack.unpackb(blob, raw=False, strict_map_key=False)
        assert msgpack.packb(doc, use_bin_type=True) == blob
        docs.append(doc)
    for doc in docs:
        assert msgpack_lite.packb(doc) == msgpack.packb(doc, use_bin_type=True)


# -- reference .ingp, the write half


@pytest.mark.parametrize("seed", [0, 1])
def test_reference_buffers_match_jax(golden, seed):
    """``params_to_reference`` and ``density_grid_to_reference`` give the JAX
    functions' bytes for the same weights (random, from a numpy seed) and
    the same grid (float16 and float32 rows, -1 culled cells)."""
    peng, _, _, jeng = golden[:4]
    rng = np.random.default_rng(seed)
    net = peng._new_network()
    tree = export_jax_params(net)
    tree = {k: {kk: ([rng.normal(0, 0.3, w.shape).astype(np.float32) for w in v]
                     if isinstance(v, list) else rng.normal(0, 0.3, v.shape).astype(np.float32))
                for kk, v in sub.items()} if k != "dir_encoding" else sub
            for k, sub in tree.items()}
    load_jax_params(net, tree)
    got = pingp.params_to_reference(export_jax_params(net), net)
    want = jingp.params_to_reference(tree, jeng.network)
    assert got == want and len(got) == 2 * pingp.reference_n_params(net)
    density = rng.normal(0, 3, (2, 16, 16, 16)).astype(np.float32)
    density[:, :3] = -1.0
    assert pingp.density_grid_to_reference(density) == jingp.density_grid_to_reference(density)
    back = pingp.density_grid_from_reference(pingp.density_grid_to_reference(density), 2, 16)
    np.testing.assert_array_equal(back, density.astype(np.float16).astype(np.float32))


def test_reference_snapshot_crosses_packages(golden, tmp_path):
    """A port ``.ingp`` of the golden state equals the JAX package's file of
    its state, byte for byte, and loads in the JAX package; a JAX ``.ingp``
    loads in the port. Each package renders the other's file within the
    golden bound, and a second save of a loaded file is byte-identical."""
    peng, pstate, pgrid, jeng, jstate, jgrid = golden
    pfile, jfile = str(tmp_path / "port.ingp"), str(tmp_path / "jax.ingp")
    peng.save_reference_snapshot(pfile, pstate, pgrid)
    jeng.save_reference_snapshot(jfile, jstate, jgrid)
    assert open(pfile, "rb").read() == open(jfile, "rb").read()

    jstate2, jgrid2 = jeng.load_reference_snapshot(pfile)
    pstate2, pgrid2 = peng.load_reference_snapshot(jfile)
    for k in ("pos_encoding", "density_mlp", "rgb_mlp"):
        for a, b in zip(jax.tree.leaves(export_jax_params(pstate2.model)[k]),
                        jax.tree.leaves(jstate2.params["model"][k])):
            np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(pgrid2.density.numpy(), np.asarray(jgrid2.density))
    gold = _golden_render()
    np.testing.assert_allclose(np.asarray(jeng.render_image(jstate2, jgrid2, 0, stride=4)),
                               gold, rtol=GOLDEN_TOL, atol=GOLDEN_TOL)
    np.testing.assert_allclose(peng.render_image(pstate2, pgrid2, 0, stride=4).numpy(),
                               gold, rtol=GOLDEN_TOL, atol=GOLDEN_TOL)
    again = str(tmp_path / "again.ingp")
    peng.save_reference_snapshot(again, pstate2, pgrid2)
    assert open(again, "rb").read() == open(pfile, "rb").read()


@pytest.mark.parametrize("encoding", [{"otype": "HashGrid", "interpolation": "Simplex"},
                                      {"otype": "TiledGrid"}], ids=["simplex", "tiled"])
def test_reference_snapshot_of_a_simplex_or_tiled_nerf_crosses_packages(encoding, tmp_path):
    """A Simplex or Tiled NeRF (the golden fixture's config with that
    position encoding, weights drawn from a numpy seed): the port's
    ``.ingp`` equals the JAX package's file of the same parameters and
    grid byte for byte; each package loads the other's file to the same
    parameters and grid, and renders it within the golden bound of the
    other; a second save of a loaded file is byte-identical."""
    from ngp_tpu.engines.nerf import NerfEngine as JaxNerfEngine
    from ngp_tpu_torch.data.nerf_loader import NerfDataset
    from ngp_tpu_torch.engines.nerf import NerfEngine
    from ngp_tpu_torch.train import TrainState
    from test_nerf_engine import CONFIG, _make_dataset

    cfg = dict(CONFIG, encoding={**CONFIG["encoding"], **encoding})
    jd = _make_dataset(6)
    kw = dict(grid_size=16, n_steps_per_unit=128, seed=11)
    jeng = JaxNerfEngine(dict(cfg), jd, batch_size=1 << 12, **kw)
    peng = NerfEngine(dict(cfg), NerfDataset(
        images=jd.images, xforms=jd.xforms, focal_lengths=jd.focal_lengths,
        principal_points=jd.principal_points, lens=jd.lens, resolution=jd.resolution,
        aabb_scale=jd.aabb_scale), device="cpu", **kw)
    penc, jenc = peng.network.pos_encoding, jeng.network.pos_encoding
    assert (penc.grid_type, penc.interpolation) == (jenc.grid_type, jenc.interpolation)
    rng = np.random.default_rng(3)
    jstate, jgrid = jeng.init_state(), jeng.init_grid()
    tree = jax.tree.map(lambda a: rng.normal(0, 0.3, np.shape(a)).astype(np.float32),
                        jax.tree.map(np.asarray, jstate.params["model"]))
    params = {**jstate.params, "model": tree}
    jstate = jstate._replace(params=params, ema=jstate.ema._replace(params=params))
    density = rng.normal(0, 3, np.shape(jgrid.density)).astype(np.float32)
    jgrid = jgrid._replace(density=jax.numpy.asarray(density))
    pstate = TrainState.create(load_jax_params(peng._new_network(), tree))
    pgrid = peng.grid_from_density(torch.from_numpy(density))
    pfile, jfile = str(tmp_path / "port.ingp"), str(tmp_path / "jax.ingp")
    peng.save_reference_snapshot(pfile, pstate, pgrid)
    jeng.save_reference_snapshot(jfile, jstate, jgrid)
    assert open(pfile, "rb").read() == open(jfile, "rb").read()

    jstate2, jgrid2 = jeng.load_reference_snapshot(pfile)
    pstate2, pgrid2 = peng.load_reference_snapshot(jfile)
    for k in ("pos_encoding", "density_mlp", "rgb_mlp"):
        for a, b in zip(jax.tree.leaves(export_jax_params(pstate2.model)[k]),
                        jax.tree.leaves(jstate2.params["model"][k])):
            np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(pgrid2.density.numpy(), np.asarray(jgrid2.density))
    np.testing.assert_allclose(peng.render_image(pstate2, pgrid2, 0, stride=4).numpy(),
                               np.asarray(jeng.render_image(jstate2, jgrid2, 0, stride=4)),
                               rtol=GOLDEN_TOL, atol=GOLDEN_TOL)
    again = str(tmp_path / "again.ingp")
    peng.save_reference_snapshot(again, pstate2, pgrid2)
    assert open(again, "rb").read() == open(pfile, "rb").read()


# -- native snapshots


def _jax_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_native_snapshot_from_port_loads_in_jax(golden, tmp_path):
    """The port's native file of the golden state, loaded by the JAX
    engine: parameters, EMA, density grid, step and loss EMA equal; its
    document has the JAX engine's keys and dtypes; the JAX engine renders
    it within the golden bound."""
    from ngp_tpu_torch.utils.meters import TrainMeters

    peng, pstate, pgrid, jeng, _, _ = golden
    peng.meters = TrainMeters()
    peng.meters.loss_ema = 0.0456
    path = str(tmp_path / "port.ingp")
    peng.save_snapshot(path, pstate, pgrid)
    doc = jsnapshot.load_snapshot(path)
    snap = doc["snapshot"]
    assert doc["mode"] == "nerf" and doc["network_config"] == peng.config
    assert list(snap) == ["training_step", "params", "ema_params", "density_grid",
                          "density_grid_mean", "aabb_scale", "loss_ema"]
    assert snap["training_step"].dtype == np.int32 and snap["training_step"].shape == ()
    assert snap["density_grid"].dtype == np.float16
    assert snap["density_grid_mean"].dtype == np.float32 and snap["density_grid_mean"].shape == ()
    assert snap["loss_ema"] == 0.0456 and snap["aabb_scale"] == 1
    jstate, jgrid = jeng.load_snapshot(path)
    assert jeng.meters.loss_ema == 0.0456
    want = export_jax_params(pstate.model)
    _assert_trees_equal(_jax_tree(jstate.params["model"]), _jax_tree(want))
    _assert_trees_equal(_jax_tree(jstate.ema.params["model"]),
                        _jax_tree(export_jax_params(pstate.inference_model())))
    # the camera group at the JAX engine's shapes, zero
    cam = _jax_tree(jeng.init_state().params["camera"])
    assert {k: v.shape for k, v in jstate.params["camera"].items()} == \
        {k: v.shape for k, v in cam.items()}
    assert not any(np.any(np.asarray(v)) for v in jstate.params["camera"].values())
    assert int(jstate.step) == pstate.step
    np.testing.assert_array_equal(np.asarray(jgrid.density),
                                  pgrid.density.numpy().astype(np.float16).astype(np.float32))
    assert float(jgrid.mean_density) == float(pgrid.mean_density)
    np.testing.assert_allclose(np.asarray(jeng.render_image(jstate, jgrid, 0, stride=4)),
                               _golden_render(), rtol=GOLDEN_TOL, atol=GOLDEN_TOL)


def test_native_snapshot_from_jax_loads_in_port(golden, tmp_path):
    """The JAX engine's native file (its random latents, optax moments and
    a loss EMA) loaded by the port: parameters, EMA, grid, step and loss
    EMA equal; the optax moments are not the port's layout, so the port's
    start at zero; a second save writes what the JAX engine wrote, the
    latents and the optimizer state aside."""
    from ngp_tpu.utils.meters import TrainMeters

    peng, _, _, jeng, jstate, jgrid = golden
    jeng.meters = TrainMeters()
    jeng.meters.loss_ema = 0.0123
    path = str(tmp_path / "jax.ingp")
    jeng.save_snapshot(path, jstate, jgrid, include_optimizer=True)
    pstate, pgrid = peng.load_snapshot(path)
    _assert_trees_equal(_jax_tree(export_jax_params(pstate.model)),
                        _jax_tree(jstate.params["model"]))
    _assert_trees_equal(_jax_tree(export_jax_params(pstate.inference_model())),
                        _jax_tree(jstate.ema.params["model"]))
    assert pstate.step == int(jstate.step)
    np.testing.assert_array_equal(pgrid.density.numpy(), np.asarray(
        jgrid.density, np.float16).astype(np.float32))
    assert peng.meters.loss_ema == 0.0123
    for opt in pstate.opt_state.values():
        assert opt.count == 0 and not any(t.any() for t in (*opt.mu, *opt.nu))
    again = str(tmp_path / "again.ingp")
    peng.save_snapshot(again, pstate, pgrid)
    a, b = jsnapshot.load_snapshot(path)["snapshot"], psnapshot.load_snapshot(again)["snapshot"]
    for s in (a, b):
        s.pop("opt_state", None)
        for tree in ("params", "ema_params"):
            s[tree]["camera"].pop("latents")
    _assert_trees_equal(b, a)


def test_native_snapshot_round_trip_with_optimizer(tmp_path, capsys):
    """A trained port state with refinement off (moments and EMA moved off
    the parameters) saved with its optimizer and loaded: step, parameters,
    EMA, moments and counts bit for bit, the frozen camera group, its EMA
    and its moments zero; the grid from its float16 densities and stored
    mean; the loss EMA; a second save byte-identical. (Training prints the
    JAX engine's ``log_every`` lines.)"""
    _round_trip_with_optimizer(tmp_path, capsys, refined=False)


def test_native_snapshot_round_trip_with_camera_optimizer(tmp_path, capsys):
    """As :func:`test_native_snapshot_round_trip_with_optimizer` with every
    camera refinement flag on, so that the camera group, its EMA and its
    moments move and round-trip bit for bit too."""
    _round_trip_with_optimizer(tmp_path, capsys, refined=True)


def _round_trip_with_optimizer(tmp_path, capsys, refined: bool):
    from ngp_tpu_torch.config import default_config
    from ngp_tpu_torch.data.synthetic import tiny_sphere_dataset
    from ngp_tpu_torch.engines.nerf import NerfEngine

    cfg = default_config("tpu")
    cfg["encoding"].update(n_levels=4, log2_hashmap_size=12)
    cfg["network"]["n_neurons"] = cfg["rgb_network"]["n_neurons"] = 16
    flags = dict(optimize_extrinsics=refined, optimize_exposure=refined,
                 optimize_focal_length=refined, optimize_distortion=refined)
    eng = NerfEngine(cfg, tiny_sphere_dataset(4, 16), batch_size=1 << 12, grid_size=16,
                     device="cpu", **flags)
    state, grid = eng.init_state(), eng.init_grid()
    state, grid, _ = eng.train(state, grid, 40, log_every=16)  # the meters read window 1
    logged = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in logged] == ["step 0", "step 16", "step 32"]
    assert all(re.fullmatch(r"step \d+: loss=\d\.\d{5} samples=\d+ k=\d+ \(\d+\.\d\d "
                            r"Msamples/s\)", ln) for ln in logged)
    loss_ema = eng.meters.loss_ema
    first, second = str(tmp_path / "a.ingp"), str(tmp_path / "b.ingp")
    eng.save_snapshot(first, state, grid, include_optimizer=True)
    state2, grid2 = eng.load_snapshot(first)
    assert state2.step == state.step == 40
    for a, b in ((state.model, state2.model), (state.ema, state2.ema),
                 (state.camera, state2.camera), (state.camera_ema, state2.camera_ema)):
        for p, q in zip(a.parameters(), b.parameters()):
            assert torch.equal(p, q)
    for cam in (state.camera, state.camera_ema):
        assert any(bool(p.any()) for p in cam.parameters()) == refined
    assert state.opt_state["camera"].count == (40 if refined else 0)
    for g in state.opt_state:
        assert state2.opt_state[g].count == state.opt_state[g].count
        names = CameraParams.NAMES if g == "camera" else [None] * len(state.opt_state[g].mu)
        for name, m, n in zip(names * 2, state.opt_state[g].mu + state.opt_state[g].nu,
                              state2.opt_state[g].mu + state2.opt_state[g].nu):
            # the frozen camera group's moments stay zero, and the latents'
            # (no extra dims: their gradient is zero)
            moved = refined if g == "camera" and name != "latents" else g != "camera"
            assert torch.equal(m, n) and bool(m.any()) == moved
    assert torch.equal(grid2.density, grid.density.half().float())
    assert torch.equal(grid2.mean_density, grid.mean_density)
    assert eng.meters.loss_ema == loss_ema > 0
    eng.save_snapshot(second, state2, grid2, include_optimizer=True)
    assert open(first, "rb").read() == open(second, "rb").read()
    # training goes on from the loaded state as from the saved one
    torch.testing.assert_close(eng.render_image(state2, grid2, 0, stride=4),
                               eng.render_image(state, grid, 0, stride=4), rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def refining():
    """Both engines at the golden settings with every camera refinement
    flag on, and the JAX engine's state of the golden snapshot."""
    from golden.make_golden import build_engine

    from ngp_tpu.engines.nerf import NerfEngine as JaxNerfEngine

    flags = dict(optimize_extrinsics=True, optimize_exposure=True,
                 optimize_focal_length=True, optimize_distortion=True)
    jeng = JaxNerfEngine(dict(build_engine().config), build_engine().dataset,
                         batch_size=1 << 12, grid_size=16, n_steps_per_unit=128,
                         density_grid_decay=0.8, seed=11, **flags)
    return _port_golden_engine(**flags), jeng, jeng.load_reference_snapshot(GOLDEN_INGP)


def _without_latents(tree):
    return {k: ({n: v for n, v in tree[k].items() if n != "latents"} if k == "camera"
                else tree[k]) for k in tree}


@pytest.mark.parametrize("name", ["pos", "rot", "exposure", "focal", "distortion"])
def test_snapshot_with_camera_parameters_crosses(refining, tmp_path, name):
    """A JAX native snapshot whose camera leaf ``name`` is not zero (one
    value in the parameters, another in the EMA) loads into the port with
    both, array for array; the port renders view 0 within the golden bound
    of the JAX engine's render of that snapshot (the EMA distortion grid
    reaches the render, pose, exposure and focal reach none, as in the JAX
    engine); and the port's save of it loads back into the JAX engine array
    for array, the latents aside (the port holds them at zero)."""
    peng, jeng, (jstate, jgrid) = refining
    rng = np.random.default_rng(len(name))
    shape = np.asarray(jstate.params["camera"][name]).shape
    value, ema_value = (rng.normal(0, 0.05, shape).astype(np.float32) for _ in range(2))
    params = {**jstate.params, "camera": {**jstate.params["camera"], name: value}}
    ema = {**jstate.ema.params, "camera": {**jstate.ema.params["camera"], name: ema_value}}
    jstate = jstate._replace(params=params, ema=jstate.ema._replace(params=ema))
    path, back = str(tmp_path / "jax.msgpack"), str(tmp_path / "port.msgpack")
    jeng.save_snapshot(path, jstate, jgrid)
    jstate, jgrid = jeng.load_snapshot(path)
    pstate, pgrid = peng.load_snapshot(path)
    np.testing.assert_array_equal(getattr(pstate.camera, name).detach().numpy(), value)
    np.testing.assert_array_equal(getattr(pstate.camera_ema, name).numpy(), ema_value)
    want = np.asarray(jeng.render_image(jstate, jgrid, 0, stride=4))
    np.testing.assert_allclose(peng.render_image(pstate, pgrid, 0, stride=4).numpy(), want,
                               rtol=GOLDEN_TOL, atol=GOLDEN_TOL)
    moved = np.abs(want - _golden_render()).max()
    assert (moved > 1e-2) == (name == "distortion"), moved
    peng.save_snapshot(back, pstate, pgrid)
    jstate2, _ = jeng.load_snapshot(back)
    for tree in ("params", "ema"):
        a = getattr(jstate, tree) if tree == "params" else jstate.ema.params
        b = getattr(jstate2, tree) if tree == "params" else jstate2.ema.params
        _assert_trees_equal(_jax_tree(_without_latents(b)), _jax_tree(_without_latents(a)))


@pytest.mark.parametrize("name", ["envmap"])
def test_snapshot_with_camera_parameters_is_refused(golden, tmp_path, name):
    """Once refused (the trainable envmap was not yet ported), now loaded:
    a snapshot that carries an envmap (one image in the parameters, another
    in the EMA) and latents that are not zero loads with both, array for
    array, though the engine neither trains an envmap nor has extra dims,
    as the JAX engine's state keeps its whole parameter tree; rays that
    leave the scene render the EMA envmap; a second save writes the same
    trees."""
    peng, pstate, pgrid = golden[:3]
    path = str(tmp_path / "s.msgpack")
    peng.save_snapshot(path, pstate, pgrid)
    doc = psnapshot.load_snapshot(path)
    del doc["version"]
    doc["snapshot"]["params"]["camera"]["latents"] += 0.5
    doc["snapshot"]["params"]["camera"]["pos"].flat[0] = 1e-3
    rng = np.random.default_rng(4)
    images = {tree: rng.uniform(0, 1, (4, 8, 4)).astype(np.float32)
              for tree in ("params", "ema_params")}
    for tree, image in images.items():
        doc["snapshot"][tree][name] = {"image": image}
    state, grid = peng.load_snapshot(_write(path, doc))
    np.testing.assert_array_equal(state.camera.latents.detach().numpy(),
                                  doc["snapshot"]["params"]["camera"]["latents"])
    np.testing.assert_array_equal(state.envmap.image.detach().numpy(), images["params"])
    np.testing.assert_array_equal(state.envmap_ema.image.numpy(), images["ema_params"])
    d = torch.nn.functional.normalize(torch.tensor([[1.0, 0.2, 0.1], [0.8, -0.3, 0.4]]), dim=-1)
    o = torch.tensor([[3.0, 0.5, 0.5]]).expand(2, 3)
    rgb, _, opacity = peng.render_rays(state, grid, o, d)
    assert not opacity.any()
    torch.testing.assert_close(rgb, peng._miss_background(d, state.envmap_ema.image))
    again = str(tmp_path / "again.msgpack")
    peng.save_snapshot(again, state, grid)
    a, b = doc["snapshot"], psnapshot.load_snapshot(again)["snapshot"]
    for tree in ("params", "ema_params"):
        _assert_trees_equal(b[tree], {k: a[tree][k] for k in sorted(a[tree])})


def _write(path, doc):
    psnapshot.save_snapshot(path, doc)
    return path


def test_snapshot_containers_match_jax(tmp_path):
    """``utils/snapshot.py`` writes the JAX package's bytes for the same
    payload (numpy and torch leaves, nested lists, every extension) and
    each package reads the other's file."""
    rng = np.random.default_rng(3)
    payload = {"a": rng.normal(size=(3, 4)).astype(np.float32), "b": [np.int32(7), 1.5, "s"],
               "c": {"d": rng.integers(0, 9, (5,)).astype(np.int64), "e": None},
               "f": np.float16(2.5), "g": np.zeros((0, 2), np.uint8)}
    for ext in (".ingp", ".msgpack"):
        jp, pp = str(tmp_path / f"j{ext}"), str(tmp_path / f"p{ext}")
        jsnapshot.save_snapshot(jp, payload)
        psnapshot.save_snapshot(pp, {**payload, "a": torch.from_numpy(payload["a"])})
        assert open(jp, "rb").read() == open(pp, "rb").read()
        _assert_trees_equal(psnapshot.load_snapshot(jp), jsnapshot.load_snapshot(pp))

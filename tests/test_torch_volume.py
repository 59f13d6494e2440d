"""The port's volume primitive (``ngp_tpu_torch/data/nanovdb_codec.py``,
``data/volume.py``, ``ops/volume_walk.py``, ``engines/volume.py``,
``Testbed`` and ``run`` in volume mode) against the JAX package on the CPU.

Sizes are small: ``tests/test_volume.py``'s config (a 6-level grid of 2^14
rows, the 64-wide MLP with a ReLU output), ``procedural_cloud(res=32)``.
The port's random draws are its own, so the JAX engine's draws (its key
schedule, folded as ``ngp_tpu/engines/volume.py`` folds it) are fed to the
port where a comparison needs the same numbers. Tolerances are stated in
each test.
"""

import copy
import json
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ngp_tpu.data import nanovdb_codec as jcodec
from ngp_tpu.data.volume import DenseVolume as JaxDenseVolume
from ngp_tpu.data.volume import procedural_cloud as jax_cloud
from ngp_tpu.engines import volume as jvolume
from ngp_tpu_torch.data import nanovdb_codec as pcodec
from ngp_tpu_torch.data.volume import DenseVolume, load_volume, procedural_cloud
from ngp_tpu_torch.engines.volume import VolumeEngine
from ngp_tpu_torch.interop import export_jax_params, load_jax_params
from ngp_tpu_torch.ops import volume_walk as vw
from ngp_tpu_torch.train import TrainState

# One intra-op thread, as every port test module sets (tests/test_torch_sdf.py).
torch.set_num_threads(1)

CONFIG = {
    "loss": {"otype": "L2"},
    "optimizer": {
        "otype": "Ema",
        "decay": 0.95,
        "nested": {"otype": "Adam", "learning_rate": 1e-3, "beta1": 0.9,
                   "beta2": 0.99, "epsilon": 1e-15, "l2_reg": 1e-6},
    },
    "encoding": {"otype": "HashGrid", "n_levels": 6, "n_features_per_level": 2,
                 "log2_hashmap_size": 14, "base_resolution": 8,
                 "per_level_scale": 1.6},
    "network": {"otype": "FullyFusedMLP", "activation": "ReLU",
                "output_activation": "ReLU", "n_neurons": 64,
                "n_hidden_layers": 2},
}
# the frames' field: 20 JAX steps at a learning rate of 1e-2
RENDER_CONFIG = copy.deepcopy(CONFIG)
RENDER_CONFIG["optimizer"]["nested"]["learning_rate"] = 1e-2
BATCH = 1 << 12
SEED = 5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def engines():
    jeng = jvolume.VolumeEngine(copy.deepcopy(CONFIG), jax_cloud(res=32), batch_size=BATCH,
                                seed=SEED)
    peng = VolumeEngine(CONFIG, procedural_cloud(32, device="cpu"), batch_size=BATCH,
                        seed=SEED, device="cpu")
    return jeng, peng


def _port_state(peng, jstate) -> TrainState:
    net = load_jax_params(peng._new_network(), _np(jstate.params))
    state = TrainState.create(net, int(jstate.step))
    state.ema = load_jax_params(copy.deepcopy(net), _np(jstate.ema.params)).requires_grad_(False)
    return state


# -- (a) the NanoVDB codec


def _random_volume():
    rng = np.random.default_rng(0)  # tests/test_volume.py's array
    return (rng.uniform(0, 2, size=(40, 24, 17))
            * (rng.uniform(size=(40, 24, 17)) > 0.4)).astype(np.float32)


def test_nanovdb_codec_matches_jax(tmp_path):
    """The port's writer gives the JAX writer's bytes for the same array;
    each package's reader returns the other's file exactly."""
    vol = _random_volume()
    pfile, jfile = str(tmp_path / "p.nvdb"), str(tmp_path / "j.nvdb")
    pcodec.write_nanovdb(pfile, vol)
    jcodec.write_nanovdb(jfile, vol)
    assert open(pfile, "rb").read() == open(jfile, "rb").read()
    np.testing.assert_array_equal(pcodec.read_nanovdb_dense(jfile), vol)
    np.testing.assert_array_equal(jcodec.read_nanovdb_dense(pfile), vol)
    assert load_volume(pfile, "cpu").global_majorant == float(vol.max())


# -- (b) the dense volume


def _box():
    vol = np.zeros((64, 32, 16), np.float32)  # tests/test_volume.py's box
    vol[10:20, 5:15, 3:9] = 2.5
    return vol


@pytest.mark.parametrize("case", ["cloud", "box"])
def test_dense_volume_matches_jax(case):
    """Every field equals the JAX package's: the density and the bitgrid
    exactly, the floats within 1e-7 (measured equal)."""
    if case == "cloud":
        got, want = procedural_cloud(32, device="cpu"), jax_cloud(res=32)
    else:
        got, want = DenseVolume.from_dense(_box(), "cpu"), JaxDenseVolume.from_dense(_box())
    np.testing.assert_array_equal(got.density.numpy(), np.asarray(want.density))
    np.testing.assert_array_equal(got.bitgrid.numpy(), np.asarray(want.bitgrid))
    assert got.bitgrid.dtype == torch.uint8 and int(got.bitgrid.sum()) > 0
    for name in ("world2index_offset", "aabb_min", "aabb_max"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), rtol=0, atol=1e-7)
    assert abs(got.world2index_scale - want.world2index_scale) <= 1e-7
    assert abs(got.global_majorant - want.global_majorant) <= 1e-7


# -- (c) the walk's pieces


def _probe(n=4096, seed=1):
    """Positions in and around the box (a quarter on bit-cell boundaries),
    unit directions (a quarter along an axis, zero components, some of
    them negative zero), alive flags and uniforms."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-0.05, 1.05, (n, 3)).astype(np.float32)
    k = n // 4
    pos[:k] = (rng.integers(0, 129, (k, 3)) - 0.5) / 128.0
    dirs = rng.normal(size=(n, 3))
    axis = rng.integers(0, 3, k)
    dirs[:k] = np.eye(3)[axis] * rng.choice([-1.0, 1.0], (k, 1))
    dirs[k // 2:k][np.eye(3, dtype=bool)[(axis[k // 2:] + 1) % 3]] = -0.0
    dirs = (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)).astype(np.float32)
    alive = rng.uniform(size=n) < 0.9
    u = rng.uniform(size=n).astype(np.float32)
    jitter = rng.uniform(size=(n, 3)).astype(np.float32)
    return pos, dirs, alive, u, jitter


def test_walk_pieces_match_jax(engines):
    """``bit_occupied``, ``density_at`` (fed the JAX draw's jitter), ``jump``
    (fed its u) and ``proc_envmap`` against the JAX engine's methods on
    the same arrays: booleans exactly, floats within 1e-6 (``vlog`` is
    within 2 ulp of the log; measured 6e-8)."""
    jeng, peng = engines
    walk = peng.walk
    pos, dirs, alive, u, _ = _probe()
    key = jax.random.PRNGKey(2)
    jitter = np.array(jax.random.uniform(key, pos.shape))
    P, D, A, U = map(torch.from_numpy, (pos, dirs, alive, u))
    assert torch.equal(vw.bit_occupied(walk, P), _t(jeng._bit_occupied(jnp.asarray(pos))))
    got = vw.density_at(walk, P, torch.from_numpy(jitter))
    want = np.asarray(jeng._density_at(jnp.asarray(pos), key))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).mean() > 0.1
    got = vw.jump(walk, P, D, A, U)
    want = jeng._jump(jnp.asarray(pos), jnp.asarray(dirs), jnp.asarray(alive), jnp.asarray(u))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-6)
    assert torch.equal(got[1], _t(want[1])) and torch.equal(got[2], _t(want[2]))
    assert 0.05 < float(got[1].float().mean()) < float(got[2].float().mean())
    sky = (0.1, 0.2, 0.3)
    got = vw.proc_envmap(D, jeng.up_dir, jeng.sun_dir, sky)
    want = jvolume.proc_envmap(jnp.asarray(dirs), jnp.asarray(jeng.up_dir),
                               jnp.asarray(jeng.sun_dir), jnp.asarray(sky))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_stream_math():
    """The stream's pieces: ``vlog`` within 2 ulp of the float64 log;
    ``sincos_2pi`` within 2e-7 of cos and sin; the hash's uniforms in
    [0, 1) with 24 bits, (0, 1] open; normals of mean 0 and variance 1
    (within 0.01 over 2^18 draws); keys differ by row, step and seed."""
    x = torch.from_numpy(np.random.default_rng(3).uniform(1e-12, 1.0, 1 << 16)
                         .astype(np.float32))
    x = torch.cat([x, torch.tensor([1.0, 2.0 ** -24, 1e-12, 0.70710677, 1.4142135])])
    ref = torch.log(x.double())
    assert float(((vw.vlog(x).double() - ref).abs() / ref.abs().clamp_min(1e-30)).max()) \
        < 2 * 2.0 ** -23
    u = torch.arange(0, 1 << 24, 97, dtype=torch.float32) * 2.0 ** -24
    c, s = vw.sincos_2pi(u)
    ang = 2 * np.pi * u.double()
    assert float((c.double() - torch.cos(ang)).abs().max()) < 2e-7
    assert float((s.double() - torch.sin(ang)).abs().max()) < 2e-7
    keys = vw.row_keys(vw.draw_key(SEED ^ 0x701, 0), torch.arange(1 << 18))
    uu = vw.uniform(keys, 3, 0)
    assert 0.0 <= float(uu.min()) and float(uu.max()) < 1.0
    assert torch.equal(uu * 2.0 ** 24, torch.floor(uu * 2.0 ** 24))
    assert float(vw.uniform_open(keys, 3, 0).min()) > 0.0
    n = vw.normal3(keys, 5, 5)
    assert float(n.mean(0).abs().max()) < 0.01 and float((n.var(0) - 1).abs().max()) < 0.01
    assert len({vw.draw_key(1, 0), vw.draw_key(1, 1), vw.draw_key(2, 0)}) == 3


# -- (d) the training walk


def _jax_training_draws(key, E):
    """The JAX engine's draws of ``generate_training_data(key, E)``
    (``ngp_tpu/engines/volume.py:131-173``): the starts (normal, uniform)
    and per iteration u, jitter, z and the normal, as torch tensors."""
    k1, k2, k3 = jax.random.split(key, 3)
    start = (_t(jax.random.normal(k1, (E, 3))), _t(jax.random.uniform(k2, (E, 3))))

    def per_iteration(it):
        kw = jax.random.fold_in(k3, it)
        return (jax.random.uniform(kw, (E,)), jax.random.uniform(jax.random.fold_in(kw, 1), (E, 3)),
                jax.random.uniform(jax.random.fold_in(kw, 2), (E,)),
                jax.random.normal(jax.random.fold_in(kw, 3), (E, 3)))

    arrays = jax.jit(jax.vmap(per_iteration))(jnp.arange(vw.MAX_WALK_ITERS))
    return start, vw.ArrayDraws(*map(_t, arrays))


def test_training_walk_matches_jax(engines):
    """``generate_training_data`` fed the JAX draws of ``PRNGKey(0)`` at 256
    episodes reproduces the JAX engine's: ``valid`` equal, positions and
    targets within 1e-5 (measured 1.2e-7 and 2.4e-7). A 1-ulp difference
    may flip one decision of the walk; none does here (share 0 < 1%)."""
    jeng, peng = engines
    E = 256
    key = jax.random.PRNGKey(0)
    start, draws = _jax_training_draws(key, E)
    pos, targets, valid = peng.generate_training_data(0, E, draws=draws, start=start)
    jpos, jtargets, jvalid = map(np.asarray, jeng.generate_training_data(key, E))
    episodes = np.abs(pos.numpy() - jpos).reshape(E, 4, 3).max(axis=(1, 2))
    flipped = np.flatnonzero((valid.numpy() != jvalid).reshape(E, 4).any(1) | (episodes > 1e-5))
    assert len(flipped) <= E // 100, f"episodes {flipped.tolist()} differ"
    keep = (np.setdiff1d(np.arange(E), flipped)[:, None] * 4 + np.arange(4)).reshape(-1)
    np.testing.assert_array_equal(valid.numpy()[keep], jvalid[keep])
    np.testing.assert_allclose(pos.numpy()[keep], jpos[keep], rtol=0, atol=1e-5)
    np.testing.assert_allclose(targets.numpy()[keep], jtargets[keep], rtol=0, atol=1e-5)
    assert 0.2 < jvalid.mean() < 0.9 and (jtargets[jvalid, 3] > 0).mean() > 0.5


def test_training_walk_kernel_semantics():
    """The twin's outputs as the kernel writes them: unfilled slots hold
    zeros, a missed or absorbed episode's throughput is 1 or 0, an episode
    never walks past 512 iterations and keeps walking after its 4 slots
    fill (final directions of full episodes turned)."""
    vol = DenseVolume.from_dense(_box() * 4.0, "cpu")
    walk = vw.WalkVolume.of(vol, 0.01, "cpu")
    E = 512
    d1, ut = vw.start_draws(vw.draw_key(1, 2), E, "cpu")
    o = vw.normalize(d1) * 2.0 + 0.5
    lo, hi = walk.aabb_min, walk.aabb_max
    d = vw.normalize(lo + ut * (hi - lo) - o)
    from ngp_tpu_torch.ops.marching import ray_aabb_range

    tmin, tmax = ray_aabb_range(o, d, lo, hi)
    p = o + d * (tmin + 1e-6)[:, None]
    out_pos, out_den, cursor, dirs, thr, steps = vw.training_walk(
        walk, p, d, tmin <= tmax, vw.HashDraws(vw.draw_key(1, 2)), 0.5, 0.0)
    slot = torch.arange(4)[None, :] >= cursor[:, None].long()
    assert not bool(out_pos[slot].any()) and not bool(out_den[slot].any())
    assert bool((thr == 0).any()) and set(thr.unique().tolist()) <= {0.0, 1.0}
    assert int(steps.max()) <= vw.MAX_WALK_ITERS
    full = cursor == 4
    assert bool(full.any()) and bool((dirs[full] != d[full]).any(dim=1).any())


# -- (e) a training step


def test_training_step_matches_jax(engines):
    """One step from the JAX package's initial parameters on the JAX
    engine's batch (``fold_in(PRNGKey(seed ^ 0x701), 0)``): the loss within
    1e-6 relative; MLP weight gradients within 2e-2 of each matrix's
    largest entry and the table gradient within 2^-6 of each level's
    largest (the SDF step test's float32-order bounds: bf16 roundings and
    addends); the parameters after the step within 2·lr (a gradient whose
    sign differs moves Adam's first step by 2·lr). The update itself
    (after − before): where JAX's gradient exceeds that bound, so that both
    gradients have its sign, the port's update is JAX's within float32
    rounding (1e-5·lr plus two spacings of the parameter); elsewhere it is
    no larger than Adam's first step, lr·(1 + 1e-5) plus that rounding.
    Every weight matrix and every level has entries of the first kind."""
    jeng, peng = engines
    jstate = jeng.init_state()
    pstate = TrainState.create(load_jax_params(peng._new_network(), _np(jstate.params)))
    key = jax.random.fold_in(jax.random.PRNGKey(SEED ^ 0x701), 0)
    pos, targets, valid = jeng.generate_training_data(key, BATCH // 4)

    def loss_of(params):
        per = jeng.trainer.loss_fn(targets, jeng.model(params, pos)) * valid[:, None]
        return jnp.sum(per) / jnp.maximum(jnp.sum(valid), 1) / per.shape[-1]

    jloss, jgrad = jax.value_and_grad(loss_of)(jstate.params)
    batch = (_t(pos), _t(targets), _t(valid))
    net = pstate.model
    ploss = peng.loss(net, *batch)
    ploss.backward()
    np.testing.assert_allclose(float(ploss.detach()), float(jloss), rtol=1e-6)
    for w, jw in zip(net.network.weights, jgrad["network"]["weights"]):
        jw = np.asarray(jw)
        np.testing.assert_allclose(w.grad.numpy(), jw, rtol=0, atol=2e-2 * np.abs(jw).max())
    for level, (got, want) in enumerate(zip(net.encoding.table.grad.numpy(),
                                            np.asarray(jgrad["encoding"]["table"]))):
        np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -6 * np.abs(want).max(),
                                   err_msg=f"level {level}")
    net.zero_grad(set_to_none=True)
    jnext, jstep_loss = jax.jit(jeng._train_step)(jstate, key)
    step_loss = peng.training_step(pstate, batch)
    np.testing.assert_allclose(float(step_loss), float(jstep_loss), rtol=1e-6)
    assert pstate.step == int(jnext.step) == 1
    lr = CONFIG["optimizer"]["nested"]["learning_rate"]
    got, want, before = export_jax_params(pstate.model), _np(jnext.params), _np(jstate.params)
    for g, w in zip(got["network"]["weights"], want["network"]["weights"]):
        np.testing.assert_allclose(g, w, rtol=0, atol=2 * lr)
    np.testing.assert_allclose(got["encoding"]["table"], want["encoding"]["table"], rtol=0,
                               atol=2 * lr)

    def check_update(name, after, want_after, start, grad, bound):
        rounding = 2 * np.spacing(np.maximum(np.abs(start), np.abs(want_after)))
        du, dj = after - start, want_after - start
        sure = np.abs(grad) > bound
        assert sure.any(), name
        miss = np.abs(du - dj)[sure] - (1e-5 * lr + rounding[sure])
        assert miss.max() <= 0, f"{name}: update off JAX's by {miss.max()} beyond rounding"
        over = np.abs(du) - (lr * (1 + 1e-5) + rounding)
        assert over.max() <= 0, f"{name}: an update exceeds Adam's first step by {over.max()}"

    for i, (g, w, b, jg) in enumerate(zip(got["network"]["weights"], want["network"]["weights"],
                                          before["network"]["weights"],
                                          jgrad["network"]["weights"])):
        jg = np.asarray(jg)
        check_update(f"weight {i}", g, w, b, jg, 2e-2 * np.abs(jg).max())
    for level, (g, w, b, jg) in enumerate(zip(got["encoding"]["table"],
                                              want["encoding"]["table"],
                                              before["encoding"]["table"],
                                              np.asarray(jgrad["encoding"]["table"]))):
        check_update(f"table level {level}", g, w, b, jg, 2.0 ** -6 * np.abs(jg).max())


# -- (f) frames


@pytest.fixture(scope="module")
def fitted():
    """Both engines on RENDER_CONFIG, the JAX engine trained 20 steps; the
    port holds its parameters."""
    jeng = jvolume.VolumeEngine(copy.deepcopy(RENDER_CONFIG), jax_cloud(res=32),
                                batch_size=BATCH, seed=SEED)
    peng = VolumeEngine(RENDER_CONFIG, procedural_cloud(32, device="cpu"), batch_size=BATCH,
                        seed=SEED, device="cpu")
    jstate, _ = jeng.train(jeng.init_state(), 20)
    return jeng, jstate, peng, _port_state(peng, jstate)


def _count_learned_frame(peng, pstate, o, d, draws, monkeypatch):
    """The rounds (calls of the walk's dispatcher) and network evaluations
    (positions) of one learned frame."""
    import ngp_tpu_torch.engines.volume as engine_module

    counts = [0, 0]
    walk, network = engine_module.volume_render_walk, peng._network

    def counted_walk(*args, **kwargs):
        counts[0] += 1
        return walk(*args, **kwargs)

    def counted_network(model, pos):
        counts[1] += pos.shape[0]
        return network(model, pos)

    monkeypatch.setattr(engine_module, "volume_render_walk", counted_walk)
    monkeypatch.setattr(peng, "_network", counted_network)
    peng.render_rays(pstate, torch.from_numpy(o), torch.from_numpy(d), False, draws=draws)
    monkeypatch.undo()
    return counts


@pytest.mark.parametrize("gt", [True, False])
def test_render_matches_jax(fitted, gt, monkeypatch):
    """A 16×16 frame from the JAX Testbed's camera fed the JAX frame draws
    (``PRNGKey(7)`` folded with each iteration): rgb and opacity within
    1e-5 of ``_render_rays`` (measured: ground truth within 1.2e-7; the
    learned frame sums the two networks' differences over each ray's
    events, and one ray of 256 is 1.08e-5 off: rays beyond 1e-5 are
    allowed at most 1% of them, each within 1e-4). The learned
    frame runs the event wavefront (each round a walk to the next event,
    the network at the events only) against the JAX lockstep loop, which
    evaluates the network at every ray every iteration."""
    jeng, jstate, peng, pstate = fitted
    o, d = peng.camera_rays((0.5, 0.5, 2.2), (0.5, 0.5, 0.5), (16, 16))
    key = jax.random.PRNGKey(7)
    B = o.shape[0]

    def per_iteration(it):
        kw = jax.random.fold_in(key, it)
        return jax.random.uniform(kw, (B,)), jax.random.uniform(jax.random.fold_in(kw, 1), (B, 3))

    draws = vw.ArrayDraws(*map(_t, jax.jit(jax.vmap(per_iteration))(
        jnp.arange(vw.MAX_WALK_ITERS))))
    params = jeng.trainer.inference_params(jstate)
    jcol, jopa = map(np.asarray, jeng._render_rays(params, jnp.asarray(o), jnp.asarray(d),
                                                   key, gt))
    col, opa = peng.render_rays(pstate, torch.from_numpy(o), torch.from_numpy(d), gt,
                                draws=draws)
    # the two packages' networks differ by up to ~2.4e-7 in a density, and
    # a ray of the learned frame sums a hundred events or more: rays beyond
    # 1e-5 are named, at most 1% of them, each within 1e-4
    opa, col = opa.numpy(), col.numpy()
    err = np.maximum(np.abs(opa - jopa), np.abs(col - jcol).max(1))
    beyond = np.flatnonzero(err > 1e-5)
    assert len(beyond) <= B // 100 and (err[beyond] < 1e-4).all(), \
        f"rays {beyond.tolist()} differ by {err[beyond].tolist()}"
    keep = np.setdiff1d(np.arange(B), beyond)
    np.testing.assert_allclose(opa[keep], jopa[keep], rtol=0, atol=1e-5)
    np.testing.assert_allclose(col[keep], jcol[keep], rtol=0, atol=1e-5)
    assert jopa.max() > 0.5 and jopa.reshape(16, 16)[0, 0] < 0.1
    if not gt:
        rounds, evaluations = _count_learned_frame(peng, pstate, o, d, draws, monkeypatch)
        assert rounds > 1 and 0 < evaluations < B * rounds


# -- (g) snapshots


def test_snapshots_cross_packages(fitted, tmp_path):
    """The JAX engine's file loaded by the port and saved again is the same
    bytes; the port's file loaded by the JAX engine holds the port's
    parameters and EMA exactly and its step; each load starts fresh
    moments at the file's step."""
    jeng, jstate, peng, pstate = fitted
    jfile, pfile = str(tmp_path / "jax.msgpack"), str(tmp_path / "port.msgpack")
    jeng.save_snapshot(jfile, jstate)
    loaded = peng.load_snapshot(jfile)
    assert loaded.step == 20 and loaded.opt_state["grid"].count == 0
    peng.save_snapshot(pfile, loaded)
    assert open(pfile, "rb").read() == open(jfile, "rb").read()
    peng.save_snapshot(str(tmp_path / "port.ingp"), pstate)
    back = jeng.load_snapshot(str(tmp_path / "port.ingp"))
    assert int(back.step) == 20
    for tree, model in ((back.params, pstate.model), (back.ema.params, pstate.ema)):
        want = export_jax_params(model)
        np.testing.assert_array_equal(np.asarray(tree["encoding"]["table"]),
                                      want["encoding"]["table"])
        for g, w in zip(tree["network"]["weights"], want["network"]["weights"]):
            np.testing.assert_array_equal(np.asarray(g), w)
    from ngp_tpu_torch.utils.snapshot import load_snapshot

    doc = load_snapshot(str(tmp_path / "port.ingp"))
    assert doc["mode"] == "volume"
    assert doc["snapshot"]["global_majorant"] == peng.volume.global_majorant


# -- (h) Testbed, the CLI and the port's own stream


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("volume")
    (root / "net.json").write_text(json.dumps(RENDER_CONFIG))
    path = str(root / "cloud.nvdb")
    pcodec.write_nanovdb(path, np.asarray(jax_cloud(res=32).density))
    return {"nvdb": path, "network": str(root / "net.json"), "root": root}


def test_fill_share_matches_jax(engines):
    """The port's hash stream fills the 4 slots of 4,096 episodes as often
    as the JAX engine's stream does: shares within 0.05."""
    jeng, peng = engines
    E = 4096
    _, _, valid = peng.generate_training_data(0, E)
    _, _, jvalid = jeng.generate_training_data(jax.random.PRNGKey(0), E)
    share, jshare = float(valid.float().mean()), float(np.asarray(jvalid).mean())
    assert abs(share - jshare) < 0.05, (share, jshare)


def test_testbed_volume_mode(files, tmp_path):
    """``Testbed`` on an ``.nvdb`` in volume mode: the default config is the
    JAX package's volume config; it trains (8 steps, finite losses),
    renders the JAX Testbed's default camera and a ground-truth frame (the
    cloud at the centre, the corner clear), round-trips a snapshot to the same frame, and the JAX
    Testbed loads the port's snapshot to the same parameters."""
    from ngp_tpu.testbed import _DEFAULT_CONFIGS as JAX_CONFIGS
    from ngp_tpu.testbed import Testbed as JaxTestbed
    from ngp_tpu_torch.testbed import Testbed, default_config

    assert default_config("volume") == JAX_CONFIGS["volume"]
    tb = Testbed(scene=files["nvdb"], config=files["network"], device="cpu", batch_size=BATCH,
                 seed=SEED)
    assert tb.mode == "volume" and tb.training_step == 0
    tb.train(8)
    assert tb.training_step == 8 and np.isfinite(tb.loss)
    img = tb.render(24, 16)
    assert img.shape == (16, 24, 3) and img.dtype == np.float32 and np.isfinite(img).all()
    snap = str(tmp_path / "volume.ingp")
    tb.save_snapshot(snap)
    tb.train(1)
    tb.load_snapshot(snap)
    assert tb.training_step == 8
    np.testing.assert_array_equal(tb.render(24, 16), img)
    jtb = JaxTestbed(scene=files["nvdb"], config=files["network"], batch_size=BATCH)
    jtb.load_snapshot(snap)
    np.testing.assert_array_equal(np.asarray(jtb.state.params["encoding"]["table"]),
                                  tb.state.model.encoding.table.detach().numpy())
    _, opa = tb.engine.render_image(tb.state, (0.5, 0.5, 2.2), (0.5, 0.5, 0.5), (16, 16),
                                    gt=True)
    assert float(opa[8, 8]) > 0.5 and float(opa[0, 0]) < 0.1


def test_cli_volume_mode(files, capsys):
    """``python -m ngp_tpu_torch.run CLOUD.nvdb --device cpu`` prints the
    JAX CLI's lines for a volume (``trained ...``, no score line, ``saved
    snapshot ...``, ``wrote ...``) and last its kernel launches (none on
    the CPU); reloaded with no steps it writes the same screenshot."""
    from ngp_tpu_torch import run
    from ngp_tpu_torch.data.png import read_png

    root = files["root"]
    snap, shot, again = (str(root / n) for n in ("cli.ingp", "cli.png", "again.png"))
    common = [files["nvdb"], "--network", files["network"], "--device", "cpu",
              "--batch_size", str(BATCH), "--screenshot_w", "20", "--screenshot_h", "12"]
    run.main(common + ["--n_steps", "3", "--save_snapshot", snap, "--screenshot", shot])
    lines = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"trained 3 steps in \S+s \(\S+ steps/s\), loss=\d+\.\d{6}", lines[0])
    assert lines[1:3] == [f"saved snapshot to {snap}", f"wrote {shot}"]
    launches = json.loads(lines[3].split(":", 1)[1])
    assert "volume_train_walk" in launches and not any(launches.values())
    run.main(common + ["--n_steps", "0", "--load_snapshot", snap, "--screenshot", again])
    lines = capsys.readouterr().out.splitlines()
    assert lines[:2] == ["loaded snapshot at step 3", f"wrote {again}"]
    np.testing.assert_array_equal(read_png(again), read_png(shot))
    assert read_png(shot).shape == (12, 20, 3)


def test_volume_refuses_the_card_without_one(files):
    """Without a card the entry points raise rather than fall back to the
    CPU, and the kernels take no explicit draws."""
    from ngp_tpu_torch import run
    from ngp_tpu_torch.testbed import Testbed

    walk = vw.WalkVolume.of(procedural_cloud(32, device="cpu"), 0.01, "cpu")
    off_cpu = walk._replace(density=torch.zeros((1, 1, 1), device="meta"))
    for kw in ({"draws": object()}, {"start": object()}):
        with pytest.raises(ValueError, match="explicit draws"):
            vw.volume_train_walk(off_cpu, 0, 1, 0.95, 0.0, ((0, 1, 0),) * 3, **kw)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for call in (lambda: VolumeEngine(CONFIG, procedural_cloud(32, device="cpu")),
                 lambda: procedural_cloud(32),
                 lambda: Testbed(scene=files["nvdb"], config=files["network"]),
                 lambda: run.main([files["nvdb"], "--n_steps", "0"])):
        with pytest.raises(RuntimeError, match="device 'cuda' requested"):
            call()


def test_train_log_every_prints_the_jax_lines(engines, capsys):
    """``VolumeEngine.train(log_every=)`` prints the JAX engine's lines,
    ``volume step {step}: loss={loss:.5f}``, at the same steps (each
    package its own loss: the draws differ), and nothing when 0."""
    jeng, peng = engines
    line = re.compile(r"volume step (\d+): loss=(\d+\.\d{5})")
    jeng.train(jeng.init_state(), 3, log_every=2)
    jlines = capsys.readouterr().out.splitlines()
    pstate = peng.init_state()
    _, losses = peng.train(pstate, 3, log_every=2)
    plines = capsys.readouterr().out.splitlines()
    assert [line.fullmatch(s).group(1) for s in jlines] == ["0", "2"]
    assert [line.fullmatch(s).group(1) for s in plines] == ["0", "2"]
    assert plines == [f"volume step {s}: loss={float(losses[s]):.5f}" for s in (0, 2)]
    peng.train(pstate, 2)
    assert capsys.readouterr().out == ""

"""The port's SDF primitive (``ngp_tpu_torch/ops/shading.py``,
``engines/sdf.py``, ``Testbed`` and ``run`` in sdf mode) against the JAX
package on the CPU.

Sizes are small: the two cubes of ``tests/test_sdf.py`` (24 triangles) and
a bumpy icosphere of 3 subdivisions (1,280 triangles); a 4-level grid
(level 0 dense, 1-3 hashed into 2^12 rows) with the sdf config's 64-wide
MLP; 2^12 samples a step. The port's random draws are its own, so the
JAX package's draws (uniforms, batches, permutations) are fed to the port
where a comparison needs the same data. Tolerances are stated in each
test.
"""

import copy
import json
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ngp_tpu.engines.sdf import SdfEngine as JaxSdfEngine
from ngp_tpu.geometry.mesh import Mesh as JaxMesh
from ngp_tpu.ops import shading as jshading
from ngp_tpu_torch.engines import sdf as psdf
from ngp_tpu_torch.geometry.mesh import Mesh
from ngp_tpu_torch.interop import export_jax_params, load_jax_params
from ngp_tpu_torch.ops import shading as pshading
from ngp_tpu_torch.train import TrainState

# One intra-op thread: with two, torch's CPU sqrt (MKL's vsSqrt, split across
# the intra-op threads) now and then returned one thread's chunk ~3e-4 off
# on an AVX-512 Xeon (torch 2.13, MKL 2024.2), never with one
# (scripts/torch_sqrt_threads.py counts it).
# Every port test module sets the same count, so that a pytest worker's
# count does not depend on which module it imported last.
torch.set_num_threads(1)

BATCH = 1 << 12
# configs/sdf/base.json's loss and optimizer, its decay starting at step 8
# so that 20 steps cross it, at a learning rate of 1e-3; a narrow grid
CONFIG = {
    "loss": {"otype": "MAPE"},
    "optimizer": {"otype": "Ema", "decay": 0.95, "nested": {
        "otype": "ExponentialDecay", "decay_start": 8, "decay_interval": 4,
        "decay_base": 0.33, "nested": {"otype": "Adam", "learning_rate": 1e-3, "beta1": 0.9,
                                       "beta2": 0.99, "epsilon": 1e-15, "l2_reg": 1e-6}}},
    "encoding": {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
                 "log2_hashmap_size": 12, "base_resolution": 16},
    "network": {"otype": "FullyFusedMLP", "activation": "ReLU", "output_activation": "None",
                "n_neurons": 64, "n_hidden_layers": 2},
}
# a field smooth enough to render: 100 JAX steps at 1e-2, no decay
RENDER_CONFIG = copy.deepcopy(CONFIG)
RENDER_CONFIG["optimizer"]["nested"] = {**CONFIG["optimizer"]["nested"]["nested"],
                                        "learning_rate": 1e-2}
EYE, LOOKAT = (0.5, 1.3, -0.6), (0.5, 0.45, 0.5)  # tests/test_sdf.py's view
SEED = 3


def _cube_triangles(center, half):
    c = np.asarray(center, np.float32)
    v = np.array([[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
                  [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]], np.float32) * float(half) + c
    faces = [(0, 2, 1), (0, 3, 2), (4, 5, 6), (4, 6, 7), (0, 1, 5), (0, 5, 4),
             (3, 6, 2), (3, 7, 6), (0, 4, 7), (0, 7, 3), (1, 2, 6), (1, 6, 5)]
    return v[np.asarray(faces)]


def _mesh_fields():
    """``tests/test_sdf.py``'s two cubes, the second along the sun."""
    return dict(
        triangles=np.concatenate([_cube_triangles([0.45, 0.35, 0.5], 0.2),
                                  _cube_triangles([0.72, 0.72, 0.77], 0.08)]),
        mesh_scale=1.0, raw_aabb_min=np.zeros(3, np.float32),
        raw_aabb_max=np.ones(3, np.float32), aabb_min=np.full(3, 0.02, np.float32),
        aabb_max=np.full(3, 0.98, np.float32))


def _engines(config):
    jeng = JaxSdfEngine(config, JaxMesh(**_mesh_fields()), batch_size=BATCH, seed=SEED)
    peng = psdf.SdfEngine(config, Mesh(**_mesh_fields()), batch_size=BATCH, seed=SEED,
                          device="cpu")
    return jeng, peng


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_state(peng, jeng, jstate) -> TrainState:
    """The JAX state's parameters and EMA in a port ``TrainState``."""
    net = load_jax_params(peng._new_network(), _np(jstate.params))
    state = TrainState.create(net, int(jstate.step))
    state.ema = load_jax_params(copy.deepcopy(net), _np(jstate.ema.params)).requires_grad_(False)
    return state


def _jax_uniforms(key, n, uniform_only=False):
    """The three draws of the JAX engine's ``generate_training_samples``
    (``ngp_tpu/engines/sdf.py:138-156``), as torch tensors."""
    n_exact, n_offset, n_uniform = psdf.SdfEngine.sample_counts(n, uniform_only)
    k1, k2, k3 = jax.random.split(key, 3)
    draws = (jax.random.uniform(k1, (n_exact + n_offset, 3)),
             jax.random.uniform(k2, (n_offset, 3), minval=1e-6, maxval=1 - 1e-6),
             jax.random.uniform(k3, (n_uniform, 3)))
    return tuple(torch.from_numpy(np.array(d)) for d in draws)


# -- shading


@pytest.mark.parametrize("brdf", [{}, {"metallic": 0.3, "subsurface": 0.4, "roughness": 0.7,
                                       "sheen": 0.5, "clearcoat": 0.6,
                                       "clearcoat_gloss": 0.2}])
def test_shading_matches_jax(brdf):
    """``evaluate_shading`` (front and back faces) and
    ``soft_shadow_visibility_update`` within 1e-6 of the JAX package's
    (float32 transcendental functions in two libraries; measured 2.4e-7)."""
    rng = np.random.default_rng(0)

    def unit(x):
        return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)

    N, V = unit(rng.normal(size=(4096, 3))), unit(rng.normal(size=(4096, 3)))
    L = unit(rng.normal(size=3))
    base, amb = rng.uniform(0, 1, (2, 4096, 3)).astype(np.float32)
    sun = rng.uniform(0, 4, (4096, 3)).astype(np.float32)
    args = (base, amb, sun, L, V, N)
    want = np.asarray(jshading.evaluate_shading(*map(jnp.asarray, args),
                                                jshading.BRDFParams(**brdf)))
    got = pshading.evaluate_shading(*map(torch.from_numpy, args), pshading.BRDFParams(**brdf))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    mv, pd, td = rng.uniform(0, 1, 4096), rng.uniform(0, 0.1, 4096), rng.uniform(0, 1, 4096)
    d = rng.uniform(-0.01, 0.1, 4096)
    vals = [x.astype(np.float32) for x in (mv, pd, td, d)]
    want = jshading.soft_shadow_visibility_update(*map(jnp.asarray, vals), 2048.0)
    got = pshading.soft_shadow_visibility_update(*map(torch.from_numpy, vals), 2048.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


# -- training data


def test_training_samples_match_jax():
    """From the JAX draws: positions within 2.4e-7 (two roundings: the
    surface points' ``sqrt`` and the logistic offsets' ``log`` round in two
    libraries; the uniform points exactly), distances within 2e-6 (the BVH bound of
    ``test_torch_sdf_geometry.py``), the surface points' distances 0; the
    port's own draws have the JAX shapes and ranges and give the same
    recipe."""
    jeng, peng = _engines(CONFIG)
    key = jax.random.PRNGKey(5)
    jpos, jdist = map(np.asarray, jeng.generate_training_samples(key, BATCH))
    pos, dist = peng.generate_training_samples(BATCH, uniforms=_jax_uniforms(key, BATCH))
    n_exact, n_offset, n_uniform = peng.sample_counts(BATCH)
    assert (n_exact, n_offset, n_uniform) == (2048, 1536, 512)
    np.testing.assert_array_equal(pos[n_exact + n_offset:].numpy(), jpos[n_exact + n_offset:])
    np.testing.assert_allclose(pos.numpy(), jpos, rtol=0, atol=2.4e-7)
    np.testing.assert_allclose(dist.numpy(), jdist, rtol=0, atol=2e-6)
    assert not dist[:n_exact].any()
    u, uu, ub = peng.draw_uniforms(BATCH, torch.Generator().manual_seed(1))
    assert u.shape == (n_exact + n_offset, 3) and uu.shape == (n_offset, 3)
    assert ub.shape == (n_uniform, 3) and 1e-6 <= float(uu.min()) and float(uu.max()) <= 1 - 1e-6
    pos, dist = peng.training_batch(0)
    assert pos.shape == (BATCH, 3) and dist.shape == (BATCH,)
    assert torch.equal(pos, peng.training_batch(0)[0])  # seeded by (seed, step)
    assert not torch.equal(pos, peng.training_batch(16)[0])
    assert np.abs(dist[n_exact:n_exact + n_offset].numpy()).mean() < 0.01
    assert sorted(peng.step_permutation(3, BATCH).tolist()) == list(range(BATCH))
    pos, _ = peng.generate_training_samples(64, torch.Generator().manual_seed(2),
                                            uniform_only=True)
    lo, hi = peng.aabb_min, peng.aabb_max
    assert pos.shape == (64, 3) and bool(((pos >= lo) & (pos <= hi)).all())


# -- the trainer


def test_step_gradients_match_jax():
    """One loss and its gradients on the same batch and parameters: the
    loss within 1e-4 relative, MLP weight gradients within 2e-2 of each
    matrix's largest entry and the table gradient within 2^-6 of each
    level's largest (the bounds of ``test_torch_image.py``: bf16 roundings
    passed in bf16, bf16 addends)."""
    jeng, peng = _engines(CONFIG)
    params = jeng.init_state().params
    pnet = load_jax_params(peng._new_network(), _np(params))
    pos, dist = map(np.array, jeng.generate_training_samples(jax.random.PRNGKey(6), BATCH))
    jloss, jgrad = jax.jit(jax.value_and_grad(jeng.trainer.loss))(
        params, jnp.asarray(pos), jnp.asarray(dist)[:, None])
    ploss = peng.trainer.loss(pnet, torch.from_numpy(pos), torch.from_numpy(dist)[:, None])
    ploss.backward()
    np.testing.assert_allclose(float(ploss.detach()), float(jloss), rtol=1e-4)
    for w, jw in zip(pnet.network.weights, jgrad["network"]["weights"]):
        jw = np.asarray(jw)
        np.testing.assert_allclose(w.grad.numpy(), jw, rtol=0, atol=2e-2 * np.abs(jw).max())
    for level, (got, want) in enumerate(zip(pnet.encoding.table.grad.numpy(),
                                            np.asarray(jgrad["encoding"]["table"]))):
        np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -6 * np.abs(want).max(),
                                   err_msg=f"level {level}")


@pytest.fixture(scope="module")
def trained():
    """Both engines from the JAX package's initial parameters, 20 steps
    each; the port fed the JAX engine's batches (a refresh at steps 0 and
    16) and permutations."""
    jeng, peng = _engines(CONFIG)
    jstate = jeng.init_state()
    pstate = TrainState.create(load_jax_params(peng._new_network(), _np(jstate.params)))
    key = jax.random.PRNGKey(SEED ^ 0xD15)
    refreshed = []

    def batch(step):
        refreshed.append(step)
        pos, dist = jeng.generate_training_samples(
            jax.random.fold_in(key, 10_000_000 + step), BATCH)
        return torch.from_numpy(np.asarray(pos)), torch.from_numpy(np.asarray(dist))

    def permutation(step, n):
        perm = jax.random.permutation(jax.random.fold_in(key, step), n)
        return torch.from_numpy(np.asarray(perm).astype(np.int64))

    peng.training_batch, peng.step_permutation = batch, permutation
    jstate, jloss = jeng.train(jstate, 20)
    pstate, plosses = peng.train(pstate, 20)
    assert refreshed == [0, 16]
    return jeng, jstate, float(jloss), peng, pstate, plosses


def test_fit_matches_jax(trained):
    """After 20 steps: the last loss within 1e-3 relative (measured
    1.1e-4); the served (EMA) MLP weights within 5e-3 (measured 1.8e-3);
    the served table within 3e-2 (measured 1.2e-2). The MAPE gradient
    carries the sign of each residual, and the surface samples' target is
    0, where a residual's sign turns on the last bf16 rounding: the two
    packages' flips differ, and Adam makes a table entry's small gradient
    a step of the learning rate. The meters read the last loss."""
    jeng, jstate, jloss, peng, pstate, plosses = trained
    assert pstate.step == int(jstate.step) == 20
    assert plosses.shape == (20,) and plosses.dtype == torch.float32
    np.testing.assert_allclose(float(plosses[-1]), jloss, rtol=1e-3)
    assert float(plosses[-1]) < float(plosses[0])
    assert peng.meters.loss_ema == float(plosses[-1])
    want = _np(jeng.trainer.inference_params(jstate))
    got = export_jax_params(pstate.inference_model())
    for g, w in zip(got["network"]["weights"], want["network"]["weights"]):
        np.testing.assert_allclose(g, w, rtol=0, atol=5e-3)
    np.testing.assert_allclose(got["encoding"]["table"], want["encoding"]["table"],
                               rtol=0, atol=3e-2)


def test_calculate_iou_matches_jax(trained):
    """The IoU of the same parameters over the JAX engine's own samples
    (``PRNGKey(99)``) equals the JAX engine's (measured equal: a sign flip
    of a prediction within a rounding of 0 would move it by 1/union); the
    port's own draws give an IoU within 0.05."""
    jeng, jstate, _, peng, _, _ = trained
    state = _port_state(peng, jeng, jstate)
    n = 1 << 14
    want = jeng.calculate_iou(jstate, n)
    got = peng.calculate_iou(state, n, uniforms=_jax_uniforms(jax.random.PRNGKey(99), n, True))
    assert abs(got - want) <= 2.0 / (n * 0.1), (got, want)
    assert abs(peng.calculate_iou(state, n) - want) < 0.05


# -- rendering


@pytest.fixture(scope="module")
def fitted():
    """The JAX engine fitted 100 steps at RENDER_CONFIG, its state in the
    port."""
    jeng, peng = _engines(RENDER_CONFIG)
    jstate, _ = jeng.train(jeng.init_state(), 100)
    return jeng, jstate, peng, _port_state(peng, jeng, jstate)


def _render(jeng, jstate, peng, pstate, gt, mode, shadow=False):
    jrgb, jhit = jeng.render_image(jstate, EYE, LOOKAT, (48, 48), gt_bvh=gt, mode=mode,
                                   shadow=shadow)
    prgb, phit = peng.render_image(pstate, EYE, LOOKAT, (48, 48), gt_bvh=gt, mode=mode,
                                   shadow=shadow)
    return jrgb, jhit, prgb.numpy(), phit.numpy()


MODES = [("headlight", False), ("shade", False), ("shade", True), ("ao", False),
         ("normals", False), ("positions", False), ("cost", False)]


@pytest.mark.parametrize("mode,shadow", MODES)
def test_ground_truth_render_matches_jax(fitted, mode, shadow):
    """A 48×48 frame of the BVH's own distances (``gt_bvh``): the same hit
    mask, steps and colours within 1e-4 (measured 4.4e-5: the traced
    positions differ by roundings of the distances, the shade's specular
    lobe amplifies them)."""
    jeng, jstate, peng, pstate = fitted
    jrgb, jhit, prgb, phit = _render(jeng, jstate, peng, pstate, True, mode, shadow)
    assert jhit.any() and not jhit.all()
    np.testing.assert_array_equal(phit, jhit)
    np.testing.assert_allclose(prgb, jrgb, rtol=0, atol=1e-4)
    assert np.isfinite(prgb).all() and not prgb[~phit].any()


@pytest.mark.parametrize("mode,shadow", MODES)
def test_model_render_matches_jax(fitted, mode, shadow):
    """A 48×48 frame of the fitted model: the hit masks equal on all but 1%
    of the pixels (measured 0.2%, rays grazing a surface where the model's
    distance straddles the 1e-4 convergence test). Over the pixels both
    hit: the step counts equal on at least 90% (measured 95%: a distance
    within a bf16 rounding of the test converges an iteration apart); on
    those, positions within 1e-4 and every mode's colour within 1e-3 on at
    least 95% (measured 96%; a normal turns where a hidden unit near 0
    switches on one package's rounding and not the other's)."""
    jeng, jstate, peng, pstate = fitted
    jcost, jhit, pcost, phit = _render(jeng, jstate, peng, pstate, False, "cost")
    assert (jhit != phit).mean() <= 0.01 and jhit.mean() > 0.1
    both = jhit & phit
    same = both & (np.rint(jcost[..., 0] * 30) == np.rint(pcost[..., 0] * 30))
    assert same.sum() >= 0.9 * both.sum(), (same.sum(), both.sum())
    jrgb, _, prgb, _ = _render(jeng, jstate, peng, pstate, False, mode, shadow)
    diff = np.abs(prgb - jrgb).max(-1)[same]
    if mode == "positions":
        assert diff.max() <= 1e-4 / 2.0
    assert (diff <= 1e-3).mean() >= 0.95, (diff <= 1e-3).mean()
    assert np.isfinite(prgb).all() and not prgb[~phit].any()


def test_model_normals_match_jax(fitted):
    """The model's normals at the same positions (the JAX engine's
    ``jax.grad`` of the network through the differentiable grid) within
    1e-4 (measured 7.1e-5 on 6 of 9,000 components, 1.2e-6 on the rest: a
    bf16 rounding of an activation that flips changes that unit's share of
    the gradient); the render freezes the served model's
    parameters, so no table gradient is left on it."""
    jeng, jstate, peng, pstate = fitted
    pos = np.random.default_rng(9).uniform(0.1, 0.9, (3000, 3)).astype(np.float32)
    params = jeng.trainer.inference_params(jstate)
    model = jeng.model
    grad = jax.grad(lambda p: jnp.sum(model.network(
        params["network"], model.encoding(params["encoding"], p, differentiable_inputs=True)
    )[:, 0]))(jnp.asarray(pos))
    want = np.asarray(grad) / np.maximum(np.linalg.norm(np.asarray(grad), axis=-1,
                                                        keepdims=True), 1e-9)
    served = pstate.inference_model()
    got = peng._normals(served, torch.from_numpy(pos), gt_bvh=False)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    assert all(p.grad is None for p in served.parameters())


def test_render_refuses_an_unknown_mode(fitted):
    _, _, peng, pstate = fitted
    with pytest.raises(ValueError, match="unknown SDF render mode 'depth'"):
        peng.render_image(pstate, EYE, LOOKAT, (8, 8), mode="depth")


# -- mesh export and snapshots


def test_marching_cubes_mesh_matches_jax(fitted):
    """The learned surface at 32³: vertices within 1e-4 of the JAX
    package's where the face counts agree (the lattice's values differ by
    bf16 flips, which move a crossing by a fraction of a cell only where
    the field is near 0 at a lattice point)."""
    jeng, jstate, peng, pstate = fitted
    jv, jf = jeng.compute_marching_cubes_mesh(jstate, 32)
    pv, pf = peng.compute_marching_cubes_mesh(pstate, 32)
    assert len(pf) > 100 and abs(len(pf) - len(jf)) <= 0.01 * len(jf)
    lo, hi = peng.mesh.aabb_min, peng.mesh.aabb_max
    assert ((pv >= lo - 1e-6) & (pv <= hi + 1e-6)).all()
    if len(pf) == len(jf) and len(pv) == len(jv):
        np.testing.assert_allclose(pv, jv, rtol=0, atol=1e-4)


def test_snapshots_cross_packages(trained, tmp_path):
    """The JAX engine's file loaded by the port and saved again is the
    same bytes; the port's file loaded by the JAX engine holds the port's
    parameters and EMA exactly, its step and mesh scale; each load starts
    fresh moments at the file's step."""
    jeng, jstate, _, peng, pstate, _ = trained
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
    assert doc["mode"] == "sdf" and doc["snapshot"]["mesh_scale"] == 1.0


# -- Testbed and the CLI


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The bumpy icosphere of 3 subdivisions as an OBJ, the network
    config file (``CONFIG`` at a learning rate of 1e-2)."""
    from ngp_tpu_torch.data.synthetic import write_bumpy_sphere_mesh

    root = tmp_path_factory.mktemp("sdf")
    (root / "net.json").write_text(json.dumps(RENDER_CONFIG))
    return {"obj": write_bumpy_sphere_mesh(str(root / "bumpy.obj"), 3),
            "network": str(root / "net.json"), "root": root}


def test_testbed_sdf_mode(files, tmp_path):
    """``Testbed`` on an ``.obj`` in sdf mode: the default config is the
    JAX package's sdf config; it trains (60 steps raise the IoU by 0.1 and
    above 0.6), renders the headlight frame of the JAX Testbed's camera (a
    fifth of it on the surface, the corner off it), exports a mesh inside
    the box, round-trips a snapshot (same IoU) that the JAX engine loads
    to the same parameters, and trains on overridden data."""
    from ngp_tpu.testbed import _DEFAULT_CONFIGS as JAX_CONFIGS
    from ngp_tpu.testbed import Testbed as JaxTestbed
    from ngp_tpu_torch.testbed import Testbed, default_config

    assert default_config("sdf") == JAX_CONFIGS["sdf"]
    tb = Testbed(scene=files["obj"], config=files["network"], device="cpu",
                 batch_size=BATCH)
    assert tb.mode == "sdf" and tb.training_step == 0
    untrained = tb.calculate_iou(1 << 13)
    tb.train(60)
    assert tb.training_step == 60 and np.isfinite(tb.loss)
    iou = tb.calculate_iou(1 << 13)
    assert iou > max(0.6, untrained + 0.1), (iou, untrained)
    img = tb.render(24, 16)
    assert img.shape == (16, 24, 3) and img.dtype == np.float32 and np.isfinite(img).all()
    assert (img.sum(-1) > 0).mean() > 0.2 and not img[0, 0].any()
    verts, faces = tb.compute_marching_cubes_mesh(24)
    assert len(faces) > 100 and (verts >= 0).all() and (verts <= 1).all()
    snap = str(tmp_path / "sdf.ingp")
    tb.save_snapshot(snap)
    tb.train(5)
    tb.load_snapshot(snap)
    assert tb.training_step == 60 and tb.calculate_iou(1 << 13) == iou
    jtb = JaxTestbed(scene=files["obj"], config=files["network"], batch_size=BATCH)
    jtb.load_snapshot(snap)
    np.testing.assert_array_equal(np.asarray(jtb.state.params["encoding"]["table"]),
                                  tb.state.model.encoding.table.detach().numpy())
    pts = np.random.default_rng(4).uniform(0, 1, (BATCH, 3)).astype(np.float32)
    tb.override_sdf_training_data(pts, np.full(BATCH, 0.5, np.float32))
    tb.train(3)
    assert tb.training_step == 63
    with pytest.raises(ValueError, match="psnr needs nerf mode"):
        tb.psnr()


def test_cli_sdf_mode(files, capsys):
    """``python -m ngp_tpu_torch.run MESH.obj --device cpu`` prints the JAX
    CLI's lines (``trained ...``, ``IoU: ...``, ``saved snapshot ...``,
    ``wrote ...`` for the screenshot and the mesh) and last its kernel
    launches (none on the CPU); reloaded with no steps it prints the same
    IoU line. ``--render_mode`` takes the SDF modes (normals, then shade);
    the JAX CLI scores the port's snapshot within 0.05 of the port (its
    own samples)."""
    import importlib.util
    import os

    from ngp_tpu_torch import run
    from ngp_tpu_torch.data.png import read_png

    root = files["root"]
    snap, shot, mesh = (str(root / n) for n in ("cli.ingp", "cli.png", "cli_mesh.obj"))
    common = [files["obj"], "--network", files["network"], "--device", "cpu",
              "--batch_size", str(BATCH)]
    run.main(common + ["--n_steps", "40", "--save_snapshot", snap, "--screenshot", shot,
                       "--screenshot_w", "40", "--screenshot_h", "24", "--render_mode",
                       "normals", "--save_mesh", mesh, "--marching_cubes_res", "24"])
    lines = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"trained 40 steps in \S+s \(\S+ steps/s\), loss=\d+\.\d{6}", lines[0])
    assert re.fullmatch(r"IoU: \d\.\d{4}", lines[1])
    assert lines[2:4] == [f"saved snapshot to {snap}", f"wrote {shot}"]
    assert re.fullmatch(rf"wrote {re.escape(mesh)} \(\d+ verts, \d+ faces\)", lines[4])
    launches = json.loads(lines[5].split(":", 1)[1])
    assert "bvh_closest_point" in launches and not any(launches.values())
    assert read_png(shot).shape == (24, 40, 3)
    shaded = str(root / "shade.png")
    run.main(common + ["--n_steps", "0", "--load_snapshot", snap, "--screenshot", shaded,
                       "--screenshot_w", "16", "--screenshot_h", "16", "--render_mode",
                       "shade"])
    again = capsys.readouterr().out.splitlines()
    assert again[:3] == ["loaded snapshot at step 40", lines[1], f"wrote {shaded}"]
    assert read_png(shaded).shape == (16, 16, 3)
    with pytest.raises(ValueError, match="--metrics_file"):
        run.main(common + ["--n_steps", "0", "--metrics_file", str(root / "m.jsonl")])
    capsys.readouterr()
    spec = importlib.util.spec_from_file_location(
        "jax_run_cli", os.path.join(os.path.dirname(os.path.dirname(__file__)),
                                    "scripts", "run.py"))
    jcli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jcli)
    jcli.main([files["obj"], "--network", files["network"], "--n_steps", "0",
               "--load_snapshot", snap, "--compile_cache", ""])
    jlines = capsys.readouterr().out.splitlines()
    assert jlines[0] == "loaded snapshot at step 40"
    assert abs(float(jlines[1].split()[1]) - float(lines[1].split()[1])) < 0.05


def test_sdf_refusals_and_the_card_default(files):
    """An octree deeper than 11 raises a ``ValueError`` that names the
    limit: with ``octree_depth`` 0 the depth is the encoding's
    ``n_levels``, 16 for a 16-level grid, where the JAX engine fails its
    assertion instead (ROADMAP C.ref 14, a case kept out of parity); an
    unknown sign mode raises; without a card the entry points raise rather
    than fall back to the CPU."""
    from ngp_tpu_torch import run
    from ngp_tpu_torch.testbed import Testbed

    mesh = Mesh(**_mesh_fields())
    deep = copy.deepcopy(CONFIG)
    deep["encoding"]["n_levels"] = 16
    with pytest.raises(ValueError, match=r"octree depth 16 is outside \[2, 11\]"):
        psdf.SdfEngine(deep, mesh, use_octree=True, device="cpu")
    with pytest.raises(AssertionError):
        JaxSdfEngine(deep, JaxMesh(**_mesh_fields()), use_octree=True)
    with pytest.raises(ValueError, match=r"octree depth 12 is outside \[2, 11\]"):
        psdf.SdfEngine(CONFIG, mesh, use_octree=True, octree_depth=12, device="cpu")
    with pytest.raises(ValueError, match="unknown sign_mode 'bogus'"):
        psdf.SdfEngine(CONFIG, mesh, sign_mode="bogus", device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for call in (lambda: psdf.SdfEngine(CONFIG, mesh),
                 lambda: Testbed(scene=files["obj"], config=files["network"]),
                 lambda: run.main([files["obj"], "--n_steps", "0"])):
        with pytest.raises(RuntimeError, match="device 'cuda' requested"):
            call()


@pytest.mark.parametrize("sign_mode", ["raystab", "winding"])
def test_sign_modes_give_the_watertight_samples_on_a_closed_mesh(sign_mode):
    """On the closed two-cube mesh the other sign modes' training samples
    equal the watertight mode's wherever |d| > 1e-6 (the JAX engine's
    ``sign_mode`` dispatch)."""
    mesh = Mesh(**_mesh_fields())
    uniforms = _jax_uniforms(jax.random.PRNGKey(8), 512)
    want = psdf.SdfEngine(CONFIG, mesh, batch_size=512, device="cpu"
                          ).generate_training_samples(512, uniforms=uniforms)[1]
    got = psdf.SdfEngine(CONFIG, mesh, batch_size=512, sign_mode=sign_mode, device="cpu"
                         ).generate_training_samples(512, uniforms=uniforms)[1]
    firm = want.abs() > 1e-6
    assert torch.equal(got.abs(), want.abs())
    assert torch.equal(torch.sign(got[firm]), torch.sign(want[firm]))


def test_train_log_every_prints_the_jax_lines(capsys):
    """``SdfEngine.train(log_every=)`` prints the JAX engine's lines, ``sdf
    step {step}: loss={loss:.6f}``, at the same steps, the port fed the
    JAX engine's batches and permutations (its loss within 1e-3 relative
    of JAX's, ``test_fit_matches_jax``'s bound; measured 8e-6 at step 3),
    and nothing when 0."""
    jeng, peng = _engines(CONFIG)
    jstate = jeng.init_state()
    pstate = TrainState.create(load_jax_params(peng._new_network(), _np(jstate.params)))
    key = jax.random.PRNGKey(SEED ^ 0xD15)
    peng.training_batch = lambda step: tuple(torch.from_numpy(np.array(a)) for a in
                                             jeng.generate_training_samples(
                                                 jax.random.fold_in(key, 10_000_000 + step),
                                                 BATCH))
    peng.step_permutation = lambda step, n: torch.from_numpy(np.asarray(
        jax.random.permutation(jax.random.fold_in(key, step), n)).astype(np.int64))
    line = re.compile(r"sdf step (\d+): loss=(\d+\.\d{6})")
    jeng.train(jstate, 4, log_every=3)
    jlines = capsys.readouterr().out.splitlines()
    _, losses = peng.train(pstate, 4, log_every=3)
    plines = capsys.readouterr().out.splitlines()
    jfound, pfound = ([line.fullmatch(s) for s in lines] for lines in (jlines, plines))
    assert [m.group(1) for m in jfound] == [m.group(1) for m in pfound] == ["0", "3"]
    assert plines == [f"sdf step {s}: loss={float(losses[s]):.6f}" for s in (0, 3)]
    for j, p in zip(jfound, pfound):
        np.testing.assert_allclose(float(p.group(2)), float(j.group(2)), rtol=1e-3)
    peng.train(pstate, 2)
    assert capsys.readouterr().out == ""

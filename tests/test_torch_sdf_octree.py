"""The port's SDF engine with the triangle octree (``use_octree``, the
Takikawa encoding) against the JAX engine on the CPU.

Mesh: the two cubes of ``tests/test_sdf.py`` (24 triangles). Configs: the
sdf test config's MLP, loss and optimizer with the Takikawa encoding of
``tests/test_octree_takikawa.py:237-243`` (5 levels, starting level 2, F =
2: an octree of depth 5, three output levels), and with its 4-level hash
grid over an octree of depth 6. The JAX engine builds its octree natively
or in numpy (the same arrays, ``tests/test_torch_octree.py``); the port
natively. The JAX draws (uniforms, leaf picks, batches, permutations) and
initial weights (through ``interop``) are fed to the port. Tolerances are
stated in each test.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ngp_tpu.engines.sdf import SdfEngine as JaxSdfEngine
from ngp_tpu.geometry.mesh import Mesh as JaxMesh
from ngp_tpu_torch.engines import sdf as psdf
from ngp_tpu_torch.geometry import triangle_bvh as pbvh
from ngp_tpu_torch.geometry.mesh import Mesh
from ngp_tpu_torch.interop import export_jax_params, load_jax_params
from ngp_tpu_torch.models.takikawa import TakikawaEncoding
from test_torch_sdf import BATCH, CONFIG, EYE, LOOKAT, _mesh_fields, _np, _port_state

# One intra-op thread, as in every port test module (test_torch_sdf.py).
torch.set_num_threads(1)

TAKIKAWA = {**copy.deepcopy(CONFIG),
            "encoding": {"otype": "Takikawa", "n_levels": 5, "starting_level": 2,
                         "n_features_per_level": 2}}
# a field smooth enough to render: 60 JAX steps at 1e-2, no decay
TAKIKAWA_RENDER = copy.deepcopy(TAKIKAWA)
TAKIKAWA_RENDER["optimizer"]["nested"] = {**CONFIG["optimizer"]["nested"]["nested"],
                                          "learning_rate": 1e-2}
KINDS = {"takikawa": (TAKIKAWA, {}), "hash_octree": (CONFIG, {"use_octree": True,
                                                              "octree_depth": 6})}
SEED = 3


def _engines(config, **kw):
    jeng = JaxSdfEngine(config, JaxMesh(**_mesh_fields()), batch_size=BATCH, seed=SEED, **kw)
    peng = psdf.SdfEngine(config, Mesh(**_mesh_fields()), batch_size=BATCH, seed=SEED,
                          device="cpu", **kw)
    return jeng, peng


def _jax_uniforms(jeng, key, n, uniform_only=False):
    """The draws of the JAX engine's ``generate_training_samples`` with an
    octree (``ngp_tpu/engines/sdf.py:136-160``): surface and offset
    uniforms, and the leaf picks and offsets that ``sample_uniform`` splits
    its key into (``ngp_tpu/geometry/triangle_octree.py:284-288``)."""
    n_exact, n_offset, n_uniform = psdf.SdfEngine.sample_counts(n, uniform_only)
    k1, k2, k3 = jax.random.split(key, 3)
    ka, kb = jax.random.split(k3)
    leaves = len(jeng.octree.codes[jeng.octree.max_depth - 1])
    draws = (jax.random.uniform(k1, (n_exact + n_offset, 3)),
             jax.random.uniform(k2, (n_offset, 3), minval=1e-6, maxval=1 - 1e-6))
    surface, offset = (torch.from_numpy(np.array(d)) for d in draws)
    pick = torch.from_numpy(np.array(jax.random.randint(ka, (n_uniform,), 0, leaves),
                                     np.int64))
    u = torch.from_numpy(np.array(jax.random.uniform(kb, (n_uniform, 3))))
    return surface, offset, (pick, u)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_octree_engine_builds_the_jax_octree(kind):
    """The engine's octree (depth ``octree_depth``, else the encoding's
    ``n_levels``) equals the JAX engine's; ``use_octree`` is set; the
    BVH equals the numpy build's; the build seconds are recorded."""
    config, kw = KINDS[kind]
    jeng, peng = _engines(config, **kw)
    assert peng.use_octree and peng.octree.max_depth == jeng.octree.max_depth
    assert peng.octree.max_depth == (6 if kind == "hash_octree" else 5)
    for d in range(peng.octree.max_depth):
        np.testing.assert_array_equal(peng.octree.codes[d].numpy(), jeng.octree.codes[d])
        np.testing.assert_array_equal(peng.octree.verts[d].numpy(), jeng.octree.verts[d])
    np.testing.assert_array_equal(peng.octree.distance_field.numpy(),
                                  jeng.octree.distance_field)
    assert peng.octree_build_s > 0 and peng.bvh_build_s > 0
    records, root = pbvh.pack_bvh_records(pbvh.build_bvh_arrays(peng.mesh.triangles))
    np.testing.assert_array_equal(peng.bvh.records.numpy(), records)
    assert peng.bvh.root == root
    if kind == "takikawa":
        assert isinstance(peng.init_state().model.encoding, TakikawaEncoding)
    plain = psdf.SdfEngine(CONFIG, Mesh(**_mesh_fields()), device="cpu")
    assert plain.octree is None and not plain.use_octree and plain.octree_build_s == 0.0


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_training_samples_match_jax(kind):
    """From the JAX draws: the uniform share (in octree leaves) exactly,
    every position within 2.4e-7 and the distances within 2e-6 (the bounds
    of ``test_torch_sdf.py``); the port's own draws land in leaves."""
    config, kw = KINDS[kind]
    jeng, peng = _engines(config, **kw)
    key = jax.random.PRNGKey(5)
    jpos, jdist = map(np.asarray, jeng.generate_training_samples(key, BATCH))
    pos, dist = peng.generate_training_samples(BATCH, uniforms=_jax_uniforms(jeng, key, BATCH))
    n_exact, n_offset, _ = peng.sample_counts(BATCH)
    np.testing.assert_array_equal(pos[n_exact + n_offset:].numpy(), jpos[n_exact + n_offset:])
    np.testing.assert_allclose(pos.numpy(), jpos, rtol=0, atol=2.4e-7)
    np.testing.assert_allclose(dist.numpy(), jdist, rtol=0, atol=2e-6)
    surface, offset, (pick, u) = peng.draw_uniforms(BATCH, torch.Generator().manual_seed(1))
    assert pick.shape == (BATCH - n_exact - n_offset,) and u.shape == (len(pick), 3)
    pos, _ = peng.training_batch(0)
    assert bool(peng.octree.contains(pos[n_exact + n_offset:]).all())


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_step_gradients_match_jax(kind):
    """One loss and its gradients on the JAX engine's batch from its
    initial parameters: the loss within 1e-5 relative (measured 2.1e-7 at
    three batches), MLP weight gradients within 2e-2 of each matrix's
    largest entry and the table gradient within 2^-6 of its largest (the
    bounds of ``test_torch_sdf.py``; measured at most 1.0e-3 and 4.0e-5
    with Takikawa, 2.9e-3 and 6.3e-3 with the hash grid: bf16 roundings
    passed in bf16, bf16 addends on both sides, the JAX sum a difference
    of prefix sums)."""
    config, kw = KINDS[kind]
    jeng, peng = _engines(config, **kw)
    params = jeng.init_state().params
    pnet = load_jax_params(peng._new_network(), _np(params))
    pos, dist = map(np.array, jeng.generate_training_samples(jax.random.PRNGKey(6), BATCH))
    jloss, jgrad = jax.jit(jax.value_and_grad(jeng.trainer.loss))(
        params, jnp.asarray(pos), jnp.asarray(dist)[:, None])
    ploss = peng.trainer.loss(pnet, torch.from_numpy(pos), torch.from_numpy(dist)[:, None])
    ploss.backward()
    np.testing.assert_allclose(float(ploss.detach()), float(jloss), rtol=1e-5)
    for w, jw in zip(pnet.network.weights, jgrad["network"]["weights"]):
        jw = np.asarray(jw)
        np.testing.assert_allclose(w.grad.numpy(), jw, rtol=0, atol=2e-2 * np.abs(jw).max())
    want = np.asarray(jgrad["encoding"]["table"])
    np.testing.assert_allclose(pnet.encoding.table.grad.numpy(), want, rtol=0,
                               atol=2.0 ** -6 * np.abs(want).max())


@pytest.fixture(scope="module")
def fitted():
    """The JAX Takikawa engine fitted 60 steps at TAKIKAWA_RENDER, its
    state in the port."""
    jeng, peng = _engines(TAKIKAWA_RENDER)
    jstate, _ = jeng.train(jeng.init_state(), 60)
    return jeng, jstate, peng, _port_state(peng, jeng, jstate)


def test_calculate_iou_matches_jax(fitted):
    """The IoU of the same parameters over the JAX engine's samples
    (``PRNGKey(99)``, in octree leaves, the model counted right outside
    them) within 2 flips of the JAX engine's; the port's own draws within
    0.05."""
    jeng, jstate, peng, pstate = fitted
    n = 1 << 14
    want = jeng.calculate_iou(jstate, n)
    got = peng.calculate_iou(pstate, n, uniforms=_jax_uniforms(
        jeng, jax.random.PRNGKey(99), n, True))
    assert abs(got - want) <= 2.0 / (n * 0.1), (got, want)
    assert abs(peng.calculate_iou(pstate, n) - want) < 0.05
    assert 0.0 < want < 1.0


def _render(jeng, jstate, peng, pstate, gt, mode):
    jrgb, jhit = jeng.render_image(jstate, EYE, LOOKAT, (48, 48), gt_bvh=gt, mode=mode)
    prgb, phit = peng.render_image(pstate, EYE, LOOKAT, (48, 48), gt_bvh=gt, mode=mode)
    return jrgb, jhit, prgb.numpy(), phit.numpy()


def test_traced_frames_with_the_skip_distance_match_jax(fitted, monkeypatch):
    """48×48 frames traced with the octree's skip distance: the BVH's
    frame with the same hit mask, step counts and positions within 1e-4;
    the model's with the hit masks equal on all but 1% of the pixels, and
    over the pixels both hit the step counts equal on at least 90% and
    there positions within 1e-4 (the bounds of ``test_torch_sdf.py``). The
    skip shortens the BVH frame's walks and hits the same pixels."""
    jeng, jstate, peng, pstate = fitted
    for gt in (True, False):
        jcost, jhit, pcost, phit = _render(jeng, jstate, peng, pstate, gt, "cost")
        jpos, _, ppos, _ = _render(jeng, jstate, peng, pstate, gt, "positions")
        assert jhit.any() and not jhit.all()
        if gt:
            np.testing.assert_array_equal(phit, jhit)
            np.testing.assert_array_equal(np.rint(pcost * 30), np.rint(jcost * 30))  # steps
            np.testing.assert_allclose(ppos, jpos, rtol=0, atol=1e-4)
            continue
        assert (jhit != phit).mean() <= 0.01
        both = jhit & phit
        same = both & (np.rint(jcost[..., 0] * 30) == np.rint(pcost[..., 0] * 30))
        assert same.sum() >= 0.9 * both.sum(), (same.sum(), both.sum())
        assert np.abs(ppos - jpos).max(-1)[same].max() <= 1e-4
    o, d = (torch.from_numpy(a) for a in peng.camera_rays(EYE, LOOKAT, (48, 48)))
    _, hit, steps = peng._trace(None, o, d, gt_bvh=True)
    monkeypatch.setattr(peng, "octree", None)
    _, plain_hit, plain_steps = peng._trace(None, o, d, gt_bvh=True)
    assert torch.equal(hit, plain_hit) and int(steps.sum()) < int(plain_steps.sum())


def test_takikawa_normals_are_the_models_gradient_where_the_jax_engine_gives_zero(fitted):
    """The port's Takikawa normals are the model's position gradient
    through ``differentiable_inputs`` (unit vectors, or 0 where the
    position is in no octree voxel of the output levels; equal to the JAX
    encoding's ``differentiable_inputs`` gradient within 1e-4). The JAX
    engine differentiates its Takikawa encoding through
    ``grid_gather_blend``, whose VJP gives the positions no gradient:
    its normals are 0 (ROADMAP C.ref 15), a case kept out of parity."""
    jeng, jstate, peng, pstate = fitted
    pos = np.random.default_rng(9).uniform(0.2, 0.8, (2000, 3)).astype(np.float32)
    params = jeng.trainer.inference_params(jstate)
    model = jeng.model
    grad = jax.grad(lambda p: jnp.sum(model.network(
        params["network"], model.encoding(params["encoding"], p, differentiable_inputs=True)
    )[:, 0]))(jnp.asarray(pos))
    want = np.asarray(grad) / np.maximum(np.linalg.norm(np.asarray(grad), axis=-1,
                                                        keepdims=True), 1e-9)
    served = pstate.inference_model()
    got = peng._normals(served, torch.from_numpy(pos), gt_bvh=False).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    norms = np.linalg.norm(got, axis=-1)  # 0 where no level's voxel is occupied
    assert np.allclose(norms[norms > 0], 1.0, atol=1e-5) and (norms > 0).mean() > 0.5
    _, jnormals = jeng._shade(params, jnp.asarray(pos), jnp.zeros_like(jnp.asarray(pos)),
                              jnp.ones(len(pos), bool), False)
    assert not np.asarray(jnormals).any()


def test_port_trains_with_its_own_draws():
    """20 steps of the Takikawa engine on its own draws: the loss falls,
    the table moves."""
    _, peng = _engines(TAKIKAWA_RENDER)
    state = peng.init_state()
    before = state.model.encoding.table.detach().clone()
    state, losses = peng.train(state, 20)
    assert state.step == 20 and float(losses[-1]) < float(losses[0])
    assert not torch.equal(before, state.model.encoding.table.detach())


def test_takikawa_snapshots_cross_packages(fitted, tmp_path):
    """A Takikawa snapshot written by the JAX engine loads in the port and
    is saved again as the same bytes; the port's loads in the JAX engine
    with the table, MLP and EMA exactly; both give the same IoU on the
    JAX samples."""
    jeng, jstate, peng, pstate = fitted
    jfile, pfile = str(tmp_path / "jax.msgpack"), str(tmp_path / "port.msgpack")
    jeng.save_snapshot(jfile, jstate)
    loaded = peng.load_snapshot(jfile)
    assert loaded.step == 60 and isinstance(loaded.model.encoding, TakikawaEncoding)
    peng.save_snapshot(pfile, loaded)
    assert open(pfile, "rb").read() == open(jfile, "rb").read()
    back = jeng.load_snapshot(pfile)
    for tree, model in ((back.params, loaded.model), (back.ema.params, loaded.ema)):
        want = export_jax_params(model)
        np.testing.assert_array_equal(np.asarray(tree["encoding"]["table"]),
                                      want["encoding"]["table"])
        for g, w in zip(tree["network"]["weights"], want["network"]["weights"]):
            np.testing.assert_array_equal(np.asarray(g), w)
    n = 1 << 12
    uniforms = _jax_uniforms(jeng, jax.random.PRNGKey(99), n, True)
    assert (peng.calculate_iou(loaded, n, uniforms=uniforms)
            == peng.calculate_iou(pstate, n, uniforms=uniforms))


def test_cli_trains_saves_and_reloads_a_takikawa_network(tmp_path, capsys):
    """``python -m ngp_tpu_torch.run`` on a bumpy icosphere (3
    subdivisions) with a written Takikawa ``--network`` file (the schema
    of ``tests/test_octree_takikawa.py:237-243``, 6 levels, at a learning
    rate of 1e-2): 40 steps, a snapshot, and a reload that prints the same
    ``IoU:`` line; the JAX CLI scores the port's snapshot within 0.05 of
    it (its own samples)."""
    import importlib.util
    import json
    import os
    import re

    from ngp_tpu_torch import run
    from ngp_tpu_torch.data.synthetic import write_bumpy_sphere_mesh

    obj = write_bumpy_sphere_mesh(str(tmp_path / "bumpy.obj"), 3)
    net = tmp_path / "takikawa.json"
    cfg = copy.deepcopy(TAKIKAWA_RENDER)
    cfg["encoding"]["n_levels"] = 6
    net.write_text(json.dumps(cfg))
    snap = str(tmp_path / "taki.ingp")
    common = [obj, "--mode", "sdf", "--network", str(net), "--device", "cpu",
              "--batch_size", str(BATCH)]
    run.main(common + ["--n_steps", "40", "--save_snapshot", snap])
    lines = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"trained 40 steps in \S+s \(\S+ steps/s\), loss=\d+\.\d{6}", lines[0])
    assert re.fullmatch(r"IoU: \d\.\d{4}", lines[1]) and 0 < float(lines[1].split()[1]) < 1
    assert lines[2] == f"saved snapshot to {snap}"
    run.main(common + ["--n_steps", "0", "--load_snapshot", snap])
    again = capsys.readouterr().out.splitlines()
    assert again[:2] == ["loaded snapshot at step 40", lines[1]]
    spec = importlib.util.spec_from_file_location(
        "jax_run_cli", os.path.join(os.path.dirname(os.path.dirname(__file__)),
                                    "scripts", "run.py"))
    jcli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jcli)
    jcli.main([obj, "--network", str(net), "--n_steps", "0", "--load_snapshot", snap,
               "--compile_cache", ""])
    jlines = capsys.readouterr().out.splitlines()
    assert jlines[0] == "loaded snapshot at step 40"
    assert abs(float(jlines[1].split()[1]) - float(lines[1].split()[1])) < 0.05

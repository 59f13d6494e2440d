"""The rest of the tcnn encoding surface in the port (ROADMAP A7a), against
the JAX package on the CPU: the Frequency, TriangleWave and OneBlob
encodings (plain tensor code, no parameters) and the TiledGrid and Simplex
grid options, through the factory, ``interop``, the optimizer's groups, one
step of each engine that trains them and ``Testbed``.

Tolerances:

- Frequency: outputs 2e-6 (both sides round the angle x·2^f·π the same way
  in float32; sin and cos differ by a few float32 ulps); input gradients
  1e-5 of the largest, 2^11·π·|cos| (a float32 ulp of the largest angle,
  2^-11, moves cos·2^f·π by that);
- TriangleWave and OneBlob: outputs 1e-6 and input gradients 1e-6 of the
  largest (the same float32 operations; the gradient sums the output
  columns' terms in another order, a few ulps of the largest term);
- the whole-path steps: the bounds of the modules that hold those paths
  for the Linear grid (loss 1e-4 relative, MLP gradients 2e-2 of each
  matrix's largest entry, table gradients 2^-6 of each level's largest),
  stated in each test.
"""

import copy
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ngp_tpu.models import factory as jfactory
from ngp_tpu_torch.interop import export_jax_params, load_jax_params
from ngp_tpu_torch.models import factory as pfactory
from ngp_tpu_torch.models.encodings import (
    FrequencyEncoding,
    GridEncoding,
    OneBlobEncoding,
    TriangleWaveEncoding,
)
from ngp_tpu_torch.optim import param_groups
from ngp_tpu_torch.train import Trainer, TrainState

# One intra-op thread, as in every port test module (see
# tests/test_torch_hashgrid.py).
torch.set_num_threads(1)

BOUND = 2.0 ** -6
PLAIN = {"Frequency": FrequencyEncoding, "TriangleWave": TriangleWaveEncoding,
         "OneBlob": OneBlobEncoding}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _level_err(want, got):
    return np.abs(got - want).max(axis=(1, 2)), np.abs(want).max(axis=(1, 2))


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("otype", list(PLAIN))
def test_plain_encodings_and_their_input_gradients_match_jax(otype, d):
    """tcnn's defaults (12 frequencies, 16 bins): the width and layout, the
    outputs and the input gradients (autograd here, autodiff there) for
    positions in [0, 1] and a little outside, module docstring bounds."""
    cfg = {"otype": otype}
    jenc, penc = jfactory.create_encoding(d, cfg), pfactory.create_encoding(d, cfg, "cpu")
    assert isinstance(penc, PLAIN[otype]) and penc.n_params == 0
    assert penc.n_output_dims == jenc.n_output_dims
    assert jenc.init(jax.random.PRNGKey(0)) == {} and not list(penc.parameters())
    rng = np.random.default_rng(d)
    x = rng.uniform(-0.05, 1.05, (700, d)).astype(np.float32)
    x[:4] = np.asarray([0.0, 1.0, 0.5, 1.0 / 3.0], np.float32)[:, None]
    g = rng.normal(size=(700, penc.n_output_dims)).astype(np.float32)
    out_j, vjp = jax.vjp(lambda xx: jenc({}, xx), jnp.asarray(x))
    (dx_j,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = penc(xt)
    (out * torch.from_numpy(g)).sum().backward()
    dx_j = np.asarray(dx_j)
    if otype == "Frequency":
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), rtol=0, atol=2e-6)
        np.testing.assert_allclose(xt.grad.numpy(), dx_j, rtol=0,
                                   atol=1e-5 * np.abs(dx_j).max())
    else:
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), rtol=0, atol=1e-6)
        np.testing.assert_allclose(xt.grad.numpy(), dx_j, rtol=0,
                                   atol=1e-6 * np.abs(dx_j).max())
    assert np.abs(dx_j).max() > 1.0


def test_factory_builds_every_ported_otype():
    """``create_encoding`` builds TiledGrid and the grid options and the
    three plain encodings with the configs' own widths; Composite nests
    them."""
    tiled = pfactory.create_encoding(3, {"otype": "TiledGrid", "n_levels": 4,
                                         "log2_hashmap_size": 10, "base_resolution": 8,
                                         "interpolation": "Simplex"}, "cpu")
    assert isinstance(tiled, GridEncoding)
    assert (tiled.grid_type, tiled.interpolation) == ("Tiled", "Simplex")
    grid = pfactory.create_encoding(2, {"otype": "Grid", "type": "Tiled"}, "cpu")
    assert grid.grid_type == "Tiled" and grid.n_input_dims == 2
    freq = pfactory.create_encoding(3, {"otype": "Frequency", "n_frequencies": 4}, "cpu")
    assert freq.n_output_dims == 24
    blob = pfactory.create_encoding(2, {"otype": "OneBlob", "n_bins": 8}, "cpu")
    assert blob.n_output_dims == 16
    comp = {"otype": "Composite", "nested": [
        {"n_dims_to_encode": 2, "otype": "TriangleWave", "n_frequencies": 3},
        {"otype": "OneBlob", "n_bins": 4}]}
    penc, jenc = pfactory.create_encoding(5, comp, "cpu"), jfactory.create_encoding(5, comp)
    assert penc.n_output_dims == jenc.n_output_dims == 6 + 12
    x = np.random.default_rng(0).uniform(0, 1, (64, 5)).astype(np.float32)
    np.testing.assert_allclose(penc(torch.from_numpy(x)).numpy(),
                               np.asarray(jenc(jenc.init(jax.random.PRNGKey(0)),
                                               jnp.asarray(x))), rtol=0, atol=1e-6)


SDF_NET = {"network": {"otype": "FullyFusedMLP", "activation": "ReLU",
                       "output_activation": "None", "n_neurons": 32, "n_hidden_layers": 2}}
GRID = {"n_levels": 4, "n_features_per_level": 2, "log2_hashmap_size": 10,
        "base_resolution": 8}
NETWORK_ENCODINGS = {
    "Frequency": {"otype": "Frequency"},
    "TriangleWave": {"otype": "TriangleWave", "n_frequencies": 6},
    "OneBlob": {"otype": "OneBlob"},
    "TiledGrid": {"otype": "TiledGrid", **GRID},
    "Simplex": {"otype": "HashGrid", "interpolation": "Simplex", **GRID},
}


@pytest.mark.parametrize("name", list(NETWORK_ENCODINGS))
def test_jax_params_round_trip(name):
    """``load_jax_params`` then ``export_jax_params`` of the JAX package's
    initial tree gives the tree back, leaf for leaf and key for key, for a
    ``NetworkWithInputEncoding`` (a parameterless encoding's tree is {})
    and, for the grids and Frequency, a ``NerfNetwork``'s position encoding;
    the port's parameter count is the JAX package's."""
    cfg = {**SDF_NET, "encoding": NETWORK_ENCODINGS[name]}
    jnet = jfactory.create_network_with_input_encoding(3, 1, cfg)
    tree = _np(jnet.init(jax.random.PRNGKey(1)))
    pnet = load_jax_params(pfactory.create_network_with_input_encoding(3, 1, cfg, "cpu"), tree)
    back = export_jax_params(pnet)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    assert pnet.n_params == jnet.n_params
    if name in ("OneBlob", "TriangleWave"):
        return
    from tests.test_torch_train_step import SMALL

    ncfg = copy.deepcopy(SMALL)
    ncfg["encoding"] = NETWORK_ENCODINGS[name]
    jn = jfactory.create_nerf_network(ncfg)
    ntree = _np(jn.init(jax.random.PRNGKey(2)))
    pn = load_jax_params(pfactory.create_nerf_network(ncfg, device="cpu"), ntree)
    nback = export_jax_params(pn)
    assert jax.tree.structure(nback) == jax.tree.structure(ntree)
    for a, b in zip(jax.tree.leaves(nback), jax.tree.leaves(ntree)):
        np.testing.assert_array_equal(a, b)


def test_an_empty_grid_group_trains():
    """A network whose encoding has no parameters: the optimizer's grid
    group is empty, and a step still updates the MLP, counts both groups'
    updates and exports the training state with empty grid moments."""
    from ngp_tpu_torch.interop import export_jax_train_state

    cfg = {**SDF_NET, "encoding": {"otype": "Frequency", "n_frequencies": 4},
           "loss": {"otype": "L2"},
           "optimizer": {"otype": "Ema", "decay": 0.95, "nested": {
               "otype": "Adam", "learning_rate": 1e-2}}}
    net = pfactory.create_network_with_input_encoding(3, 1, cfg, "cpu")
    net.reset_parameters(torch.Generator().manual_seed(0))
    groups = param_groups(net)
    assert groups["grid"] == [] and len(groups["dense"]) == 3
    state = TrainState.create(net)
    trainer = Trainer(pfactory.create_loss(cfg["loss"]), cfg["optimizer"])
    before = [w.detach().clone() for w in net.network.weights]
    x = torch.rand((256, 3), generator=torch.Generator().manual_seed(1))
    for _ in range(2):
        loss = trainer.training_step(state, x, x[:, :1])
    assert torch.isfinite(loss) and state.step == 2
    assert state.opt_state["grid"].count == state.opt_state["dense"].count == 2
    assert all(not torch.equal(a, w) for a, w in zip(before, net.network.weights))
    tree = export_jax_train_state(state)
    assert tree["params"]["encoding"] == {} and tree["opt"]["grid"]["mu"] == {}


def test_sdf_step_with_a_frequency_encoding_matches_jax():
    """One SDF loss and its gradients on the JAX engine's batch from the
    same parameters (``tests/test_torch_sdf.py``'s pattern): the loss 1e-4
    relative, MLP weight gradients 2e-2 of each matrix's largest entry."""
    from ngp_tpu.engines.sdf import SdfEngine as JaxSdfEngine
    from ngp_tpu.geometry.mesh import Mesh as JaxMesh
    from ngp_tpu_torch.engines.sdf import SdfEngine
    from ngp_tpu_torch.geometry.mesh import Mesh
    from tests.test_torch_sdf import BATCH, CONFIG, SEED, _mesh_fields

    cfg = copy.deepcopy(CONFIG)
    cfg["encoding"] = {"otype": "Frequency"}
    jeng = JaxSdfEngine(cfg, JaxMesh(**_mesh_fields()), batch_size=BATCH, seed=SEED)
    peng = SdfEngine(cfg, Mesh(**_mesh_fields()), batch_size=BATCH, seed=SEED, device="cpu")
    params = jeng.init_state().params
    assert params["encoding"] == {}
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
# -- whole paths: one NeRF step, one image step


def _nerf_config(kind):
    from tests.test_torch_train_step import SMALL

    cfg = copy.deepcopy(SMALL)
    if kind == "tiled":
        cfg["encoding"]["otype"] = "TiledGrid"
    else:
        cfg["encoding"]["interpolation"] = "Simplex"
    return cfg


@pytest.mark.parametrize("kind", ["simplex", "tiled"])
def test_nerf_step_matches_jax_on_an_injected_batch(kind):
    """One NeRF step on the JAX engine's batch and background from the same
    weights and grid (``tests/test_torch_train_step.py``'s pattern and
    bounds): loss 1e-4 relative, MLP gradients 2e-2 of each matrix's
    largest entry, the table gradient 2^-6 of each level's largest."""
    from ngp_tpu.engines.nerf import NerfEngine as JaxNerfEngine
    from ngp_tpu_torch.engines.nerf import NerfEngine, RayBatch
    from ngp_tpu_torch.interop import load_jax_train_state
    from ngp_tpu_torch.ops.occupancy import OccupancyGridState
    from tests.test_nerf_engine import _make_dataset
    from tests.test_torch_train_step import ENGINE, _port_dataset, jax_state_tree

    cfg = _nerf_config(kind)
    ds = _make_dataset(n_views=4)
    jeng = JaxNerfEngine(copy.deepcopy(cfg), ds, **ENGINE)
    peng = NerfEngine(copy.deepcopy(cfg), _port_dataset(ds), device="cpu", **ENGINE)
    assert peng.network.pos_encoding.grid_type == ("Tiled" if kind == "tiled" else "Hash")
    jstate = jeng.init_state()
    jgrid = jeng.update_grid(jstate, jeng.init_grid(), jax.random.PRNGKey(1), warmup=True)
    k, n_rays = jeng._k, jeng._n_rays
    key = jax.random.PRNGKey(5)
    jemap = jeng.init_error_map()
    jbatch = jeng._sample_ray_batch(key, jeng.data, n_rays, jemap)
    bg = jax.random.uniform(jax.random.fold_in(key, 7), (n_rays, 3))
    # eager: under jit XLA contracts multiply-adds in the march, and the
    # positions it then gives the grid move the table gradient of a Tiled
    # grid's finest level (64³ cells wrapped onto 4,096 rows) by 2.5% of its
    # largest entry (eager: 0.04%), as tests/test_torch_camera.py found
    jloss, _, jgrads, _ = jeng.batch_loss_and_grads(
        jstate.params, jgrid.bitfield, jgrid.mean_density, key, jeng.data, k=k,
        n_rays=n_rays, emap=jemap)
    state = load_jax_train_state(peng._new_network(), jax_state_tree(jeng, jstate))
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    batch = RayBatch(t(jbatch.origins), t(jbatch.dirs), t(jbatch.target_rgba), t(jbatch.n0),
                     t(jbatch.img).long(), t(jbatch.uv))
    grid = OccupancyGridState(t(jgrid.density), t(jgrid.bitfield), t(jgrid.mean_density),
                              int(jgrid.ema_step))
    loss, _, _ = peng.batch_loss_and_grads(state.model, grid, batch, t(bg), k,
                                           peng.init_error_map())
    assert float(loss) == pytest.approx(float(jloss), rel=1e-4)
    jm = jgrads["model"]
    for mlp in ("density_mlp", "rgb_mlp"):
        for i, w in enumerate(getattr(state.model, mlp).weights):
            want = np.asarray(jm[mlp]["weights"][i])
            assert np.abs(w.grad.numpy() - want).max() <= 2e-2 * np.abs(want).max()
    want = np.asarray(jm["pos_encoding"]["table"])
    err, scale = _level_err(want, state.model.pos_encoding.table.grad.numpy())
    assert (err <= BOUND * scale).all(), err / scale


def test_image_step_with_simplex_matches_jax():
    """One image-network loss and its gradients at D = 2 with Simplex
    (``tests/test_torch_image.py``'s pattern and bounds): outputs 1e-4, the
    loss 1e-4 relative, MLP gradients 2e-2 of each matrix's largest entry,
    the table gradient 2^-6 of each level's largest."""
    from ngp_tpu.models import factory as jfactory
    from ngp_tpu.train import Trainer as JaxTrainer
    from ngp_tpu_torch.interop import load_jax_params
    from ngp_tpu_torch.models import factory as pfactory
    from ngp_tpu_torch.train import Trainer
    from tests.test_torch_image import CONFIG

    cfg = copy.deepcopy(CONFIG)
    cfg["encoding"]["interpolation"] = "Simplex"
    jnet = jfactory.create_network_with_input_encoding(2, 3, cfg)
    params = jnet.init(jax.random.PRNGKey(0))
    pnet = load_jax_params(pfactory.create_network_with_input_encoding(2, 3, cfg, "cpu"),
                           jax.tree.map(np.asarray, params))
    assert pnet.encoding.interpolation == "Simplex" and pnet.n_params == jnet.n_params
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 1, (1 << 12, 2)).astype(np.float32)
    tgt = rng.uniform(0, 1, (1 << 12, 3)).astype(np.float32)
    jtrainer = JaxTrainer(jnet.__call__, jfactory.create_loss(cfg["loss"]), cfg["optimizer"])
    jloss, jgrad = jax.jit(jax.value_and_grad(jtrainer.loss))(params, jnp.asarray(x),
                                                              jnp.asarray(tgt))
    ptrainer = Trainer(pfactory.create_loss(cfg["loss"]), cfg["optimizer"])
    np.testing.assert_allclose(pnet(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jnet(params, jnp.asarray(x))), rtol=0, atol=1e-4)
    ploss = ptrainer.loss(pnet, torch.from_numpy(x), torch.from_numpy(tgt))
    ploss.backward()
    np.testing.assert_allclose(float(ploss.detach()), float(jloss), rtol=1e-4)
    for w, jw in zip(pnet.network.weights, jgrad["network"]["weights"]):
        jw = np.asarray(jw)
        np.testing.assert_allclose(w.grad.numpy(), jw, rtol=0, atol=2e-2 * np.abs(jw).max())
    err, scale = _level_err(np.asarray(jgrad["encoding"]["table"]),
                            pnet.encoding.table.grad.numpy())
    assert (err <= BOUND * scale).all(), err / scale


# -- Testbed: each new otype and option trains, renders and snapshots

TESTBED_CASES = [("nerf", {"otype": "TiledGrid"}), ("nerf", {"interpolation": "Simplex"}),
                 ("nerf", {"otype": "Frequency", "n_frequencies": 6}),
                 ("sdf", {"otype": "Frequency"}), ("sdf", {"otype": "TriangleWave"}),
                 ("sdf", {"otype": "OneBlob"}), ("sdf", {"interpolation": "Simplex"}),
                 ("image", {"interpolation": "Simplex"}), ("image", {"otype": "OneBlob"})]


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """A 32² sphere capture, a bumpy sphere of 320 triangles and a 32²
    image, written."""
    from ngp_tpu_torch.data.synthetic import (
        write_bumpy_sphere_mesh,
        write_gigapixel_bin,
        write_sphere_capture,
    )

    root = tmp_path_factory.mktemp("tcnn")
    return {"nerf": write_sphere_capture(str(root / "cap"), res=32)[0],
            "sdf": write_bumpy_sphere_mesh(str(root / "bumpy.obj"), 2),
            "image": write_gigapixel_bin(str(root / "img.bin"), 32)}


@pytest.mark.parametrize("mode,encoding", TESTBED_CASES,
                         ids=[f"{m}-{e.get('otype', e.get('interpolation'))}"
                              for m, e in TESTBED_CASES])
def test_testbed_trains_renders_and_snapshots(scenes, mode, encoding, tmp_path):
    """A ``Testbed`` on the mode's default config with its encoding narrowed
    to 4 levels of 2^12 rows, then ``reload_network_from_json`` with that
    config given the new otype or option: the engine builds it, 3 steps
    give a finite loss, a 16 × 12 render is finite, and a snapshot saved
    and loaded holds the same parameters; a second save and load renders
    the first load's pixels (a NeRF snapshot keeps its occupancy grid in
    float16)."""
    from ngp_tpu_torch.testbed import Testbed, default_config

    kw = {"nerf": dict(grid_size=16, batch_size=1 << 12), "sdf": dict(batch_size=1 << 10),
          "image": dict(batch_size=1 << 10)}[mode]
    cfg = default_config(mode)
    cfg["encoding"].update(n_levels=4, log2_hashmap_size=12)
    tb = Testbed(scene=scenes[mode], config=copy.deepcopy(cfg), device="cpu", seed=1, **kw)
    cfg["encoding"].update(encoding)
    tb.reload_network_from_json(json.loads(json.dumps(cfg)))
    enc = tb.engine.network.pos_encoding if mode == "nerf" else tb.state.model.encoding
    if "interpolation" in encoding:
        assert enc.interpolation == "Simplex"
    elif encoding["otype"] == "TiledGrid":
        assert enc.grid_type == "Tiled"
    else:
        assert type(enc).__name__ == encoding["otype"] + "Encoding"
    tb.train(3)
    assert tb.training_step == 3 and np.isfinite(tb.loss)
    img = tb.render(16, 12)
    assert img.shape == (12, 16, 3) and np.isfinite(img).all()
    params = export_jax_params(tb.state.model)
    path = str(tmp_path / "snap.msgpack")
    tb.save_snapshot(path)
    tb.load_snapshot(path)
    for a, b in zip(jax.tree.leaves(export_jax_params(tb.state.model)), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    first = tb.render(16, 12)
    tb.save_snapshot(path)
    tb.load_snapshot(path)
    np.testing.assert_array_equal(tb.render(16, 12), first)

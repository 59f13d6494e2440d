"""The port's NeRF training step and loop (``ngp_tpu_torch/engines/nerf.py``)
against the JAX package's ``NerfEngine``, on the CPU at a small size: L=4
levels (one dense, three hashed; additive hash as on the main path),
T=2^12, 32-wide MLPs, occupancy grid 16³, 2^12 sample slots per step, on
the sphere scene of ``tests/test_nerf_engine.py``.

The step is compared on an injected batch: the JAX package's own
``_sample_ray_batch`` output and training background, fed to both
packages from the same weights and grid (carried across with
``ngp_tpu_torch.interop``). Tolerances:

- loss 1e-4 relative, the march's integers exactly;
- MLP weight gradients 2e-2 of the largest entry of each matrix: both
  packages round the MLPs' operands and hidden activations to bf16 and
  pass gradients through those roundings in bf16, so a float32 sum order
  that flips one rounding moves a gradient entry by up to a bf16 ulp
  (2^-8 relative) of a term; measured below 1e-2;
- the table gradient 2^-6 of max|d(table)| per level, the bound of
  ``tests/test_torch_grid_backward.py`` (bf16 addends).
"""

import copy
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ngp_tpu.engines.nerf import NerfEngine as JaxNerfEngine
from ngp_tpu_torch.data.nerf_loader import NerfDataset
from ngp_tpu_torch.data.synthetic import tiny_sphere_dataset
from ngp_tpu_torch.engines.nerf import NerfEngine, RayBatch
from ngp_tpu_torch.interop import export_jax_train_state, load_jax_train_state
from ngp_tpu_torch.ops.occupancy import OccupancyGridState
from tests.test_nerf_engine import CONFIG, _make_dataset

# One intra-op thread: with two, torch's CPU sqrt (MKL's vsSqrt, split across
# the intra-op threads) now and then returned one thread's chunk ~3e-4 off
# on an AVX-512 Xeon (torch 2.13, MKL 2024.2), never with one
# (scripts/torch_sqrt_threads.py counts it).
# Every port test module sets the same count, so that a pytest worker's
# count does not depend on which module it imported last.
torch.set_num_threads(1)

SMALL = copy.deepcopy(CONFIG)
SMALL["encoding"] = {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
                     "log2_hashmap_size": 12, "base_resolution": 16,
                     "per_level_scale": 2.0, "hash_variant": "additive"}
SMALL["network"]["n_neurons"] = 32
SMALL["rgb_network"]["n_neurons"] = 32
ENGINE = dict(batch_size=1 << 12, grid_size=16, seed=3)


def _port_dataset(ds):
    return NerfDataset(ds.images, ds.xforms, ds.focal_lengths, ds.principal_points,
                       ds.lens, ds.resolution, ds.aabb_scale)


def _t(a):
    return torch.from_numpy(np.array(a))


def jax_state_tree(jeng, jstate) -> dict:
    """A JAX ``TrainState`` as the port's training-state tree: the model
    subtree of params, Adam moments and counts per group, EMA."""
    inner = jstate.opt_state.inner_states
    masked = type(inner["dense"].inner_state[0].mu["camera"]["pos"])

    def empty(v):
        return v is None or (isinstance(v, (dict, list)) and not v)

    def strip(tree):
        """The group's own leaves, without the other groups' placeholders."""
        if isinstance(tree, dict):
            out = {k: strip(v) for k, v in tree.items()}
            return {k: v for k, v in out.items() if not empty(v)}
        if isinstance(tree, list):
            out = [strip(v) for v in tree]
            return out if any(v is not None for v in out) else None
        return None if isinstance(tree, masked) else np.asarray(tree)

    opt = {}
    for g in ("dense", "grid"):
        adam = inner[g].inner_state[0]
        opt[g] = {"count": int(adam.count), "mu": strip(adam.mu["model"]),
                  "nu": strip(adam.nu["model"])}
    return {"step": int(jstate.step),
            "params": jax.tree.map(np.asarray, jstate.params["model"]),
            "opt": opt, "ema": jax.tree.map(np.asarray, jstate.ema.params["model"])}


@pytest.fixture(scope="module")
def engines():
    ds = _make_dataset(n_views=4)
    jeng = JaxNerfEngine(copy.deepcopy(SMALL), ds, **ENGINE)
    peng = NerfEngine(copy.deepcopy(SMALL), _port_dataset(ds), device="cpu", **ENGINE)
    jstate = jeng.init_state()
    jgrid = jeng.update_grid(jstate, jeng.init_grid(), jax.random.PRNGKey(1), warmup=True)
    return jeng, peng, jstate, jgrid


def _port_grid(jgrid):
    return OccupancyGridState(_t(jgrid.density), _t(jgrid.bitfield),
                              _t(jgrid.mean_density), int(jgrid.ema_step))


def test_geometry_and_init_grid_match_jax(engines):
    jeng, peng, _, _ = engines
    assert peng.n_lattice == jeng.n_lattice
    assert peng.batch_geometry == (jeng._k, jeng._n_rays)
    assert peng.samples_per_step == jeng.samples_per_step
    assert peng._grid_strides == jeng._grid_strides
    assert peng._march_gate_eligible and jeng._march_gate_eligible
    jg, pg = jeng.init_grid(), peng.init_grid()
    np.testing.assert_array_equal(pg.density.numpy(), np.asarray(jg.density))
    np.testing.assert_array_equal(pg.bitfield.numpy(), np.asarray(jg.bitfield))


def test_train_state_round_trips_through_interop(engines):
    jeng, peng, jstate, _ = engines
    tree = jax_state_tree(jeng, jstate)
    state = load_jax_train_state(peng._new_network(), tree)
    assert state.step == 0 and state.opt_state["grid"].count == 0
    back = export_jax_train_state(state)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("seg_budget", [None, 512])
def test_step_matches_jax_on_an_injected_batch(engines, seg_budget):
    jeng, peng, jstate, jgrid = engines
    jeng._seg_budget = peng._seg_budget = seg_budget
    k, n_rays = jeng._k, jeng._n_rays
    key = jax.random.PRNGKey(5)
    jemap = jeng.init_error_map()
    jbatch = jeng._sample_ray_batch(key, jeng.data, n_rays, jemap)
    bg = jax.random.uniform(jax.random.fold_in(key, 7), (n_rays, 3))
    step = jax.jit(jeng.batch_loss_and_grads, static_argnames=("k", "n_rays"))
    jloss, jmetrics, jgrads, jemap2 = step(
        jstate.params, jgrid.bitfield, jgrid.mean_density, key, jeng.data, k=k,
        n_rays=n_rays, emap=jemap)

    state = load_jax_train_state(peng._new_network(), jax_state_tree(jeng, jstate))
    batch = RayBatch(_t(jbatch.origins), _t(jbatch.dirs), _t(jbatch.target_rgba),
                     _t(jbatch.n0), _t(jbatch.img).long(), _t(jbatch.uv))
    loss, metrics, pemap = peng.batch_loss_and_grads(
        state.model, _port_grid(jgrid), batch, _t(bg), k, peng.init_error_map())
    jeng._seg_budget = peng._seg_budget = None

    assert float(loss) == pytest.approx(float(jloss), rel=1e-4)
    assert float(metrics["loss"]) == pytest.approx(float(jmetrics["loss"]), rel=1e-4)
    for name in ("mean_total", "seg_total"):
        assert float(metrics[name]) == float(jmetrics[name]), name
    assert int(metrics["measured_samples"]) == pytest.approx(
        int(jmetrics["measured_samples"]), rel=1e-3)
    np.testing.assert_allclose(pemap.data.numpy(), np.asarray(jemap2.data),
                               rtol=1e-4, atol=1e-4 * float(np.abs(jemap2.data).max()))

    model = state.model
    jm = jgrads["model"]
    for mlp in ("density_mlp", "rgb_mlp"):
        for i, w in enumerate(getattr(model, mlp).weights):
            want = np.asarray(jm[mlp]["weights"][i])
            err = np.abs(w.grad.numpy() - want).max()
            assert err <= 2e-2 * np.abs(want).max(), (mlp, i, err / np.abs(want).max())
    want = np.asarray(jm["pos_encoding"]["table"])
    got = model.pos_encoding.table.grad.numpy()
    err = np.abs(got - want).max(axis=(1, 2))
    scale = np.abs(want).max(axis=(1, 2))
    assert (err <= 2.0 ** -6 * scale).all(), err / scale


def test_apply_grads_matches_the_engine_optimizer(engines):
    """``apply_grads`` against the JAX engine's own ``apply_grads``
    (``NerfEngine.tx``: sparse Adam on the table, Adam + L2 on the MLPs,
    the schedule; then ``ema_update``), fed identical gradients for three
    steps, a quarter of the table entries exactly 0 each step. The whole
    training state, exported back to the JAX layout, agrees to 1e-6
    relative, and to 1e-8 absolute where a parameter has cancelled to near
    zero (ten float32 ulps of the ±1e-2 steps); zero-gradient table entries
    are unchanged."""
    jeng, peng, jstate, _ = engines
    state = load_jax_train_state(peng._new_network(), jax_state_tree(jeng, jstate))
    rng = np.random.default_rng(12)
    apply = jeng.apply_grads  # eager: under jit XLA contracts multiply-adds
    for _ in range(3):
        grads = jax.tree.map(
            lambda x: rng.normal(size=x.shape).astype(np.float32), jstate.params)
        table = grads["model"]["pos_encoding"]["table"]
        table[rng.uniform(size=table.shape) < 0.25] = 0.0
        jstate = apply(jstate, jax.tree.map(jnp.asarray, grads))
        before = state.model.pos_encoding.table.detach().clone()
        for name, p in state.model.named_parameters():
            p.grad = _t(_tree_get(grads["model"], name))
        peng.apply_grads(state)
        zero = _t(table == 0.0)
        assert torch.equal(state.model.pos_encoding.table.detach()[zero], before[zero])
    want, got = jax_state_tree(jeng, jstate), export_jax_train_state(state)
    assert got["step"] == want["step"] == 3
    for g in ("dense", "grid"):
        assert got["opt"][g]["count"] == want["opt"][g]["count"] == 3
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=1e-6, atol=1e-8)


def _tree_get(tree, name):
    for k in name.split("."):
        tree = tree[int(k)] if k.isdigit() else tree[k]
    return tree


def test_adapt_batch_geometry_matches_jax(engines):
    """A fixed sequence of metrics through both engines' host logic: the
    (K, rays, segment budget) after each is identical."""
    jeng, peng, _, _ = engines
    jeng, peng = copy.copy(jeng), copy.copy(peng)
    seq = [(900.0, 5000.0, 0.0), (40.0, 300.0, 400.0), (40.0, 300.0, 200.0),
           (12.0, 80.0, 60.0), (3.0, 10.0, 4000.0), (30.0, 200.0, 30.0),
           (200.0, 3000.0, 9000.0), (0.0, 0.0, 0.0), (5.0, 30.0, 20.0)]
    for measured, mean_total, seg_total in seq:
        m = {"measured_samples": measured, "mean_total": mean_total,
             "seg_total": seg_total, "n_rays": jeng._n_rays}
        jeng.adapt_batch_geometry(m)
        peng.adapt_batch_geometry(m)
        assert (peng._k, peng._n_rays, peng._seg_budget) == (
            jeng._k, jeng._n_rays, jeng._seg_budget)


def test_zero_sample_guard(engines):
    _, peng, _, _ = engines
    peng = copy.copy(peng)
    peng._zero_sample_checks = 0
    zero = {"measured_samples": 0.0, "mean_total": 0.0, "seg_total": 0.0, "n_rays": 64}
    peng.adapt_batch_geometry(zero)
    peng.adapt_batch_geometry(zero)
    with pytest.raises(RuntimeError, match="0 samples"):
        peng.adapt_batch_geometry(zero)


@pytest.mark.parametrize("warmup", [True, False])
def test_update_grid_matches_jax_on_its_draws(engines, warmup):
    """One occupancy update from the same weights and the JAX package's
    jitter: densities to the network's tolerance (1e-3, see
    ``tests/test_torch_network.py``), the bitfield exactly wherever a
    cell's density is not within that tolerance of the threshold (at
    initialization most cells sit near it), the update count exactly."""
    jeng, peng, jstate, jgrid = engines
    # a table far from its initial ±1e-4 spreads the densities out
    params = jax.tree.map(lambda x: x, jstate.params)
    params["model"]["pos_encoding"] = {"table": params["model"]["pos_encoding"]["table"] * 3e3}
    jstate = jstate._replace(params=params, ema=jstate.ema._replace(params=params))
    key = jax.random.PRNGKey(9)
    cfg = jeng.grid_cfg
    n = cfg.n_cascades * cfg.n_cells // (1 if warmup else jeng._grid_strides)
    jitter = _t(jax.random.uniform(key, (n, 3)))
    want = jax.jit(jeng._update_grid, static_argnames="warmup")(
        jstate.params, jgrid, key, warmup=warmup)
    state = load_jax_train_state(peng._new_network(), jax_state_tree(jeng, jstate))
    got = peng.update_grid(state, _port_grid(jgrid), warmup, jitter=jitter)
    np.testing.assert_allclose(got.density.numpy(), np.asarray(want.density),
                               rtol=1e-3, atol=1e-6)
    _assert_bitfields_agree(got, want, min_clear=0.5)
    assert got.ema_step == int(want.ema_step)


def _assert_bitfields_agree(got, want, min_clear):
    """Bitfields equal at every cell whose density is not within 2e-3 of
    the threshold min(0.01, mean): the means are float32 sums in another
    order. One cascade, so no max-pool from finer cascades to untangle."""
    assert want.density.shape[0] == 1
    assert float(got.mean_density) == pytest.approx(float(want.mean_density), rel=1e-3)
    dens = np.asarray(want.density)
    thresh = min(0.01, float(want.mean_density))
    clear = np.abs(dens - thresh) > 2e-3 * thresh
    assert clear.mean() >= min_clear
    np.testing.assert_array_equal(got.bitfield.numpy()[clear],
                                  np.asarray(want.bitfield)[clear])


def test_decay_grid_matches_jax(engines):
    """The decay-only update (an EMA step with an empty splat): densities
    exactly, the bitfield away from the threshold."""
    jeng, peng, _, jgrid = engines
    want = jeng._decay_grid(jgrid)
    got = peng.decay_grid(_port_grid(jgrid))
    np.testing.assert_array_equal(got.density.numpy(), np.asarray(want.density))
    _assert_bitfields_agree(got, want, min_clear=0.0)
    assert got.ema_step == int(want.ema_step)


def test_not_yet_ported_options_raise():
    """The trainable envmap and depth supervision (ROADMAP A5c); camera
    refinement is ported (``tests/test_torch_camera.py``)."""
    ds = _port_dataset(_make_dataset(n_views=2))
    with pytest.raises(ValueError, match="not yet ported"):
        NerfEngine(copy.deepcopy(SMALL), ds, device="cpu", train_envmap=True)
    with pytest.raises(ValueError, match="not yet ported"):
        NerfEngine(copy.deepcopy(SMALL), ds, device="cpu", depth_supervision_lambda=0.1)


def test_training_loop_runs_and_keeps_its_step(engines):
    """A few steps through ``train``: the step count lives in the state
    (two calls continue where the first stopped), the EMA starts at the
    first update, loss stays finite, the grid is updated on the cadence."""
    _, _, _, _ = engines
    ds = _port_dataset(_make_dataset(n_views=4))
    eng = NerfEngine(copy.deepcopy(SMALL), ds, device="cpu", adapt_every=2, **ENGINE)
    state, grid = eng.init_state(), eng.init_grid()
    assert state.ema is None and state.inference_model() is state.model
    state, grid, m = eng.train(state, grid, 3)
    state, grid, m = eng.train(state, grid, 3)
    assert state.step == 6 and state.opt_state["dense"].count == 6
    assert state.ema is not None and math.isfinite(float(m["loss"]))
    assert grid.ema_step == 6  # steps 0..5 each update (interval 1 before step 32)
    img = eng.render_image(state, grid, 0, stride=8)
    assert img.shape == (6, 6, 3) and bool(torch.isfinite(img).all())


def test_synthetic_sphere_matches_the_bench_scene():
    from __graft_entry__ import _tiny_sphere_dataset

    want, got = _tiny_sphere_dataset(3, 16), tiny_sphere_dataset(3, 16)
    for f in ("images", "xforms", "focal_lengths", "principal_points"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.resolution == want.resolution and got.wants_importance_sampling


@pytest.mark.slow
def test_train_sphere_to_psnr():
    """The JAX package's ``test_train_sphere_to_psnr`` settings: 400 steps
    must reach PSNR > 20 dB on view 0 and prune the occupancy grid."""
    from tests.test_nerf_engine import SPHERE_RGB

    eng = NerfEngine(copy.deepcopy(CONFIG), _port_dataset(_make_dataset()),
                     batch_size=1 << 15, n_render_samples=128, grid_size=32,
                     n_steps_per_unit=256, density_grid_decay=0.8, seed=7, device="cpu")
    state, grid = eng.init_state(), eng.init_grid()
    state, grid, metrics = eng.train(state, grid, 400)
    assert math.isfinite(float(metrics["loss"]))
    psnr = eng.psnr(state, grid, 0, stride=2)
    assert psnr > 20.0, psnr
    frac = float(grid.bitfield[0].float().mean())
    assert 0.001 < frac < 0.30, frac
    img = eng.render_image(state, grid, 0, stride=2).numpy()
    np.testing.assert_allclose(img[img.shape[0] // 2, img.shape[1] // 2], SPHERE_RGB,
                               atol=0.15)

"""The port's training operations against the JAX package, on the CPU:
losses, the NeRF training loss and its gradient, the density activation's
clamped derivative, compaction gradients, the optimizer stack, occupancy
maintenance on the JAX package's own random draws, the gated march, and
the error-map CDFs.

Tolerances: losses and their gradients 1e-6 (the same float32 formulas);
the training loss value 1e-6 and its gradient 2e-5 relative (the composite's
cumulative sums and exps may round differently in the last bit); the
optimizer 1e-6 relative over several steps (identical formulas, float32
rounding of the step-dependent scalars); integers and occupancy exact.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ngp_tpu.ops import compaction as jcompaction
from ngp_tpu.ops import losses as jlosses
from ngp_tpu.ops import marching as jmarch
from ngp_tpu.ops import occupancy as jocc
from ngp_tpu.ops.composite import density_activation_exp as jax_density_exp
from ngp_tpu.ops.composite import nerf_training_loss as jax_training_loss
from ngp_tpu.optim import ema_init, ema_update as jax_ema_update, make_optimizer
from ngp_tpu_torch.engines import nerf as pnerf
from ngp_tpu_torch.ops import compaction as pcompaction
from ngp_tpu_torch.ops import losses as plosses
from ngp_tpu_torch.ops import marching as pmarch
from ngp_tpu_torch.ops import occupancy as pocc
from ngp_tpu_torch.ops.composite import density_activation_exp, nerf_training_loss
from ngp_tpu_torch.optim import (
    OptimizerConfig,
    adam_init,
    adam_skip_zero_step,
    adam_step,
    ema_update,
)

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("name", sorted(plosses._LOSSES))
def test_losses_match_jax(name):
    rng = np.random.default_rng(0)
    target = rng.uniform(-1, 2, (64, 3)).astype(np.float32)
    pred = rng.uniform(-1, 2, (64, 3)).astype(np.float32)
    pred[:4] = target[:4] + np.asarray([0.5, 1.0, 1.5], np.float32)  # Huber's kink
    jfn, pfn = jlosses.get_loss(name), plosses.get_loss(name)
    want = np.asarray(jfn(jnp.asarray(target), jnp.asarray(pred)))
    want_g = np.asarray(jax.grad(lambda p: jnp.sum(jfn(jnp.asarray(target), p)))(
        jnp.asarray(pred)))
    p = _t(pred).requires_grad_()
    got = pfn(_t(target), p)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), want_g, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        plosses.get_loss("nope")


def test_density_activation_clamps_its_derivative():
    x = np.asarray([-40.0, -20.0, -15.0, 0.0, 3.0, 15.0, 20.0, 29.0, 40.0], np.float32)
    xt = _t(x).requires_grad_()
    y = density_activation_exp(xt)
    y.sum().backward()
    want_y = np.asarray(jax_density_exp(jnp.asarray(x)))
    want_g = np.asarray(jax.grad(lambda v: jnp.sum(jax_density_exp(v)))(jnp.asarray(x)))
    np.testing.assert_allclose(y.detach().numpy(), want_y, rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), want_g, rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.exp(np.clip(x, -15, 15)), rtol=1e-6)
    assert y[-1] == torch.exp(torch.tensor(30.0))  # forward clamp at e^30


def _loss_inputs(seed=2, N=6, K=10):
    """The inputs of ``tests/test_nerf_ops.py``'s reference-formula oracle."""
    rng = np.random.default_rng(seed)
    raw = rng.normal(0, 1, (N, K, 4)).astype(np.float32)
    raw[..., 3] += 1.0
    raw[0, :3, 3] = -2.0  # negative raw densities for the bootstrap term
    dt = rng.uniform(0.005, 0.02, (N, K)).astype(np.float32)
    t_mid = np.cumsum(dt, 1).astype(np.float32)
    valid = np.ones((N, K), bool)
    valid[1, 7:] = False
    valid[3, :] = False
    complete = np.asarray([True, True, False, True, True, False])
    bg = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    target = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    return raw, dt, t_mid, valid, complete, bg, target


@pytest.mark.parametrize("loss,rgb_act,mean_density,near", [
    ("L2", "Logistic", 1.0, 0.0),  # the oracle's setting
    ("Huber", "Logistic", 0.001, 0.1),  # the main path: bootstrap and near-camera on
    ("Huber", "Exponential", 0.001, 0.05),  # HDR: the rgb output L2 penalty
])
def test_training_loss_and_gradient_match_jax(loss, rgb_act, mean_density, near):
    raw, dt, t_mid, valid, complete, bg, target = _loss_inputs()

    def jloss(r):
        out, aux = jax_training_loss(
            r, jnp.asarray(dt), jnp.asarray(t_mid), jnp.asarray(valid),
            jnp.asarray(complete), jnp.asarray(bg), jnp.asarray(target),
            jlosses.get_loss(loss), rgb_act, "Exponential", jnp.asarray(mean_density),
            depth_sample=jnp.asarray(t_mid), near_distance=near)
        return out, aux

    (want, aux), want_g = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(raw))
    r = _t(raw).requires_grad_()
    out = nerf_training_loss(
        r, _t(dt), _t(t_mid), _t(valid), _t(complete), _t(bg), _t(target),
        plosses.get_loss(loss), rgb_act, "Exponential", torch.tensor(mean_density),
        depth_sample=_t(t_mid), near_distance=near)
    out.loss.backward()
    np.testing.assert_allclose(float(out.loss.detach()), float(want), rtol=1e-6)
    g = np.asarray(want_g)
    np.testing.assert_allclose(r.grad.numpy(), g, rtol=2e-5, atol=2e-5 * np.abs(g).max())
    np.testing.assert_allclose(out.per_ray_loss.numpy(), np.asarray(aux["per_ray_loss"]),
                               rtol=1e-6, atol=1e-7)
    assert int(out.measured_samples) == int(aux["measured_samples"])


def test_compaction_gradients_match_custom_vjps():
    """Autograd of the port's index ops equals the JAX package's custom
    VJPs of ``compact_rows`` / ``expand_rows`` (on the live rows; the JAX
    package pads to the static budget)."""
    rng = np.random.default_rng(3)
    nk, budget = 96, 24
    valid = rng.uniform(size=nk) < 0.4
    x = rng.normal(size=(nk, 3)).astype(np.float32)
    w = rng.normal(size=(3, 2)).astype(np.float32)

    def jf(xj):
        plan = jcompaction.compaction_plan(jnp.asarray(valid), budget)
        y = jnp.tanh(jcompaction.compact_rows(xj, plan) @ jnp.asarray(w))
        return jnp.sum(jcompaction.expand_rows(y, plan) ** 3)

    want = np.asarray(jax.grad(jf)(jnp.asarray(x)))
    xt = _t(x).requires_grad_()
    plan = pcompaction.compaction_plan(_t(valid), budget)
    y = torch.tanh(pcompaction.compact_rows(xt, plan) @ _t(w))
    (pcompaction.expand_rows(y, plan) ** 3).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-5, atol=1e-6)
    assert plan.n_live == budget < valid.sum()  # the budget overflowed


OPT_CFG = {"otype": "Ema", "decay": 0.95, "nested": {
    "otype": "ExponentialDecay", "decay_start": 2, "decay_interval": 3,
    "decay_base": 0.33, "nested": {
        "otype": "Adam", "learning_rate": 1e-2, "beta1": 0.9, "beta2": 0.99,
        "epsilon": 1e-15, "l2_reg": 1e-6}}}


def test_optimizer_matches_jax_on_identical_gradients():
    """Several steps of the engine's stack (``NerfEngine.tx``: dense Adam +
    L2, sparse skip-zero Adam on tables, ExponentialDecay) and
    ``ema_update`` against the port's, fed the same gradients, a quarter of
    the table entries exactly 0 each step."""
    from ngp_tpu.optim import _unwrap_ema, _unwrap_schedule, scale_by_adam_skip_zero
    import optax

    rng = np.random.default_rng(4)
    params = {"table": rng.normal(size=(2, 64, 2)).astype(np.float32),
              "w": rng.normal(size=(8, 4)).astype(np.float32)}
    dense_tx, ema_decay, schedule = make_optimizer(OPT_CFG, grid_label_fn=None)
    inner, _ = _unwrap_schedule(_unwrap_ema(OPT_CFG)[0])
    sparse_tx = optax.chain(scale_by_adam_skip_zero(0.9, 0.99, 1e-15),
                            optax.scale_by_learning_rate(schedule))
    tx = optax.multi_transform({"dense": dense_tx, "grid": sparse_tx},
                               {"table": "grid", "w": "dense"})
    jp = jax.tree.map(jnp.asarray, params)
    jopt, jema = tx.init(jp), ema_init(jp)

    cfg = OptimizerConfig.from_json(OPT_CFG)
    assert cfg.ema_decay == ema_decay == 0.95
    pt = {k: _t(v) for k, v in params.items()}
    pema = {k: v.clone() for k, v in pt.items()}
    sdense, sgrid = adam_init([pt["w"]]), adam_init([pt["table"]])
    for step in range(7):
        grads = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
        grads["table"][rng.uniform(size=grads["table"].shape) < 0.25] = 0.0
        before = pt["table"].clone()
        upd, jopt = tx.update(jax.tree.map(jnp.asarray, grads), jopt, jp)
        jp = optax.apply_updates(jp, upd)
        jema = jax_ema_update(jema, jp, ema_decay, jnp.asarray(step, jnp.int32))
        lr = cfg.schedule(step)
        assert lr == pytest.approx(float(schedule(step)), rel=1e-6)
        adam_step([pt["w"]], [_t(grads["w"])], sdense, lr, cfg.b1, cfg.b2, cfg.eps, cfg.l2_reg)
        adam_skip_zero_step([pt["table"]], [_t(grads["table"])], sgrid, lr,
                            cfg.b1, cfg.b2, cfg.eps)
        ema_update([pema["table"], pema["w"]], [pt["table"], pt["w"]], cfg.ema_decay, step)
        for k in params:
            np.testing.assert_allclose(pt[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(pema[k].numpy(), np.asarray(jema.params[k]),
                                       rtol=1e-6, atol=1e-7)
        zero = torch.from_numpy(grads["table"] == 0.0)
        assert torch.equal(pt["table"][zero], before[zero])
    inner_adam = jopt.inner_states["grid"].inner_state[0]
    np.testing.assert_allclose(sgrid.mu[0].numpy(), np.asarray(inner_adam.mu["table"]),
                               rtol=1e-6, atol=1e-7)
    assert sdense.count == sgrid.count == 7


def test_schedule_and_ema_decay_scalars():
    from ngp_tpu.optim import exponential_decay_schedule as jsched

    from ngp_tpu_torch.optim import ema_decay_at, exponential_decay_schedule

    cfg = {"decay_start": 20000, "decay_interval": 10000, "decay_base": 0.33}
    for step in (0, 19999, 20000, 25000, 45000):
        assert exponential_decay_schedule(cfg, 1e-2)(step) == pytest.approx(
            float(jsched(cfg, 1e-2)(step)), rel=1e-6)
    for step in (0, 1, 5, 100, 10000):
        d = float(jnp.minimum(0.95, (1.0 + jnp.int32(step)) / (10.0 + jnp.int32(step))))
        assert ema_decay_at(0.95, step) == d


def _cfgs(G=8, C=2):
    return jocc.OccupancyGridConfig(G, C, 0.8), pocc.OccupancyGridConfig(G, C, 0.8)


def test_cell_positions_on_jax_draws_exact():
    jcfg, pcfg = _cfgs()
    key = jax.random.PRNGKey(3)
    _, want = jocc.all_cells(jcfg, key)
    jitter = jax.random.uniform(key, (jcfg.n_cascades * jcfg.n_cells, 3))
    np.testing.assert_array_equal(pocc.all_cells(pcfg, _t(jitter)).numpy(),
                                  np.asarray(want))
    for phase in (0, 3):
        want = jocc.stride_cells(jcfg, key, jnp.int32(phase), 8)
        jit = jax.random.uniform(key, (jcfg.n_cascades * jcfg.n_cells // 8, 3))
        np.testing.assert_array_equal(
            pocc.stride_cells(pcfg, _t(jit), phase, 8).numpy(), np.asarray(want))
        vals = np.arange(want.shape[0], dtype=np.float32) + 1.0
        np.testing.assert_array_equal(
            pocc.place_stride(pcfg, _t(vals), phase, 8).numpy(),
            np.asarray(jocc.place_stride(jcfg, jnp.asarray(vals), jnp.int32(phase), 8)))
    with pytest.raises(ValueError):
        pocc.stride_cells(pcfg, _t(jit), 0, 6)


def test_grid_update_transforms_exact():
    jcfg, pcfg = _cfgs()
    rng = np.random.default_rng(6)
    density = rng.uniform(-0.2, 0.05, (2, 8, 8, 8)).astype(np.float32)
    density[density < -0.1] = -1.0  # culled cells keep their marker
    splat = rng.uniform(0, 20, (2, 8, 8, 8)).astype(np.float32)
    splat[splat < 10] = 0.0
    jstate = jocc.OccupancyGridState(jnp.asarray(density), None,
                                     jnp.asarray(0.0), jnp.int32(4))
    want = jocc.update_grid_state_dense(jcfg, jstate, jnp.asarray(splat))
    pstate = pocc.OccupancyGridState(_t(density), None, torch.tensor(0.0), 4)
    got = pocc.update_grid_state_dense(pcfg, pstate, _t(splat))
    np.testing.assert_array_equal(got.density.numpy(), np.asarray(want.density))
    np.testing.assert_array_equal(got.bitfield.numpy(), np.asarray(want.bitfield))
    assert float(got.mean_density) == pytest.approx(float(want.mean_density), rel=1e-6)
    assert got.ema_step == int(want.ema_step) == 5
    np.testing.assert_array_equal(
        pocc.ema_update_density(_t(density), _t(splat), 0.8).numpy(),
        np.asarray(jocc.ema_update_density(jnp.asarray(density), jnp.asarray(splat), 0.8)))


def test_coarse_gate_exact():
    rng = np.random.default_rng(7)
    bits = (rng.uniform(size=(3, 16, 16, 16)) < 0.02).astype(np.uint8)
    for pool in (4, 8):
        np.testing.assert_array_equal(
            pocc.build_coarse_gate(_t(bits), pool).numpy(),
            np.asarray(jocc.build_coarse_gate(jnp.asarray(bits), pool)))


def test_mark_untrained_cells_exact():
    from tests.test_nerf_engine import _make_dataset

    ds = _make_dataset(n_views=5)
    jcfg, pcfg = _cfgs(G=16, C=2)
    xf = ds.xforms[:, 0]
    want = jocc.mark_untrained_cells(jcfg, jnp.zeros((2, 16, 16, 16)), jnp.asarray(xf),
                                     jnp.asarray(ds.focal_lengths),
                                     jnp.asarray(ds.principal_points), ds.resolution,
                                     chunk=4096)
    got = pocc.mark_untrained_cells(pcfg, _t(xf), _t(ds.focal_lengths),
                                    _t(ds.principal_points), ds.resolution, chunk=4096)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() == 0).any() and (got.numpy() == -1).any()


@pytest.mark.parametrize("cone,n_casc", [(0.0, 1), (1.0 / 128, 3)])
def test_gated_march_matches_jax(cone, n_casc):
    """The setting of ``tests/test_nerf_ops.py::test_hierarchical_march_matches_ungated``:
    the gated march with a budget covering every passing segment, with a
    tight budget (overflow drops the deepest segments), in one call and in
    ray chunks (the budget spans the batch), against the JAX package;
    integers exact, t and dt as in the ungated march."""
    rng = np.random.default_rng(5)
    G, N, K = 16, 32, 64
    aabb_scale = 2 ** (n_casc - 1)
    density = rng.uniform(0, 0.02, size=(n_casc, G, G, G)).astype(np.float32)
    bitfield = jocc.build_bitfield(jnp.asarray(density), jnp.asarray(1.0))
    gate = jocc.build_coarse_gate(bitfield)
    stepping = jmarch.SteppingSpace.make(cone)
    half = 0.5 * aabb_scale
    lo, hi = np.full(3, 0.5 - half, np.float32), np.full(3, 0.5 + half, np.float32)
    o = rng.uniform(0.5 - half, 0.5 + half, size=(N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmin, _ = jmarch.ray_aabb_range(jnp.asarray(o), jnp.asarray(d), jnp.asarray(lo),
                                    jnp.asarray(hi))
    n0 = np.asarray(stepping.to_steps(tmin)) + rng.uniform(0, 1, N).astype(np.float32)
    M = -(-(int(math.ceil(stepping.to_steps_scalar(pocc.SQRT3 * aabb_scale))) + 2) // 8) * 8
    pstep = pmarch.SteppingSpace.make(cone)
    pgate = pocc.build_coarse_gate(_t(bitfield))
    for budget in (None, N * (M // 8) - 1, 8, 100):
        want = jax.jit(lambda o, d, n0: jmarch.march_rays(
            o, d, bitfield, jnp.asarray(lo), jnp.asarray(hi), stepping, n0, M, K,
            n_casc - 1, gate=gate, seg_budget=budget))(
                jnp.asarray(o), jnp.asarray(d), jnp.asarray(n0))
        for max_points in (None, 5 * M):
            got = pmarch.march_rays(_t(o), _t(d), _t(bitfield), _t(lo), _t(hi), pstep,
                                    _t(n0), M, K, n_casc - 1, gate=pgate,
                                    seg_budget=budget, max_points=max_points)
            assert int(got.gate_total) == int(want.gate_total) > 0
            for f in ("n_samples", "total", "valid", "complete", "exited"):
                np.testing.assert_array_equal(getattr(got, f).numpy(),
                                              np.asarray(getattr(want, f)), err_msg=f)
            np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=1e-6, atol=1e-7)


def test_error_map_cdfs_and_sampling_match_jax():
    from ngp_tpu.engines.nerf import _build_cdfs, _sample_discrete

    rng = np.random.default_rng(8)
    data = rng.exponential(size=(3, 16, 16)).astype(np.float32)
    data[1] = 0.0
    for got, want in zip(pnerf.build_cdfs(_t(data)), _build_cdfs(jnp.asarray(data))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    cdf = np.sort(rng.uniform(size=(50, 16)).astype(np.float32), axis=1)
    u = rng.uniform(size=50).astype(np.float32)
    np.testing.assert_array_equal(
        pnerf.sample_discrete(_t(cdf), _t(u)).numpy(),
        np.asarray(_sample_discrete(jnp.asarray(cdf), jnp.asarray(u))))

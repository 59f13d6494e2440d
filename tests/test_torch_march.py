"""Parity of the port's occupancy grid, march, compaction and compositing
(``ngp_tpu_torch/ops``) with the JAX package: exact where the outputs are
integers or booleans, float32-tight elsewhere. Cascades > 1 throughout
(aabb_scale 4, three cascades)."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ngp_tpu.ops import compaction as jcomp
from ngp_tpu.ops import composite as jcomposite
from ngp_tpu.ops import marching as jmarch
from ngp_tpu.ops import occupancy as jocc
from ngp_tpu_torch.ops import compaction as pcomp
from ngp_tpu_torch.ops import composite as pcomposite
from ngp_tpu_torch.ops import marching as pmarch
from ngp_tpu_torch.ops import occupancy as pocc

# One intra-op thread: with two, torch's CPU sqrt (MKL's vsSqrt, split across
# the intra-op threads) now and then returned one thread's chunk ~3e-4 off
# on an AVX-512 Xeon (torch 2.13, MKL 2024.2), never with one
# (scripts/torch_sqrt_threads.py counts it).
# Every port test module sets the same count, so that a pytest worker's
# count does not depend on which module it imported last.
torch.set_num_threads(1)

C, G, AABB_SCALE = 3, 64, 4
AABB_MIN = np.full(3, 0.5 - AABB_SCALE / 2, np.float32)
AABB_MAX = np.full(3, 0.5 + AABB_SCALE / 2, np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _density(seed, occupied=0.3):
    rng = np.random.default_rng(seed)
    d = rng.exponential(0.05, (C, G, G, G)).astype(np.float32)
    d[rng.uniform(size=d.shape) > occupied] = 0.0
    d[rng.uniform(size=d.shape) < 0.02] = -1.0  # culled cells
    return d


@pytest.mark.parametrize("mean", [0.004, 0.5])  # threshold = mean, = 0.01
def test_build_bitfield_exact(mean):
    d = _density(0)
    m = np.float32(mean)
    want = np.asarray(jocc.build_bitfield(jnp.asarray(d), jnp.asarray(m)))
    got = pocc.build_bitfield(_t(d), _t(m)).numpy()
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert 0 < got.mean() < 1


def test_mips_and_occupied_at_exact():
    rng = np.random.default_rng(1)
    bitfield = np.asarray(jocc.build_bitfield(jnp.asarray(_density(2)),
                                              jnp.asarray(np.float32(0.01))))
    n = 50_000
    pos = rng.uniform(-2.0, 3.0, (n, 3)).astype(np.float32)
    pos[:1000] = np.round(pos[:1000] * 16) / 16  # exactly on cell faces
    dt = np.exp(rng.uniform(-9.0, 0.0, n)).astype(np.float32)
    np.testing.assert_array_equal(
        pocc.mip_from_pos(_t(pos), C - 1).numpy(),
        np.asarray(jocc.mip_from_pos(jnp.asarray(pos), C - 1)))
    mip_j = jocc.mip_from_dt(jnp.asarray(dt), jnp.asarray(pos), C - 1, G)
    mip_p = pocc.mip_from_dt(_t(dt), _t(pos), C - 1, G)
    np.testing.assert_array_equal(mip_p.numpy(), np.asarray(mip_j))
    assert len(np.unique(np.asarray(mip_j))) == C
    want = np.asarray(jocc.occupied_at(jnp.asarray(bitfield), jnp.asarray(pos), mip_j))
    got = pocc.occupied_at(_t(bitfield), _t(pos), mip_p).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.05 < want.mean() < 0.9


def _rays(n, seed):
    """Rays from a sphere of radius 3.5 around the scene center (outside
    the box) toward random points inside it, plus a quarter starting inside."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    o = 0.5 + 3.5 * v / np.linalg.norm(v, axis=-1, keepdims=True)
    o[: n // 4] = rng.uniform(-1.0, 2.0, (n // 4, 3))
    target = rng.uniform(-1.0, 2.0, (n, 3))
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _stepping_and_lattice(cone_angle, n_steps_per_unit):
    min_step = jocc.SQRT3 / n_steps_per_unit
    max_step = min_step * (1 << (jocc.NERF_CASCADES - 1)) * n_steps_per_unit / G
    js = jmarch.SteppingSpace.make(cone_angle, min_step, max_step)
    ps = pmarch.SteppingSpace.make(cone_angle, min_step, max_step)
    assert tuple(js) == tuple(ps)
    span = js.to_steps_scalar(jocc.SQRT3 * AABB_SCALE) - js.to_steps_scalar(0.0)
    return js, ps, min(-(-(int(math.ceil(span)) + 2) // 8) * 8, 2048)


@pytest.mark.parametrize("cone_angle,n_steps_per_unit", [(0.0, 64), (1 / 256, 1024)])
def test_march_rays_matches_jax(cone_angle, n_steps_per_unit):
    """Integer outputs exact; t to 1e-6. With a cone angle the lattice
    goes through float32 exp, whose last bit can differ between the two
    libraries: t then differs by up to one ulp, and dt, a difference of two
    lattice t's, by up to two ulps of t. These rays cross no cell or mip
    boundary within that bit, so the integer outputs still agree exactly."""
    js, ps, M = _stepping_and_lattice(cone_angle, n_steps_per_unit)
    K = 64
    bitfield = np.asarray(jocc.build_bitfield(jnp.asarray(_density(3, 0.1)),
                                              jnp.asarray(np.float32(0.01))))
    o, d = _rays(512, 4)
    tmin, _ = jmarch.ray_aabb_range(jnp.asarray(o), jnp.asarray(d),
                                    jnp.asarray(AABB_MIN), jnp.asarray(AABB_MAX))
    tmin_p, _ = pmarch.ray_aabb_range(_t(o), _t(d), _t(AABB_MIN), _t(AABB_MAX))
    np.testing.assert_array_equal(tmin_p.numpy(), np.asarray(tmin))
    n0 = np.asarray(js.to_steps(tmin + 1e-4))
    want = jmarch.march_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(bitfield),
                             jnp.asarray(AABB_MIN), jnp.asarray(AABB_MAX), js,
                             jnp.asarray(n0), M, K, C - 1)
    got = pmarch.march_rays(_t(o), _t(d), _t(bitfield), _t(AABB_MIN),
                            _t(AABB_MAX), ps, _t(n0), M, K, C - 1)
    for name in ("valid", "n_samples", "total", "complete", "exited"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    t = np.asarray(want.t)
    np.testing.assert_allclose(got.t.numpy(), t, rtol=1e-6, atol=1e-6)
    assert (np.abs(got.dt.numpy() - np.asarray(want.dt)) <= 2 * np.spacing(t)).all()
    total = np.asarray(want.total)
    assert (total > K).any() and (total == 0).any() and (total > 0).mean() > 0.3


def test_compaction_plan_exact():
    rng = np.random.default_rng(5)
    valid = rng.uniform(size=16 * 300) < 0.4
    budget = 1024
    jplan = jcomp.compaction_plan(jnp.asarray(valid), budget)
    plan = pcomp.compaction_plan(_t(valid), budget)
    assert plan.n_valid == int(jplan.n_valid) > budget
    assert plan.n_live == budget
    np.testing.assert_array_equal(plan.cidx.numpy(), np.asarray(jplan.cidx)[:budget])
    np.testing.assert_array_equal(plan.keep.numpy(), np.asarray(jplan.keep))
    x = rng.normal(size=(valid.size, 4)).astype(np.float32)
    xc = pcomp.compact_rows(_t(x), plan)
    np.testing.assert_array_equal(
        xc.numpy(), np.asarray(jcomp.compact_rows(jnp.asarray(x), jplan))[:budget])
    np.testing.assert_array_equal(
        pcomp.expand_rows(xc, plan).numpy(),
        np.asarray(jcomp.expand_rows(jnp.asarray(xc.numpy()), jplan)))
    small = pcomp.compaction_plan(_t(valid), 1 << 16)  # budget not reached
    assert small.n_live == small.n_valid and bool((small.keep == _t(valid)).all())


def test_composite_matches_jax():
    rng = np.random.default_rng(6)
    N, K = 256, 48
    rgb = rng.uniform(size=(N, K, 3)).astype(np.float32)
    sigma = np.exp(rng.normal(0.0, 3.0, (N, K))).astype(np.float32)
    dt = rng.uniform(0.001, 0.05, (N, K)).astype(np.float32)
    t = np.cumsum(dt, axis=1).astype(np.float32)
    valid = rng.uniform(size=(N, K)) < 0.7
    for mt in (1e-4, 0.01):
        want = jcomposite.composite(*(jnp.asarray(a) for a in (rgb, sigma, dt, t, valid)), mt)
        got = pcomposite.composite(*(_t(a) for a in (rgb, sigma, dt, t, valid)), mt)
        for name in want._fields:
            np.testing.assert_allclose(
                getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                rtol=1e-6, atol=1e-6, err_msg=name)
    x = rng.normal(0.0, 20.0, 1000).astype(np.float32)
    for name in ("exponential", "logistic", "relu", "none"):
        np.testing.assert_allclose(
            pcomposite.density_activation(name)(_t(x)).numpy(),
            np.asarray(jcomposite.density_activation(name)(jnp.asarray(x))), rtol=1e-6)
        np.testing.assert_allclose(
            pcomposite.rgb_activation(name)(_t(x)).numpy(),
            np.asarray(jcomposite.rgb_activation(name)(jnp.asarray(x))), rtol=1e-6)


def test_render_budget_overflow_drops_samples_without_density():
    """Fault C1 of the JAX package (ROADMAP.md): ``_eval_marched`` masks
    ``valid`` to the compaction budget only on a local copy
    (``ngp_tpu/engines/nerf.py:1403``), and ``_render_chunk`` composites
    with the unmasked ``marched`` (``:1631`` → ``_finish_shade`` ``:1466``):
    every sample dropped by the budget comes back with raw output 0 and
    composites with density exp(0) = 1, as fog. The port hands the
    compaction-masked ``valid`` to compositing, so dropped samples add
    nothing; on the kept samples both packages agree."""
    from golden.make_golden import build_engine
    from test_torch_render import GOLDEN_INGP, port_golden_engine

    jeng = build_engine()
    jstate, jgrid = jeng.load_reference_snapshot(GOLDEN_INGP)
    jparams = jeng.inference_params(jstate)
    peng = port_golden_engine()
    pstate, pgrid = peng.load_reference_snapshot(GOLDEN_INGP)

    o_t, d_t, _ = peng.view_rays(0)  # 48×48 rays
    o, d = jnp.asarray(o_t.numpy()), jnp.asarray(d_t.numpy())
    tmin, tmax = jmarch.ray_aabb_range(o, d, jeng.aabb.min, jeng.aabb.max)
    marched = jmarch.march_rays(
        o, d, jgrid.bitfield, jeng.aabb.min, jeng.aabb.max, jeng.stepping,
        jeng.stepping.to_steps(tmin + 1e-4), jeng.n_lattice,
        jeng.n_render_samples, jeng.grid_cfg.max_mip)
    frac = 0.01
    rgb_j, sigma_j = jeng._eval_marched(jparams, o, d, marched, frac)
    marched_t = pmarch.MarchedRays(*(_t(a) for a in marched[:7]))
    with torch.no_grad():
        rgb_p, sigma_p, marched_p = peng._eval_marched(
            pstate.model, o_t, d_t, marched_t, frac)

    keep = marched_p.valid.numpy()
    valid = np.asarray(marched.valid)
    N, K = valid.shape
    budget = -(-int(N * K * frac) // 1024) * 1024
    assert keep.sum() == budget < valid.sum()  # the budget overflowed
    assert not (keep & ~valid).any()
    # per sample, the network bound of test_torch_network.py (a hidden
    # unit's bf16 rounding can flip); composited, the golden render's bound
    np.testing.assert_allclose(rgb_p.numpy()[keep], np.asarray(rgb_j)[keep],
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(sigma_p.numpy()[keep], np.asarray(sigma_j)[keep],
                               rtol=1e-3, atol=1e-3)

    masked_j = marched._replace(valid=jnp.asarray(keep))
    for mode in ("shade", "depth", "ao"):
        want = jeng._finish_shade(jparams, d, masked_j, rgb_j, sigma_j, mode, None)
        got = peng._finish_shade(d_t, marched_p, rgb_p, sigma_p, mode)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4, atol=2e-4)

    # the JAX package's render of the same chunk: dropped samples as fog
    _, _, opacity_c1 = jeng._finish_shade(jparams, d, marched, rgb_j, sigma_j,
                                          "shade", None)
    _, _, opacity = peng._finish_shade(d_t, marched_p, rgb_p, sigma_p, "shade")
    dropped = (valid & ~keep).any(axis=1)
    gap = np.asarray(opacity_c1) - opacity.numpy()
    assert dropped.sum() > 100
    assert (gap[dropped] > 1e-3).mean() > 0.9
    np.testing.assert_allclose(gap[~dropped], 0.0, atol=1e-5)

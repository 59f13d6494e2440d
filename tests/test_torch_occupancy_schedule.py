"""The occupancy schedule and the geometry-seeded priors of the port
(``ngp_tpu_torch/ops/occupancy.py``, ``engines/nerf.py``, ``testbed.py``)
against the JAX package on the CPU, at small sizes (grids of 16–32 cells a
side, the 4-level 2^12 grid of ``tests/test_torch_train_step.py``).

Exact: the probe-sampled cells fed the JAX draws (``jax.random`` keys
split as ``sample_update_cells`` splits them), both seeding functions,
``load_xyz``, ``init_grid`` with a prior and with ``fork_grid_init``, the
Testbed's ``.obj`` and ``.xyz`` priors, and the loop's sequence of updates
and decays.

The max-splat: the port's atomic max equals numpy's ``maximum.at`` bit for
bit. The JAX ``splat_max`` (``dense_segment_max``) takes each cell's
maximum as the difference of two entries of a float32 prefix sum over
every cell's head, so a cell is off by up to a few 2^-24 of the splat's
total (2.4 on uniform values over five seeds, 4.4 on a probe-sampled
update's densities; some empty cells come out negative): the
port is held to it within ``SPLAT_ULPS``·2^-24 of that total (ROADMAP C.ref
12), and so is every grid update that splats. One probe-sampled
``update_grid`` from the same weights and draws: the densities within the
networks' float32 difference besides.
"""

import copy
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ngp_tpu.engines.nerf import NerfEngine as JaxNerfEngine
from ngp_tpu.ops import occupancy as jocc
from ngp_tpu_torch.engines.nerf import NerfEngine
from ngp_tpu_torch.interop import load_jax_train_state
from ngp_tpu_torch.ops import occupancy as pocc
from tests.test_nerf_engine import _make_dataset
from tests.test_torch_train_step import (
    ENGINE,
    SMALL,
    _port_dataset,
    _port_grid,
    _t,
    jax_state_tree,
)

# One intra-op thread, as in every port test module (see
# tests/test_torch_train_step.py).
torch.set_num_threads(1)


def _grid_values(cfg, seed: int) -> np.ndarray:
    """A (C, G, G, G) density with culled (−1), empty (0), faint (below
    0.01) and occupied cells, from a numpy seed."""
    rng = np.random.default_rng(seed)
    shape = (cfg.n_cascades, cfg.grid_size, cfg.grid_size, cfg.grid_size)
    u = rng.uniform(size=shape)
    vals = rng.uniform(0.0, 0.5, shape)
    return np.where(u < 0.3, -1.0, np.where(u < 0.5, 0.0, np.where(
        u < 0.7, vals * 0.01, vals))).astype(np.float32)


def _jax_draws(cfg, key, n: int):
    """The draws of ``jocc.sample_update_cells`` for ``key``: its split into
    four keys, the cascade, the probes and the jitter."""
    k1, k2, k3, _ = jax.random.split(key, 4)
    mip = jax.random.randint(k1, (n,), 0, cfg.n_cascades)
    probes = jax.random.randint(k2, (n, 10), 0, cfg.n_cells)
    jitter = jax.random.uniform(k3, (n, 3))
    return _t(mip), _t(probes), _t(jitter)


# the JAX splat's bound: this many 2^-24 of the splat's total (its prefix
# sum's rounding; 2.4 and 4.4 measured)
SPLAT_ULPS = 8.0


def _splat_bound(splat) -> float:
    return SPLAT_ULPS * 2.0 ** -24 * float(np.asarray(splat, np.float64).sum())


@pytest.mark.parametrize("seed", [0, 1])
def test_splat_max_is_exact_and_within_the_jax_prefix_sums_bound(seed):
    """Repeated cells keep their largest value and untouched cells stay 0,
    bit for bit with numpy's ``maximum.at``; the JAX splat within
    ``SPLAT_ULPS``·2^-24 of the total."""
    cfg = jocc.OccupancyGridConfig(grid_size=16, n_cascades=2)
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 2 * cfg.n_cells, 20000).astype(np.int32)
    vals = rng.uniform(0.0, 3.0, 20000).astype(np.float32)
    exact = np.zeros(2 * cfg.n_cells, np.float32)
    np.maximum.at(exact, idx, vals)
    got = pocc.splat_max(pocc.OccupancyGridConfig(16, 2), torch.from_numpy(idx),
                         torch.from_numpy(vals))
    np.testing.assert_array_equal(got.numpy().reshape(-1), exact)
    want = np.asarray(jocc.splat_max(cfg, jnp.asarray(idx), jnp.asarray(vals)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=_splat_bound(exact))


@pytest.mark.parametrize("n_cascades", [1, 3])
def test_sample_update_cells_matches_jax_on_its_draws(n_cascades):
    """The cells and jittered positions, exactly."""
    jcfg = jocc.OccupancyGridConfig(grid_size=16, n_cascades=n_cascades)
    pcfg = pocc.OccupancyGridConfig(16, n_cascades)
    density = _grid_values(jcfg, n_cascades)
    key = jax.random.PRNGKey(7)
    n_u, n_n = 3000, 2000
    want_idx, want_pos = jocc.sample_update_cells(jcfg, key, jnp.asarray(density), n_u, n_n)
    mip, probes, jitter = _jax_draws(jcfg, key, n_u + n_n)
    idx, pos = pocc.sample_update_cells(pcfg, torch.from_numpy(density), n_u, n_n,
                                        mip, probes, jitter)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want_pos))
    # the nonuniform samples land on occupied cells wherever a probe found one
    flat = density.reshape(-1)
    assert (flat[idx.numpy()[:n_u]] > -0.01).mean() > 0.99
    assert (flat[idx.numpy()[n_u:]] > 0.01).mean() > 0.9


def test_sample_update_cells_draws_from_the_generator():
    """Without draws the cells come from the generator: the same seed gives
    the same cells, another seed others."""
    cfg = pocc.OccupancyGridConfig(16, 2)
    density = torch.from_numpy(_grid_values(cfg, 1))
    a = pocc.sample_update_cells(cfg, density, 100, 100,
                                 generator=torch.Generator().manual_seed(1))
    b = pocc.sample_update_cells(cfg, density, 100, 100,
                                 generator=torch.Generator().manual_seed(1))
    c = pocc.sample_update_cells(cfg, density, 100, 100,
                                 generator=torch.Generator().manual_seed(2))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])


def test_update_grid_state_matches_jax():
    """Given the cells and densities: the grid (×MIN_CONE_STEPSIZE, max
    splat, EMA, culled cells kept) exactly against the EMA of numpy's
    ``maximum.at``, and within the JAX splat's bound of the JAX grid; the
    mean within 1e-6 (float32 sums in another order; above 0.01 here, so
    the threshold is exactly 0.01); the bitfield exactly at every cell not
    within that bound of it; the update count."""
    jcfg = jocc.OccupancyGridConfig(grid_size=16, n_cascades=2, decay=0.95)
    pcfg = pocc.OccupancyGridConfig(16, 2, 0.95)
    density = _grid_values(jcfg, 3)
    bitfield = np.zeros_like(density, np.uint8)
    rng = np.random.default_rng(4)
    idx = rng.integers(0, 2 * jcfg.n_cells, 6000).astype(np.int32)
    sigma = rng.uniform(0.0, 400.0, 6000).astype(np.float32)
    jstate = jocc.OccupancyGridState(jnp.asarray(density), jnp.asarray(bitfield),
                                     jnp.float32(0.0), jnp.int32(5))
    want = jocc.update_grid_state(jcfg, jstate, jnp.asarray(idx), jnp.asarray(sigma))
    got = pocc.update_grid_state(pcfg, pocc.OccupancyGridState(
        torch.from_numpy(density), torch.from_numpy(bitfield), torch.tensor(0.0), 5),
        torch.from_numpy(idx), torch.from_numpy(sigma))
    splat = np.zeros(2 * jcfg.n_cells, np.float32)
    np.maximum.at(splat, idx, sigma * np.float32(pocc.MIN_CONE_STEPSIZE))
    exact = pocc.ema_update_density(torch.from_numpy(density),
                                    torch.from_numpy(splat.reshape(density.shape)), 0.95)
    np.testing.assert_array_equal(got.density.numpy(), exact.numpy())
    bound = _splat_bound(splat)
    np.testing.assert_allclose(got.density.numpy(), np.asarray(want.density), rtol=0,
                               atol=bound)
    assert float(want.mean_density) > 0.01
    assert float(got.mean_density) == pytest.approx(float(want.mean_density), rel=1e-6)
    clear = np.abs(np.asarray(want.density) - 0.01) > bound
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(got.bitfield.numpy()[clear], np.asarray(want.bitfield)[clear])
    assert got.ema_step == int(want.ema_step) == 6
    assert (got.density.numpy()[density < 0] == -1.0).all()


def _random_mesh(seed: int) -> np.ndarray:
    """Triangles (T, 3, 3) in and around [0, 1]³: small ones near the
    centre, long ones across it (n_sub up to the 256 cap at G = 32), and
    some outside every cascade, from a numpy seed."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(0.2, 0.8, (300, 1, 3))
    small = centres + rng.normal(0, 0.02, (300, 3, 3))
    large = rng.uniform(-1.5, 2.5, (20, 3, 3))
    return np.concatenate([small, large]).astype(np.float32)


@pytest.mark.parametrize("n_cascades", [1, 3])
def test_seed_grid_from_mesh_matches_jax(n_cascades):
    """Exactly, cell for cell."""
    tris = _random_mesh(n_cascades)
    jcfg = jocc.OccupancyGridConfig(grid_size=32, n_cascades=n_cascades)
    want = jocc.seed_grid_from_mesh(jcfg, tris)
    got = pocc.seed_grid_from_mesh(pocc.OccupancyGridConfig(32, n_cascades), tris)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert 0 < (got == 0).sum() < got.size


@pytest.mark.parametrize("dilation", [1, 2])
@pytest.mark.parametrize("planes", [True, False])
def test_seed_grid_from_point_cloud_matches_jax(dilation, planes):
    """Exactly, with and without the ground and sky planes, at dilations
    1 and 2; points on cell boundaries and outside the box included."""
    rng = np.random.default_rng(dilation)
    pts = np.concatenate([rng.uniform(-1.0, 2.0, (2000, 3)),
                          rng.integers(0, 33, (200, 3)) / 32.0]).astype(np.float32)
    jcfg = jocc.OccupancyGridConfig(grid_size=32, n_cascades=2)
    want = jocc.seed_grid_from_point_cloud(jcfg, pts, dilation, planes)
    got = pocc.seed_grid_from_point_cloud(pocc.OccupancyGridConfig(32, 2), pts, dilation,
                                          planes)
    np.testing.assert_array_equal(got, want)


def test_load_xyz_matches_jax(tmp_path):
    """Comments, short and bad lines skipped, extra columns dropped."""
    from ngp_tpu.geometry.mesh import load_xyz as jload
    from ngp_tpu_torch.geometry.mesh import load_xyz as pload

    p = tmp_path / "pc.xyz"
    p.write_text("# comment\n1.0 2.0 3.0 255 0 0\n4 5 6\nbad line\n1 2\n"
                 "nan x 3\n-0.125 1e-3 7.5e2\n\n")
    got, want = pload(str(p)), jload(str(p))
    assert got.dtype == np.float32 and got.shape == (3, 3)
    np.testing.assert_array_equal(got, want)
    (tmp_path / "empty.xyz").write_text("# nothing\n")
    assert pload(str(tmp_path / "empty.xyz")).shape == (0, 3)


def _engine_pair(n_views: int = 4, **kw):
    ds = _make_dataset(n_views=n_views)
    jeng = JaxNerfEngine(copy.deepcopy(SMALL), ds, **{**ENGINE, **kw})
    peng = NerfEngine(copy.deepcopy(SMALL), _port_dataset(ds), device="cpu",
                      **{**ENGINE, **kw})
    return jeng, peng


@pytest.mark.parametrize("fork", [False, True])
def test_init_grid_with_prior_and_fork_start_matches_jax(fork):
    """``init_grid(precomputed_density=)`` (the prior's −1 cells culled
    besides the frustum's) and ``fork_grid_init`` (visible cells at 1.0):
    density, mean and bitfield exactly; a prior of another shape raises."""
    jeng, peng = _engine_pair(fork_grid_init=fork)
    rng = np.random.default_rng(5)
    prior = pocc.seed_grid_from_point_cloud(peng.grid_cfg, rng.uniform(0.3, 0.7, (300, 3)),
                                            mark_ground_sky=False)
    for pre in (None, prior):
        jg = jeng.init_grid(precomputed_density=pre)
        pg = peng.init_grid(precomputed_density=pre)
        np.testing.assert_array_equal(pg.density.numpy(), np.asarray(jg.density))
        np.testing.assert_array_equal(pg.bitfield.numpy(), np.asarray(jg.bitfield))
        assert float(pg.mean_density) == float(jg.mean_density)
    assert (pg.density.numpy()[prior < 0] == -1.0).all()
    assert set(np.unique(pg.density.numpy())) == {-1.0, 1.0 if fork else 0.0}
    with pytest.raises(ValueError, match="precomputed density shape"):
        peng.init_grid(precomputed_density=prior[:, :8])


@pytest.mark.parametrize("strides", [0, 3, 8])
def test_grid_update_strides_matches_jax(strides):
    """The round-robin period: ``grid_update_strides``, else 2·C, at least
    4, rounded up to a power of two."""
    jeng, peng = _engine_pair(grid_update_strides=strides)
    assert peng._grid_strides == jeng._grid_strides


def _record_jax_events(jeng, n_steps: int) -> list:
    """The JAX loop's occupancy passes over ``n_steps`` steps from step 0,
    with the step itself, the update and the decay replaced by recorders."""
    events, steps = [], []

    def update(state, grid, key, warmup):
        events.append((len(steps), "warmup" if warmup else "update"))
        return grid

    def decay(grid):
        events.append((len(steps), "decay"))
        return grid

    def step(state, grid, emap, key):
        steps.append(len(steps))
        return state, emap, {}

    jeng.update_grid, jeng.decay_grid, jeng.train_step = update, decay, step
    jeng._process_window = lambda *a, **k: None

    class State:
        step = 0

    jeng.train(State(), None, n_steps)
    return events


def _record_port_events(peng, n_steps: int) -> list:
    """The port loop's passes, recorded the same way."""
    events, steps = [], []

    def update(state, grid, warmup, **kw):
        events.append((len(steps), "warmup" if warmup else "update"))
        return grid

    def decay(grid):
        events.append((len(steps), "decay"))
        return grid

    def step(state, grid, emap):
        steps.append(len(steps))
        return emap, {"loss": 0.0, "measured_samples": 1.0, "mean_total": 1.0}

    peng.update_grid, peng.decay_grid, peng.train_step = update, decay, step
    peng._process_window = lambda *a, **k: None
    peng.train(peng.init_state(), None, n_steps)
    return events


@pytest.mark.parametrize("kw", [
    {}, {"reference_prep_cadence": False},
    {"reference_prep_cadence": False, "grid_update_interval": 10, "grid_decay_interval": 3,
     "warmup_all_cells_steps": 50},
], ids=["reference", "decoupled", "decoupled_custom"])
def test_event_sequence_matches_the_jax_loop(kw):
    """Over steps 0–299: the same passes before the same steps, and
    ``grid_event`` names each."""
    jeng, peng = _engine_pair(n_views=2, **kw)
    want = _record_jax_events(jeng, 300)
    got = _record_port_events(peng, 300)
    assert got == want
    assert [(s, peng.grid_event(s)) for s in range(300) if peng.grid_event(s)] == want
    kinds = {k for _, k in want}
    assert kinds == ({"warmup", "update"} if not kw else {"warmup", "update", "decay"})


@pytest.mark.parametrize("cadence", [True, False])
def test_probe_sampled_update_grid_matches_jax_on_its_draws(cadence):
    """One probe-sampled update (``grid_stride_update=False``; G³/4 cells
    of each kind under the reference cadence, G³/8 otherwise) from the same
    weights, grid and draws: the densities within the networks' float32
    difference (rtol 1e-6) plus the JAX splat's bound (atol), every culled
    cell exactly, the bitfield wherever a cell is not within that of the
    threshold, the update count."""
    jeng, peng = _engine_pair(n_views=4, grid_stride_update=False,
                              reference_prep_cadence=cadence, grid_size=16)
    jstate = jeng.init_state()
    params = jax.tree.map(lambda x: x, jstate.params)
    params["model"]["pos_encoding"] = {"table": params["model"]["pos_encoding"]["table"] * 3e3}
    jstate = jstate._replace(params=params, ema=jstate.ema._replace(params=params))
    jgrid = jeng.update_grid(jstate, jeng.init_grid(), jax.random.PRNGKey(1), warmup=True)
    key = jax.random.PRNGKey(9)
    cfg = jeng.grid_cfg
    n_part = cfg.n_cells // (4 if cadence else 8) * cfg.n_cascades
    want = jax.jit(jeng._update_grid, static_argnames="warmup")(
        jstate.params, jgrid, key, warmup=False)
    mip, probes, jitter = _jax_draws(cfg, key, 2 * n_part)
    state = load_jax_train_state(peng._new_network(), jax_state_tree(jeng, jstate))
    got = peng.update_grid(state, _port_grid(jgrid), False, jitter=jitter, mip=mip,
                           probes=probes)
    idx, pos = pocc.sample_update_cells(peng.grid_cfg, _t(jgrid.density), n_part, n_part,
                                        mip, probes, jitter)
    sigma = torch.exp(peng.chunked_density(state.model, peng.aabb.relative_pos(pos)))
    bound = _splat_bound(pocc.splat_max(peng.grid_cfg, idx, sigma * pocc.MIN_CONE_STEPSIZE))
    wd = np.asarray(want.density)
    np.testing.assert_allclose(got.density.numpy(), wd, rtol=1e-6, atol=bound)
    old = np.asarray(jgrid.density)
    np.testing.assert_array_equal(got.density.numpy()[old < 0], -1.0)
    assert (got.density.numpy() > old * np.float32(cfg.decay)).sum() > 100
    thresh = min(0.01, float(want.mean_density))
    clear = np.abs(wd - thresh) > bound + 1e-6 * thresh
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got.bitfield.numpy()[clear],
                                  np.asarray(want.bitfield)[clear])
    assert got.ema_step == int(want.ema_step)


def test_decoupled_probe_sampled_training_runs():
    """A few steps of the decoupled schedule with probe-sampled updates
    from the engine's own generator: finite loss, one grid pass counted
    for each event (``ema_step``), culled cells kept."""
    ds = _port_dataset(_make_dataset(n_views=4))
    eng = NerfEngine(copy.deepcopy(SMALL), ds, device="cpu", reference_prep_cadence=False,
                     grid_stride_update=False, grid_update_interval=4,
                     grid_decay_interval=2, warmup_all_cells_steps=4, **ENGINE)
    state, grid0 = eng.init_state(), eng.init_grid()
    state, grid, m = eng.train(state, grid0, 9)
    assert np.isfinite(float(m["loss"]))
    events = [eng.grid_event(s) for s in range(9)]
    assert events == ["warmup", None, "decay", None, "update", None, "decay", None, "update"]
    assert grid.ema_step == 5
    assert (grid.density[grid0.density < 0] == -1.0).all()


# -- the Testbed's priors


@pytest.fixture(scope="module")
def prior_captures(tmp_path_factory):
    """A written 32² capture in two directories, one with the sphere's
    ``.obj`` beside it and one with its ``.xyz`` (``data/synthetic.py``),
    and a small network file."""
    import json
    import shutil

    from ngp_tpu_torch.data.synthetic import write_sphere_capture, write_sphere_prior
    from tests.test_torch_testbed import SMALL_CHILD, SMALL_PARENT

    root = tmp_path_factory.mktemp("prior")
    train_json, _ = write_sphere_capture(str(root / "mesh"), res=32)
    shutil.copytree(root / "mesh", root / "cloud")
    write_sphere_prior(str(root / "mesh"), "obj", subdivisions=3)
    write_sphere_prior(str(root / "cloud"), "xyz", n_points=3000)
    (root / "parent.json").write_text(json.dumps(SMALL_PARENT))
    (root / "net.json").write_text(SMALL_CHILD)
    return root


@pytest.mark.parametrize("kind", ["mesh", "cloud"])
def test_testbed_geometry_prior_matches_jax(prior_captures, kind):
    """The seeded grid of the port's ``Testbed`` equals the JAX Testbed's
    exactly (density and bitfield), culls more than the frustum alone, and
    is seeded again when the network config is reloaded."""
    from ngp_tpu.testbed import Testbed as JaxTestbed
    from ngp_tpu_torch.testbed import Testbed

    scene = str(prior_captures / kind / "transforms_train.json")
    net = str(prior_captures / "net.json")
    kw = dict(grid_size=32, batch_size=1 << 12, seed=3)
    ptb = Testbed(scene=scene, config=net, device="cpu", **kw)
    jtb = JaxTestbed(scene=scene, config=net, **kw)
    np.testing.assert_array_equal(ptb.grid.density.numpy(), np.asarray(jtb.grid.density))
    np.testing.assert_array_equal(ptb.grid.bitfield.numpy(), np.asarray(jtb.grid.bitfield))
    plain = ptb.engine.init_grid()
    culled, culled_plain = (ptb.grid.density < 0).sum(), (plain.density < 0).sum()
    assert culled > culled_plain and (ptb.grid.density[plain.density < 0] == -1).all()
    # the sphere's surface (radius 0.25 about the centre) stays trainable
    G = 32
    c = np.floor((np.asarray([0.5, 0.5, 0.75]) - 0.5 + 0.5) * G).astype(int)
    assert float(ptb.grid.density[0, c[0], c[1], c[2]]) == 0.0
    ptb.reload_network_from_json(net)
    np.testing.assert_array_equal(ptb.grid.density.numpy(), np.asarray(jtb.grid.density))
    assert os.path.exists(os.path.join(os.path.dirname(scene), kind + (
        ".obj" if kind == "mesh" else ".xyz")))

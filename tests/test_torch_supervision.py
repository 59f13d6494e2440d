"""Latents, environment maps, depth supervision and supplied rays in the port
(``ngp_tpu_torch/engines/nerf.py``) against the JAX package's
``NerfEngine``, on the CPU at the small size of
``tests/test_torch_train_step.py`` (L=4, T=2^12, 32-wide MLPs, grid 16³,
2^12 sample slots) on the sphere of ``tests/test_nerf_engine.py``. Inputs
(depth maps, supplied rays, envmaps, gradients, moments) come from numpy
seeds. Tolerances, those of ``tests/test_torch_camera.py``:

- one step on the JAX engine's injected batch, on a grid occupied in a
  ball, so that rays that miss it complete and see the background (the
  JAX step run eagerly: under jit XLA contracts o + d·t, and a sample
  whose position then crosses a cell boundary of the finest level moves
  that level's table gradient by up to 6% of its largest entry with
  supplied rays): loss 1e-4 relative; the
  MLP gradients 2e-2 of each matrix's largest entry; the table gradient
  2^-6 of each level's largest; the latents' gradient 2e-2 of its largest
  entry (it passes the bf16-rounded rgb MLP backward); the envmap's 1e-3
  of its largest (it reaches no MLP backward: the transmittance and the
  mix);
- one optimizer update from the JAX engine's gradients: the envmap, the
  latents, their EMA and their moments within 1e-6 relative;
- the supplied rays' batch (origins, directions, march starts, depth
  targets) from the JAX batch's pixels and jitter: 1e-6.

With extrinsic, focal or distortion refinement the JAX engine rebuilds
every training ray from the poses and drops a dataset's supplied rays
(ROADMAP C.ref 11): the port refuses that combination, and
``test_supplied_rays_with_ray_refinement_are_refused_where_the_jax_engine_drops_them``
keeps it out of parity.
"""

import copy
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ngp_tpu.engines.nerf import NerfEngine as JaxNerfEngine
from ngp_tpu_torch.engines.nerf import NerfEngine, RayBatch
from ngp_tpu_torch.interop import export_jax_train_state, load_jax_train_state
from ngp_tpu_torch.ops.marching import ray_aabb_range
from ngp_tpu_torch.train import CameraParams
from tests.test_nerf_engine import FOCAL, RES, _make_dataset
from tests.test_torch_camera import (
    _assert_grads_match,
    _port_grid,
    _t,
    _tree_get,
    jax_camera_state_tree,
)
from tests.test_torch_envmap import port_dataset
from tests.test_torch_train_step import ENGINE, SMALL

# One intra-op thread, as in every port test module (see
# tests/test_torch_train_step.py).
torch.set_num_threads(1)

ENVMAP_RES = (8, 16)


def _depths(ds, seed: int = 0) -> np.ndarray:
    """Seeded z-depths in [0.2, 1.4], a quarter of the pixels without one."""
    rng = np.random.default_rng(seed)
    shape = ds.images.shape[:3]
    z = rng.uniform(0.2, 1.4, shape).astype(np.float32)
    return np.where(rng.uniform(size=shape) < 0.25, 0.0, z).astype(np.float32)


def _rays(ds, seed: int = 1) -> np.ndarray:
    """Supplied rays (I, H, W, 6) in NGP space: each view's pinhole rays at
    the pixel centres, origins moved by up to 1e-3 and directions turned by
    about 0.01 and scaled by 0.5–2 (so that they are not the camera
    model's and not unit), from a numpy seed."""
    rng = np.random.default_rng(seed)
    u = (np.arange(RES) + 0.5) / RES
    uu, vv = np.meshgrid(u, u)
    dir_cam = np.stack([(uu - 0.5) * RES / FOCAL, (vv - 0.5) * RES / FOCAL,
                        np.ones_like(uu)], -1)
    out = []
    for i in range(ds.images.shape[0]):
        xf = ds.xforms[i, 0].astype(np.float64)
        d = dir_cam @ xf[:, :3].T
        d = d + rng.normal(0, 0.01, d.shape)
        d = d * rng.uniform(0.5, 2.0, d.shape[:2] + (1,))
        o = xf[:, 3] + rng.uniform(-1e-3, 1e-3, d.shape)
        out.append(np.concatenate([o, d], -1))
    return np.stack(out).astype(np.float32)


def _envmap(seed: int = 2, shape=ENVMAP_RES) -> np.ndarray:
    """A seeded lat-long map: colour 0–1.5, alpha 0–1."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.0, 1.5, (*shape, 4)).astype(np.float32)
    img[..., 3] = rng.uniform(0.0, 1.0, shape)
    return img


# case: (dataset changes, engine keywords, camera leaves with a gradient)
CASES = {
    "train_envmap_logistic": ({}, {"train_envmap": True}, ()),
    "train_envmap_exponential": ({"is_hdr": True}, {"train_envmap": True}, ()),
    "dataset_envmap": ({"envmap": _envmap(3)}, {}, ()),
    "depth_camera_rays": ({"depths": True}, {"depth_supervision_lambda": 0.5}, ()),
    "depth_supplied_rays": ({"depths": True, "rays": True},
                            {"depth_supervision_lambda": 0.5}, ()),
    "latents": ({"n_extra_learnable_dims": 4}, {}, ("latents",)),
    "supplied_rays": ({"rays": True}, {}, ()),
}


def _dataset(changes: dict, n_views: int = 4):
    ds = _make_dataset(n_views=n_views)
    for name, value in changes.items():
        if name == "depths":
            value = _depths(ds)
        elif name == "rays":
            value = _rays(ds)
        setattr(ds, name, value)
    return ds


def _engines(changes: dict, kw: dict, n_views: int = 4):
    ds = _dataset(changes, n_views)
    kw = {"envmap_resolution": ENVMAP_RES, **kw}
    jeng = JaxNerfEngine(copy.deepcopy(SMALL), ds, **ENGINE, **kw)
    peng = NerfEngine(copy.deepcopy(SMALL), port_dataset(ds), device="cpu", **ENGINE, **kw)
    return jeng, peng


def jax_full_state_tree(jeng, jstate) -> dict:
    """``jax_camera_state_tree`` with the envmap: its image and EMA, and,
    where it trains, its Adam moments and count."""
    tree = jax_camera_state_tree(jeng, jstate)
    if "envmap" in jstate.params:
        image = lambda t: {"image": np.asarray(t["envmap"]["image"])}  # noqa: E731
        tree["envmap"] = image(jstate.params)
        tree["envmap_ema"] = image(jstate.ema.params)
        if jeng.train_envmap:
            adam = jstate.opt_state.inner_states["envmap"].inner_state[0]
            tree["opt"]["envmap"] = {"count": int(adam.count), "mu": image(adam.mu),
                                     "nu": image(adam.nu)}
    return tree


def _with_envmap(jstate, image, ema_image=None):
    params = {**jstate.params, "envmap": {"image": jnp.asarray(image)}}
    ema_image = image if ema_image is None else ema_image
    ema = {**jstate.ema.params, "envmap": {"image": jnp.asarray(ema_image)}}
    return jstate._replace(params=params, ema=jstate.ema._replace(params=ema))


def _port_state(peng, tree):
    camera, envmap = peng._initial_groups()
    return load_jax_train_state(peng._new_network(), tree, camera=camera, envmap=envmap)


@pytest.fixture(scope="module")
def warm():
    """A JAX occupancy grid occupied in a ball of radius 0.25 about the
    scene centre (density 1) and empty elsewhere: rays that miss it leave
    the scene complete and see the background, the envmap's; rays through
    it take samples."""
    from ngp_tpu.ops import occupancy as jocc

    jeng, _ = _engines({}, {})
    grid = jeng.init_grid()
    C, G = grid.density.shape[:2]
    assert C == 1
    c = (np.arange(G) + 0.5) / G - 0.5
    r2 = c[:, None, None] ** 2 + c[None, :, None] ** 2 + c[None, None, :] ** 2
    density = jnp.asarray(np.where(r2 < 0.25 ** 2, 1.0, 0.0)[None].astype(np.float32))
    mean = jnp.mean(jnp.maximum(density[0], 0.0))
    return jocc.OccupancyGridState(density, jocc.build_bitfield(density, mean), mean,
                                   grid.ema_step)


@pytest.mark.parametrize("case", list(CASES))
def test_step_matches_jax_on_an_injected_batch(warm, case):
    """One step from the same weights, grid, latents and envmap (a seeded
    one where it trains) on the JAX engine's batch (its rays, depth targets
    and background): the loss, the model's gradients, the latents' and the
    envmap's (module docstring). A dataset's envmap is held fixed: the
    port computes no gradient for it."""
    changes, kw, leaves = CASES[case]
    jeng, peng = _engines(changes, kw)
    jstate = jeng.init_state()
    if kw.get("train_envmap"):
        jstate = _with_envmap(jstate, _envmap(4), _envmap(5))
    key = jax.random.PRNGKey(5)
    k, n_rays = jeng._k, jeng._n_rays
    jemap = jeng.init_error_map()
    jbatch = jeng._sample_ray_batch(key, jeng.data, n_rays, jemap)
    bg = jax.random.uniform(jax.random.fold_in(key, 7), (n_rays, 3))
    jloss, jmetrics, jgrads, _ = jeng.batch_loss_and_grads(
        jstate.params, warm.bitfield, warm.mean_density, key, jeng.data, k=k, n_rays=n_rays,
        emap=jemap)
    state = _port_state(peng, jax_full_state_tree(jeng, jstate))
    depth = None if jbatch.target_depth is None else _t(jbatch.target_depth)
    assert (depth is not None) == ("depth_supervision_lambda" in kw)
    batch = RayBatch(_t(jbatch.origins), _t(jbatch.dirs), _t(jbatch.target_rgba),
                     _t(jbatch.n0), _t(jbatch.img).long(), _t(jbatch.uv),
                     target_depth=depth)
    loss, metrics, _ = peng.batch_loss_and_grads(state.model, _port_grid(warm), batch, _t(bg),
                                                 k, camera=state.camera, envmap=state.envmap)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-4)
    assert float(metrics["loss"]) == pytest.approx(float(jmetrics["loss"]), rel=1e-4)
    _assert_grads_match(jgrads, state, leaves)
    if "envmap" not in jstate.params:
        assert state.envmap is None
    elif kw.get("train_envmap"):
        want = np.asarray(jgrads["envmap"]["image"])
        got = state.envmap.image.grad.numpy()
        assert np.abs(want).max() > 0
        err = np.abs(got - want).max()
        assert err <= 1e-3 * np.abs(want).max(), err / np.abs(want).max()
    else:
        assert state.envmap.image.grad is None


def test_depth_term_moves_the_loss_by_the_jax_engines_amount(warm):
    """The depth term on: the loss with λ = 0.5 minus the loss at λ = 0 on
    the same batch, in both packages (1e-3 relative of the term)."""
    changes, kw, _ = CASES["depth_camera_rays"]
    losses = {}
    for lam in (0.0, 0.5):
        jeng, peng = _engines(changes, {"depth_supervision_lambda": lam})
        jeng.data = jeng.data._replace(depths=jnp.asarray(_depths(jeng.dataset)))
        peng.depths = torch.from_numpy(_depths(jeng.dataset))
        jstate = jeng.init_state()
        key = jax.random.PRNGKey(6)
        k, n_rays = jeng._k, jeng._n_rays
        jbatch = jeng._sample_ray_batch(key, jeng.data, n_rays, None)
        bg = jax.random.uniform(jax.random.fold_in(key, 7), (n_rays, 3))
        jloss = jeng.batch_loss_and_grads(jstate.params, warm.bitfield, warm.mean_density, key,
                                jeng.data, k=k, n_rays=n_rays)[0]
        state = _port_state(peng, jax_full_state_tree(jeng, jstate))
        batch = RayBatch(_t(jbatch.origins), _t(jbatch.dirs), _t(jbatch.target_rgba),
                         _t(jbatch.n0), _t(jbatch.img).long(), _t(jbatch.uv),
                         target_depth=_t(jbatch.target_depth))
        loss = peng.batch_loss_and_grads(state.model, _port_grid(warm), batch, _t(bg), k,
                                         camera=state.camera)[0]
        losses[lam] = (float(jloss), float(loss))
    jterm = losses[0.5][0] - losses[0.0][0]
    pterm = losses[0.5][1] - losses[0.0][1]
    assert jterm > 1e-3
    assert pterm == pytest.approx(jterm, rel=1e-3)


@pytest.mark.parametrize("depths", [False, True])
def test_supplied_ray_batch_matches_jax(depths):
    """``_rays_at`` on the JAX batch's images and pixels, the march start
    from the JAX jitter: origins, normalised directions, n0 and the depth
    targets z·|r[3:]| (1e-6); the supplied rays set ``near_distance`` to 0
    in both packages."""
    changes = {"rays": True, **({"depths": True} if depths else {})}
    kw = {"depth_supervision_lambda": 0.5} if depths else {}
    jeng, peng = _engines(changes, kw)
    assert jeng.near_distance == peng.near_distance == 0.0
    key = jax.random.PRNGKey(7)
    n = jeng._n_rays
    jbatch = jeng._sample_ray_batch(key, jeng.data, n, None)
    _, _, kjit = jax.random.split(key, 3)
    jit = _t(jax.random.uniform(kjit, (n,)))
    uv = _t(jbatch.uv)
    W, H = peng.resolution
    px = torch.floor(uv * torch.tensor([W, H], dtype=torch.float32)).long()
    o, d, xf, target_depth = peng._rays_at(_t(jbatch.img).long(), px, uv)
    assert xf is None
    np.testing.assert_allclose(o.numpy(), np.asarray(jbatch.origins), rtol=0, atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(jbatch.dirs), rtol=0, atol=1e-6)
    tmin, _ = ray_aabb_range(o, d, peng.aabb.min, peng.aabb.max)
    n0 = peng.stepping.to_steps(tmin) + jit
    np.testing.assert_allclose(n0.numpy(), np.asarray(jbatch.n0), rtol=0, atol=1e-5)
    if depths:
        assert float(np.abs(np.asarray(jbatch.target_depth)).max()) > 0
        np.testing.assert_allclose(target_depth.numpy(), np.asarray(jbatch.target_depth),
                                   rtol=0, atol=1e-6)
    else:
        assert target_depth is None and jbatch.target_depth is None


def test_camera_ray_depth_targets_match_jax():
    """Depth targets z·|dir_cam| of the camera rays at the JAX batch's
    pixels (1e-6)."""
    jeng, peng = _engines({"depths": True}, {"depth_supervision_lambda": 0.5})
    key = jax.random.PRNGKey(8)
    jbatch = jeng._sample_ray_batch(key, jeng.data, jeng._n_rays, None)
    uv = _t(jbatch.uv)
    W, H = peng.resolution
    px = torch.floor(uv * torch.tensor([W, H], dtype=torch.float32)).long()
    _, _, _, target_depth = peng._rays_at(_t(jbatch.img).long(), px, uv)
    np.testing.assert_allclose(target_depth.numpy(), np.asarray(jbatch.target_depth), rtol=0,
                               atol=1e-6)


def test_init_grid_under_supplied_rays_matches_jax():
    """No frustum culling with supplied rays: every cell trainable, as the
    JAX engine's grid (density and bitfield equal), on one view whose
    camera's frustum culls 232 cells without them."""
    jeng, peng = _engines({"rays": True}, {}, n_views=1)
    jg, pg = jeng.init_grid(), peng.init_grid()
    np.testing.assert_array_equal(pg.density.numpy(), np.asarray(jg.density))
    np.testing.assert_array_equal(pg.bitfield.numpy(), np.asarray(jg.bitfield))
    assert not (pg.density < 0).any()
    culled = NerfEngine(copy.deepcopy(SMALL), port_dataset(_make_dataset(1)), device="cpu",
                        **ENGINE).init_grid()
    assert int((culled.density < 0).sum()) == 232  # the camera's frustum culls


def test_supplied_rays_with_ray_refinement_are_refused_where_the_jax_engine_drops_them():
    """ROADMAP C.ref 11, kept out of parity: with extrinsic refinement the
    JAX engine's network sees rays rebuilt from the poses (at a zero camera
    group the camera model's, not the supplied ones the batch marched); the
    port refuses supplied rays with each of the three ray-refining flags,
    and takes them with exposure refinement and latents."""
    jeng = JaxNerfEngine(copy.deepcopy(SMALL), _dataset({"rays": True}), **ENGINE,
                         optimize_extrinsics=True)
    key = jax.random.PRNGKey(9)
    jbatch = jeng._sample_ray_batch(key, jeng.data, jeng._n_rays, None)
    jo, jd = jeng._adjusted_rays(jeng.init_state().params["camera"], jbatch.img, jbatch.uv,
                                 jeng.data)
    off = max(float(jnp.abs(jo - jbatch.origins).max()), float(jnp.abs(jd - jbatch.dirs).max()))
    assert off > 1e-3, off  # the supplied rays were dropped
    ds = port_dataset(_dataset({"rays": True}))
    for flag in ("optimize_extrinsics", "optimize_focal_length", "optimize_distortion"):
        with pytest.raises(ValueError, match=r"supplied per-pixel rays.*C\.ref 11"):
            NerfEngine(copy.deepcopy(SMALL), ds, device="cpu", **ENGINE, **{flag: True})
    ds.n_extra_learnable_dims = 4
    eng = NerfEngine(copy.deepcopy(SMALL), ds, device="cpu", **ENGINE, optimize_exposure=True)
    assert eng.camera_opt is not None and eng.rays is not None


# -- the optimizer and the training-state tree


@pytest.mark.parametrize("count", [0, 7])
def test_envmap_and_latent_updates_match_jax(count):
    """One update of every group from the JAX engine's random gradients,
    with ``train_envmap`` and E = 4 latents, the envmap's and the camera
    group's Adam at ``count`` with random moments: the envmap, the latents,
    their EMA and moments within 1e-6 relative (the envmap's rule:
    b1 0.9, b2 0.99, eps 1e-8, lr 1e-2, no decay; with an ``envmap``
    optimizer block in the config at count 7: its own constants)."""
    cfg = copy.deepcopy(SMALL)
    if count:
        cfg["envmap"] = {"optimizer": {"otype": "Ema", "decay": 0.9, "nested": {
            "otype": "ExponentialDecay", "decay_start": 1, "nested": {
                "otype": "Adam", "learning_rate": 3e-3, "beta1": 0.8, "beta2": 0.95,
                "epsilon": 1e-6}}}}
    ds = _make_dataset(n_views=4)
    ds.n_extra_learnable_dims = 4
    kw = dict(train_envmap=True, envmap_resolution=ENVMAP_RES)
    jeng = JaxNerfEngine(copy.deepcopy(cfg), ds, **ENGINE, **kw)
    peng = NerfEngine(copy.deepcopy(cfg), port_dataset(ds), device="cpu", **ENGINE, **kw)
    rng = np.random.default_rng(count + 20)
    jstate = _with_envmap(jeng.init_state(), _envmap(6), _envmap(7))
    inner = dict(jstate.opt_state.inner_states)
    rand = lambda x: jnp.asarray(np.abs(rng.normal(size=x.shape)).astype(np.float32)  # noqa: E731
                                 * 1e-3)
    for g in ("camera", "envmap"):
        adam, *rest = inner[g].inner_state
        adam = adam._replace(count=jnp.asarray(count, jnp.int32),
                             mu={**adam.mu, g: jax.tree.map(rand, adam.mu[g])},
                             nu={**adam.nu, g: jax.tree.map(rand, adam.nu[g])})
        # the schedule's count too (the camera's decayed weights keep none)
        rest = [r._replace(count=jnp.asarray(count, jnp.int32)) if "count" in r._fields else r
                for r in rest]
        inner[g] = inner[g]._replace(inner_state=(adam, *rest))
    jstate = jstate._replace(step=jnp.asarray(count, jnp.int32),
                             opt_state=jstate.opt_state._replace(inner_states=inner))
    grads = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32), jstate.params)

    state = _port_state(peng, jax_full_state_tree(jeng, jstate))
    assert state.opt_state["envmap"].count == state.opt_state["camera"].count == count
    want = jax_full_state_tree(jeng, jeng.apply_grads(jstate, jax.tree.map(jnp.asarray, grads)))
    for name, p in state.model.named_parameters():
        p.grad = _t(_tree_get(grads["model"], name))
    for name in CameraParams.NAMES:
        getattr(state.camera, name).grad = _t(grads["camera"][name])
    state.envmap.image.grad = _t(grads["envmap"]["image"])
    peng.apply_grads(state)
    got = export_jax_train_state(state)
    assert got["opt"]["envmap"]["count"] == want["opt"]["envmap"]["count"] == count + 1
    pairs = [(got[t]["image"], want[t]["image"], t) for t in ("envmap", "envmap_ema")]
    pairs += [(got["opt"]["envmap"][m]["image"], want["opt"]["envmap"][m]["image"], m)
              for m in ("mu", "nu")]
    pairs += [(got[t]["latents"], want[t]["latents"], t) for t in ("camera", "camera_ema")]
    pairs += [(got["opt"]["camera"][m]["latents"], want["opt"]["camera"][m]["latents"], m)
              for m in ("mu", "nu")]
    for a, b, what in pairs:
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-12, err_msg=what)
    assert not np.array_equal(got["envmap"]["image"], _envmap(6))


def test_dataset_envmap_stays_fixed_while_its_ema_follows_jax():
    """A dataset's envmap without ``train_envmap``: an update leaves it bit
    for bit and its Adam count at 0; its EMA takes the JAX engine's EMA
    update (1e-6 relative), from an EMA other than the image."""
    ds = _dataset({"envmap": _envmap(8)})
    jeng = JaxNerfEngine(copy.deepcopy(SMALL), ds, **ENGINE)
    peng = NerfEngine(copy.deepcopy(SMALL), port_dataset(ds), device="cpu", **ENGINE)
    assert peng.envmap_opt is None
    jstate = _with_envmap(jeng.init_state(), _envmap(8), _envmap(9))
    rng = np.random.default_rng(10)
    grads = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32), jstate.params)
    state = _port_state(peng, jax_full_state_tree(jeng, jstate))
    want = jax_full_state_tree(jeng, jeng.apply_grads(jstate, jax.tree.map(jnp.asarray, grads)))
    for name, p in state.model.named_parameters():
        p.grad = _t(_tree_get(grads["model"], name))
    peng.apply_grads(state)
    got = export_jax_train_state(state)
    np.testing.assert_array_equal(got["envmap"]["image"], _envmap(8))
    np.testing.assert_array_equal(want["envmap"]["image"], _envmap(8))
    np.testing.assert_allclose(got["envmap_ema"]["image"], want["envmap_ema"]["image"],
                               rtol=1e-6, atol=1e-12)
    assert state.opt_state["envmap"].count == 0


def test_train_state_with_envmap_and_latents_round_trips_through_interop():
    """A JAX training state after one update with ``train_envmap`` and E = 4
    (envmap, latents, EMA, moments and counts all moved) crosses into the
    port and back exactly."""
    ds = _make_dataset(n_views=4)
    ds.n_extra_learnable_dims = 4
    kw = dict(train_envmap=True, envmap_resolution=ENVMAP_RES)
    jeng = JaxNerfEngine(copy.deepcopy(SMALL), ds, **ENGINE, **kw)
    peng = NerfEngine(copy.deepcopy(SMALL), port_dataset(ds), device="cpu", **ENGINE, **kw)
    jstate = jeng.init_state()
    rng = np.random.default_rng(11)
    grads = jax.tree.map(lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32)),
                         jstate.params)
    jstate = jeng.apply_grads(jstate, grads)
    tree = jax_full_state_tree(jeng, jstate)
    assert tree["opt"]["envmap"]["count"] == tree["opt"]["camera"]["count"] == 1
    state = _port_state(peng, tree)
    back = export_jax_train_state(state)
    assert set(back) == set(tree)
    assert set(back["opt"]) == {"dense", "grid", "camera", "envmap"}
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# -- initial state, training, renders, snapshots


def test_initial_latents_and_envmap():
    """Latents 0.1·normal of the engine's own draw (the JAX engine draws
    from ``jax.random``: ROADMAP C "Not faults, by design"), the same on
    every call; E = 0 leaves them zero and the group still; the envmap the
    dataset's image, else 1e-4 at ``envmap_resolution``; none without
    either."""
    _, peng = _engines({"n_extra_learnable_dims": 4}, {"train_envmap": True})
    a, b = peng.init_state(), peng.init_state()
    lat = a.camera.latents.detach()
    assert lat.shape == (4, 4) and torch.equal(lat, b.camera.latents)
    assert 0.03 < float(lat.std()) < 0.3 and not a.camera_still
    np.testing.assert_array_equal(a.envmap.image.detach().numpy(),
                                  np.full((*ENVMAP_RES, 4), 1e-4, np.float32))
    _, peng = _engines({"envmap": _envmap(12)}, {"train_envmap": True})
    s = peng.init_state()
    np.testing.assert_array_equal(s.envmap.image.detach().numpy(), _envmap(12))
    assert not s.camera.latents.any() and s.camera_still
    _, peng = _engines({}, {})
    s = peng.init_state()
    assert s.envmap is None and "envmap" not in s.opt_state


def test_every_option_trains_and_renders():
    """Every option at once but the refinements (latents E = 4, a trained
    envmap from a dataset's, depth supervision on supplied rays): a few
    steps move the latents (> 1e-5, the JAX package's
    ``test_extra_learnable_dims`` gate) and the envmap, the loss stays
    finite, and renders with zero latents are finite; their miss pixels
    show the EMA envmap."""
    changes = {"n_extra_learnable_dims": 4, "envmap": _envmap(13), "depths": True,
               "rays": True}
    _, peng = _engines(changes, {"train_envmap": True, "depth_supervision_lambda": 0.5})
    state, grid = peng.init_state(), peng.init_grid()
    lat0, env0 = state.camera.latents.detach().clone(), state.envmap.image.detach().clone()
    state, grid, m = peng.train(state, grid, 6)
    assert math.isfinite(float(m["loss"]))
    assert float((state.camera.latents.detach() - lat0).abs().max()) > 1e-5
    assert float((state.envmap.image.detach() - env0).abs().max()) > 1e-5
    assert state.opt_state["camera"].count == state.opt_state["envmap"].count == 6
    img = peng.render_image(state, grid, 0, stride=4)
    assert bool(torch.isfinite(img).all())
    o = torch.tensor([[5.0, 0.5, 0.5]]).expand(8, 3).contiguous()
    d = torch.tensor([[1.0, 0.0, 0.0]]).expand(8, 3).contiguous()  # away from the box
    rgb, _, opacity = peng.render_rays(state, grid, o, d)
    assert not opacity.any()
    torch.testing.assert_close(rgb, peng._miss_background(d, state.envmap_ema.image.detach()),
                               rtol=0, atol=0)


def _set_image_testbeds(tmp_path, lam: float):
    from ngp_tpu.testbed import Testbed as JaxTestbed
    from ngp_tpu_torch.data.synthetic import write_sphere_capture
    from ngp_tpu_torch.testbed import Testbed

    train_json, _ = write_sphere_capture(str(tmp_path / f"cap{lam}"), res=16, depth=True)
    kw = dict(grid_size=16, batch_size=1 << 12, depth_supervision_lambda=lam)
    return (JaxTestbed(scene=train_json, config=copy.deepcopy(SMALL), **kw),
            Testbed(scene=train_json, config=copy.deepcopy(SMALL), device="cpu", **kw))


@pytest.mark.parametrize("lam", [0.0, 0.5])
def test_testbed_set_image_with_depth_matches_jax(tmp_path, lam):
    """``Testbed.set_image(frame, img, depth=)`` on a capture with depth
    maps: with depth supervision both packages replace the frame's image
    and depth map (equal); without it both keep no depths and take the
    image."""
    jtb, ptb = _set_image_testbeds(tmp_path, lam)
    rng = np.random.default_rng(14)
    img = rng.uniform(size=(16, 16, 3)).astype(np.float32)
    depth = rng.uniform(0.1, 2.0, (16, 16)).astype(np.float32)
    for tb in (jtb, ptb):
        tb.set_image(2, img, depth=depth)
    np.testing.assert_array_equal(ptb.engine.images.numpy(), np.asarray(jtb.engine.data.images))
    if lam:
        np.testing.assert_array_equal(ptb.engine.depths.numpy(),
                                      np.asarray(jtb.engine.data.depths))
        np.testing.assert_array_equal(ptb.engine.depths[2].numpy(), depth)
        assert ptb.engine.depths[0].any()  # the loaded maps
    else:
        assert ptb.engine.depths is None and jtb.engine.data.depths is None


def test_native_snapshot_with_envmap_and_latents_crosses_both_ways(tmp_path):
    """A JAX native snapshot with a trained envmap and non-zero latents
    (E = 4; parameters and EMA differ) loads into the port tree for tree;
    the port's save of it loads into the JAX engine tree for tree; rays
    that leave the scene render the EMA envmap in both (1e-6). (Renders of
    an untrained field overflow the render budget, where the JAX engine
    composites fog: ROADMAP C.ref 1.)"""
    ds = _make_dataset(n_views=4)
    ds.n_extra_learnable_dims = 4
    kw = dict(train_envmap=True, envmap_resolution=ENVMAP_RES)
    jeng = JaxNerfEngine(copy.deepcopy(SMALL), ds, **ENGINE, **kw)
    peng = NerfEngine(copy.deepcopy(SMALL), port_dataset(ds), device="cpu", **ENGINE, **kw)
    jstate = _with_envmap(jeng.init_state(), _envmap(15), _envmap(16))
    jgrid = jeng.update_grid(jstate, jeng.init_grid(), jax.random.PRNGKey(2), warmup=True)
    lat = np.random.default_rng(17).normal(0, 0.1, (4, 4)).astype(np.float32)
    jstate = jstate._replace(ema=jstate.ema._replace(params={
        **jstate.ema.params, "camera": {**jstate.ema.params["camera"], "latents": lat}}))
    path, back = str(tmp_path / "jax.ingp"), str(tmp_path / "port.ingp")
    jeng.save_snapshot(path, jstate, jgrid)
    pstate, pgrid = peng.load_snapshot(path)
    jtree = jax_full_state_tree(jeng, jstate)
    got = export_jax_train_state(pstate)
    for name in ("envmap", "envmap_ema", "camera", "camera_ema"):
        for leaf in got[name]:
            np.testing.assert_array_equal(got[name][leaf], jtree[name][leaf], err_msg=name)
    assert np.abs(got["camera"]["latents"]).max() > 0
    peng.save_snapshot(back, pstate, pgrid)
    jstate2, _ = jeng.load_snapshot(back)
    jstate, jgrid = jeng.load_snapshot(path)  # its float16 grid, as the port's
    for a, b in ((jstate.params, jstate2.params), (jstate.ema.params, jstate2.ema.params)):
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        assert jax.tree.structure(a) == jax.tree.structure(b)
    rng = np.random.default_rng(18)
    d = rng.normal(size=(64, 3))
    d[:, 0] = np.abs(d[:, 0]) + 0.5
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    o = np.broadcast_to(np.asarray([3.0, 0.5, 0.5], np.float32), d.shape).copy()
    want, _, wopa = jeng.render_rays(jstate, jgrid, jnp.asarray(o), jnp.asarray(d))
    got, _, opa = peng.render_rays(pstate, pgrid, torch.from_numpy(o), torch.from_numpy(d))
    assert not np.asarray(wopa).any() and not opa.any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    assert np.abs(np.asarray(want)).max() > 0.1


def test_fixed_training_background():
    """``train_with_random_bg=False``: the batch's background is
    ``background_color``, as in the JAX engine (which the sky capture of
    ``chip_smoke.py supervision`` trains with, as the JAX package's sky
    test does); by default a uniform draw a ray."""
    kw = dict(background_color=(0.25, 0.5, 0.75))
    _, peng = _engines({}, {**kw, "train_with_random_bg": False})
    _, bg = peng._sample_ray_batch(64)
    torch.testing.assert_close(bg, torch.tensor([[0.25, 0.5, 0.75]]).expand(64, 3))
    _, peng = _engines({}, kw)
    _, bg = peng._sample_ray_batch(64)
    assert bg.std() > 0.1


def test_written_capture_carries_depths_rays_envmap_and_latents(tmp_path):
    """``write_sphere_capture``'s options, read back by ``load_nerf``: the
    depth maps give each hit pixel's distance along the ray (z·|dir_cam|)
    within the 16-bit quantum, 0 where the ray misses; the supplied rays
    are the camera model's at the pixel centres (1e-5); the envmap and the
    extra dims are the json's; ``aabb_scale`` and ``distance`` place the
    scene box and the eyes; the brightness seed scales the albedo."""
    from ngp_tpu_torch.data.nerf_loader import load_nerf
    from ngp_tpu_torch.data.synthetic import (
        CAPTURE_DEPTH_SCALE,
        CAPTURE_ENVMAP_RES,
        capture_view,
        write_sphere_capture,
    )

    train_json, _ = write_sphere_capture(str(tmp_path / "a"), res=16, depth=True, rays=True,
                                         envmap=True, n_extra_learnable_dims=3)
    ds = load_nerf(train_json)
    assert ds.n_extra_learnable_dims == 3 and ds.aabb_scale == 2
    assert ds.envmap.shape == (*CAPTURE_ENVMAP_RES, 4)
    eng = NerfEngine(copy.deepcopy(SMALL), ds, device="cpu", depth_supervision_lambda=0.5,
                     **ENGINE)
    plain = NerfEngine(copy.deepcopy(SMALL), load_nerf(train_json), device="cpu", **ENGINE)
    plain.rays = None
    img = torch.arange(ds.n_images).repeat_interleave(256)
    px = torch.stack(torch.meshgrid(torch.arange(16), torch.arange(16), indexing="xy"),
                     -1).reshape(-1, 2).repeat(ds.n_images, 1)
    uv = (px.float() + 0.5) / 16
    o, d, _, target_depth = eng._rays_at(img, px, uv)
    o2, d2, _, _ = plain._rays_at(img, px, uv)
    torch.testing.assert_close(o, o2, rtol=0, atol=1e-5)
    torch.testing.assert_close(d, d2, rtol=0, atol=1e-5)
    want = np.concatenate([capture_view(ds.xforms[i, 0], 16, ds.focal_lengths[i],
                                        ds.principal_points[i], ds.lens)["distance"].ravel()
                           for i in range(ds.n_images)])
    quantum = CAPTURE_DEPTH_SCALE * ds.scale * 2.0  # |dir_cam| < 2 here
    assert (want > 0).any() and (want == 0).any()
    np.testing.assert_allclose(target_depth.numpy(), want, rtol=0, atol=quantum)
    far_json, _ = write_sphere_capture(str(tmp_path / "b"), res=16, aabb_scale=1, distance=3.0,
                                       brightness_seed=0)
    far = load_nerf(far_json)
    assert far.aabb_scale == 1
    eyes = far.xforms[:, 0, :, 3]
    np.testing.assert_allclose(np.linalg.norm(eyes - 0.5, axis=-1), 3.0, rtol=1e-5)
    near = load_nerf(write_sphere_capture(str(tmp_path / "c"), res=16, distance=3.0)[0])
    assert not np.array_equal(far.images, near.images)  # the brightness

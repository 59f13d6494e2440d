"""Held-out evaluation in the port against the JAX package, on the CPU:
the metrics (``ngp_tpu_torch/utils/metrics.py``), the sRGB curves
(``ops/tonemap.py``), ``NerfEngine.render_view`` and
``eval_test_transforms`` on the golden snapshot, the engine's guards for
what a loaded capture may carry that the port does not yet run, training
on captures with motion blur or a rolling shutter, and (slow) training on
a loaded PNG capture to a held-out score.

Tolerances: metrics 1e-6 relative (the same numpy formulas); the sRGB
curves 1e-6; ``render_view`` 1e-4 on the image, depth and opacity (the
golden render's own bound is 2e-4); ``eval_test_transforms`` PSNR 0.01 dB.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from ngp_tpu.geometry.camera import Lens as JaxLens
from ngp_tpu.ops import tonemap as jtonemap
from ngp_tpu.utils import metrics as jmetrics
from ngp_tpu_torch.data.nerf_loader import NerfDataset
from ngp_tpu_torch.engines.nerf import NerfEngine
from ngp_tpu_torch.geometry.camera import LENS_OPENCV, Lens
from ngp_tpu_torch.ops import tonemap as ptonemap
from ngp_tpu_torch.utils import metrics as pmetrics

# One intra-op thread: with two, torch's CPU sqrt (MKL's vsSqrt, split across
# the intra-op threads) now and then returned one thread's chunk ~3e-4 off
# on an AVX-512 Xeon (torch 2.13, MKL 2024.2), never with one
# (scripts/torch_sqrt_threads.py counts it).
# Every port test module sets the same count, so that a pytest worker's
# count does not depend on which module it imported last.
torch.set_num_threads(1)

OPENCV = (-0.1, 0.02, 1e-3, -1e-3, 0.0, 0.0, 0.0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (40, 52, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05 * (seed + 1), a.shape), 0, 1).astype(np.float32)
    for name in ("mse", "psnr", "ssim", "flip"):
        want = getattr(jmetrics, name)(a, b)
        got = getattr(pmetrics, name)(a, b)
        assert abs(got - want) <= 1e-6 * abs(want), name
    assert pmetrics.psnr_from_mse(1e-3) == jmetrics.psnr_from_mse(1e-3)
    assert pmetrics.ssim(a[..., 0], b[..., 0]) == jmetrics.ssim(a[..., 0], b[..., 0])


def test_srgb_curves_match_jax():
    x = np.linspace(-0.1, 1.5, 4001, dtype=np.float32)
    for name in ("srgb_to_linear", "linear_to_srgb"):
        want = np.asarray(getattr(jtonemap, name)(jnp.asarray(x)))
        got = getattr(ptonemap, name)(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7, err_msg=name)


@pytest.fixture(scope="module")
def golden_engines():
    """The golden snapshot in both packages (``test_torch_render.py``)."""
    from golden.make_golden import build_engine
    from test_torch_render import GOLDEN_INGP, port_golden_engine

    peng, jeng = port_golden_engine(), build_engine()
    return (peng, *peng.load_reference_snapshot(GOLDEN_INGP),
            jeng, *jeng.load_reference_snapshot(GOLDEN_INGP))


@pytest.mark.parametrize("spp,kw", [
    (1, {}),
    (4, {}),
    (1, {"aperture_size": 0.02, "focus_z": 1.1}),
    (2, {"snap_to_pixel_centers": True, "width": 40, "height": 36}),
])
def test_render_view_matches_jax(golden_engines, spp, kw):
    """An OpenCV lens with an off-center principal point, every second
    pixel of the raster, the eval's min transmittance; spp 4 jitters the
    sub-pixel offsets from the shared numpy seed."""
    peng, pstate, pgrid, jeng, jstate, jgrid = golden_engines
    xf, f = jeng.dataset.xforms[1, 0], jeng.dataset.focal_lengths[1]
    args = dict(pp=(0.52, 0.47), spp=spp, pixel_stride=2, min_transmittance=1e-4,
                seed=5, **kw)
    want = jeng.render_view(jstate, jgrid, xf, f, lens=JaxLens(LENS_OPENCV, OPENCV), **args)
    got = peng.render_view(pstate, pgrid, xf, f, lens=Lens(LENS_OPENCV, OPENCV), **args)
    assert got[0].shape == want[0].shape
    assert float(np.asarray(want[0]).std()) > 0.05  # the view shows the object
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-4)


def _test_sets(jeng):
    """The golden camera ring as a held-out set, in both packages: pinhole,
    and with an OpenCV lens and off-center principal points."""
    ds = jeng.dataset
    arrays = dict(images=ds.images, xforms=ds.xforms, focal_lengths=ds.focal_lengths,
                  resolution=ds.resolution, aabb_scale=ds.aabb_scale)
    pps = np.tile(np.asarray([[0.51, 0.48]], np.float32), (ds.n_images, 1))
    return [
        (NerfDataset(lens=Lens(), principal_points=ds.principal_points, **arrays),
         dataclasses.replace(ds, lens=JaxLens())),
        (NerfDataset(lens=Lens(LENS_OPENCV, OPENCV), principal_points=pps, **arrays),
         dataclasses.replace(ds, lens=JaxLens(LENS_OPENCV, OPENCV), principal_points=pps)),
    ]


@pytest.mark.parametrize("lens", ["pinhole", "opencv"])
def test_eval_test_transforms_matches_jax(golden_engines, tmp_path, lens):
    peng, pstate, pgrid, jeng, jstate, jgrid = golden_engines
    pset, jset = _test_sets(jeng)[["pinhole", "opencv"].index(lens)]
    kw = dict(stride=2, max_views=3, compute_flip=lens == "pinhole")
    want = jeng.eval_test_transforms(jstate, jgrid, jset, **kw)
    path = str(tmp_path / "first.png")
    got = peng.eval_test_transforms(pstate, pgrid, pset, save_first_to=path, **kw)
    assert got["n_views"] == want["n_views"] == 3
    assert set(got) == set(want)
    for key in ("psnr", "min_psnr", "max_psnr"):
        assert abs(got[key] - want[key]) <= 0.01, key
    assert abs(got["ssim"] - want["ssim"]) <= 1e-3
    if kw["compute_flip"]:
        assert abs(got["flip"] - want["flip"]) <= 1e-3
    for g, w in zip(got["per_view"], want["per_view"]):
        assert g["view"] == w["view"] and abs(g["psnr"] - w["psnr"]) <= 0.01
    rgb, _, _ = peng.render_view(pstate, pgrid, pset.xforms[0, 0], pset.focal_lengths[0],
                                 pset.principal_points[0], pixel_stride=2, lens=pset.lens,
                                 min_transmittance=1e-4)
    with Image.open(path) as im:
        saved = np.asarray(im)
    np.testing.assert_array_equal(
        saved, (np.clip(rgb.numpy(), 0, 1) * 255).astype(np.uint8))


def test_engine_refuses_what_a_capture_may_carry_but_the_port_does_not_run():
    from test_nerf_engine import CONFIG, _make_dataset

    jd = _make_dataset(2)
    base = dict(images=jd.images, xforms=jd.xforms, focal_lengths=jd.focal_lengths,
                principal_points=jd.principal_points, lens=Lens(),
                resolution=jd.resolution)
    for extra, what in (
        ({"envmap": np.zeros((4, 8, 4), np.float32)}, "envmap"),
        ({"render_aabb": (np.zeros(3), np.ones(3))}, "render_aabb"),
        ({"rays": np.zeros((2, 48, 48, 6), np.float32)}, "rays"),
    ):
        with pytest.raises(ValueError, match=what):
            NerfEngine(dict(CONFIG), NerfDataset(**{**base, **extra}), device="cpu")
    # depth maps are carried and, with depth supervision off, ignored as in
    # the JAX package
    depths = np.ones((2, 48, 48), np.float32)
    NerfEngine(dict(CONFIG), NerfDataset(**base, depths=depths), device="cpu")


@pytest.mark.parametrize("shutter", ["motion_blur", "rolling"])
def test_shuttered_capture_trains(shutter):
    """A capture with end poses (each camera turned 0.02 rad about the
    scene's centre) and pure motion blur, or a rolling shutter across the
    rows: the engine keeps the end poses, and 60 steps (the JAX package's
    ``test_rolling_shutter_smoke_and_motion_blur_xform_use``) give a finite
    loss that falls below the first window's and below 0.05."""
    from test_nerf_engine import CONFIG, SPHERE_C, _lookat_xform, _make_dataset

    jd = _make_dataset(6)
    xf = jd.xforms.copy()
    c, s = math.cos(0.02), math.sin(0.02)
    rot_z = np.asarray([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    for i in range(xf.shape[0]):
        eye = SPHERE_C + rot_z @ (xf[i, 0, :, 3] - SPHERE_C)
        xf[i, 1] = _lookat_xform(eye.astype(np.float32), SPHERE_C)
    rs = (0.0, 0.0, 0.0, 1.0) if shutter == "motion_blur" else (0.0, 0.0, 1.0, 0.0)
    ds = NerfDataset(images=jd.images, xforms=xf, focal_lengths=jd.focal_lengths,
                     principal_points=jd.principal_points, lens=Lens(),
                     resolution=jd.resolution, aabb_scale=1, rolling_shutter=rs)
    eng = NerfEngine(dict(CONFIG), ds, batch_size=1 << 12, grid_size=16,
                     n_steps_per_unit=128, density_grid_decay=0.8, seed=17,
                     adapt_every=4, device="cpu")
    assert eng.xforms_end is not None
    state, grid = eng.init_state(), eng.init_grid()
    state, grid, m0 = eng.train(state, grid, 4)
    state, grid, m = eng.train(state, grid, 56)
    assert math.isfinite(float(m["loss"]))
    assert float(m["loss"]) < float(m0["loss"]) and float(m["loss"]) < 0.05


@pytest.mark.slow
def test_train_on_loaded_png_capture_to_held_out_psnr(tmp_path):
    """Write the textured-sphere capture (OpenCV lens, aabb_scale 2) at
    64², load it, train 400 steps of the "tpu" tier and score the held-out
    views (about two minutes on a CPU; one such run read 32.1 dB)."""
    from ngp_tpu_torch.config import default_config
    from ngp_tpu_torch.data.nerf_loader import load_nerf
    from ngp_tpu_torch.data.synthetic import write_sphere_capture

    train_json, test_json = write_sphere_capture(str(tmp_path), res=64)
    train, test = load_nerf(train_json), load_nerf(test_json)
    assert train.lens.mode == LENS_OPENCV and train.aabb_scale == 2
    eng = NerfEngine(default_config("tpu"), train, batch_size=1 << 16, grid_size=32,
                     device="cpu")
    state, grid = eng.init_state(), eng.init_grid()
    state, grid, metrics = eng.train(state, grid, 400)
    assert np.isfinite(float(metrics["loss"]))
    scores = eng.eval_test_transforms(state, grid, test)
    assert scores["n_views"] == 4
    assert scores["psnr"] > 28.0 and scores["ssim"] > 0.9, scores

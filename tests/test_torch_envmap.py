"""The port's lat-long environment map (``ngp_tpu_torch/ops/envmap.py``) and
the NeRF engine's miss background against the JAX package's
(``ngp_tpu/ops/envmap.py``, ``NerfEngine._miss_background``), on the CPU.
Inputs come from numpy seeds. Tolerances: the (theta, phi) coordinates
and the read 1e-6; the gradient with respect to the image 1e-6, or 1e-6
of the deposited mass Σ|term| at a texel where that exceeds 1 (the two
packages sum a texel's deposits in different orders); the render
background 1e-6."""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ngp_tpu.engines.nerf import NerfEngine as JaxNerfEngine
from ngp_tpu.ops import envmap as jenv
from ngp_tpu_torch.engines.nerf import NerfEngine
from ngp_tpu_torch.ops import envmap as penv
from tests.test_nerf_engine import _make_dataset
from tests.test_torch_train_step import ENGINE, SMALL

def port_dataset(ds):
    """The port's ``NerfDataset`` of a JAX one, every field carried."""
    import dataclasses

    from ngp_tpu_torch.data.nerf_loader import NerfDataset
    from ngp_tpu_torch.geometry.camera import Lens

    kw = {f.name: getattr(ds, f.name) for f in dataclasses.fields(NerfDataset)}
    kw["lens"] = Lens(ds.lens.mode, tuple(ds.lens.params))
    kw["rolling_shutter"] = tuple(ds.rolling_shutter)
    return NerfDataset(**kw)


# One intra-op thread, as in every port test module (see
# tests/test_torch_train_step.py).
torch.set_num_threads(1)


def _directions() -> np.ndarray:
    """Unit directions: both poles (dirs[:, 1] = ±1 after the swizzle), the
    wrap seam (−z with x just either side of 0, and exactly 0), the four
    horizontal axes and 256 seeded random ones."""
    rng = np.random.default_rng(0)
    special = [(0, 1, 0), (0, -1, 0), (1e-7, 0.3, -1), (-1e-7, 0.3, -1), (0, 0.3, -1),
               (1e-3, -0.5, -1), (-1e-3, -0.5, -1), (1, 0, 0), (-1, 0, 0), (0, 0, 1)]
    d = np.concatenate([np.asarray(special, np.float64), rng.normal(size=(256, 3))])
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _image(H=8, W=16, seed=1) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-0.2, 1.5, (H, W, 4)).astype(np.float32)


def test_dir_to_latlong_uv_matches_jax():
    d = _directions()
    want = jenv.dir_to_latlong_uv(jnp.asarray(d))
    got = penv.dir_to_latlong_uv(torch.from_numpy(d))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", [(8, 16), (5, 3), (1, 1)])
def test_read_envmap_and_its_gradient_match_jax(shape):
    """The read at the poles, across the seam and at seeded directions, and
    the gradient of Σ w·read with respect to the image (the 4-corner
    deposit), on a square-ish, an odd and a one-texel map."""
    d = _directions()
    img = _image(*shape)
    w = np.random.default_rng(2).normal(size=(d.shape[0], 4)).astype(np.float32)
    want = np.asarray(jenv.read_envmap(jnp.asarray(img), jnp.asarray(d)))
    want_g = np.asarray(jax.grad(
        lambda im: jnp.sum(jenv.read_envmap(im, jnp.asarray(d)) * w))(jnp.asarray(img)))
    # the bilinear weights are positive: the gradient of Σ|w|·read is Σ|term|
    mass = np.asarray(jax.grad(
        lambda im: jnp.sum(jenv.read_envmap(im, jnp.asarray(d)) * np.abs(w)))(jnp.asarray(img)))
    image = torch.from_numpy(img).requires_grad_(True)
    got = penv.read_envmap(image, torch.from_numpy(d))
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-6)
    err = np.abs(image.grad.numpy() - want_g)
    assert (err <= 1e-6 * np.maximum(mass, 1.0)).all(), (err / np.maximum(mass, 1.0)).max()
    assert np.abs(want_g).max() > 0


def test_read_envmap_interpolates_across_the_seam():
    """Columns 0 and W−1 are neighbours: a direction whose x index falls
    between them reads their mean; the JAX package's own case (u = 0.5)
    reads the mean of columns 7 and 8."""
    H, W = 8, 16
    img = np.zeros((H, W, 4), np.float32)
    img[:, :, 0] = np.linspace(0, 1, W)[None, :]
    out = penv.read_envmap(torch.from_numpy(img), torch.tensor([[0.0, 0.0, 1.0]]))
    assert abs(float(out[0, 0]) - 0.5 * (img[4, 7, 0] + img[4, 8, 0])) < 1e-5
    # phi·(W−1) just below W−1: the far corner wraps to column 0
    theta, phi = penv.dir_to_latlong_uv(torch.tensor([[-1e-3, 0.0, -1.0]]))
    assert float(phi[0]) * (W - 1) > W - 2
    seam = penv.read_envmap(torch.from_numpy(img), torch.tensor([[-1e-3, 0.0, -1.0]]))
    fx = float(phi[0]) * (W - 1)
    wx = fx - np.floor(fx)
    assert abs(float(seam[0, 0]) - ((1 - wx) * img[4, W - 2, 0] + wx * img[4, W - 1, 0])) < 1e-5


@pytest.mark.parametrize("hdr", [False, True], ids=["logistic", "exponential"])
def test_miss_background_matches_jax(hdr):
    """Both render backgrounds: the envmap over a non-black
    ``background_color``, mixed in linear light for sRGB outputs
    (Logistic) and as it is for HDR outputs (Exponential), against the JAX
    engine's ``_miss_background``; without an envmap the background
    colour."""
    ds = _make_dataset(n_views=2)
    ds.is_hdr = hdr
    bg = (0.2, 0.5, 0.8)
    jeng = JaxNerfEngine(copy.deepcopy(SMALL), ds, **ENGINE, background_color=bg)
    peng = NerfEngine(copy.deepcopy(SMALL), port_dataset(ds), device="cpu", **ENGINE,
                      background_color=bg)
    assert peng.rgb_act == jeng.rgb_act == ("Exponential" if hdr else "Logistic")
    d = _directions()
    img = _image(seed=3)
    img[..., 3] = np.clip(img[..., 3], 0.0, 1.0)
    want = np.asarray(jeng._miss_background({"envmap": {"image": jnp.asarray(img)}},
                                            jnp.asarray(d)))
    got = peng._miss_background(torch.from_numpy(d), torch.from_numpy(img))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    plain = np.asarray(jeng._miss_background({}, jnp.asarray(d)))
    np.testing.assert_allclose(peng._miss_background(torch.from_numpy(d)).numpy(), plain,
                               rtol=0, atol=0)

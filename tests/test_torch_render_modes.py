"""The NeRF debug render modes (normals, positions, encoding, cost) of the
port's ``NerfEngine.render_image`` against the JAX package's
``render_image(..., mode=)`` on the CPU, with the weights and occupancy
carried across.

Two scenes: the golden snapshot ``tests/golden/golden.ingp`` (a trained
sphere; XOR hash, float32 table reads), loaded by both packages, view 0 at
stride 4; and the full-width "tpu" tier (additive hash, bf16 table reads
for σ and float32 reads for ∇σ) with the port's seeded weights, its table
scaled to U(±0.1), over a ball of occupancy, as in
``tests/test_torch_render.py::test_tpu_tier_cascaded_render_matches_jax``.

Tolerances: cost exactly (march-step counts over 128); positions and
encoding within the golden render's 2e-4. Normals over the pixels whose
opacity exceeds 0.5 (where the opacity is low the composited normal weighs
samples of nearly empty space, whose normalised gradient is noise): per
sample the two packages' ∇σ agree to 2.3e-6 of |∇σ| on the "tpu" tier's
field, but a trilinear field's gradient jumps across every cell face, so a
sample position one rounding away picks another cell's gradient. The two
packages' sample positions differ by such roundings (the positions mode
differs by up to 6.7e-6). On the trained golden sphere that moves the
composited normal little: bound ``NORMALS_TOL`` = 2e-3, measured 6.1e-5.
The "tpu" tier's random field (a table of U(±0.1) on 8 levels) is rough:
moving the rays' origins by 1e-7 of themselves moves the port's own
normals frame by up to 4.4e-3 over those pixels, so its bound is
``NORMALS_TOL_ROUGH`` = 1e-2, measured 2.7e-3.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

from ngp_tpu_torch.interop import export_jax_params
from ngp_tpu_torch.ops.hashgrid import HASHGRID_ENCODE

# One intra-op thread: with two, torch's CPU sqrt (MKL's vsSqrt, split across
# the intra-op threads) now and then returned one thread's chunk ~3e-4 off
# on an AVX-512 Xeon (torch 2.13, MKL 2024.2), never with one
# (scripts/torch_sqrt_threads.py counts it).
# Every port test module sets the same count, so that a pytest worker's
# count does not depend on which module it imported last.
torch.set_num_threads(1)

GOLDEN_TOL = 2e-4
NORMALS_TOL = 2e-3
NORMALS_TOL_ROUGH = 1e-2
DEBUG_MODES = ("normals", "positions", "encoding", "cost")


@pytest.fixture(scope="module")
def golden():
    """The golden snapshot in both packages (``test_torch_render.py``)."""
    from golden.make_golden import build_engine
    from test_torch_render import GOLDEN_INGP, port_golden_engine

    peng, jeng = port_golden_engine(), build_engine()
    return (peng, *peng.load_reference_snapshot(GOLDEN_INGP),
            jeng, *jeng.load_reference_snapshot(GOLDEN_INGP))


@pytest.fixture(scope="module")
def tpu_tier():
    """The "tpu" tier's engines on one 32×18 view at aabb_scale 4, the
    port's seeded weights (table ×1e3) as both packages' state, and a ball
    of occupancy plus 5% noise."""
    from ngp_tpu.data.nerf_loader import NerfDataset as JaxNerfDataset
    from ngp_tpu.engines.nerf import NerfEngine as JaxNerfEngine
    from ngp_tpu.geometry.camera import Lens as JaxLens
    from ngp_tpu_torch.config import default_config
    from ngp_tpu_torch.data.nerf_loader import NerfDataset
    from ngp_tpu_torch.engines.nerf import NerfEngine
    from ngp_tpu_torch.geometry.camera import Lens

    res, focal = (32, 18), 16.0 / np.tan(np.radians(30.0))
    eye = np.asarray([2.0, 0.6, 0.9], np.float32)
    fwd = (0.5 - eye) / np.linalg.norm(0.5 - eye)
    right = np.cross(fwd, np.asarray([0, 0, 1], np.float32))
    right /= np.linalg.norm(right)
    xf = np.stack([right, np.cross(fwd, right), fwd, eye], 1).astype(np.float32)
    arrays = dict(images=np.zeros((1, res[1], res[0], 4), np.uint8),
                  xforms=np.stack([xf, xf])[None],
                  focal_lengths=np.full((1, 2), focal, np.float32),
                  principal_points=np.full((1, 2), 0.5, np.float32),
                  resolution=res, aabb_scale=4)
    peng = NerfEngine(default_config("tpu"), NerfDataset(lens=Lens(), **arrays),
                      grid_size=32, device="cpu")
    jeng = JaxNerfEngine(default_config("tpu"),
                         JaxNerfDataset(lens=JaxLens(), **arrays), grid_size=32)
    state = peng.init_state()
    with torch.no_grad():
        state.model.pos_encoding.table.mul_(1e3)
    rng = np.random.default_rng(0)
    r = (np.arange(32) + 0.5) / 32 - 0.5
    density = np.stack([
        ((r[:, None, None] ** 2 + r[None, :, None] ** 2 + r[None, None, :] ** 2)
         * 4.0 ** c <= 0.25).astype(np.float32) for c in range(3)])
    density[rng.uniform(size=density.shape) < 0.05] = 1.0
    grid = peng.grid_from_density(torch.from_numpy(density))
    # the JAX engine's render reads the served parameters and the bitfield
    params = {"model": jax.tree.map(jax.numpy.asarray, export_jax_params(state.model))}
    jstate = SimpleNamespace(params=params, ema=SimpleNamespace(params=params))
    jgrid = SimpleNamespace(bitfield=jax.numpy.asarray(grid.bitfield.numpy()))
    return peng, state, grid, jeng, jstate, jgrid


def _compare(mode, got, want, opacity, normals_tol=NORMALS_TOL):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    if mode == "cost":
        np.testing.assert_array_equal(got, want)
    elif mode == "normals":
        hit = opacity > 0.5
        assert hit.sum() >= 8
        err = float(np.abs(got[hit] - want[hit]).max())
        assert err <= normals_tol, err
    else:
        np.testing.assert_allclose(got, want, rtol=GOLDEN_TOL, atol=GOLDEN_TOL)


@pytest.mark.parametrize("mode", DEBUG_MODES)
def test_golden_debug_modes_match_jax(golden, mode):
    peng, pstate, pgrid, jeng, jstate, jgrid = golden
    got = peng.render_image(pstate, pgrid, 0, stride=4, mode=mode)
    want = jeng.render_image(jstate, jgrid, 0, stride=4, mode=mode)
    o, d, hw = peng.view_rays(0, stride=4)
    opacity = peng.render_rays(pstate, pgrid, o, d)[2].reshape(hw).numpy()
    assert float(opacity.max()) > 0.9  # the view shows the sphere
    _compare(mode, got, want, opacity)


@pytest.mark.parametrize("mode", ["normals", "encoding"])
def test_tpu_tier_debug_modes_match_jax(tpu_tier, mode):
    """The additive hash with bf16 reads for σ and the encoding, float32
    reads for ∇σ, as the JAX package reads them."""
    peng, state, grid, jeng, jstate, jgrid = tpu_tier
    assert peng.network.pos_encoding.bf16_reads
    o, d, _ = peng.view_rays(0)
    got, _, opacity = peng.render_rays(state, grid, o, d, mode=mode)
    want = jeng.render_rays(jstate, jgrid, jax.numpy.asarray(o.numpy()),
                            jax.numpy.asarray(d.numpy()), mode=mode)[0]
    assert float(opacity.max()) > 0.5  # rays do pass through density
    _compare(mode, got, want, opacity.numpy(), NORMALS_TOL_ROUGH)


def test_modes_share_the_composite_and_launch_no_table_gradient(golden, monkeypatch):
    """Every mode returns the shade pass's depth and opacity over every
    valid sample (the debug modes run uncompacted: at compaction 1.0 the
    shade pass matches); the normals render computes no d(table), although
    the served model's parameters require grad, and leaves them as it
    found them; the cost mode is the march's count over 128."""
    from ngp_tpu_torch.models import encodings
    from ngp_tpu_torch.ops.marching import march_rays, ray_aabb_range

    peng, pstate, pgrid, *_ = golden
    o, d, _ = peng.view_rays(0, stride=4)
    full = peng.render_rays(pstate, pgrid, o, d)
    model = peng.inference_params(pstate)
    model.requires_grad_(True)
    calls = []
    backward = encodings.hashgrid_backward
    monkeypatch.setattr(encodings, "hashgrid_backward",
                        lambda *a, **k: calls.append(1) or backward(*a, **k))
    launches = dict(HASHGRID_ENCODE.launches)
    for mode in DEBUG_MODES:
        rgb, depth, opacity = peng.render_rays(pstate, pgrid, o, d, mode=mode)
        torch.testing.assert_close(depth, full[1], rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(opacity, full[2], rtol=1e-6, atol=1e-6)
    assert not calls
    assert all(p.requires_grad for p in model.parameters())
    assert HASHGRID_ENCODE.launches == launches  # the CPU runs the twins
    tmin, tmax = peng.aabb.min, peng.aabb.max
    t0, _ = ray_aabb_range(o, d, tmin, tmax)
    marched = march_rays(o, d, pgrid.bitfield, tmin, tmax, peng.stepping,
                         peng.stepping.to_steps(t0 + 1e-4), peng.n_lattice,
                         peng.n_render_samples, peng.grid_cfg.max_mip)
    cost = peng.render_rays(pstate, pgrid, o, d, mode="cost")[0]
    torch.testing.assert_close(cost[:, 0], marched.n_samples.float() / 128.0,
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown render mode"):
        peng.render_rays(pstate, pgrid, o, d, mode="slice")

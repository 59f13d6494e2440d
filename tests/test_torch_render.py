"""The port's serving path end to end on the CPU: the reference snapshot
``tests/golden/golden.ingp`` loaded by ``ngp_tpu_torch`` and rendered
(view 0, stride 4) must match the JAX package's frozen render
``tests/golden/golden.npz["render"]``; the snapshot codec must agree with
the JAX package's."""

import os

import msgpack
import numpy as np
import torch

import jax

from ngp_tpu.data import ingp_snapshot as jingp
from ngp_tpu_torch.data import ingp_snapshot as pingp
from ngp_tpu_torch.data import msgpack_lite
from ngp_tpu_torch.data.nerf_loader import NerfDataset
from ngp_tpu_torch.engines.nerf import NerfEngine
from ngp_tpu_torch.interop import export_jax_params
from ngp_tpu_torch.ops.hashgrid import HASHGRID_ENCODE

# One intra-op thread: with two, torch's CPU sqrt (MKL's vsSqrt, split across
# the intra-op threads) now and then returned one thread's chunk ~3e-4 off
# on an AVX-512 Xeon (torch 2.13, MKL 2024.2), never with one
# (scripts/torch_sqrt_threads.py counts it).
# Every port test module sets the same count, so that a pytest worker's
# count does not depend on which module it imported last.
torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
GOLDEN_INGP = os.path.join(GOLDEN, "golden.ingp")


def port_golden_engine(**kw):
    """The port's engine with the golden fixture's render settings
    (``tests/golden/make_golden.py:build_engine``; its batch size and grid
    decay matter only to training) and camera set
    (``tests/test_nerf_engine.py:_make_dataset(6)``)."""
    from test_nerf_engine import CONFIG, _make_dataset

    jd = _make_dataset(6)
    ds = NerfDataset(
        images=jd.images, xforms=jd.xforms, focal_lengths=jd.focal_lengths,
        principal_points=jd.principal_points, lens=jd.lens,
        resolution=jd.resolution, aabb_scale=jd.aabb_scale,
    )
    return NerfEngine(dict(CONFIG), ds, grid_size=16, n_steps_per_unit=128,
                      seed=11, device="cpu", **kw)


def test_golden_render_matches_frozen_jax_render():
    """Same bound as the JAX package's own golden test
    (``test_golden_parity.py``): rtol = atol = 2e-4."""
    eng = port_golden_engine()
    state, grid = eng.load_reference_snapshot(GOLDEN_INGP)
    launches = HASHGRID_ENCODE.launches["hashgrid_encode"]
    img = eng.render_image(state, grid, 0, stride=4).numpy()
    gold = np.load(os.path.join(GOLDEN, "golden.npz"))["render"]
    assert img.shape == gold.shape == (12, 12, 3)
    np.testing.assert_allclose(img, gold, rtol=2e-4, atol=2e-4)
    assert gold.std() > 0.05  # the view shows the object, not background
    assert eng.last_render_samples > 0
    assert HASHGRID_ENCODE.launches["hashgrid_encode"] == launches  # the CPU runs the twin


def test_render_modes_and_uncompacted_render_agree():
    """depth and ao share the shade pass; with compaction off (frac 1.0)
    the golden view renders the same, since it never fills the budget."""
    eng = port_golden_engine()
    state, grid = eng.load_reference_snapshot(GOLDEN_INGP)
    o, d, _ = eng.view_rays(0, stride=4)
    rgb, depth, opacity = eng.render_rays(state, grid, o, d)
    rgb_d, _, _ = eng.render_rays(state, grid, o, d, mode="depth")
    rgb_a, _, _ = eng.render_rays(state, grid, o, d, mode="ao")
    torch.testing.assert_close(rgb_d, depth[:, None].expand(-1, 3))
    torch.testing.assert_close(rgb_a, opacity[:, None].expand(-1, 3))
    eng_full = port_golden_engine(render_compaction_frac=1.0)
    rgb_full, _, _ = eng_full.render_rays(state, grid, o, d)
    torch.testing.assert_close(rgb_full, rgb, rtol=0, atol=0)
    small = eng.render_rays(state, grid, o, d, chunk=7)[0]  # ragged chunks
    torch.testing.assert_close(small, rgb, rtol=1e-6, atol=1e-6)


def test_msgpack_lite_matches_msgpack():
    import zlib

    with open(GOLDEN_INGP, "rb") as f:
        blob = zlib.decompress(f.read())
    assert msgpack_lite.unpackb(blob) == msgpack.unpackb(
        blob, raw=False, strict_map_key=False)
    sample = {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
                 2**63, -1, -32, -33, -128, -129, -32768, -32769, -2**31,
                 -2**31 - 1, -2**63],
        "floats": [0.5, -1.25e300, float("inf")],
        "str": ["", "a" * 31, "b" * 32, "c" * 256, "é" * 40000],
        "bin": [b"", b"x" * 300, b"y" * 70000],
        "nested": {"list": list(range(20)), "map": {str(i): i for i in range(20)}},
        "consts": [None, True, False],
        7: "int key",
    }
    packed = msgpack.packb(sample, use_bin_type=True)
    assert msgpack_lite.unpackb(packed) == sample
    f32 = msgpack.packb(1.5, use_single_float=True)
    assert f32[0] == 0xCA and msgpack_lite.unpackb(f32) == 1.5


def test_snapshot_codec_matches_jax():
    from golden.make_golden import build_engine

    doc_j, doc_p = jingp.load_ingp(GOLDEN_INGP), pingp.load_ingp(GOLDEN_INGP)
    assert doc_j == doc_p
    snap = doc_p["snapshot"]
    jeng = build_engine()
    peng = port_golden_engine()
    want = jingp.params_from_reference(snap, jeng.network)
    got = pingp.params_from_reference(snap, peng.network)
    for k in ("pos_encoding", "density_mlp", "rgb_mlp"):
        for a, b in zip(jax.tree.leaves(got[k]), jax.tree.leaves(want[k])):
            np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(
        pingp.density_grid_from_reference(snap["density_grid_binary"], 1, 16),
        jingp.density_grid_from_reference(snap["density_grid_binary"], 1, 16))
    np.testing.assert_array_equal(pingp.morton_codes(16), jingp._morton_codes(16))

    jstate, jgrid = jeng.load_reference_snapshot(GOLDEN_INGP)
    pstate, pgrid = peng.load_reference_snapshot(GOLDEN_INGP)
    np.testing.assert_array_equal(pgrid.bitfield.numpy(), np.asarray(jgrid.bitfield))
    assert pstate.step == int(jstate.step)
    loaded = export_jax_params(pstate.model)
    np.testing.assert_array_equal(
        loaded["pos_encoding"]["table"],
        np.asarray(jeng.inference_params(jstate)["model"]["pos_encoding"]["table"]))


def test_tpu_tier_cascaded_render_matches_jax():
    """The serving configuration end to end: the full-width "tpu" tier
    (additive hash, bf16 table reads), aabb_scale 4 (three cascades,
    exponential stepping), compaction 0.625, against the JAX package's
    ``_render_chunk`` on the same rays, weights and bitfield. The weights
    are the port's seeded init with the table scaled to U(±0.1), so the
    grid shapes the output; the occupancy grid is a ball plus noise.
    Tolerance: the golden render's 2e-4."""
    from ngp_tpu.data.nerf_loader import NerfDataset as JaxNerfDataset
    from ngp_tpu.engines.nerf import NerfEngine as JaxNerfEngine
    from ngp_tpu.geometry.camera import Lens as JaxLens
    from ngp_tpu_torch.config import default_config
    from ngp_tpu_torch.geometry.camera import Lens

    res, focal = (32, 18), 16.0 / np.tan(np.radians(30.0))
    eye = np.asarray([2.5, 0.5, 1.1], np.float32)
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
    assert peng.n_lattice == jeng.n_lattice and peng.cone_angle > 0

    state = peng.init_state()
    with torch.no_grad():
        state.model.pos_encoding.table.mul_(1e3)
    tree = export_jax_params(state.model)
    rng = np.random.default_rng(0)
    r = (np.arange(32) + 0.5) / 32 - 0.5
    density = np.stack([
        ((r[:, None, None] ** 2 + r[None, :, None] ** 2 + r[None, None, :] ** 2)
         * 4.0 ** c <= 0.25).astype(np.float32) for c in range(3)])
    density[rng.uniform(size=density.shape) < 0.05] = 1.0
    grid = peng.grid_from_density(torch.from_numpy(density))

    o, d, _ = peng.view_rays(0)
    got = peng.render_rays(state, grid, o, d)
    jparams = {"model": jax.tree.map(jax.numpy.asarray, tree)}
    aabb = jeng.aabb
    want = jeng._render_chunk(jparams, jax.numpy.asarray(grid.bitfield.numpy()),
                              jax.numpy.asarray(o.numpy()),
                              jax.numpy.asarray(d.numpy()), aabb.min, aabb.max)
    assert peng.last_render_samples > 1000
    assert float(got[2].max()) > 0.1  # rays do pass through density
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4, atol=2e-4)

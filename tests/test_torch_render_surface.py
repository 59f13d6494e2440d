"""The rest of the NeRF render surface in the port (``engines/nerf.py``:
the crop box, overlays, the density slice, foveated frames and mesh vertex
optimisation; ``geometry/foveation.py``; ``ops/mesh_opt.py``) against the
JAX package on the CPU, on the golden snapshot ``tests/golden/golden.ingp``
loaded by both packages (view 0 at stride 4 where a view is rendered).

Tolerances:
- frames (crop box, overlays, foveated): the golden render's 2e-4;
- the crop box at the scene box: the uncropped frame bit for bit;
- the density slice: 1e-5 relative (one network evaluation a point);
- the foveation warp, unwarp and density: 1e-6 (the same float32 formulas);
- mesh optimisation: the gradient's terms and 3 Adam steps within 1e-5.
  The 1-ring and normal sums are ``index_add_`` in the port (float32, in
  the face list's order on the CPU) and prefix-sum differences in the JAX
  package (``dense_segment_sum``), which are off by a few 2^-24 of each
  column's total (ROADMAP C.ref 12): the port is held to float64 sums
  within 1e-6 of each column's total and to the JAX sums within
  ``SUM_ULPS``·2^-24 of it. Downstream, k_smooth = 2048 scales that error
  to ~0.2 in the gradient, and where a gradient component is within it of
  0 Adam's step takes the other sign (a vertex then differs by 2·lr). So
  the gradient and the 3 steps are held within 1e-5 to the JAX functions
  with their segment sum replaced, in the test, by ``jax.ops.segment_sum``
  (a scatter-add, the sum the reference's atomics compute); against the
  JAX package as it is, the gradient within k_smooth times the sums'
  bound and the steps within 1e-5 at 99% of the vertices.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ngp_tpu.geometry.foveation import Foveation as JaxFoveation
from ngp_tpu.ops import mesh_opt as jmesh
from ngp_tpu_torch.geometry.foveation import Foveation, PiecewiseQuadratic
from ngp_tpu_torch.ops import mesh_opt as pmesh

# One intra-op thread, as in every port test module (see
# tests/test_torch_train_step.py).
torch.set_num_threads(1)

GOLDEN_TOL = 2e-4
SUM_ULPS = 8.0


@pytest.fixture(scope="module")
def golden():
    """The golden snapshot in both packages (``test_torch_render.py``)."""
    from golden.make_golden import build_engine
    from test_torch_render import GOLDEN_INGP, port_golden_engine

    peng, jeng = port_golden_engine(), build_engine()
    return (peng, *peng.load_reference_snapshot(GOLDEN_INGP),
            jeng, *jeng.load_reference_snapshot(GOLDEN_INGP))


HALF_BOX = (np.asarray([0.5, 0.1, 0.1], np.float32), np.asarray([0.9, 0.9, 0.8], np.float32))


@pytest.mark.parametrize("box", ["half", "offset"])
def test_crop_box_frame_matches_jax(golden, box):
    """A crop box inside the scene box (``render_aabb``, set on both
    engines): the frame within 2e-4; the pixels whose rays miss the box
    are the background exactly, and the crop marches fewer samples."""
    peng, pstate, pgrid, jeng, jstate, jgrid = golden
    crop = HALF_BOX if box == "half" else (np.asarray([0.3, 0.35, 0.2], np.float32),
                                           np.asarray([0.7, 0.75, 1.0], np.float32))
    full = peng.render_image(pstate, pgrid, 0, stride=4)
    full_samples = peng.last_render_samples
    try:
        peng.render_aabb = jeng.render_aabb = crop
        got = peng.render_image(pstate, pgrid, 0, stride=4)
        want = np.asarray(jeng.render_image(jstate, jgrid, 0, stride=4))
        crop_samples = peng.last_render_samples
        o, d, _ = peng.view_rays(0, stride=4)
    finally:
        peng.render_aabb = jeng.render_aabb = None
    np.testing.assert_allclose(got.numpy(), want, rtol=GOLDEN_TOL, atol=GOLDEN_TOL)
    assert crop_samples < full_samples
    assert not torch.equal(got, full)
    from ngp_tpu_torch.ops.marching import ray_aabb_range

    tmin, tmax = ray_aabb_range(o, d, torch.from_numpy(crop[0]), torch.from_numpy(crop[1]))
    miss = (tmin > tmax).reshape(got.shape[:2])
    assert miss.any()
    bg = torch.as_tensor(peng.background_color, dtype=torch.float32)
    assert torch.equal(got[miss], bg.expand(int(miss.sum()), 3))


def test_crop_box_at_the_scene_box_is_the_uncropped_frame(golden):
    """``max(tmin, tcmin) + 1e-4`` with tcmin = tmin and the exit test at
    tcmax = tmax: bit for bit."""
    peng, pstate, pgrid, *_ = golden
    want = peng.render_image(pstate, pgrid, 0, stride=4)
    peng.render_aabb = (peng.aabb.min.numpy(), peng.aabb.max.numpy())
    try:
        got = peng.render_image(pstate, pgrid, 0, stride=4)
    finally:
        peng.render_aabb = None
    assert torch.equal(got, want)


@pytest.mark.parametrize("overlay", ["gt", "error"])
def test_overlays_match_jax(golden, overlay):
    """Within 2e-4; "gt"'s left half is the ground truth exactly."""
    peng, pstate, pgrid, jeng, jstate, jgrid = golden
    got = peng.render_image(pstate, pgrid, 0, stride=4, overlay=overlay)
    want = np.asarray(jeng.render_image(jstate, jgrid, 0, stride=4, overlay=overlay))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=GOLDEN_TOL, atol=GOLDEN_TOL)
    if overlay == "gt":
        half = got.shape[1] // 2
        gt = peng.images[0, ::4, ::4, :3].to(torch.float32)
        if peng.images.dtype == torch.uint8:
            gt = gt / 255.0
        assert torch.equal(got[:, :half], gt[:, :half])
    else:
        assert float(got[..., 0].max()) == pytest.approx(1.0)
    with pytest.raises(ValueError, match="unknown overlay"):
        peng.render_image(pstate, pgrid, 0, stride=8, overlay="heat")


@pytest.mark.parametrize("z", [0.5, 0.3])
def test_density_slice_matches_jax(golden, z):
    """A host (res, res) array within 1e-5 relative."""
    peng, pstate, _, jeng, jstate, _ = golden
    got = peng.render_density_slice(pstate, z, resolution=48)
    want = jeng.render_density_slice(jstate, z, resolution=48)
    assert isinstance(got, np.ndarray) and got.shape == (48, 48)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * float(want.max()))
    assert want.max() > 10 * want.min()  # the slice crosses the sphere


@pytest.mark.parametrize("steep,center,radius", [
    (1.0, 0.5, 0.2), (0.5, 0.5, 0.1), (0.33, 0.3, 0.05), (0.7, 0.7, 0.2), (0.6, 0.1, 0.3),
])
def test_piecewise_quadratic_matches_jax(steep, center, radius):
    """The coefficients equal (the same double bisection); warp, unwarp and
    density on 1,025 points within 1e-6."""
    from ngp_tpu.geometry.foveation import PiecewiseQuadratic as JaxPQ

    pq, jpq = PiecewiseQuadratic.make(steep, center, radius), JaxPQ.make(steep, center, radius)
    assert pq.__dict__ == jpq.__dict__
    x = np.linspace(-0.05, 1.05, 1025, dtype=np.float32)
    for fn in ("warp", "unwarp", "density"):
        got = getattr(pq, fn)(torch.from_numpy(x)).numpy()
        want = np.asarray(getattr(jpq, fn)(jnp.asarray(x)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=fn)


def test_foveation_2d_matches_jax():
    """Per-axis warps on random uv: warp, unwarp, density within 1e-6; the
    round trip within 1e-4 (the JAX test's bound)."""
    fov = Foveation.make((0.5, 0.6), (0.5, 0.4), 0.1)
    jfov = JaxFoveation.make((0.5, 0.6), (0.5, 0.4), 0.1)
    uv = np.random.default_rng(0).random((256, 2)).astype(np.float32)
    for fn in ("warp", "unwarp", "density"):
        got = getattr(fov, fn)(torch.from_numpy(uv)).numpy()
        want = np.asarray(getattr(jfov, fn)(jnp.asarray(uv)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=fn)
    back = fov.unwarp(fov.warp(torch.from_numpy(uv))).numpy()
    np.testing.assert_allclose(back, uv, atol=1e-4)


@pytest.mark.parametrize("scale", [0.5, 0.3])
def test_foveated_frame_matches_jax(golden, scale):
    """The foveated frame within 2e-4, the same buffer size, and near the
    full frame at the focus (the JAX test's 0.08)."""
    peng, pstate, pgrid, jeng, jstate, jgrid = golden
    xf, f = jeng.dataset.xforms[0, 0], jeng.dataset.focal_lengths[0]
    kw = dict(width=40, height=32, buffer_scale=scale)
    got, size = peng.render_view_foveated(pstate, pgrid, xf, f,
                                          Foveation.make(0.6, 0.5, 0.15), **kw)
    want, jsize = jeng.render_view_foveated(jstate, jgrid, xf, f,
                                            JaxFoveation.make(0.6, 0.5, 0.15), **kw)
    assert got.shape == (32, 40, 3) and tuple(size) == tuple(jsize)
    assert size == (max(round(40 * scale), 16), 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=GOLDEN_TOL,
                               atol=GOLDEN_TOL)
    full, _, _ = peng.render_view(pstate, pgrid, xf, f, width=40, height=32)
    assert float((full[12:20, 16:24] - got[12:20, 16:24]).abs().mean()) < 0.08


def _tetra():
    verts = np.asarray([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]],
                       np.float32)
    faces = np.asarray([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]], np.int32)
    return verts, faces


# the golden sphere's raw density reaches 2.7 at most: its mesh is taken at 0
MESH_THRESH = 0.0


def _mesh(golden, resolution: int = 24):
    peng, pstate, *_ = golden
    verts, faces = peng.compute_marching_cubes_mesh(pstate, resolution, MESH_THRESH)
    assert len(faces) > 1000
    verts, faces = np.ascontiguousarray(verts), np.ascontiguousarray(faces)
    return verts, faces


def _sums_f64(verts, faces):
    """The 1-ring sums (V, 4) and normal sums (V, 3) in float64."""
    v = verts.astype(np.float64)
    a, b, c = faces.T
    fn = np.cross(v[b] - v[a], v[c] - v[a])
    ring = np.zeros((len(v), 4))
    nrm = np.zeros((len(v), 3))
    for corner, others in ((a, (b, c)), (b, (a, c)), (c, (a, b))):
        np.add.at(ring, corner, np.concatenate([v[others[0]] + v[others[1]],
                                                np.full((len(a), 1), 2.0)], 1))
        np.add.at(nrm, corner, fn)
    return ring, nrm


@pytest.mark.parametrize("mesh", ["tetra", "marching_cubes"])
def test_vertex_ring_and_normals_match(golden, mesh):
    """The tetrahedron exactly as the JAX test states it; on the golden
    sphere's mesh the sums within 1e-6 of each column's total of float64
    sums, and the JAX ones within ``SUM_ULPS``·2^-24 of it."""
    verts, faces = _tetra() if mesh == "tetra" else _mesh(golden)
    ring, nrm = pmesh.vertex_ring_and_normals(torch.from_numpy(verts), torch.from_numpy(faces))
    jring, jnrm = jmesh.vertex_ring_and_normals(jnp.asarray(verts), jnp.asarray(faces))
    ring64, nrm64 = _sums_f64(verts, faces)
    w = np.maximum(ring64[:, 3:], 1.0)
    total = np.abs(ring64[:, :3]).sum(0) + np.abs(nrm64).sum(0)
    np.testing.assert_allclose(ring.numpy(), ring64[:, :3] / w, rtol=0,
                               atol=1e-6 * total.max() / w.min())
    np.testing.assert_allclose(nrm.numpy(), nrm64, rtol=0, atol=1e-6 * np.abs(nrm64).sum())
    bound = SUM_ULPS * 2.0 ** -24
    np.testing.assert_allclose(ring.numpy(), np.asarray(jring), rtol=0,
                               atol=bound * np.abs(ring64[:, :3]).sum() / w.min())
    np.testing.assert_allclose(nrm.numpy(), np.asarray(jnrm), rtol=0,
                               atol=bound * np.abs(nrm64).sum())
    if mesh == "tetra":
        np.testing.assert_allclose(ring.numpy()[0], verts[1:].mean(0), atol=1e-6)
        assert float(nrm[0] @ torch.from_numpy(verts[0] - verts.mean(0))) > 0


def _scatter_sum(monkeypatch):
    """The JAX mesh module's segment sum replaced by a scatter-add."""
    import jax

    monkeypatch.setattr(jmesh, "dense_segment_sum",
                        lambda keys, vals, n: jax.ops.segment_sum(vals, keys, n))


def test_mesh_opt_gradient_matches_jax(golden, monkeypatch):
    """The three terms on the tetrahedron (the JAX test's case) within
    1e-5, and on the golden mesh with seeded densities and gradients:
    within k_smooth times the sums' bound of the JAX package's, within
    1e-5 of its functions on a scatter-add."""
    verts, faces = _tetra()
    d = np.asarray([3.0, 1.0, 3.0, 1.0], np.float32)
    dg = np.tile(np.asarray([[1.0, 0.0, 0.0]], np.float32), (4, 1))
    for k in (dict(k_smooth=0.0, k_density=1.0, k_inflate=0.0), {}):
        got = pmesh.mesh_opt_gradient(torch.from_numpy(verts), torch.from_numpy(faces),
                                      torch.from_numpy(d), torch.from_numpy(dg), 2.0, **k)
        want = jmesh.mesh_opt_gradient(jnp.asarray(verts), jnp.asarray(faces),
                                       jnp.asarray(d), jnp.asarray(dg), 2.0, **k)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    verts, faces = _mesh(golden)
    rng = np.random.default_rng(3)
    d = rng.uniform(1.5, 3.5, len(verts)).astype(np.float32)
    dg = rng.normal(size=(len(verts), 3)).astype(np.float32)
    got = pmesh.mesh_opt_gradient(torch.from_numpy(verts), torch.from_numpy(faces),
                                  torch.from_numpy(d), torch.from_numpy(dg), 2.5).numpy()

    def jax_gradient():
        return np.asarray(jmesh.mesh_opt_gradient(jnp.asarray(verts), jnp.asarray(faces),
                                                  jnp.asarray(d), jnp.asarray(dg), 2.5))

    ring64, _ = _sums_f64(verts, faces)
    bound = 2048.0 * SUM_ULPS * 2.0 ** -24 * np.abs(ring64[:, :3]).sum() / max(
        ring64[:, 3].min(), 1.0)
    np.testing.assert_allclose(got, jax_gradient(), rtol=0, atol=bound)
    _scatter_sum(monkeypatch)
    want = jax_gradient()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_optimize_mesh_vertices_matches_jax(golden, monkeypatch):
    """Three steps from the golden sphere's marching-cubes mesh (numpy
    arrays in, as ``compute_marching_cubes_mesh`` gives them): the
    vertices within 1e-5 of the JAX package's at 99% of them, and of its
    steps on a scatter-add at every one; the vertices move, and no table
    gradient is left behind (the parameters stay frozen)."""
    peng, pstate, _, jeng, jstate, _ = golden
    verts, faces = _mesh(golden)
    kw = dict(n_steps=3, density_thresh=MESH_THRESH)
    got = peng.optimize_mesh_vertices(pstate, verts, faces, **kw)
    want = np.asarray(jeng.optimize_mesh_vertices(jstate, verts, faces, **kw))
    assert got.shape == verts.shape and got.dtype == torch.float32
    near = np.all(np.abs(got.numpy() - want) <= 1e-5, axis=1)
    assert near.mean() >= 0.99
    _scatter_sum(monkeypatch)
    want = np.asarray(jeng.optimize_mesh_vertices(jstate, verts, faces, **kw))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    moved = np.abs(got.numpy() - verts).max()
    assert 1e-4 < moved < 1e-3  # 3 Adam steps of 1e-4
    model = peng.inference_params(pstate)
    assert all(p.grad is None and p.requires_grad for p in model.parameters())
    again = peng.optimize_mesh_vertices(pstate, torch.from_numpy(verts),
                                        torch.from_numpy(faces), **kw)
    assert torch.equal(again, got)

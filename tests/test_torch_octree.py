"""The port's triangle octree (``ngp_tpu_torch/geometry/triangle_octree.py``)
and host builders (``ngp_tpu_torch/ops/host_build.py``, the C++ of
``ngp_tpu_torch/hostsrc/ngp_host.cpp``) against the JAX package on the CPU.

Meshes: the 12-triangle cube of ``tests/test_octree_takikawa.py`` at depth 5
and a bumpy icosphere of 3 subdivisions (1,280 triangles) at depth 7; the
thread-split cases use 4 subdivisions (5,120 triangles), enough for the C++
builders to split their loops. The JAX package's own octree build prefers
its native library; the tests switch that off (``ngp_tpu.native`` returning
None) so that they hold the port to its numpy path. Every comparison is
exact: the builds are integer codes and ids, the queries integer lookups,
float32 fractions and float32 divisions by powers of two.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ngp_tpu.native as jax_native
from ngp_tpu.geometry import triangle_bvh as jbvh
from ngp_tpu.geometry import triangle_octree as joct
from ngp_tpu.geometry.mesh import normalize_mesh
from ngp_tpu_torch.data.synthetic import bumpy_sphere
from ngp_tpu_torch.geometry import triangle_bvh as pbvh
from ngp_tpu_torch.geometry import triangle_octree as poct
from ngp_tpu_torch.ops import host_build

# One intra-op thread, as in every port test module (test_torch_sdf.py).
torch.set_num_threads(1)


def _cube_mesh(lo=0.3, hi=0.7):
    """``tests/test_octree_takikawa.py``'s 12-triangle cube in [lo, hi]³."""
    c = np.array([[x, y, z] for z in (lo, hi) for y in (lo, hi) for x in (lo, hi)],
                 np.float32)
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6), (0, 2, 6, 4),
             (1, 5, 7, 3)]
    tris = []
    for a, b, cc, d in quads:
        tris += [[c[a], c[b], c[cc]], [c[a], c[cc], c[d]]]
    return np.asarray(tris, np.float32)


def _sphere(subdivisions):
    v, f = bumpy_sphere(subdivisions)
    return normalize_mesh(v[f]).triangles


CASES = {"cube": (_cube_mesh(), 5), "sphere": (_sphere(3), 7)}


@pytest.fixture
def jax_numpy_octree(monkeypatch):
    """The JAX package's ``TriangleOctree.build`` on its numpy path."""
    monkeypatch.setattr(jax_native, "octree_build", lambda *a: None)
    monkeypatch.setattr(jax_native, "chessboard_dt", lambda *a: None)
    return joct.TriangleOctree.build


def _assert_same_octree(got: dict, want):
    """``got`` (:func:`poct.octree_arrays`) equals the JAX octree ``want``
    (or another arrays dict) array for array, dtypes included."""
    def field(name):
        return want[name] if isinstance(want, dict) else getattr(want, name)

    assert len(got["codes"]) == len(field("codes"))
    for key in ("codes", "verts"):
        for d, (g, w) in enumerate(zip(got[key], field(key))):
            assert g.dtype == np.int32 and np.asarray(w).dtype == np.int32, (key, d)
            np.testing.assert_array_equal(g, w, err_msg=f"{key}[{d}]")
    assert got["n_vertices"] == field("n_vertices")
    assert got["dt_depth"] == field("dt_depth")
    np.testing.assert_array_equal(got["distance_field"], field("distance_field"))
    assert np.asarray(field("distance_field")).dtype == np.int32


# -- the numpy pieces


def test_tri_box_overlap_matches_jax():
    """The SAT test equals the JAX package's on random triangles and cubes
    (many overlaps and misses) and on its four hand-made cases."""
    rng = np.random.default_rng(0)
    tri = rng.uniform(0.2, 0.8, (4096, 3, 3))
    center = rng.uniform(0.2, 0.8, (4096, 3))
    for half in (0.01, 0.05, 0.15):
        got = poct.tri_box_overlap(center, half, tri)
        np.testing.assert_array_equal(got, joct.tri_box_overlap(center, half, tri))
        assert 0 < got.sum() < len(got)
    t = np.array([[[0.1, 0.1, 0.5], [0.9, 0.1, 0.5], [0.5, 0.9, 0.5]]])
    for c, half, want in (((0.5, 0.5, 0.5), 0.2, True), ((0.5, 0.5, 0.0), 0.2, False),
                          ((2.0, 0.5, 0.5), 0.2, False), ((0.5, 0.3, 0.5), 0.05, True)):
        assert poct.tri_box_overlap(np.array([c]), half, t)[0] == want


@pytest.mark.parametrize("G,density", [(12, 0.03), (16, 0.002), (9, 0.3)])
def test_distance_transforms_match_jax_and_brute_force(G, density):
    """The numpy and the C++ chessboard transforms equal the JAX package's
    numpy transform and a brute-force L∞ distance to the nearest occupied
    cell, exactly."""
    rng = np.random.default_rng(G)
    occ = rng.uniform(size=(G, G, G)) < density
    occ[G // 2, 1, G - 2] = True
    pts = np.argwhere(occ)
    q = np.stack(np.meshgrid(*[np.arange(G)] * 3, indexing="ij"), -1).reshape(-1, 1, 3)
    brute = np.abs(q - pts[None]).max(-1).min(-1).reshape(G, G, G)
    for got in (poct.chessboard_distance(occ), host_build.chessboard_dt(occ)):
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, brute)
    np.testing.assert_array_equal(joct._chessboard_distance(occ), brute)


@pytest.mark.parametrize("name", sorted(CASES))
def test_numpy_build_matches_jax(name, jax_numpy_octree):
    """The port's numpy build equals the JAX package's numpy build array
    for array: codes, dual-vertex ids, vertex count, distance field."""
    tris, depth = CASES[name]
    want = jax_numpy_octree(tris, depth)
    _assert_same_octree(poct.octree_arrays_numpy(tris, depth), want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_native_build_matches_numpy(name):
    """The C++ build equals the numpy build array for array; on the CPU
    tensors of ``TriangleOctree.build`` the same values."""
    tris, depth = CASES[name]
    want = poct.octree_arrays_numpy(tris, depth)
    got = poct.octree_arrays(tris, depth)
    _assert_same_octree(got, want)
    oc = poct.TriangleOctree.build(tris, depth, device="cpu")
    assert oc.max_depth == depth and oc.n_vertices == want["n_vertices"]
    assert oc.n_nodes == sum(len(c) for c in want["codes"])
    for d in range(depth):
        np.testing.assert_array_equal(oc.codes[d].numpy(), want["codes"][d])
        np.testing.assert_array_equal(oc.verts[d].numpy(), want["verts"][d])
    np.testing.assert_array_equal(oc.distance_field.numpy(), want["distance_field"])


@pytest.mark.parametrize("n_threads", [1, 2, 3, 7])
def test_native_builds_do_not_depend_on_the_thread_split(n_threads):
    """5,120 triangles split over 1, 2, 3 or 7 threads: the octree at depth
    6 and the BVH equal the numpy builds (and so each other)."""
    tris = _sphere(4)
    want = poct.octree_arrays_numpy(tris, 6)
    _assert_same_octree(poct.octree_arrays(tris, 6, n_threads=n_threads), want)
    want = pbvh.build_bvh_arrays(tris)
    got = pbvh.build_bvh_arrays_native(tris, n_threads)
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if key == "depth":
            assert g == w
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, key
        np.testing.assert_array_equal(g, w, err_msg=key)


@pytest.mark.parametrize("name", ["cube", "sphere", "two_triangles"])
def test_native_bvh_matches_the_numpy_build_and_jax(name):
    """``build_bvh`` (the C++ builder) equals the numpy build's tree
    (arrays, depth, packed records, root) and the JAX package's numpy
    build."""
    tris = {"cube": _cube_mesh(), "sphere": _sphere(3),
            "two_triangles": _cube_mesh()[:2]}[name]
    native = pbvh.build_bvh(tris, "cpu")
    plain = pbvh.build_bvh_arrays(tris)
    records, root = pbvh.pack_bvh_records(plain)
    want = jbvh._build_bvh_numpy(tris)
    for field in want._fields:
        np.testing.assert_array_equal(getattr(native, field).numpy(), plain[field],
                                      err_msg=field)
        np.testing.assert_array_equal(getattr(native, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)
    assert native.depth == plain["depth"] and native.root == root
    np.testing.assert_array_equal(native.records.numpy(), records)


def test_depth_limits_and_builders_refused():
    """Depths outside [2, 11] raise a ``ValueError`` that names the limit
    (the JAX package's assertion, ROADMAP C.ref 14), from the C++ and the
    numpy builder alike."""
    tris = _cube_mesh()
    for depth in (1, 12, 16):
        for build in (poct.TriangleOctree.build, poct.octree_arrays_numpy):
            with pytest.raises(ValueError,
                               match=rf"octree depth {depth} is outside \[2, 11\]"):
                build(tris, depth)


def test_a_failed_host_compile_raises(monkeypatch, tmp_path):
    """Where the compiler fails the host builders raise; nothing falls
    back to numpy. The library's name follows its source and flags."""
    path = host_build.lib_path()
    assert path.name.startswith("libngp_host-") and path.suffix == ".so"
    monkeypatch.setattr(host_build, "_LIB", None)
    monkeypatch.setattr(host_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(host_build, "CXX_FLAGS", host_build.CXX_FLAGS + ("-DNGP_BOGUS",))
    assert host_build.lib_path() != path
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for ngp_host.cpp"):
        poct.TriangleOctree.build(_cube_mesh(), 4)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        pbvh.build_bvh(_cube_mesh())


# -- the queries


def _query_points(n, seed):
    """Uniform points, points on voxel faces of every depth up to 6 and
    points outside [0, 1]³."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, 3))
    x[: n // 8] = np.round(x[: n // 8] * 64) / 64
    x[n // 8: n // 4] = rng.uniform(-0.2, 1.2, (n // 8, 3))
    x[0], x[1] = 0.0, 1.0
    return x.astype(np.float32)


@pytest.mark.parametrize("name", sorted(CASES))
def test_queries_match_jax(name, jax_numpy_octree):
    """At every depth ``lookup_level`` (found, vertex ids, fractions),
    ``contains`` and ``skip_distance`` equal the JAX octree's, exactly."""
    tris, depth = CASES[name]
    joc = jax_numpy_octree(tris, depth)
    poc = poct.TriangleOctree.build(tris, depth, device="cpu")
    x = _query_points(4096, 1)
    xj, xp = jnp.asarray(x), torch.from_numpy(x)
    for d in range(depth):
        jf, jv, jfr = map(np.asarray, joc.lookup_level(d, xj))
        pf, pv, pfr = poc.lookup_level(d, xp)
        np.testing.assert_array_equal(pf.numpy(), jf, err_msg=f"found {d}")
        np.testing.assert_array_equal(pv.numpy(), jv, err_msg=f"verts {d}")
        np.testing.assert_array_equal(pfr.numpy(), jfr, err_msg=f"frac {d}")
        assert pv.dtype == torch.int32 and pfr.dtype == torch.float32
    inside = poc.contains(xp).numpy()
    np.testing.assert_array_equal(inside, np.asarray(joc.contains(xj)))
    assert 0 < inside.sum() < len(inside)
    skip = poc.skip_distance(xp)
    np.testing.assert_array_equal(skip.numpy(), np.asarray(joc.skip_distance(xj)))
    assert skip.dtype == torch.float32 and float(skip.max()) > 0


def test_skip_distance_is_a_safe_lower_bound():
    """``skip_distance`` never exceeds the Euclidean distance to the
    nearest occupied voxel of the distance field's depth."""
    oc = poct.TriangleOctree.build(_cube_mesh(), 5, device="cpu")
    G = 1 << oc.dt_depth
    c = oc.codes[oc.dt_depth].numpy().astype(np.int64)
    cells = np.stack([c & (G - 1), (c >> oc.dt_depth) & (G - 1), c >> (2 * oc.dt_depth)], -1)
    q = np.random.default_rng(3).uniform(size=(512, 3)).astype(np.float32)
    skip = oc.skip_distance(torch.from_numpy(q)).numpy()
    d = np.maximum(cells[None] / G - q[:, None], np.maximum(q[:, None] - (cells[None] + 1) / G, 0))
    true = np.sqrt((np.maximum(d, 0) ** 2).sum(-1)).min(1)
    assert (skip <= true + 1e-6).all() and (skip > 0).any()


@pytest.mark.parametrize("name", sorted(CASES))
def test_sample_uniform_from_the_jax_draws(name, jax_numpy_octree):
    """``sample_uniform`` fed the JAX package's draws (its key split into
    ``randint`` leaf numbers and ``uniform`` offsets) equals its
    ``sample_uniform`` exactly; the port's own draws land in leaves."""
    tris, depth = CASES[name]
    joc = jax_numpy_octree(tris, depth)
    poc = poct.TriangleOctree.build(tris, depth, device="cpu")
    key, n = jax.random.PRNGKey(4), 2048
    want = np.asarray(joc.sample_uniform(key, n))
    k1, k2 = jax.random.split(key)
    pick = np.asarray(jax.random.randint(k1, (n,), 0, len(joc.codes[depth - 1])))
    u = np.array(jax.random.uniform(k2, (n, 3)))
    got = poc.sample_uniform(torch.from_numpy(pick.astype(np.int64)), torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), want)
    pick, u = poc.draw_uniform(n, torch.Generator().manual_seed(0))
    assert pick.shape == (n,) and u.shape == (n, 3)
    assert int(pick.min()) >= 0 and int(pick.max()) < len(poc.codes[depth - 1])
    assert bool(poc.contains(poc.sample_uniform(pick, u)).all())

"""The port's SDF geometry (``ngp_tpu_torch/geometry/mesh.py``,
``geometry/triangle_bvh.py`` and the BVH kernels' twins in ``ops/bvh.py``)
against the JAX package on the CPU.

Meshes: the cube and the two cubes of ``tests/test_sdf.py``, a bumpy
icosphere of 3 subdivisions (1,280 triangles, ``data/synthetic.py``) and a
soup of 500 random triangles. Loaders, normalisation, the area CDF, surface
samples and the BVH build compute the same numpy formulas and are equal
exactly. The queries are float32 traversals in two frameworks: the JAX
package's XLA loops may order a sum otherwise, so distances agree within
2e-6 in the unit cube, a leaf slot may differ only between candidates
within that bound, and a ray's t within 1e-5·max(1, t) (a quotient of dot
products of unit-scale vectors, rounded relative to the scene's scale).
"""

import struct

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ngp_tpu.geometry import mesh as jmesh
from ngp_tpu.geometry import triangle_bvh as jbvh
from ngp_tpu_torch.data.synthetic import bumpy_sphere, write_bumpy_sphere_mesh
from ngp_tpu_torch.geometry import mesh as pmesh
from ngp_tpu_torch.geometry import triangle_bvh as pbvh

# One intra-op thread: with two, torch's CPU sqrt (MKL's vsSqrt, split across
# the intra-op threads) now and then returned one thread's chunk ~3e-4 off
# on an AVX-512 Xeon (torch 2.13, MKL 2024.2), never with one
# (scripts/torch_sqrt_threads.py counts it).
# Every port test module sets the same count, so that a pytest worker's
# count does not depend on which module it imported last.
torch.set_num_threads(1)

N_QUERIES = 4096
DIST_TOL = 2e-6


def _cube_triangles(center, half):
    """``tests/test_sdf.py``'s 12-triangle cube, outward CCW winding."""
    c = np.asarray(center, np.float32)
    v = np.array([[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
                  [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]], np.float32) * float(half) + c
    faces = [(0, 2, 1), (0, 3, 2), (4, 5, 6), (4, 6, 7), (0, 1, 5), (0, 5, 4),
             (3, 6, 2), (3, 7, 6), (0, 4, 7), (0, 7, 3), (1, 2, 6), (1, 6, 5)]
    return v[np.asarray(faces)]


def _meshes():
    bumpy_v, bumpy_f = bumpy_sphere(3)
    return {
        "cube": _cube_triangles([0.5, 0.5, 0.5], 0.25),
        "two_cubes": np.concatenate([_cube_triangles([0.45, 0.35, 0.5], 0.2),
                                     _cube_triangles([0.72, 0.72, 0.77], 0.08)]),
        "bumpy": jmesh.normalize_mesh(bumpy_v[bumpy_f]).triangles,
        "soup": np.random.default_rng(7).uniform(0.1, 0.9, (500, 3, 3)).astype(np.float32),
    }


MESHES = _meshes()


def _build_cases():
    """The meshes, and two that stress the sort's ties: 50 triangles five
    times over, and centroids at +0.0 and −0.0 (numpy holds them equal)."""
    rng = np.random.default_rng(1)
    zeros = rng.normal(size=(3000, 3, 3)).astype(np.float32)
    zeros[:200] = 0.0
    zeros[200:400, :, 0] = -0.0
    return {**MESHES, "repeated": np.repeat(MESHES["soup"][:50], 5, axis=0),
            "signed_zeros": zeros}


BUILD_CASES = _build_cases()


# -- loaders and normalisation


def _write_stl(path, tris):
    with open(path, "wb") as f:
        f.write(b"\0" * 80 + struct.pack("<I", len(tris)))
        for t in tris:
            f.write(struct.pack("<3f", 0, 0, 1) + t.astype("<f4").tobytes() + b"\0\0")


@pytest.mark.parametrize("kind", ["obj", "stl", "polygon_obj"])
def test_loaders_normalisation_and_sampling_equal_jax(kind, tmp_path):
    """``load_mesh_file``, ``normalize_mesh`` (triangles, scale, boxes),
    areas, ``area_cdf``, normals and ``sample_surface`` exactly equal."""
    path = str(tmp_path / f"m.{kind.split('_')[-1]}")
    if kind == "obj":
        write_bumpy_sphere_mesh(path, 2)
    elif kind == "stl":
        _write_stl(path, MESHES["two_cubes"] * 7.0 - 3.0)
    else:  # a quad and a pentagon as fans, v/vt/vn tokens, negative indices
        with open(path, "w") as f:
            f.write("# polygons\nv 0 0 0\nv 2 0 0\nv 2 1 0\nv 0 1 0\nv 1 2 1\n"
                    "vt 0 0\nvn 0 0 1\nf 1/1/1 2/1/1 3/1/1 4/1/1\n"
                    "f -5 -4 -3 -2 -1\nf 1 3 5\n")
    raw = pmesh.load_mesh_file(path)
    np.testing.assert_array_equal(raw, jmesh.load_mesh_file(path))
    assert raw.dtype == np.float32 and raw.shape[1:] == (3, 3)
    got, want = pmesh.load_mesh(path), jmesh.load_mesh(path)
    for field in ("triangles", "raw_aabb_min", "raw_aabb_max", "aabb_min", "aabb_max"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    assert got.mesh_scale == want.mesh_scale and got.n_triangles == want.n_triangles
    np.testing.assert_array_equal(got.areas(), want.areas())
    np.testing.assert_array_equal(got.area_cdf(), want.area_cdf())
    np.testing.assert_array_equal(got.normals(), want.normals())
    u = np.random.default_rng(3).uniform(size=(2000, 3)).astype(np.float32)
    np.testing.assert_array_equal(pmesh.sample_surface(got, u), jmesh.sample_surface(want, u))
    with pytest.raises(ValueError, match=r"\.obj or binary \.stl"):
        pmesh.load_mesh_file(str(tmp_path / "m.ply"))


def test_bumpy_sphere_mesh_is_closed_and_outward(tmp_path):
    """The written OBJ reads back as 20·4^s triangles (every coordinate the
    float32 of ``bumpy_sphere``), each edge shared by two faces in
    opposite directions, with a positive enclosed volume."""
    v, f = bumpy_sphere(3)
    assert f.shape == (1280, 3) and v.dtype == np.float32
    path = write_bumpy_sphere_mesh(str(tmp_path / "b.obj"), 3)
    np.testing.assert_array_equal(pmesh.load_obj(path), v[f])
    edges = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
    assert len({tuple(e) for e in edges.tolist()}) == len(edges)  # no edge twice one way
    assert {tuple(e) for e in edges[:, ::-1].tolist()} == {tuple(e) for e in edges.tolist()}
    t = v[f].astype(np.float64)
    assert np.einsum("ij,ij->i", t[:, 0], np.cross(t[:, 1], t[:, 2])).sum() > 0
    r = np.linalg.norm(v, axis=1)
    assert 0.3 * 0.85 - 1e-6 <= r.min() and r.max() <= 0.3 * 1.15 + 1e-6


# -- the build


@pytest.mark.parametrize("name", sorted(BUILD_CASES))
def test_build_equals_the_jax_numpy_build(name):
    """Every array of ``build_bvh_arrays`` (built a level at a time)
    equals the JAX package's recursive ``_build_bvh_numpy`` exactly; the
    tree on the CPU holds the same values; its depth is below the
    stack's."""
    tris = BUILD_CASES[name]
    got = pbvh.build_bvh_arrays(tris)
    want = jbvh._build_bvh_numpy(tris)
    for field in want._fields:
        g, w = got[field], np.asarray(getattr(want, field))
        assert g.dtype == w.dtype and g.shape == w.shape, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    tree = pbvh.build_bvh(tris)
    assert tree.depth == got["depth"] < pbvh.STACK_DEPTH
    for field in want._fields:
        np.testing.assert_array_equal(getattr(tree, field).numpy(), got[field])


def test_build_refuses_a_tree_deeper_than_the_stack(monkeypatch):
    monkeypatch.setattr(pbvh, "STACK_DEPTH", 4)
    with pytest.raises(ValueError, match="depth 10 of 1280 triangles"):
        pbvh.build_bvh_arrays(MESHES["bumpy"])


# -- the kernels' packed records


def _small_meshes():
    """Trees whose leaves hold 1, 2, 3 and 4 real triangles, and trees of
    at most ``LEAF_SIZE`` triangles, whose root is a leaf."""
    rng = np.random.default_rng(5)
    return {f"tris{n}": rng.uniform(0.2, 0.8, (n, 3, 3)).astype(np.float32)
            for n in (1, 3, 4, 5, 6, 7, 9, 11)}


PACK_CASES = {**BUILD_CASES, **_small_meshes()}


@pytest.mark.parametrize("name", sorted(PACK_CASES))
def test_packed_records_decode_to_the_tree(name):
    """Each internal node has one record, numbered level by level from the
    root (record 0); walking the records from the root's reference gives
    back ``node_min``/``node_max`` (every node but the root, whose box is
    in no record), ``node_a``, ``node_b``, ``node_leaf`` and each leaf's
    count of real (not padding) triangles exactly; the padding slots are
    the ones past that count, at ``FAR``."""
    arrays = pbvh.build_bvh_arrays(PACK_CASES[name])
    tree = pbvh.build_bvh(PACK_CASES[name])
    records, root = tree.records.numpy(), tree.root
    M = len(arrays["node_leaf"])
    assert records.dtype == np.int32 and records.shape == (int((~arrays["node_leaf"]).sum()),
                                                           pbvh.RECORD_WORDS)
    real = (arrays["tri_index"].reshape(-1, pbvh.LEAF_SIZE) >= 0).sum(1)
    slot = np.arange(pbvh.LEAF_SIZE)
    pads = arrays["tri_index"].reshape(-1, pbvh.LEAF_SIZE) < 0
    np.testing.assert_array_equal(pads, slot >= real[:, None])
    assert (arrays["triangles"].reshape(-1, pbvh.LEAF_SIZE, 9)[pads] == np.float32(pbvh.FAR)).all()
    node_min, node_max = np.full((M, 3), np.nan, np.float32), np.full((M, 3), np.nan, np.float32)
    node_a, node_b = np.zeros(M, np.int32), np.zeros(M, np.int32)
    node_leaf, counts = np.zeros(M, bool), {}

    def visit(ref, node):
        if ref < 0:
            leaf = ~ref >> 3
            node_leaf[node], node_a[node] = True, leaf * pbvh.LEAF_SIZE
            counts[int(leaf)] = ~ref & 7
            return
        words = records[ref]
        boxes = words[:12].view(np.float32)
        left, right = int(words[14]), int(words[15])
        node_a[node], node_b[node] = left, right
        node_min[left], node_max[left] = boxes[0:3], boxes[3:6]
        node_min[right], node_max[right] = boxes[6:9], boxes[9:12]
        visit(int(words[12]), left)
        visit(int(words[13]), right)

    visit(root, 0)
    assert (root == 0) == (len(records) > 0)
    for field, got in (("node_min", node_min), ("node_max", node_max)):
        np.testing.assert_array_equal(got[1:], arrays[field][1:], err_msg=field)
    np.testing.assert_array_equal(node_a, arrays["node_a"])
    np.testing.assert_array_equal(node_b, arrays["node_b"])
    np.testing.assert_array_equal(node_leaf, arrays["node_leaf"])
    assert counts == {k: int(real[k]) for k in range(len(real))}
    levels = [0] * len(records)  # level order: a record's level never falls
    for r, words in enumerate(records):
        for ref in words[12:14]:
            if ref >= 0:
                levels[ref] = levels[r] + 1
                assert ref > r
    assert levels == sorted(levels)


def _packed_queries(seed, n=1024):
    """Points around the unit cube, a few at the padding's corner (where a
    padding slot beats every real triangle), and rays from them, a quarter
    along the axes."""
    rng = np.random.default_rng(seed)
    points = rng.uniform(-0.2, 1.2, (n, 3)).astype(np.float32)
    points[:3] = [[pbvh.FAR] * 3, [pbvh.FAR, pbvh.FAR, 0.9 * pbvh.FAR], [1e9, 1e9, 1e9]]
    dirs = rng.normal(size=(n, 3))
    k = n // 4
    dirs[:k] = np.eye(3)[rng.integers(0, 3, k)] * rng.choice([-1, 1], (k, 1))
    dirs = (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)).astype(np.float32)
    return torch.from_numpy(points), torch.from_numpy(dirs)


@pytest.mark.parametrize("name", sorted({**MESHES, **_small_meshes()}))
def test_packed_walk_matches_the_twins(name):
    """The kernels' walk over the packed records (plain PyTorch,
    ``ops/bvh.py``: the next child kept, the other pushed, a stack of
    depth − 1, only real triangles, the padding's distance once) gives the
    twins' outputs and each query's nodes processed exactly: the twins
    run the JAX loop on the tree's arrays."""
    from ngp_tpu_torch.ops import bvh as bvh_ops

    tree = pbvh.build_bvh({**MESHES, **_small_meshes()}[name])
    points, dirs = _packed_queries(11)
    stats = {}
    want = bvh_ops.bvh_closest_point_reference(tree, points, stats)
    got = bvh_ops.bvh_closest_point_packed(tree, points)
    for g, w in zip(got[:3], want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert torch.equal(got[3], stats["visits"])
    assert int(stats["visits"].sum()) == stats["internal_pops"] + stats["leaf_pops"]
    if name in ("bumpy", "soup", "tris1", "tris3"):  # the far queries meet a padded leaf
        assert bool((tree.tri_index[got[2][:2].long()] < 0).all())  # whose padding wins
    stats = {}
    want = bvh_ops.bvh_ray_intersect_reference(tree, points, dirs, stats)
    got = bvh_ops.bvh_ray_intersect_packed(tree, points, dirs)
    for g, w in zip(got[:2], want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert torch.equal(got[2], stats["visits"])
    assert bool(torch.isfinite(got[0]).any())


# -- the queries


def _queries(seed):
    rng = np.random.default_rng(seed)
    points = rng.uniform(0.0, 1.0, (N_QUERIES, 3)).astype(np.float32)
    dirs = rng.normal(size=(N_QUERIES, 3))
    return points, (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)).astype(np.float32)


def _point_triangle_dist(p, tri):
    """float64 distances from points (n, 3) to triangles (n, 3, 3), by
    dense sampling-free projection: the minimum over the face (when the
    projection falls inside) and the three edges."""
    p, tri = p.astype(np.float64), tri.astype(np.float64)
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    best = np.full(len(p), np.inf)
    for s, e in ((a, b), (b, c), (c, a)):
        d = e - s
        t = np.clip(np.einsum("ij,ij->i", p - s, d) / np.maximum(np.einsum("ij,ij->i", d, d),
                                                                   1e-300), 0, 1)
        best = np.minimum(best, np.linalg.norm(s + d * t[:, None] - p, axis=1))
    n = np.cross(b - a, c - a)
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-300)
    h = np.einsum("ij,ij->i", p - a, n)
    q = p - h[:, None] * n
    inside = np.ones(len(p), bool)
    for s, e in ((a, b), (b, c), (c, a)):
        inside &= np.einsum("ij,ij->i", np.cross(e - s, q - s), n) >= 0
    return np.where(inside, np.abs(h), best)


def _edge_distance(o, d, t, tri):
    """float64 distance from the hit point o + t·d to the nearest edge of
    ``tri`` (n, 3, 3)."""
    hitp = o.astype(np.float64) + d.astype(np.float64) * t[:, None]
    tri = tri.astype(np.float64)
    best = np.full(len(o), np.inf)
    for i, j in ((0, 1), (1, 2), (2, 0)):
        s, e = tri[:, i], tri[:, j]
        seg = e - s
        u = np.clip(np.einsum("ij,ij->i", hitp - s, seg) / np.einsum("ij,ij->i", seg, seg), 0, 1)
        best = np.minimum(best, np.linalg.norm(s + seg * u[:, None] - hitp, axis=1))
    return best


@pytest.mark.parametrize("name", sorted(MESHES))
def test_closest_point_and_watertight_sign_match_jax(name):
    """Distances within 2e-6; where the leaf slots differ, both slots'
    triangles lie within 2e-6 of the same distance (float64); the closest
    points within 2e-6 where the slots agree; the watertight sign equal
    wherever |d| > 1e-6 and the slots agree (the sign of a point whose
    closest point is an edge follows that slot's face, in both packages).
    On the cube the signed distance is the analytic box SDF within 2e-5 at
    ``tests/test_sdf.py``'s points."""
    tris = MESHES[name]
    jtree, ptree = jbvh._build_bvh_numpy(tris), pbvh.build_bvh(tris)
    q, _ = _queries(1)
    jd, jcp, jslot = (np.asarray(a) for a in jbvh.closest_point(jtree, jnp.asarray(q)))
    pd, pcp, pslot = (a.numpy() for a in pbvh.closest_point(ptree, torch.from_numpy(q)))
    np.testing.assert_allclose(pd, jd, rtol=0, atol=DIST_TOL)
    differ = pslot != jslot  # ties at a shared vertex or edge, mostly
    if differ.any():
        slots = np.asarray(jtree.triangles)
        dj = _point_triangle_dist(q[differ], slots[jslot[differ]])
        dp = _point_triangle_dist(q[differ], slots[pslot[differ]])
        np.testing.assert_allclose(dp, dj, rtol=0, atol=DIST_TOL)
    np.testing.assert_allclose(pcp[~differ], jcp[~differ], rtol=0, atol=DIST_TOL)
    js = np.asarray(jbvh.signed_distance_watertight(jtree, jnp.asarray(q)))
    ps = pbvh.signed_distance_watertight(ptree, torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(np.abs(ps), np.abs(js), rtol=0, atol=DIST_TOL)
    firm = (np.abs(js) > 1e-6) & ~differ
    np.testing.assert_array_equal(np.sign(ps[firm]), np.sign(js[firm]))
    if name == "cube":  # tests/test_sdf.py's points and bound
        p = np.random.default_rng(1).uniform(0.05, 0.95, size=(500, 3)).astype(np.float32)
        box = np.abs(p - 0.5) - 0.25
        sdf = np.linalg.norm(np.maximum(box, 0), axis=-1) + np.minimum(box.max(-1), 0)
        got = pbvh.signed_distance_watertight(ptree, torch.from_numpy(p)).numpy()
        np.testing.assert_allclose(got, sdf, rtol=0, atol=2e-5)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_ray_intersect_matches_jax(name):
    """Rays from the queries in seeded unit directions: hit or miss equal
    except where the hit point lies within 1e-6 of the hit triangle's
    edge (float64); t within 1e-5·max(1, t); the leaf slot equal except
    where the two slots' hits lie within that bound of each other. On the
    cube, rays straight up the middle hit the faces at 0.25
    (``tests/test_sdf.py``)."""
    tris = MESHES[name]
    jtree, ptree = jbvh._build_bvh_numpy(tris), pbvh.build_bvh(tris)
    o, d = _queries(2)
    jt, jslot = (np.asarray(a) for a in jbvh.ray_intersect(jtree, jnp.asarray(o), jnp.asarray(d)))
    pt, pslot = (a.numpy() for a in pbvh.ray_intersect(ptree, torch.from_numpy(o),
                                                       torch.from_numpy(d)))
    jhit, phit = np.isfinite(jt), np.isfinite(pt)
    assert jhit.any() and (phit == (pslot >= 0)).all()
    slots = np.asarray(jtree.triangles)
    odd = jhit != phit
    if odd.any():
        t = np.where(jhit, jt, pt)[odd]
        slot = np.where(jhit, jslot, pslot)[odd]
        assert (_edge_distance(o[odd], d[odd], t, slots[slot]) < 1e-6).all()
    both = jhit & phit
    np.testing.assert_allclose(pt[both], jt[both], rtol=0,
                               atol=1e-5 * np.maximum(1.0, jt[both]).max())
    assert (np.abs(pt[both] - jt[both]) <= 1e-5 * np.maximum(1.0, jt[both])).all()
    differ = both & (pslot != jslot)
    if differ.any():  # the same hit on two triangles, at a shared edge
        assert (_edge_distance(o[differ], d[differ], jt[differ], slots[jslot[differ]])
                < 1e-6).all()
    assert (pslot[~phit] == -1).all()
    if name == "cube":
        up = np.asarray([[0.5, 0.5, 0.0], [0.5, 0.5, 0.5], [0.0, 0.0, 0.0]], np.float32)
        t, slot = pbvh.ray_intersect(ptree, torch.from_numpy(up),
                                     torch.tensor([[0.0, 0.0, 1.0]] * 3))
        np.testing.assert_allclose(t[:2].numpy(), [0.25, 0.25], atol=1e-5)
        assert not torch.isfinite(t[2]) and int(slot[2]) == -1


def test_raystab_and_winding_signs_match_jax():
    """On the closed bumpy sphere: the raystab sign (32 stabs, parity of
    crossings) and the winding-number sign equal the JAX package's
    wherever |d| > 1e-6, with distances within 2e-6; the winding numbers
    within 1e-5 (float32 sums of 1,280 atan2 terms in chunks of 4,096);
    both agree with the watertight sign on the closed mesh. On the cube
    with its top face removed, the winding sign still finds the inside
    (``tests/test_sdf.py``)."""
    tris = MESHES["bumpy"]
    jtree, ptree = jbvh._build_bvh_numpy(tris), pbvh.build_bvh(tris)
    q, _ = _queries(3)
    q = q[:1024]  # raystab marches ~100 traversals
    tq = torch.from_numpy(q)
    jr = np.asarray(jbvh.signed_distance_raystab(jtree, jnp.asarray(q)))
    pr = pbvh.signed_distance_raystab(ptree, tq).numpy()
    jw = np.asarray(jbvh.signed_distance_winding(jtree, jnp.asarray(q)))
    pw = pbvh.signed_distance_winding(ptree, tq).numpy()
    pwt = pbvh.signed_distance_watertight(ptree, tq).numpy()
    for got, want in ((pr, jr), (pw, jw)):
        np.testing.assert_allclose(np.abs(got), np.abs(want), rtol=0, atol=DIST_TOL)
        firm = np.abs(want) > 1e-6
        np.testing.assert_array_equal(np.sign(got[firm]), np.sign(want[firm]))
        np.testing.assert_array_equal(np.sign(got[firm]), np.sign(pwt[firm]))
    assert 0.1 < (pr < 0).mean() < 0.9
    np.testing.assert_allclose(
        pbvh.winding_number(ptree.triangles, tq).numpy(),
        np.asarray(jbvh.winding_number(jtree.triangles, jnp.asarray(q))), rtol=0, atol=1e-5)
    lo, hi = 0.3, 0.7
    v = np.array([[x, y, z] for x in (lo, hi) for y in (lo, hi) for z in (lo, hi)])
    faces = [(0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5), (0, 4, 5), (0, 5, 1),
             (2, 3, 7), (2, 7, 6), (0, 2, 6), (0, 6, 4)]  # no z = hi face
    open_box = np.asarray([[v[a], v[b], v[c]] for a, b, c in faces], np.float32)
    pts = torch.tensor([[0.5, 0.5, 0.5], [0.65, 0.65, 0.65], [0.9, 0.5, 0.5], [0.5, 0.1, 0.5]])
    sd = pbvh.signed_distance_winding(pbvh.build_bvh(open_box), pts)
    np.testing.assert_array_equal(np.sign(sd.numpy()), [-1, -1, 1, 1])

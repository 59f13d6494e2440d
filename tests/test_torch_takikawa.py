"""The port's Takikawa encoding (``ngp_tpu_torch/models/takikawa.py``)
against the JAX package's (``ngp_tpu/models/takikawa.py``) on the CPU.

Octrees: the 12-triangle cube at depth 5 and a bumpy icosphere of 3
subdivisions at depth 7 (the JAX octree built on its numpy path, the
port's natively: the same arrays, ``tests/test_torch_octree.py``). Tables
are seeded normals, positions seeded uniforms in and around the meshes.

Tolerances: the trilinear weights bit for bit (the same float32 formula in
the same order); the forward within 1e-6 of each output's largest
magnitude (8 products summed in two libraries' orders); the table gradient
with bf16 addends on both sides within the float32 order bound
2·(n − 1)·2^-24·Σ|addends| of a row against a float64 sum of the same
addends, and against the JAX package's CPU sum (prefix-sum differences of
the sorted addends, ROADMAP C.ref 12) within 4·2^-24 of the addends' total
mass (measured 0.054–0.13); with ``differentiable_inputs`` dx within 1e-5 and
the table gradient (float32 addends) within 1e-6 of its largest entry.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ngp_tpu.native as jax_native
from ngp_tpu.geometry import triangle_octree as joct
from ngp_tpu.models.takikawa import TakikawaEncoding as JaxTakikawa
from ngp_tpu_torch.geometry import triangle_octree as poct
from ngp_tpu_torch.interop import export_jax_params, load_jax_params
from ngp_tpu_torch.models.factory import create_network_with_input_encoding
from ngp_tpu_torch.models.takikawa import TakikawaEncoding
from ngp_tpu_torch.optim import param_groups
from test_torch_octree import CASES

# One intra-op thread, as in every port test module (test_torch_sdf.py).
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def octrees():
    """(JAX octree, port octree) of each case."""
    saved = jax_native.octree_build, jax_native.chessboard_dt
    jax_native.octree_build = jax_native.chessboard_dt = lambda *a: None
    try:
        return {name: (joct.TriangleOctree.build(tris, depth),
                       poct.TriangleOctree.build(tris, depth, device="cpu"))
                for name, (tris, depth) in CASES.items()}
    finally:
        jax_native.octree_build, jax_native.chessboard_dt = saved


def _pair(octrees, name, starting_level, F, sum_mode=False, seed=0):
    joc, poc = octrees[name]
    jenc = JaxTakikawa(octree=joc, starting_level=starting_level, n_features_per_level=F,
                       sum_instead_of_concat=sum_mode)
    penc = TakikawaEncoding(poc, starting_level, F, sum_mode, device="cpu")
    table = np.random.default_rng(seed).normal(size=(poc.n_vertices, F)).astype(np.float32)
    with torch.no_grad():
        penc.table.copy_(torch.from_numpy(table))
    return jenc, {"table": jnp.asarray(table)}, penc


def _points(n, seed, lo=0.2, hi=0.8):
    return np.random.default_rng(seed).uniform(lo, hi, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(CASES))
def test_weights_match_jax_bit_for_bit(name, octrees):
    """Each output level's vertex ids and trilinear weights (0 where the
    voxel is empty) equal the JAX encoding's ``_gather_plan``."""
    jenc, _, penc = _pair(octrees, name, 1, 2)
    x = _points(2048, 1, 0.0, 1.0)
    jid, jw = map(np.asarray, jenc._gather_plan(jnp.asarray(x)))
    pid, pw = penc.gather_plan(torch.from_numpy(x))
    np.testing.assert_array_equal(pid.numpy(), jid)
    np.testing.assert_array_equal(pw.numpy(), jw)
    assert (pw.numpy() == 0).all(-1).any() and (pw.numpy() != 0).any()


FORWARD_CASES = [("cube", 0, 1, False, None), ("cube", 1, 2, False, None),
                 ("cube", 2, 4, True, None), ("sphere", 2, 8, False, 3),
                 ("sphere", 0, 2, True, 4), ("sphere", 3, 2, False, 1)]


@pytest.mark.parametrize("name,start,F,sum_mode,max_level", FORWARD_CASES)
def test_forward_matches_jax(name, start, F, sum_mode, max_level, octrees):
    """Concatenated (level-major) and summed outputs, with and without
    ``max_level``, F 1, 2, 4 and 8: within 1e-6 of the largest output;
    the plain and ``differentiable_inputs`` forwards agree the same way;
    unreached levels output exact zeros."""
    jenc, jparams, penc = _pair(octrees, name, start, F, sum_mode)
    x = _points(4096, 2, 0.0, 1.0)
    want = np.asarray(jenc(jparams, jnp.asarray(x), max_level=max_level))
    got = penc(torch.from_numpy(x), max_level=max_level)
    assert got.shape == want.shape == (4096, penc.n_output_dims)
    assert penc.n_output_dims == jenc.n_output_dims and penc.n_levels == jenc.n_levels
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-6 * scale)
    slow = penc(torch.from_numpy(x), max_level=max_level, differentiable_inputs=True)
    np.testing.assert_allclose(slow.detach().numpy(), want, rtol=0, atol=1e-6 * scale)
    if not sum_mode:
        # depth 1's voxel at the corner touches the mesh, no deeper one
        far = penc(torch.tensor([[0.02, 0.02, 0.02]]))
        assert not far[0, max(0, 2 - start) * F:].any()
    if max_level is not None and not sum_mode:
        assert not got[:, (max_level + 1) * F:].any()


@pytest.mark.parametrize("name,F", [("cube", 2), ("sphere", 1), ("sphere", 4)])
def test_table_gradient_with_bf16_addends(name, F, octrees):
    """d(table) of a seeded cotangent: the port's sum of bf16-rounded
    ``w·g`` (``batched_segment_sum``'s twin on the CPU) within the float32
    order bound of a float64 sum of the same addends, and within the JAX
    package's prefix-sum error of its d(table) (module docstring)."""
    jenc, jparams, penc = _pair(octrees, name, 1, F)
    x = _points(2048, 3)
    g = np.random.default_rng(4).normal(size=(2048, penc.n_output_dims)).astype(np.float32)
    out = penc(torch.from_numpy(x))
    (got,) = torch.autograd.grad(out, penc.table, torch.from_numpy(g))
    _, vjp = jax.vjp(lambda p: jenc(p, jnp.asarray(x)), jparams)
    want = np.asarray(vjp(jnp.asarray(g))[0]["table"])

    idx, w = (a.numpy() for a in penc.gather_plan(torch.from_numpy(x)))
    L = penc.n_levels
    gl = g.reshape(-1, L, F).transpose(1, 0, 2)  # (L, N, F)
    addends = (w[..., None] * gl[:, :, None, :]).astype(np.float32)
    addends = torch.from_numpy(addends).to(torch.bfloat16).to(torch.float64).numpy()
    exact = np.zeros((penc.octree.n_vertices, F))
    mass = np.zeros_like(exact)
    count = np.zeros(penc.octree.n_vertices)
    keys = idx.reshape(-1)
    np.add.at(exact, keys, addends.reshape(-1, F))
    np.add.at(mass, keys, np.abs(addends.reshape(-1, F)))
    np.add.at(count, keys, 1)
    bound = 2.0 * np.maximum(count - 1, 0)[:, None] * 2.0 ** -24 * mass
    assert (np.abs(got.numpy() - exact) <= bound).all()
    assert np.abs(want - got.numpy()).max() <= 4 * 2.0 ** -24 * mass.sum(0).max()
    assert np.abs(got.numpy()).max() > 0


@pytest.mark.parametrize("name,start,F", [("cube", 0, 2), ("sphere", 2, 4)])
def test_input_gradients_match_jax(name, start, F, octrees):
    """``differentiable_inputs=True``: dx within 1e-5 of ``jax.vjp`` of the
    JAX encoding's ``differentiable_inputs`` path, d(table) (float32
    addends) within 1e-6 of its largest entry."""
    jenc, jparams, penc = _pair(octrees, name, start, F, seed=5)
    x = _points(1024, 6)
    g = np.random.default_rng(7).normal(size=(1024, penc.n_output_dims)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = penc(xt, differentiable_inputs=True)
    dx, dtable = torch.autograd.grad(out, (xt, penc.table), torch.from_numpy(g))
    _, vjp = jax.vjp(lambda p, xx: jenc(p, xx, differentiable_inputs=True), jparams,
                     jnp.asarray(x))
    jp, jx = vjp(jnp.asarray(g))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jx), rtol=0, atol=1e-5)
    assert float(dx.abs().max()) > 1e-3
    jt = np.asarray(jp["table"])
    np.testing.assert_allclose(dtable.numpy(), jt, rtol=0, atol=1e-6 * np.abs(jt).max())
    # the plain forward gives the positions no gradient, as the JAX one
    xt = torch.from_numpy(x).requires_grad_(True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(penc(xt).sum(), xt)


def test_init_parameters_interop_and_optimizer_group(octrees):
    """The table starts U(-1e-4, 1e-4) from the caller's generator (equal
    for equal seeds); it crosses to and from the JAX layout ``{"table":
    (V, F)}`` unchanged; its name puts it in the sparse-Adam group."""
    _, poc = octrees["cube"]
    cfg = {"encoding": {"otype": "Takikawa", "starting_level": 1, "n_features_per_level": 2},
           "network": {"otype": "FullyFusedMLP", "n_neurons": 16, "n_hidden_layers": 1}}
    a = create_network_with_input_encoding(3, 1, cfg, "cpu", poc)
    b = create_network_with_input_encoding(3, 1, cfg, "cpu", poc)
    a.reset_parameters(torch.Generator().manual_seed(9))
    b.reset_parameters(torch.Generator().manual_seed(9))
    table = a.encoding.table
    assert table.shape == (poc.n_vertices, 2) and torch.equal(table, b.encoding.table)
    assert 0 < float(table.detach().abs().max()) <= 1e-4
    assert a.n_params == poc.n_vertices * 2 + a.network.n_params
    tree = export_jax_params(a)
    assert set(tree["encoding"]) == {"table"} and tree["encoding"]["table"].shape == (
        poc.n_vertices, 2)
    c = load_jax_params(create_network_with_input_encoding(3, 1, cfg, "cpu", poc), tree)
    assert torch.equal(c.encoding.table, table)
    groups = param_groups(a)
    assert [n for n, _ in groups["grid"]] == ["encoding.table"]
    assert "encoding.table" not in [n for n, _ in groups["dense"]]
    jenc = JaxTakikawa(octree=octrees["cube"][0], starting_level=1)
    jtable = np.asarray(jenc.init(jax.random.PRNGKey(0))["table"])
    assert jtable.shape == tuple(table.shape) and np.abs(jtable).max() <= 1e-4

"""Parity of the port's NeRF network (``ngp_tpu_torch/models``) with the JAX
package's, on the "tpu" tier narrowed to L=4, T=2^12, with parameters from
the JAX ``network.init`` carried across by ``interop.load_jax_params``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _default_config
from ngp_tpu.models.factory import create_nerf_network as jax_create_nerf_network
from ngp_tpu_torch.config import TIERS, default_config
from ngp_tpu_torch.interop import export_jax_params, load_jax_params
from ngp_tpu_torch.models.factory import create_encoding, create_network
from ngp_tpu_torch.models.factory import create_nerf_network

# One intra-op thread: with two, torch's CPU sqrt (MKL's vsSqrt, split across
# the intra-op threads) now and then returned one thread's chunk ~3e-4 off
# on an AVX-512 Xeon (torch 2.13, MKL 2024.2), never with one
# (scripts/torch_sqrt_threads.py counts it).
# Every port test module sets the same count, so that a pytest worker's
# count does not depend on which module it imported last.
torch.set_num_threads(1)


def _narrow_tpu_config():
    cfg = default_config("tpu")
    cfg["encoding"].update({"n_levels": 4, "log2_hashmap_size": 12})
    return cfg


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("tier", TIERS)
def test_default_config_matches_graft_entry(tier, monkeypatch):
    monkeypatch.setenv("NGP_TPU_BENCH_CONFIG", tier)
    assert default_config(tier) == _default_config()


def test_load_jax_params_round_trip():
    cfg = _narrow_tpu_config()
    jnet = jax_create_nerf_network(cfg)
    tree = _numpy_tree(jnet.init(jax.random.PRNGKey(0)))
    net = load_jax_params(create_nerf_network(cfg, device="cpu"), tree)
    back = export_jax_params(net)
    flat_a, struct_a = jax.tree.flatten(tree)
    flat_b, struct_b = jax.tree.flatten(back)
    assert struct_a == struct_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    bad = dict(tree, density_mlp={"weights": tree["density_mlp"]["weights"][:1]})
    with pytest.raises(ValueError, match="layers"):
        load_jax_params(net, bad)


def test_nerf_network_forward_matches_jax():
    """Both sides round MLP operands and hidden activations to bf16 at the
    same points and read the (additive-hash) table as bf16; only float32
    summation order differs, which can flip a bf16 rounding of a hidden
    unit (2^-8 relative). Tolerance: 1e-3 relative, 1e-3 absolute."""
    cfg = _narrow_tpu_config()
    jnet = jax_create_nerf_network(cfg)
    tree = _numpy_tree(jnet.init(jax.random.PRNGKey(0)))
    # features of U(±1e-4) would vanish under the MLP's bf16 rounding;
    # scale the table so the grid matters to the output
    tree["pos_encoding"]["table"] = tree["pos_encoding"]["table"] * 1e3
    net = load_jax_params(create_nerf_network(cfg, device="cpu"), tree)
    assert net.pos_encoding.bf16_reads

    rng = np.random.default_rng(0)
    pos = rng.uniform(0.0, 1.0, (4096, 3)).astype(np.float32)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    dirs = ((d / np.linalg.norm(d, axis=-1, keepdims=True) + 1.0) * 0.5).astype(np.float32)

    want = np.asarray(jnet(jax.tree.map(jnp.asarray, tree), jnp.asarray(pos),
                           jnp.asarray(dirs)))
    want_density = np.asarray(jnet.density(jax.tree.map(jnp.asarray, tree),
                                           jnp.asarray(pos)))
    with torch.no_grad():
        got = net(torch.from_numpy(pos), torch.from_numpy(dirs)).numpy()
        got_density = net.density(torch.from_numpy(pos)).numpy()
    assert got.shape == (4096, 4) and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got_density, want_density, rtol=1e-3, atol=1e-3)


def test_sh_and_composite_match_jax():
    from ngp_tpu.models.factory import create_encoding as jax_create_encoding

    cfg = default_config("tpu")["dir_encoding"]
    jenc, penc = jax_create_encoding(5, cfg), create_encoding(5, cfg, "cpu")
    assert penc.n_output_dims == jenc.n_output_dims == 18
    x = np.random.default_rng(1).uniform(0, 1, (512, 5)).astype(np.float32)
    want = np.asarray(jenc(jenc.init(jax.random.PRNGKey(0)), jnp.asarray(x)))
    got = penc(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_unknown_and_unported_otypes_raise():
    """Unknown otypes and activations raise; a Takikawa encoding (ported,
    ROADMAP A7b) builds from its config over an octree, as the JAX
    factory builds it, and raises without one."""
    from ngp_tpu_torch.geometry.triangle_octree import TriangleOctree
    from ngp_tpu_torch.models.takikawa import TakikawaEncoding

    with pytest.raises(ValueError, match="unknown encoding otype 'Nope'"):
        create_encoding(3, {"otype": "Nope"}, "cpu")
    with pytest.raises(ValueError, match="unknown network otype 'Nope'"):
        create_network(3, 3, {"otype": "Nope"}, "cpu")
    cfg = {"otype": "Takikawa", "starting_level": 1, "n_features_per_level": 4,
           "sum_instead_of_concat": True}
    with pytest.raises(ValueError, match="the Takikawa encoding needs a TriangleOctree"):
        create_encoding(3, cfg, "cpu")
    tri = np.array([[[0.2, 0.3, 0.4], [0.7, 0.3, 0.5], [0.4, 0.8, 0.6]]], np.float32)
    octree = TriangleOctree.build(tri, 4)
    enc = create_encoding(3, cfg, "cpu", octree=octree)
    assert isinstance(enc, TakikawaEncoding) and enc.octree is octree
    assert (enc.starting_level, enc.n_levels, enc.n_output_dims) == (1, 3, 4)
    assert enc.table.shape == (octree.n_vertices, 4) and enc.sum_instead_of_concat
    assert create_encoding(3, {"otype": "Takikawa"}, "cpu", octree=octree).n_output_dims == 8
    with pytest.raises(ValueError, match="unknown activation"):
        create_network(3, 3, {"activation": "Nope"}, "cpu")


def test_cuda_entry_points_refuse_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        create_nerf_network(_narrow_tpu_config())


def test_reset_parameters_is_seeded():
    cfg = _narrow_tpu_config()
    a = create_nerf_network(cfg, device="cpu")
    b = create_nerf_network(cfg, device="cpu")
    a.reset_parameters(torch.Generator().manual_seed(5))
    b.reset_parameters(torch.Generator().manual_seed(5))
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    table = a.pos_encoding.table
    assert table.abs().max() <= 1e-4 and table.abs().max() > 0

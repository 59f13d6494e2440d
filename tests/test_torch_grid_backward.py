"""The port's grid-encoding table gradient (``GridEncoding`` backward:
``hashgrid_backward_addends`` then ``batched_segment_sum``, the plain twins
of the two CUDA kernels, on the CPU) against ``jax.grad`` of the JAX
package's ``GridEncoding.__call__`` with the same cotangent.

The JAX package reaches its d(table) by three routes, all covered: the
additive hash through the corner-duplicated view and its "quads" backward
(``_gdgb_bwd``), the XOR hash through ``grid_gather_blend_enc``
(``_ggbe_bwd``), and the Pallas forward's ``_pge_bwd``. Setup as in
``tests/test_torch_hashgrid.py``: L=4, base resolution 8, scale 2.0; in 3D
with T=2^12 the levels are dense, dense, hashed, hashed. Positions include
0 and 1 (the dense top plane) in every coordinate.

Tolerance. Both sides round each addend w_c·g to bf16 and sum in float32.
Where the JAX package's dense top plane shifts the cell base and pushes the
fraction to 1, it deposits one addend g where the port deposits (1−f)·g and
f·g on the same row; bf16 rounds those separately, by up to 2^-9 of each.
A weight that differs in its last bit between the two can also round the
other way. The JAX CPU sum (differences of float32 cumulative sums) adds an
error of a few ulps of the running total. The bound is 2^-6 of
max|d(table)| per level: four bf16 half-ulps. Measured: see
``test_measured_error_is_far_below_the_bound``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ngp_tpu.models.encodings import GridEncoding as JaxGridEncoding
from ngp_tpu.models.encodings import pallas_grid_encode
from ngp_tpu_torch.models.encodings import GridEncoding
from ngp_tpu_torch.ops.hashgrid import hashgrid_backward_addends_reference
from ngp_tpu_torch.ops.segsum import batched_segment_sum

torch.set_num_threads(2)

BOUND = 2.0 ** -6

EDGES = [0.0, 1.0, 0.5, 1.0 - 1e-7, 1e-7]


def _positions(n, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (n, d)).astype(np.float32)
    k = len(EDGES)
    for i, v in enumerate(EDGES):
        x[i] = v  # every coordinate at the edge value
        x[k + i, 0] = v
        x[2 * k + i, d - 1] = v
    return x


def _encodings(d, f, variant, **kw):
    args = dict(n_input_dims=d, n_levels=4, n_features_per_level=f,
                log2_hashmap_size=12 if d == 3 else 10, base_resolution=8,
                per_level_scale=2.0, hash_variant=variant, **kw)
    return JaxGridEncoding(**args), GridEncoding(device="cpu", **args)


def _grads(jenc, penc, x, g, max_level=None):
    """(JAX d(table), port d(table)) for cotangent ``g``."""
    table = np.random.default_rng(0).uniform(
        -1, 1, tuple(penc.table.shape)).astype(np.float32)

    def f(t):
        return jnp.sum(jenc({"table": t}, jnp.asarray(x), max_level=max_level)
                       * jnp.asarray(g))

    want = np.asarray(jax.jit(jax.grad(f))(jnp.asarray(table)))
    with torch.no_grad():
        penc.table.copy_(torch.from_numpy(table))
    penc.table.grad = None
    (penc(torch.from_numpy(x), max_level=max_level) * torch.from_numpy(g)).sum().backward()
    return want, penc.table.grad.numpy()


def _level_err(want, got):
    """(max |got − want| per level, max |want| per level)."""
    return np.abs(got - want).max(axis=(1, 2)), np.abs(want).max(axis=(1, 2))


CASES = [(v, r, m, 3) for v in ("additive", "tcnn") for r in ("float32", "bf16")
         for m in (None, 1)] + [("additive", "bf16", None, 2), ("tcnn", "float32", 1, 2)]


@pytest.mark.parametrize("variant,reads,max_level,d", CASES)
def test_table_gradient_matches_jax(variant, reads, max_level, d):
    kw = ({"dup_gather_dtype": "float32" if reads == "float32" else "packed_bf16"}
          if variant == "additive"
          else {"gather_dtype": "float32" if reads == "float32" else "bfloat16"})
    jenc, penc = _encodings(d, 2, variant, **kw)
    assert penc.bf16_reads == (reads == "bf16")
    x = _positions(2000, d, d)
    g = np.random.default_rng(5).normal(size=(2000, 8)).astype(np.float32)
    want, got = _grads(jenc, penc, x, g, max_level)
    err, scale = _level_err(want, got)
    assert (err <= BOUND * scale + 1e-12).all(), (err / scale)
    # rows no corner touches are exactly zero in the port (skip-zero Adam
    # reads that); the JAX CPU sum leaves ulps of its running total there
    touched = np.zeros(got.shape[:2], bool)
    keys, _ = hashgrid_backward_addends_reference(
        torch.from_numpy(x), torch.from_numpy(g), penc.level_scale, penc.level_res,
        penc.level_size, penc.level_hashed, penc.hash_variant)
    for l in range(touched.shape[0]):
        touched[l, keys[l].numpy()] = True
    assert not got[~touched].any()
    if max_level is not None:
        assert not got[max_level + 1:].any()


@pytest.mark.parametrize("f", [1, 4, 8])
def test_table_gradient_other_widths(f):
    jenc, penc = _encodings(3, f, "additive", dup_gather_dtype="float32")
    x = _positions(1500, 3, f)
    g = np.random.default_rng(f).normal(size=(1500, 4 * f)).astype(np.float32)
    want, got = _grads(jenc, penc, x, g)
    err, scale = _level_err(want, got)
    assert (err <= BOUND * scale).all(), (err / scale)


def test_matches_pallas_forward_backward():
    """``_pge_bwd``, the backward that the JAX package pairs with the Pallas
    forward (B1), on the XOR hash."""
    jenc, penc = _encodings(3, 2, "tcnn")
    x = _positions(8192, 3, 9)  # the kernel takes whole 8192-row tiles
    g = np.random.default_rng(9).normal(size=(8192, 8)).astype(np.float32)
    table = jnp.zeros(tuple(penc.table.shape), jnp.float32)
    want = np.asarray(jax.jit(jax.grad(lambda t: jnp.sum(
        pallas_grid_encode(jenc, t, jnp.asarray(x)) * jnp.asarray(g))))(table))
    penc.table.grad = None
    (penc(torch.from_numpy(x)) * torch.from_numpy(g)).sum().backward()
    err, scale = _level_err(want, penc.table.grad.numpy())
    assert (err <= BOUND * scale).all(), (err / scale)


def test_top_plane_gets_the_same_total_weight(monkeypatch):
    """At x = 1 every dense-level corner clamps onto the top plane: the
    JAX package's shifted base with fraction 1 and the port's per-corner
    clamp put the whole cotangent on the same rows; at x = 0 both use the
    first plane. With float32 addends on both sides
    (``NGP_TPU_SEGSUM_PAYLOAD=float32`` there, the port's backward half and
    ``batched_segment_sum(..., "float32")`` here) the two agree to float32
    rounding."""
    monkeypatch.setenv("NGP_TPU_SEGSUM_PAYLOAD", "float32")
    for x0 in (0.0, 1.0):
        jenc, penc = _encodings(3, 2, "additive", dup_gather_dtype="float32")
        x = np.full((16, 3), x0, np.float32)
        x[8:, 0] = 0.3
        g = np.ones((16, 8), np.float32)
        want, _ = _grads(jenc, penc, x, g)
        keys, vals = hashgrid_backward_addends_reference(
            torch.from_numpy(x), torch.from_numpy(g), penc.level_scale,
            penc.level_res, penc.level_size, penc.level_hashed, penc.hash_variant)
        got = batched_segment_sum(keys, vals, penc.table.shape[1], "float32").numpy()
        dense = ~penc.level_geometry()[3]
        np.testing.assert_allclose(got[dense], want[dense], rtol=1e-6, atol=1e-6)


def test_differentiable_inputs_is_not_yet_ported():
    _, penc = _encodings(3, 2, "tcnn")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        penc(torch.zeros((4, 3)), differentiable_inputs=True)


def test_measured_error_is_far_below_the_bound():
    """The error the docstring's bound covers, on the tpu-tier path
    (additive hash, packed-bf16 reads): below 2^-7 of max|d(table)| on
    every level. Measured on this setup: 2^-9.2 and 2^-8.4 on the two dense
    levels (the top-plane split), 2^-10.8 and 2^-14.6 on the hashed ones;
    with the XOR hash 2^-18.9 and 2^-17.6 on the dense levels (identical
    addends, only the order of the sums differs) and the same on the
    hashed."""
    jenc, penc = _encodings(3, 2, "additive")
    x = _positions(4000, 3, 11)
    g = np.random.default_rng(11).normal(size=(4000, 8)).astype(np.float32)
    want, got = _grads(jenc, penc, x, g)
    err, scale = _level_err(want, got)
    assert (err <= 2.0 ** -7 * scale).all(), (err / scale)

"""Tiled grids and Simplex interpolation in the port's grid encoding
(``ngp_tpu_torch/ops/hashgrid.py``: the plain twins of the three CUDA grid
kernels, run on the CPU) against the JAX package's ``GridEncoding``.

Setup: L=4 levels, base resolution 8, per_level_scale 2.0. In 3D with
T=2^10 a Tiled grid stores level 0 dense (8³ = 512 rows) and wraps levels
1-3 (16³, 32³ and 64³ cells onto 1,024 rows); a Hash grid hashes them. In
2D with T=2^8 levels 0 and 1 are dense (64 and 256 rows), 2 and 3 wrap or
hash. Positions include 0 and 1 (the dense top plane, where a corner
clamps), a few just outside [0, 1], and rows whose coordinates are equal,
so that their fractions tie at every level (the Simplex rank order).

The JAX package computes these grids on its classic path
(``pairs_eligible`` is false): the forward reads ``gather_dtype`` rows
(float32 here) even with the additive hash, d(table) sums bf16 addends
(``_ggbe_bwd``), and dx is plain autodiff of the float32 gathers, through
the sort for Simplex. Tolerances, each the bound of the test module that
holds the Linear grid:

- forward: ``RTOL, ATOL = 1e-5, 1e-6`` (``tests/test_torch_hashgrid.py``);
- d(table): 2^-6 of max|d(table)| per level
  (``tests/test_torch_grid_backward.py``: bf16 addends on both sides);
- dx and the float32-addend d(table): the float32 order bound
  (2·(n − 1) + 2·D)·2^-24·Σ|term| of ``tests/test_torch_grid_input_grad.py``,
  Σ|term| and n from ``hashgrid_input_grad_mass``;
- the twins against their composed plain form: bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ngp_tpu.models.encodings import GridEncoding as JaxGridEncoding
from ngp_tpu_torch.models.encodings import GridEncoding
from ngp_tpu_torch.ops.hashgrid import (
    HASHGRID_ENCODE,
    hashgrid_backward,
    hashgrid_backward_addends_reference,
    hashgrid_encode_cuda,
    hashgrid_encode_reference,
    hashgrid_input_grad,
    hashgrid_input_grad_mass,
    hashgrid_input_grad_reference,
    level_mask,
    n_corners,
    simplex_ranks,
)
from ngp_tpu_torch.ops.segsum import segment_sum_reference

# One intra-op thread, as in every port test module (see
# tests/test_torch_hashgrid.py).
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
BOUND = 2.0 ** -6
EDGES = [0.0, 1.0, 0.5, 1.0 - 1e-7, 1e-7, -0.01, 1.01]

KINDS = {"tiled": ("Tiled", "Linear"), "simplex": ("Hash", "Simplex"),
         "tiled_simplex": ("Tiled", "Simplex")}


def _positions(n, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (n, d)).astype(np.float32)
    k = len(EDGES)
    for i, v in enumerate(EDGES):
        x[i] = v  # every coordinate at the edge value
        x[k + i, 0] = v
        x[2 * k + i, d - 1] = v
    tied = slice(3 * k, 3 * k + 40)
    x[tied, 1:] = x[tied, :1]  # equal coordinates: tied fractions everywhere
    x[3 * k + 40:3 * k + 60, 1] = x[3 * k + 40:3 * k + 60, 0]  # a tie of two
    return x


def _encodings(kind, d, f, variant, n_levels=4, **kw):
    grid_type, interpolation = KINDS[kind]
    args = dict(n_input_dims=d, n_levels=n_levels, n_features_per_level=f,
                log2_hashmap_size=10 if d == 3 else 8, base_resolution=8,
                per_level_scale=2.0, hash_variant=variant, grid_type=grid_type,
                interpolation=interpolation)
    args.update(kw)
    return JaxGridEncoding(**args), GridEncoding(device="cpu", **args)


def _geo(penc):
    return (penc.level_scale, penc.level_res, penc.level_size, penc.level_hashed,
            penc.hash_variant)


def _level_err(want, got):
    return np.abs(got - want).max(axis=(1, 2)), np.abs(want).max(axis=(1, 2))


def _within(got, want, mass, n, d, what):
    bound = (2.0 * (n - 1) + 2.0 * d) * 2.0 ** -24 * mass
    err = np.abs(got.astype(np.float64) - want)
    assert (err <= bound).all(), (what, float(err.max()), float((err - bound).max()))


def test_level_geometry_matches_jax():
    """Tiled levels are never hashed; their rows are min(next_multiple(r^D,
    8), T), and a level wraps (mask size − 1) exactly where r^D > T."""
    for d in (2, 3):
        for kind in ("tiled", "simplex"):
            jenc, penc = _encodings(kind, d, 2, "tcnn")
            for a, b in zip(jenc._level_geometry(), penc.level_geometry()):
                np.testing.assert_array_equal(a, b)
            assert penc.n_params == jenc.n_params
            assert penc.max_table_rows == jenc.max_table_rows
        hashed = penc.level_geometry()[3]
        tiled = _encodings("tiled", d, 2, "tcnn")[1]
        _, tres, tsizes, thashed = tiled.level_geometry()
        assert not thashed.any() and hashed.any()
        wraps = [int(r) ** d > int(s) for r, s in zip(tres, tsizes)]
        assert not wraps[0] and all(wraps[2:])
        for s, w in zip(tsizes.tolist(), wraps):
            assert not w or (s == tiled.table_size and level_mask(s) == s - 1)


CASES = [(kind, d, v, f) for kind in ("tiled", "simplex") for d in (2, 3)
         for v in ("tcnn", "additive") for f in (1, 2, 4)]
CASES += [("tiled_simplex", 3, "tcnn", 2), ("tiled_simplex", 2, "additive", 4)]


@pytest.mark.parametrize("kind,d,variant,f", CASES)
def test_forward_table_and_position_gradients_match_jax(kind, d, variant, f):
    """Forward, d(table) and dx of the port's encoding against the JAX
    package's, both paths (module docstring); the twins against their
    composed plain form bit for bit; the CPU tensors launch no kernel."""
    jenc, penc = _encodings(kind, d, f, variant)
    assert not penc.bf16_reads  # the JAX classic path reads gather_dtype rows
    L, T, _ = penc.table.shape
    n = 600
    x = _positions(n, d, 10 * d + f)
    rng = np.random.default_rng(f + d)
    table = rng.uniform(-1, 1, (L, T, f)).astype(np.float32)
    g = rng.normal(size=(n, L * f)).astype(np.float32)
    tx, tg, tt = torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(table)
    interp = penc.interpolation
    before = dict(HASHGRID_ENCODE.launches)

    # training path: float32 reads, bf16 addends
    out_j, vjp = jax.vjp(lambda t: jenc({"table": t}, jnp.asarray(x)), jnp.asarray(table))
    dt_j = np.asarray(vjp(jnp.asarray(g))[0])
    with torch.no_grad():
        penc.table.copy_(tt)
    penc.table.grad = None
    out_p = penc(tx)
    (out_p * tg).sum().backward()
    np.testing.assert_allclose(out_p.detach().numpy(), np.asarray(out_j), rtol=RTOL, atol=ATOL)
    err, scale = _level_err(dt_j, penc.table.grad.numpy())
    assert (err <= BOUND * scale + 1e-12).all(), err / scale
    keys, vals = hashgrid_backward_addends_reference(tx, tg, *_geo(penc), None, interp)
    assert keys.shape == (L, n * n_corners(d, interp))
    assert torch.equal(penc.table.grad, segment_sum_reference(keys, vals, T))

    # differentiable path: dx and the float32-addend d(table)
    def f_j(t, xx):
        return jenc({"table": t}, xx, differentiable_inputs=True)

    _, vjp = jax.vjp(f_j, jnp.asarray(table), jnp.asarray(x))
    dt2_j, dx_j = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    penc.table.grad = None
    xt = tx.clone().requires_grad_(True)
    (penc(xt, differentiable_inputs=True) * tg).sum().backward()
    dx_p = xt.grad.numpy()
    assert torch.equal(xt.grad, hashgrid_input_grad_reference(tx, tg, tt, *_geo(penc), None,
                                                              interp))
    assert torch.equal(penc.table.grad, hashgrid_backward(tx, tg, *_geo(penc), None, T,
                                                          "float32", interp))
    mass, terms = hashgrid_input_grad_mass(tx, tg, tt, *_geo(penc), None, interp)
    _within(dx_p, dx_j, mass.numpy(), terms, d, "dx")
    assert np.abs(dx_j).max() > 1.0
    tmass = np.zeros((L, T, f))
    count = np.zeros((L, T, 1))
    for l in range(L):
        np.add.at(tmass[l], keys[l].numpy(), np.abs(vals[l].numpy()).astype(np.float64))
        np.add.at(count[l], keys[l].numpy(), 1.0)
    _within(penc.table.grad.numpy(), dt2_j, tmass, np.maximum(count, 1.0), d, "d(table)")
    assert HASHGRID_ENCODE.launches == before


@pytest.mark.parametrize("kind", ["tiled", "simplex"])
def test_max_level_zeroes_levels_and_their_gradients(kind):
    """max_level: the levels above it are zero in the output and add nothing
    to d(table) or dx, as in the JAX package."""
    jenc, penc = _encodings(kind, 3, 2, "tcnn")
    L, T, F = penc.table.shape
    x = _positions(400, 3, 4)
    rng = np.random.default_rng(4)
    table = rng.uniform(-1, 1, (L, T, F)).astype(np.float32)
    g = rng.normal(size=(400, L * F)).astype(np.float32)
    out_j, vjp = jax.vjp(lambda t, xx: jenc({"table": t}, xx, max_level=1,
                                            differentiable_inputs=True),
                         jnp.asarray(table), jnp.asarray(x))
    dt_j, dx_j = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    with torch.no_grad():
        penc.table.copy_(torch.from_numpy(table))
    penc.table.grad = None
    xt = torch.from_numpy(x).requires_grad_(True)
    out = penc(xt, max_level=1, differentiable_inputs=True)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), rtol=RTOL, atol=ATOL)
    assert not out[:, 2 * F:].any()
    assert not penc.table.grad[2:].any()
    mass, terms = hashgrid_input_grad_mass(torch.from_numpy(x), torch.from_numpy(g),
                                           torch.from_numpy(table), *_geo(penc), 1,
                                           penc.interpolation)
    _within(xt.grad.numpy(), dx_j, mass.numpy(), terms, 3, "dx")


@pytest.mark.parametrize("d", [2, 3])
def test_tiled_strides_wrap_modulo_two_to_the_32(d):
    """Levels of up to 1,024,000 cells a side (per_level_scale 40): the
    stride r^d and the linear sum wrap modulo 2^32 before the level's mask,
    as the JAX package's uint32 arithmetic does."""
    jenc, penc = _encodings("tiled", d, 2, "tcnn", per_level_scale=40.0)
    res = penc.level_geometry()[1]
    assert int(res[-1]) ** (d - 1) > 2 ** 32 or d == 2
    L, T, F = penc.table.shape
    x = _positions(800, d, 3)
    rng = np.random.default_rng(3)
    table = rng.uniform(-1, 1, (L, T, F)).astype(np.float32)
    g = rng.normal(size=(800, L * F)).astype(np.float32)
    out_j, vjp = jax.vjp(lambda xx: jenc({"table": jnp.asarray(table)}, xx,
                                         differentiable_inputs=True), jnp.asarray(x))
    (dx_j,) = vjp(jnp.asarray(g))
    tx, tg, tt = torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(table)
    np.testing.assert_allclose(hashgrid_encode_reference(tx, tt, *_geo(penc)).numpy(),
                               np.asarray(out_j), rtol=RTOL, atol=ATOL)
    mass, terms = hashgrid_input_grad_mass(tx, tg, tt, *_geo(penc))
    _within(hashgrid_input_grad(tx, tg, tt, *_geo(penc)).numpy(), np.asarray(dx_j),
            mass.numpy(), terms, d, "dx")


@pytest.mark.parametrize("d", [2, 3])
def test_simplex_ranks_follow_the_jax_sort_on_ties(d):
    """The twin's ranks, corners and weights are the JAX package's
    ``_simplex_corners_weights`` exactly, on fractions with every kind of
    tie (two equal, all equal, zeros)."""
    jenc, _ = _encodings("simplex", d, 2, "tcnn")
    rng = np.random.default_rng(d)
    frac = rng.choice(np.asarray([0.0, 0.25, 0.5, 0.75], np.float32), (500, d))
    frac[:50] = rng.integers(0, 1 << 20, (50, d)) / np.float32(1 << 20)
    corners_j, w_j = (np.asarray(a) for a in jenc._simplex_corners_weights(jnp.asarray(frac)))
    ranks = simplex_ranks(torch.from_numpy(frac))
    corners = np.stack([np.stack([(r < k).numpy() for r in ranks], -1)
                        for k in range(d + 1)], 1).astype(np.int32)
    np.testing.assert_array_equal(corners, corners_j)
    # weights: the twin's at a level of scale 1 from x = frac + 7.5, whose
    # p = x + 0.5 = frac + 8 is exact (fractions are multiples of 2^-20)
    x = torch.from_numpy(frac) + 7.5
    from ngp_tpu_torch.ops.hashgrid import _level_corners

    ws = [w for _, w in _level_corners(x, 1.0, 64, 1 << 20, False, False, "Simplex")]
    np.testing.assert_array_equal(torch.stack(ws, 1).numpy(), w_j)


@pytest.mark.parametrize("kind", ["tiled", "simplex"])
def test_additive_grid_reads_float32_rows_unlike_the_linear_fast_path(kind):
    """With the additive hash and the default packed_bf16 dup dtype, a
    Linear Hash grid reads bf16-rounded rows (the JAX fast path), a Tiled
    or Simplex grid float32 rows (the JAX classic path): its output equals
    the JAX package's within the float32 bound, far below what bf16 rows
    would move it. ``gather_dtype="bfloat16"`` turns bf16 reads on."""
    jenc, penc = _encodings(kind, 3, 2, "additive")
    assert not penc.bf16_reads
    assert _encodings("tiled", 3, 2, "additive", gather_dtype="bfloat16")[1].bf16_reads
    assert GridEncoding(hash_variant="additive", device="cpu").bf16_reads
    L, T, F = penc.table.shape
    x = _positions(1000, 3, 8)
    table = np.random.default_rng(8).uniform(-1, 1, (L, T, F)).astype(np.float32)
    with torch.no_grad():
        penc.table.copy_(torch.from_numpy(table))
    got = penc(torch.from_numpy(x)).detach().numpy()
    want = np.asarray(jenc({"table": jnp.asarray(table)}, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    bf16 = hashgrid_encode_reference(torch.from_numpy(x),
                                     torch.from_numpy(table).to(torch.bfloat16), *_geo(penc),
                                     None, penc.interpolation).numpy()
    assert np.abs(bf16 - want).max() > 100 * ATOL


def test_cuda_wrappers_refuse_cpu_tensors_and_unknown_interpolations():
    _, penc = _encodings("simplex", 3, 2, "tcnn")
    x = torch.from_numpy(_positions(64, 3, 0))
    with pytest.raises(ValueError, match="CUDA tensor"):
        hashgrid_encode_cuda(x, penc.table.detach(), *_geo(penc), None, "Simplex")
    with pytest.raises(ValueError, match="unsupported interpolation"):
        GridEncoding(interpolation="Cubic", device="cpu")
    with pytest.raises(ValueError, match="unsupported grid_type"):
        GridEncoding(grid_type="Octree", device="cpu")

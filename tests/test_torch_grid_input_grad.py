"""The port's grid encoding differentiated in its positions
(``GridEncoding.forward(..., differentiable_inputs=True)``: dx from
``hashgrid_input_grad``, d(table) from ``hashgrid_backward`` with float32
addends; on the CPU their plain twins) against ``jax.vjp`` of the JAX
package's ``GridEncoding.__call__(..., differentiable_inputs=True)``, which
is plain autodiff of float32 gathers.

Setup as in ``tests/test_torch_grid_backward.py``: L=4, base resolution 8,
scale 2.0; in 3D with T=2^12 the levels are dense, dense, hashed, hashed,
in 2D with T=2^10 dense, dense, dense, hashed. Positions include 0 and 1
(the dense top plane, where a cell's upper corners clamp onto its lower
ones) in every coordinate, and a few just outside [0, 1].

Tolerance, per component: both sides sum the same float32 terms in other
orders. A float32 sum of n terms in any order is within
(n − 1)·2^-24·Σ|term| of the exact sum, so two orders differ by at most
2·(n − 1)·2^-24·Σ|term|. For dx the terms are
scale_l·g_f·table[idx_c, f]·Π_{d'≠d} w_{c,d'} and n = L·2^D·F; for d(table)
a row's terms are its addends w_c·g and n their count. The JAX package
multiplies a term's factors in another order (its weight product, then the
product with the feature sum). A product of the D weight factors and one
more factor, rounded after each of its D multiplications, is within
D·2^-24 of exact, so two orders differ by 2·D ulps of the term: 2·D more
ulps of Σ|term|. Measured with that bound (3D, d(table)): up to 0.65 of it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ngp_tpu.models.encodings import GridEncoding as JaxGridEncoding
from ngp_tpu_torch.models import encodings as port_encodings
from ngp_tpu_torch.models.encodings import GridEncoding
from ngp_tpu_torch.ops.hashgrid import (
    HASHGRID_ENCODE,
    hashgrid_backward_addends_reference,
    hashgrid_encode_reference,
    hashgrid_input_grad,
    hashgrid_input_grad_mass,
    hashgrid_input_grad_reference,
)

# One intra-op thread: with two, torch's CPU sqrt (MKL's vsSqrt, split across
# the intra-op threads) now and then returned one thread's chunk ~3e-4 off
# on an AVX-512 Xeon (torch 2.13, MKL 2024.2), never with one
# (scripts/torch_sqrt_threads.py counts it).
# Every port test module sets the same count, so that a pytest worker's
# count does not depend on which module it imported last.
torch.set_num_threads(1)

EDGES = [0.0, 1.0, 0.5, 1.0 - 1e-7, 1e-7]
OUTSIDE = [-0.01, 1.01, -1e-3, 1.0 + 1e-3]


def _positions(n, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (n, d)).astype(np.float32)
    k = len(EDGES)
    for i, v in enumerate(EDGES):
        x[i] = v  # every coordinate at the edge value
        x[k + i, 0] = v
        x[2 * k + i, d - 1] = v
    for i, v in enumerate(OUTSIDE):
        x[3 * k + i, i % d] = v
    return x


def _encodings(d, f, variant, n_levels=4, **kw):
    args = dict(n_input_dims=d, n_levels=n_levels, n_features_per_level=f,
                log2_hashmap_size=12 if d == 3 else 10, base_resolution=8,
                per_level_scale=2.0, hash_variant=variant, **kw)
    return JaxGridEncoding(**args), GridEncoding(device="cpu", **args)


def _geo(penc):
    return (penc.level_scale, penc.level_res, penc.level_size, penc.level_hashed,
            penc.hash_variant)


def _jax_vjp(jenc, table, x, g, max_level):
    """(out, d(table), dx) of the JAX differentiable path."""
    def f(t, xx):
        return jenc({"table": t}, xx, max_level=max_level, differentiable_inputs=True)

    out, vjp = jax.vjp(f, jnp.asarray(table), jnp.asarray(x))
    dt, dx = vjp(jnp.asarray(g))
    return np.asarray(out), np.asarray(dt), np.asarray(dx)


def _port_grads(penc, table, x, g, max_level):
    """(out, d(table), dx) of the port's encoding with differentiable_inputs."""
    with torch.no_grad():
        penc.table.copy_(torch.from_numpy(table))
    penc.table.grad = None
    xt = torch.from_numpy(x).requires_grad_(True)
    out = penc(xt, max_level=max_level, differentiable_inputs=True)
    (out * torch.from_numpy(g)).sum().backward()
    return out.detach().numpy(), penc.table.grad.numpy(), xt.grad.numpy()


def _dx_mass(penc, table, x, g, max_level):
    """(Σ|term| per component of dx (float64), terms per component)."""
    mass, n = hashgrid_input_grad_mass(torch.from_numpy(x), torch.from_numpy(g),
                                       torch.from_numpy(table), *_geo(penc), max_level)
    return mass.numpy(), n


def _table_mass(penc, x, g, max_level, n_rows):
    """(Σ|addend| per d(table) entry (float64), addends per row)."""
    keys, vals = hashgrid_backward_addends_reference(
        torch.from_numpy(x), torch.from_numpy(g), *_geo(penc), max_level)
    L, _, F = vals.shape
    mass = np.zeros((L, n_rows, F))
    count = np.zeros((L, n_rows, 1))
    v = np.abs(vals.numpy()).astype(np.float64)
    for l in range(L):
        np.add.at(mass[l], keys[l].numpy(), v[l])
        np.add.at(count[l], keys[l].numpy(), 1.0)
    return mass, count


def _within(got, want, mass, n, d, what):
    """|got − want| within the module's bound: 2·(n − 1) + 2·d ulps of
    Σ|term|, d the position dimensions."""
    bound = (2.0 * (n - 1) + 2.0 * d) * 2.0 ** -24 * mass
    err = np.abs(got.astype(np.float64) - want)
    assert (err <= bound).all(), (what, float(err.max()), float((err - bound).max()))


CASES = [(d, v, f, None) for d in (2, 3) for v in ("additive", "tcnn")
         for f in (1, 2, 4)] + [(3, "additive", 2, 1), (2, "tcnn", 4, 2)]


@pytest.mark.parametrize("d,variant,f,max_level", CASES)
def test_input_and_table_gradients_match_jax(d, variant, f, max_level):
    """dx and the unrounded d(table) within the float32 order bound; the
    forward itself reads float32 rows (bf16_reads holds for the additive
    cases, F even) and equals the float32 twin bit for bit."""
    jenc, penc = _encodings(d, f, variant)
    L, T, _ = penc.table.shape
    n = 1200
    x = _positions(n, d, 10 * d + f)
    rng = np.random.default_rng(f)
    table = rng.uniform(-1, 1, (L, T, f)).astype(np.float32)
    g = rng.normal(size=(n, L * f)).astype(np.float32)
    out_j, dt_j, dx_j = _jax_vjp(jenc, table, x, g, max_level)
    out_p, dt_p, dx_p = _port_grads(penc, table, x, g, max_level)

    ref = hashgrid_encode_reference(torch.from_numpy(x), torch.from_numpy(table),
                                    *_geo(penc), max_level).numpy()
    np.testing.assert_array_equal(out_p, ref)
    np.testing.assert_allclose(out_p, out_j, rtol=1e-6, atol=1e-6)

    mass, terms = _dx_mass(penc, table, x, g, max_level)
    _within(dx_p, dx_j, mass, terms, d, "dx")
    assert np.abs(dx_j).max() > 1.0  # the gradient is not trivially small
    tmass, count = _table_mass(penc, x, g, max_level, T)
    _within(dt_p, dt_j, tmass, np.maximum(count, 1.0), d, "d(table)")
    if max_level is not None:
        assert not dt_p[max_level + 1:].any()
        assert not np.signbit(dt_p[max_level + 1:]).any()


def test_dx_matches_the_twin_and_levels_above_max_level_add_nothing():
    """The autograd backward's dx is ``hashgrid_input_grad``'s (the twin on
    the CPU, no kernel launch); with max_level the dx is that of the
    levels up to it, and a table row of a higher level changes nothing."""
    _, penc = _encodings(3, 2, "additive")
    L, T, F = penc.table.shape
    x = torch.from_numpy(_positions(500, 3, 4))
    rng = np.random.default_rng(4)
    table = torch.from_numpy(rng.uniform(-1, 1, (L, T, F)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(500, L * F)).astype(np.float32))
    before = dict(HASHGRID_ENCODE.launches)
    for max_level in (None, 1):
        with torch.no_grad():
            penc.table.copy_(table)
        xt = x.clone().requires_grad_(True)
        (penc(xt, max_level=max_level, differentiable_inputs=True) * g).sum().backward()
        want = hashgrid_input_grad(x, g, table, *_geo(penc), max_level)
        assert torch.equal(xt.grad, want)
        assert torch.equal(want, hashgrid_input_grad_reference(
            x, g, table, *_geo(penc), max_level))
    assert HASHGRID_ENCODE.launches == before
    high = table.clone()
    high[2:] = torch.from_numpy(rng.uniform(-1, 1, (L - 2, T, F)).astype(np.float32))
    assert torch.equal(hashgrid_input_grad(x, g, table, *_geo(penc), 1),
                       hashgrid_input_grad(x, g, high, *_geo(penc), 1))


def test_top_plane_clamped_corners_cancel():
    """At x_0 = 1 every dense level's upper corners along x clamp onto the
    lower ones: the pair reads one row, so that level adds exactly 0 to
    dx_0. On a grid of dense levels only the whole dx_0 is +-0; JAX agrees
    within the bound."""
    jenc, penc = _encodings(2, 2, "tcnn", n_levels=3)  # res 8, 16, 32: all dense
    assert not penc.level_hashed.any()
    L, T, F = penc.table.shape
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, (64, 2)).astype(np.float32)
    x[:, 0] = 1.0
    table = rng.uniform(-1, 1, (L, T, F)).astype(np.float32)
    g = rng.normal(size=(64, L * F)).astype(np.float32)
    got = hashgrid_input_grad(torch.from_numpy(x), torch.from_numpy(g),
                              torch.from_numpy(table), *_geo(penc)).numpy()
    assert not got[:, 0].any()
    assert np.abs(got[:, 1]).max() > 1.0
    _, _, dx_j = _jax_vjp(jenc, table, x, g, None)
    mass, terms = _dx_mass(penc, table, x, g, None)
    _within(got, dx_j, mass, terms, 2, "dx")


@pytest.mark.parametrize("d", [2, 3])
def test_twin_matches_finite_differences_in_float64(d):
    """Inside a cell the encoding is linear along each axis, so a central
    difference in float64 is exact but for rounding: the float64 twin
    matches it to 1e-9 relative, at positions at least 1e-3 (in cell
    units) from every cell face on every level."""
    _, penc = _encodings(d, 2, "tcnn")
    L, T, F = penc.table.shape
    rng = np.random.default_rng(d)
    x = rng.uniform(0.0, 1.0, (4000, d))
    for sc in penc.level_scale.tolist():
        p = x * sc + 0.5
        frac = p - np.floor(p)
        x = x[(np.minimum(frac, 1.0 - frac) > 1e-3).all(1)]
    assert x.shape[0] > 50
    x = torch.from_numpy(x)
    table = torch.from_numpy(rng.uniform(-1, 1, (L, T, F)))
    g = torch.from_numpy(rng.normal(size=(x.shape[0], L * F)))
    geo = _geo(penc)
    dx = hashgrid_input_grad_reference(x, g, table, *geo)
    h = 1e-7 / penc.level_scale.max().item()
    for k in range(d):
        e = torch.zeros(d, dtype=torch.float64)
        e[k] = h
        up = (hashgrid_encode_reference(x + e, table, *geo) * g).sum(1)
        down = (hashgrid_encode_reference(x - e, table, *geo) * g).sum(1)
        fd = (up - down) / (2 * h)
        torch.testing.assert_close(dx[:, k], fd, rtol=1e-6, atol=1e-6 * fd.abs().max())


def test_only_the_gradients_asked_for_are_computed(monkeypatch):
    """A table that does not require grad launches no d(table) backward:
    ``needs_input_grad`` follows ``requires_grad``, not the inputs an
    ``autograd.grad`` call asks for, so a caller that wants dx alone
    detaches the table (the engine's normals mode does). Positions that do
    not require grad get no dx."""
    calls = []
    for name in ("hashgrid_backward", "hashgrid_input_grad"):
        fn = getattr(port_encodings, name)
        monkeypatch.setattr(port_encodings, name,
                            lambda *a, _fn=fn, _n=name, **k: calls.append(_n) or _fn(*a, **k))
    _, penc = _encodings(3, 2, "additive")
    x = torch.from_numpy(_positions(64, 3, 1)).requires_grad_(True)
    penc.table.requires_grad_(False)
    out = penc(x, differentiable_inputs=True)
    torch.autograd.grad(out.sum(), x)
    assert calls == ["hashgrid_input_grad"]
    penc.table.requires_grad_(True)
    calls.clear()
    out = penc(x.detach(), differentiable_inputs=True)
    out.sum().backward()
    assert calls == ["hashgrid_backward"]


def _bits(t):
    return t.contiguous().view(torch.int32 if t.dtype == torch.float32 else torch.int64)


@pytest.mark.parametrize("d,f,variant", [(2, 1, "tcnn"), (2, 2, "additive"),
                                         (2, 8, "tcnn"), (3, 1, "additive"),
                                         (3, 2, "tcnn"), (3, 8, "additive")])
def test_twin_adds_the_level_terms_in_level_order_from_positive_zero(d, f, variant):
    """dx with levels 0 .. k is dx with levels 0 .. k − 1 plus level k's term
    t_k (the twin on level k alone: 0.0 + t_k), bit for bit: the twin is a
    float32 sum of per-level terms in level order from +0.0, the contract
    that lets the kernel take its levels in stages of its cotangent tile
    and keep the twin's bits."""
    _, penc = _encodings(d, f, variant, n_levels=6)
    L, T, F = penc.table.shape
    n = 700
    x = torch.from_numpy(_positions(n, d, 30 + d))
    rng = np.random.default_rng(10 * d + f)
    table = torch.from_numpy(rng.uniform(-1, 1, (L, T, F)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(n, L * F)).astype(np.float32))
    geo = _geo(penc)
    prev = torch.zeros(n, d)
    for k in range(L):
        level = [v[k:k + 1] for v in geo[:4]]
        t_k = hashgrid_input_grad_reference(x, g[:, k * F:(k + 1) * F], table[k:k + 1],
                                            *level, variant)
        got = hashgrid_input_grad_reference(x, g, table, *geo, k)
        assert torch.equal(_bits(got), _bits(prev + t_k)), k
        prev = got
    assert torch.equal(_bits(prev), _bits(hashgrid_input_grad_reference(x, g, table, *geo)))
    assert prev.abs().max() > 1.0


@pytest.mark.parametrize("d", [2, 3])
def test_a_negative_zero_first_term_gives_positive_zero(d):
    """The level sum starts from +0.0, not from the first level's term: a
    level 0 whose term t_0 = dfrac · scale is −0.0 (scale −0.0, zero
    cotangents) gives dx = +0.0 alone."""
    _, penc = _encodings(d, 2, "tcnn")
    L, T, F = penc.table.shape
    scale = penc.level_scale.clone()
    scale[0] = -0.0
    geo = (scale, *_geo(penc)[1:])
    x = torch.from_numpy(_positions(300, d, 7))
    rng = np.random.default_rng(7)
    table = torch.from_numpy(rng.uniform(-1, 1, (L, T, F)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(300, L * F)).astype(np.float32))
    g[:, :F] = 0.0
    dx = hashgrid_input_grad_reference(x, g, table, *geo, 0)
    assert not dx.any() and not torch.signbit(dx).any()
    # the term itself is -0.0: a sum started from it would keep the sign
    frac = x * 0.0 + 0.5
    assert torch.signbit((frac * 0.0) * scale[0]).all()

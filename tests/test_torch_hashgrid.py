"""Parity of the port's grid encoding (``ngp_tpu_torch/ops/hashgrid.py``,
plain twin of the CUDA kernel, run on the CPU) with the JAX package.

Setup: L=4 levels, base resolution 8, per_level_scale 2.0. In 3D with
T=2^12 the levels are dense, dense, hashed, hashed; in 2D T=2^10 gives
three dense levels and one hashed. Positions include 0, 1, the top dense
plane of level 0 (x·7 + 0.5 ≥ 7) and values slightly outside [0, 1].
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ngp_tpu.models.encodings import GridEncoding as JaxGridEncoding
from ngp_tpu.models.encodings import pallas_grid_encode
from ngp_tpu_torch.models.encodings import GridEncoding
from ngp_tpu_torch.ops.hashgrid import (
    HASHGRID_ENCODE,
    _host_geometry,
    hashgrid_encode,
    hashgrid_encode_cuda,
)

# One intra-op thread: with two, torch's CPU sqrt (MKL's vsSqrt, split across
# the intra-op threads) now and then returned one thread's chunk ~3e-4 off
# on an AVX-512 Xeon (torch 2.13, MKL 2024.2), never with one
# (scripts/torch_sqrt_threads.py counts it).
# Every port test module sets the same count, so that a pytest worker's
# count does not depend on which module it imported last.
torch.set_num_threads(1)

# float32 agreement: both sides blend the same float32 values; only the
# summation order over the 2^D corners (and, for the additive hash, the
# JAX package's shifted top-plane base instead of a per-corner clamp) can
# differ, a few float32 ulps of the result.
RTOL, ATOL = 1e-5, 1e-6

SPECIAL = [0.0, 1.0, 0.95, 0.99, -0.01, 1.01, -0.2, 1.2, 0.5, 7.0 / 14.0]


def _positions(n, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (n, d)).astype(np.float32)
    k = len(SPECIAL)
    for i, v in enumerate(SPECIAL):
        x[i] = v  # every coordinate at the special value
        x[k + i, 0] = v  # one coordinate at a time
        x[2 * k + i, d - 1] = v
    return x


def _encodings(d, f, variant, dup_dtype="float32"):
    kw = dict(n_input_dims=d, n_levels=4, n_features_per_level=f,
              log2_hashmap_size=12 if d == 3 else 10, base_resolution=8,
              per_level_scale=2.0, hash_variant=variant,
              dup_gather_dtype=dup_dtype)
    return JaxGridEncoding(**kw), GridEncoding(device="cpu", **kw)


def _table(enc, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.0, 1.0, tuple(enc.table.shape)).astype(np.float32)


def _port(enc, table, x, max_level=None):
    with torch.no_grad():
        enc.table.copy_(torch.from_numpy(table))
        return enc(torch.from_numpy(x), max_level=max_level).numpy()


def test_level_geometry_matches_jax():
    for d in (2, 3):
        jenc, penc = _encodings(d, 2, "tcnn")
        for a, b in zip(jenc._level_geometry(), penc.level_geometry()):
            np.testing.assert_array_equal(a, b)
        assert penc.n_output_dims == jenc.n_output_dims
        assert penc.max_table_rows == jenc.max_table_rows
        assert penc.n_params == jenc.n_params
        hashed = penc.level_geometry()[3]
        assert hashed.any() and not hashed.all()


def test_twin_matches_pallas_kernel_interpret():
    """(a) the TPU kernel itself, run as the JAX package runs it on the CPU
    (``pallas_grid_encode`` → ``hashgrid_encode_pallas``, interpret mode)."""
    jenc, penc = _encodings(3, 2, "tcnn")
    table = _table(penc, 1)
    x = _positions(8192, 3, 2)
    want = np.asarray(pallas_grid_encode(jenc, jnp.asarray(table), jnp.asarray(x)))
    got = _port(penc, table, x)
    # The interpret-mode kernel rounds p = x·scale + 0.5 once (fused); the
    # port rounds product and sum separately, as the JAX XLA path does (the
    # two agree bit for bit). Where the roundings differ (x·scale in a lower
    # binade than p), the fraction moves by one ulp of p ≤ 2^-17 (p < 128), the
    # output by at most that times |t_hi − t_lo| ≤ 2·max|t|.
    scales = penc.level_geometry()[0]
    p2 = (x[:, None, :] * scales[None, :, None]).astype(np.float32) + np.float32(0.5)
    p1 = (x[:, None, :].astype(np.float64) * scales[None, :, None] + 0.5).astype(np.float32)
    fused_differs = np.repeat((p1 != p2).any(-1), 2, axis=1)  # (N, L·F)
    assert fused_differs.mean() < 0.15  # the rest is held to RTOL, ATOL
    np.testing.assert_allclose(got[~fused_differs], want[~fused_differs],
                               rtol=RTOL, atol=ATOL)
    bound = 2.0 ** -17 * 2 * np.abs(table).max()
    assert np.abs(got - want)[fused_differs].max(initial=0.0) <= bound


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("f", [1, 2, 4, 8])
@pytest.mark.parametrize("variant", ["tcnn", "additive"])
def test_twin_matches_grid_encoding(variant, f, d):
    """(b) ``GridEncoding.__call__`` with float32 table reads, both hash
    variants, every F and D the kernel takes, with and without max_level."""
    jenc, penc = _encodings(d, f, variant)
    table = _table(penc, 10 * f + d)
    x = _positions(2048, d, f + d)
    params = {"table": jnp.asarray(table)}
    for max_level in (None, 1):
        want = np.asarray(jenc(params, jnp.asarray(x), max_level=max_level))
        got = _port(penc, table, x, max_level=max_level)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert not got[:, 2 * f:].any()  # levels above max_level=1 are zero


@pytest.mark.parametrize("d", [2, 3])
def test_packed_bf16_default_additive_path(d):
    """(c) the default additive path reads the table rounded to bf16. Each
    level's output is a convex blend of table entries (the weights sum to
    1), and bf16 rounding moves an entry by at most 2^-9 of its magnitude,
    so the two sides may differ by at most 2^-8·max|table[l]| per level
    even where only one of them rounded."""
    jenc, penc = _encodings(d, 2, "additive", dup_dtype="packed_bf16")
    assert penc.bf16_reads
    table = _table(penc, 7)
    x = _positions(4096, d, 8)
    want = np.asarray(jenc({"table": jnp.asarray(table)}, jnp.asarray(x)))
    got = _port(penc, table, x)
    bound = 2.0 ** -8 * np.abs(table).max(axis=(1, 2))  # (L,)
    err = np.abs(got - want).reshape(-1, 4, 2).max(axis=(0, 2))
    assert (err <= bound).all(), (err, bound)


def test_wrapper_uses_twin_only_for_cpu_tensors():
    """The dispatcher routes CPU tensors to the twin and launches nothing;
    the CUDA wrapper refuses CPU tensors rather than falling back."""
    _, penc = _encodings(3, 2, "tcnn")
    x = torch.from_numpy(_positions(64, 3, 0))
    before = HASHGRID_ENCODE.launches["hashgrid_encode"]
    out = hashgrid_encode(x, penc.table.detach(), penc.level_scale,
                          penc.level_res, penc.level_size, penc.level_hashed,
                          "tcnn")
    assert out.shape == (64, 8) and HASHGRID_ENCODE.launches["hashgrid_encode"] == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        hashgrid_encode_cuda(x, penc.table.detach(), penc.level_scale,
                             penc.level_res, penc.level_size,
                             penc.level_hashed, "tcnn")


def test_host_geometry_is_read_once_per_tensor_set():
    """The forward kernel takes the level geometry by value: the wrapper
    reads the four tensors to the host once, keeps the struct on ``scale``,
    and reads again after an in-place change or with another tensor."""
    _, penc = _encodings(3, 2, "tcnn")
    parts = [penc.level_scale.clone(), penc.level_res.clone(),
             penc.level_size.clone(), penc.level_hashed.clone()]
    geo = _host_geometry(*parts)
    L = parts[0].shape[0]
    assert list(geo.scale[:L]) == parts[0].tolist()
    assert list(geo.res[:L]) == parts[1].tolist()
    assert list(geo.mask[:L]) == [s - 1 for s in parts[2].tolist()]
    assert list(geo.hashed[:L]) == parts[3].tolist()
    assert _host_geometry(*parts) is geo
    parts[1][0] += 1
    again = _host_geometry(*parts)
    assert again is not geo and again.res[0] == geo.res[0] + 1
    other = parts[3].clone()
    assert _host_geometry(*parts[:3], other) is not again

"""The port's segment sums and histograms (``ngp_tpu_torch/ops/segsum.py``,
plain twins of ``csrc/segment_sum.cu``, run on the CPU) against numpy and
against the JAX package's Pallas kernels in interpret mode: B2
``segment_sum_sorted_blocks`` (fed sorted keys and ``block_starts_for``, as
``tests/test_pallas_segsum.py`` feeds it), B3
``segment_count_onehot_batched`` and B4 ``segment_sum_onehot`` /
``segment_count_onehot``.

Cases: uniform keys, one hot row, mostly empty rows (which must be exactly
zero), unsorted keys (the port takes any order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ngp_tpu.ops.pallas.segsum import (
    segment_count_onehot as jax_segment_count_onehot,
    segment_count_onehot_batched,
    segment_sum_onehot as jax_segment_sum_onehot,
)
from ngp_tpu.ops.pallas.segsum_sorted import (
    RB,
    block_starts_for,
    segment_sum_sorted_blocks,
)
from ngp_tpu.ops.scatter_free import batched_segment_sum as jax_batched_segment_sum
from ngp_tpu_torch.ops.segsum import (
    SEGMENT_SUM,
    batched_segment_sum,
    segment_count,
    segment_count_onehot,
    segment_sum_onehot,
)

torch.set_num_threads(2)

KINDS = ["uniform", "one_hot_row", "few_rows"]


def _keys_vals(kind, L, M, T, F, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, T, (L, M))
    if kind == "one_hot_row":
        keys[:, : M // 2] = RB + 3
    elif kind == "few_rows":
        keys = rng.integers(0, 8, (L, M)) * (T // 8) + 1
    vals = rng.normal(size=(L, M, F)).astype(np.float32)
    return keys.astype(np.int32), vals


def _bf16(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _add_at(keys, vals, T):
    L, _, F = vals.shape
    out = np.zeros((L, T, F), np.float64)
    for l in range(L):
        np.add.at(out[l], keys[l], vals[l].astype(np.float64))
    return out


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("payload", ["bfloat16", "float32"])
def test_twin_matches_numpy_add_at(kind, payload):
    """Each addend rounded to the payload type, then summed: against an
    exact float64 ``add.at`` of the same rounded addends the float32 sum
    is within (n − 1)·2^-24·Σ|addend| per row."""
    L, M, T, F = 3, 4000, 4 * RB, 2
    keys, vals = _keys_vals(kind, L, M, T, F, 0)
    rounded = _bf16(vals) if payload == "bfloat16" else vals
    want = _add_at(keys, rounded, T)
    mass = _add_at(keys, np.abs(rounded), T)
    count = _add_at(keys, np.ones((L, M, 1), np.float32), T)
    before = dict(SEGMENT_SUM.launches)
    got = batched_segment_sum(torch.from_numpy(keys), torch.from_numpy(vals), T, payload).numpy()
    assert SEGMENT_SUM.launches == before  # CPU tensors run the twin
    assert np.all(np.abs(got - want) <= count * 2.0 ** -24 * mass)
    assert np.all(got[mass == 0] == 0.0)


@pytest.mark.parametrize("kind", KINDS)
def test_matches_sorted_blocks_kernel(kind):
    """B2 in interpret mode adds bf16 addends in float32 over sorted keys
    in its windows; the port adds the same bf16 addends in key order of
    arrival. Both are float32 sums of identical addends: within
    2·(n − 1)·2^-24·Σ|addend| of each other per row; empty rows are 0 in
    both."""
    L, M, T, F = 3, 5000, 4 * RB, 4
    keys, vals = _keys_vals(kind, L, M, T, F, 1)
    order = np.argsort(keys, axis=1, kind="stable")
    keys_s = np.take_along_axis(keys, order, axis=1)
    vals_s = np.stack([np.take_along_axis(vals[..., f], order, axis=1)
                       for f in range(F)], axis=1)  # (L, F, M)
    starts = block_starts_for(jnp.asarray(keys), T, interpret=True)
    want = np.asarray(segment_sum_sorted_blocks(
        jnp.asarray(keys_s), jnp.asarray(vals_s), starts, T, interpret=True))
    got = batched_segment_sum(torch.from_numpy(keys), torch.from_numpy(vals), T).numpy()
    mass = _add_at(keys, np.abs(_bf16(vals)), T)
    count = _add_at(keys, np.ones((L, M, 1), np.float32), T)
    assert np.all(np.abs(got - want) <= 2.0 * count * 2.0 ** -24 * mass)
    empty = mass == 0
    assert np.all(got[empty] == 0.0) and np.all(want[empty] == 0.0)


def test_matches_jax_batched_segment_sum():
    """The contract of ``batched_segment_sum`` (the JAX package's CPU path,
    cumsum differences over sorted bf16 payloads) on unsorted keys with
    per-level live sizes: the cumsum differences carry float32 errors of
    the running total, so the bound is 2^-20 of each level's total mass."""
    L, M, T, F = 4, 3000, 1024, 2
    rng = np.random.default_rng(2)
    sizes = [64, 512, 1024, 1024]
    keys = np.stack([rng.integers(0, s, M) for s in sizes]).astype(np.int32)
    vals = rng.normal(size=(L, M, F)).astype(np.float32)
    want = np.asarray(jax_batched_segment_sum(
        jnp.asarray(keys), jnp.asarray(vals), T, level_sizes=sizes))
    got = batched_segment_sum(torch.from_numpy(keys), torch.from_numpy(vals), T,
                              level_sizes=sizes).numpy()
    total = np.abs(_bf16(vals)).sum(axis=(1, 2))[:, None, None]
    assert np.all(np.abs(got - want) <= 2.0 ** -20 * total)
    for l, s in enumerate(sizes):
        assert np.all(got[l, s:] == 0.0)
    with pytest.raises(ValueError):
        batched_segment_sum(torch.from_numpy(keys), torch.from_numpy(vals), T,
                            level_sizes=sizes[:2])


@pytest.mark.parametrize("kind", KINDS)
def test_count_matches_batched_onehot_kernel(kind):
    """B3 in interpret mode, exact."""
    L, M, T = 3, 4000, 4 * RB
    keys, _ = _keys_vals(kind, L, M, T, 1, 3)
    want = np.asarray(segment_count_onehot_batched(jnp.asarray(keys), T, interpret=True))
    got = segment_count(torch.from_numpy(keys), T).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", KINDS)
def test_onehot_entry_points_match_kernel(kind):
    """B4 in interpret mode: ``segment_sum_onehot`` (bf16 addends of its
    one-hot matmul, float32 sum; bound as for B2) and
    ``segment_count_onehot`` (exact)."""
    M, T, F = 3000, 2 * RB, 2
    keys, vals = _keys_vals(kind, 1, M, T, F, 4)
    want = np.asarray(jax_segment_sum_onehot(
        jnp.asarray(keys[0]), jnp.asarray(vals[0]), T, sc=256, interpret=True))
    got = segment_sum_onehot(torch.from_numpy(keys[0]), torch.from_numpy(vals[0]), T).numpy()
    mass = _add_at(keys, np.abs(_bf16(vals)), T)[0]
    count = _add_at(keys, np.ones((1, M, 1), np.float32), T)[0]
    assert np.all(np.abs(got - want) <= 2.0 * count * 2.0 ** -24 * mass)
    want_c = np.asarray(jax_segment_count_onehot(jnp.asarray(keys[0]), T, sc=256,
                                                 interpret=True))
    np.testing.assert_array_equal(
        segment_count_onehot(torch.from_numpy(keys[0]), T).numpy(), want_c)

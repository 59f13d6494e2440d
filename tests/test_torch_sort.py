"""The port's bitonic sort (``ngp_tpu_torch/ops/sort.py``, the plain twin of
``csrc/bitonic_sort.cu``, run on the CPU) against the JAX package's Pallas
kernel ``bitonic_sort_pos`` (B5) in interpret mode, on the same numpy keys.

The port runs the TPU kernel's network stage for stage, so the sorted keys
and the permutation must be equal exactly, ties included: dense ties (keys
in [0, n/2)) with an ``INT32_MAX`` tail, and rows already sorted or
reversed.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ngp_tpu.ops.pallas.sort import bitonic_sort_pos as jax_bitonic_sort_pos
from ngp_tpu_torch.ops.sort import (
    BITONIC_SORT,
    INT32_MAX,
    bitonic_sort_pos,
    bitonic_sort_pos_reference,
)


def _tied_keys(b, n, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n // 2, (b, n)).astype(np.int32)
    keys[:, -3:] = INT32_MAX  # padding sorts to the tail
    return keys


def _check_against_jax(keys):
    want_k, want_p = (np.asarray(a) for a in
                      jax_bitonic_sort_pos(jnp.asarray(keys), interpret=True))
    before = dict(BITONIC_SORT.launches)
    got_k, got_p = bitonic_sort_pos(torch.from_numpy(keys))
    assert BITONIC_SORT.launches == before  # CPU tensors run the twin
    assert got_k.dtype == got_p.dtype == torch.int32
    np.testing.assert_array_equal(got_k.numpy(), want_k)
    np.testing.assert_array_equal(got_p.numpy(), want_p)
    # the keys are sorted, the perm is a permutation that gathers them
    np.testing.assert_array_equal(
        got_k.numpy(), torch.sort(torch.from_numpy(keys), dim=1).values.numpy())
    for row, p in zip(keys, got_p.numpy()):
        np.testing.assert_array_equal(np.sort(p), np.arange(keys.shape[1]))
        np.testing.assert_array_equal(row[p], np.sort(row))


@pytest.mark.parametrize("b,n", [(1, 256), (2, 2048), (3, 1024), (2, 128)])
def test_twin_matches_pallas_kernel_with_ties(b, n):
    _check_against_jax(_tied_keys(b, n, b * 1000 + n))


def test_twin_matches_pallas_kernel_on_sorted_and_reversed_rows():
    n = 512
    up = np.arange(n, dtype=np.int32)
    rng = np.random.default_rng(7)
    steps = np.sort(rng.integers(0, 16, n)).astype(np.int32)  # sorted, tied
    _check_against_jax(np.stack([up, up[::-1], steps, steps[::-1]]))


def test_input_is_not_modified():
    keys = torch.from_numpy(_tied_keys(2, 256, 3))
    copy = keys.clone()
    bitonic_sort_pos(keys)
    assert torch.equal(keys, copy)


@pytest.mark.parametrize("shape", [(1, 100), (2, 384), (1, 64), (3,)])
def test_refuses_what_the_network_does_not_take(shape):
    """n must be a power of two and at least 128 (the JAX kernel's asserts);
    keys must be (B, n)."""
    with pytest.raises(ValueError):
        bitonic_sort_pos(torch.zeros(shape, dtype=torch.int32))


def test_refuses_other_key_types():
    with pytest.raises(ValueError):
        bitonic_sort_pos(torch.zeros((1, 128), dtype=torch.int64))

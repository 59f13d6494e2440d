"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs a CUDA device and skips without one. The file imports
torch, numpy and ``ngp_tpu_torch`` only, so it runs on a host without JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest`` because ``tests/conftest.py`` configures JAX.)
"""

import numpy as np
import pytest
import torch

from ngp_tpu_torch.models.encodings import GridEncoding
from ngp_tpu_torch.ops.hashgrid import (
    HASHGRID_ENCODE,
    hashgrid_backward_addends,
    hashgrid_backward_addends_cuda,
    hashgrid_backward_addends_reference,
    hashgrid_encode,
    hashgrid_encode_cuda,
    hashgrid_encode_reference,
)
from ngp_tpu_torch.ops.segsum import (
    SEGMENT_SUM,
    batched_segment_sum,
    segment_count,
    segment_count_onehot,
    segment_count_reference,
    segment_sum_cuda,
    segment_sum_onehot,
    segment_sum_reference,
)

# The kernel rounds every product and sum as the twin does, in the same
# order; only a compiler's different rounding of floorf or the bf16 widening
# could separate them, so the bound is float32-tight.
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(d, f, variant, seed, n=1 << 14):
    enc = GridEncoding(n_input_dims=d, n_levels=4, n_features_per_level=f,
                       log2_hashmap_size=12 if d == 3 else 10,
                       base_resolution=8, per_level_scale=2.0,
                       hash_variant=variant, device="cuda")
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(
        rng.uniform(-1, 1, tuple(enc.table.shape)).astype(np.float32)).cuda()
    x = rng.uniform(-0.2, 1.2, (n, d)).astype(np.float32)
    geo = (enc.level_scale, enc.level_res, enc.level_size, enc.level_hashed,
           variant)
    return torch.from_numpy(x).cuda(), table, geo


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("f", [1, 2, 4, 8])
@pytest.mark.parametrize("variant", ["tcnn", "additive"])
def test_kernel_matches_twin(cuda, variant, f, d):
    x, table, geo = _case(d, f, variant, 10 * f + d)
    for tab in (table, table.to(torch.bfloat16)):
        for max_level in (None, 1):
            before = HASHGRID_ENCODE.launches["hashgrid_encode"]
            got = hashgrid_encode(x, tab, *geo, max_level)
            assert HASHGRID_ENCODE.launches["hashgrid_encode"] == before + 1
            want = hashgrid_encode_reference(x, tab, *geo, max_level)
            torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x, table, geo = _case(3, 2, "tcnn", 0, n=64)
    bad = [
        (x.double(), table, geo),
        (x[:, :1].contiguous(), table, geo),
        (x, table.half(), geo),
        (x, table[:, :, :1].repeat(1, 1, 3), geo),
        (x.t().contiguous().t(), table, geo),
        (x, table, (geo[0].cpu(),) + geo[1:]),
        (x, table, geo[:4] + ("xor",)),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            hashgrid_encode_cuda(args[0], args[1], *args[2])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("f", [1, 2, 4, 8])
@pytest.mark.parametrize("variant", ["tcnn", "additive"])
def test_backward_addends_match_twin(cuda, variant, f, d):
    x, table, geo = _case(d, f, variant, 100 + 10 * f + d)
    L = table.shape[0]
    g = torch.randn((x.shape[0], L * f), generator=torch.Generator().manual_seed(d)).cuda()
    for max_level in (None, 1):
        before = HASHGRID_ENCODE.launches["hashgrid_backward_addends"]
        keys, vals = hashgrid_backward_addends(x, g, *geo, max_level)
        assert HASHGRID_ENCODE.launches["hashgrid_backward_addends"] == before + 1
        wkeys, wvals = hashgrid_backward_addends_reference(x, g, *geo, max_level)
        assert torch.equal(keys, wkeys)
        torch.testing.assert_close(vals, wvals, rtol=RTOL, atol=ATOL)


def _keys_and_vals(kind, L, M, T, F, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, T, (L, M))
    if kind == "one_hot_row":
        keys[:, : M // 2] = 7
    elif kind == "few_rows":  # most rows empty, must stay exactly zero
        keys = rng.integers(0, 16, (L, M)) * (T // 16)
    vals = rng.normal(size=(L, M, F)).astype(np.float32)
    vals[:, ::5] = 0.0  # zero addends skip the atomic
    return (torch.from_numpy(keys.astype(np.int32)).cuda(),
            torch.from_numpy(vals).cuda())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["uniform", "one_hot_row", "few_rows"])
@pytest.mark.parametrize("f", [1, 2, 4, 8])
@pytest.mark.parametrize("payload", ["bfloat16", "float32"])
def test_segment_sum_matches_twin(cuda, payload, f, kind):
    keys, vals = _keys_and_vals(kind, 3, 1 << 16, 1 << 12, f, f)
    before = SEGMENT_SUM.launches["segment_sum"]
    got = batched_segment_sum(keys, vals, 1 << 12, payload)
    assert SEGMENT_SUM.launches["segment_sum"] == before + 1
    want = segment_sum_reference(keys, vals, 1 << 12, payload)
    # float32 atomics add in another order than index_add_. A float32 sum
    # of n addends is within (n - 1)·2^-24·Σ|addend| of the exact one, so
    # the two orders differ by at most twice that (the addends themselves
    # are identical: both round to bf16 to nearest even).
    mass = segment_sum_reference(keys, vals.abs(), 1 << 12, payload)
    n = segment_count_reference(keys, 1 << 12)[..., None].float()
    assert ((got - want).abs() <= 2.0 * n * 2.0 ** -24 * mass).all()
    assert torch.equal(got[mass == 0], torch.zeros_like(got[mass == 0]))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["uniform", "one_hot_row", "few_rows"])
def test_segment_count_matches_twin(cuda, kind):
    keys, _ = _keys_and_vals(kind, 3, 1 << 16, 1 << 12, 1, 5)
    before = SEGMENT_SUM.launches["segment_count"]
    got = segment_count(keys, 1 << 12)
    assert SEGMENT_SUM.launches["segment_count"] == before + 1
    assert torch.equal(got, segment_count_reference(keys, 1 << 12))


@pytest.mark.cuda
def test_onehot_entry_points_run_the_kernels(cuda):
    keys, vals = _keys_and_vals("uniform", 1, 5000, 640, 4, 9)
    before = dict(SEGMENT_SUM.launches)
    got = segment_sum_onehot(keys[0], vals[0], 640)
    want = segment_sum_reference(keys, vals, 640)[0]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(segment_count_onehot(keys[0], 640),
                       segment_count_reference(keys, 640)[0])
    # each entry point counts its own launches, not the batched ones'
    assert {k: n - before[k] for k, n in SEGMENT_SUM.launches.items()} == {
        "segment_sum": 0, "segment_count": 0,
        "segment_sum_onehot": 1, "segment_count_onehot": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["tcnn", "additive"])
def test_grid_gradient_matches_cpu(cuda, variant):
    """d(table) of GridEncoding through the two kernels on the card against
    the same module on the CPU (the twins): bf16 addends are identical, only
    the float32 order of the sums differs."""
    encs = [GridEncoding(n_levels=4, log2_hashmap_size=12, base_resolution=8,
                         hash_variant=variant, device=dev) for dev in ("cpu", "cuda")]
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(0, 1, (1 << 14, 3)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(1 << 14, 8)).astype(np.float32))
    grads = []
    for enc in encs:
        enc.reset_parameters(torch.Generator().manual_seed(0))
        dev = enc.table.device
        (enc(x.to(dev)) * g.to(dev)).sum().backward()
        grads.append(enc.table.grad.cpu())
    mass = grads[0].abs().amax()
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-5, atol=1e-5 * float(mass))


@pytest.mark.cuda
def test_new_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x, table, geo = _case(3, 2, "tcnn", 0, n=64)
    g = torch.zeros((64, 8), device="cuda")
    for args in [(x, g.double()), (x, g[:, :7].contiguous()), (x, g.t().contiguous().t()),
                 (x.cpu(), g), (x, g.cpu())]:
        with pytest.raises(ValueError):
            hashgrid_backward_addends_cuda(*args, *geo)
    keys, vals = _keys_and_vals("uniform", 2, 64, 128, 2, 0)
    for args in [(keys.long(), vals), (keys[0], vals), (keys, vals.double()),
                 (keys, vals[:, :, :1].repeat(1, 1, 3)), (keys.cpu(), vals),
                 (keys, vals.cpu())]:
        with pytest.raises(ValueError):
            segment_sum_cuda(*args, 128)
    with pytest.raises(ValueError):
        segment_sum_cuda(keys, vals, 128, "float16")

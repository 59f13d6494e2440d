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
    hashgrid_encode,
    hashgrid_encode_cuda,
    hashgrid_encode_reference,
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
            before = HASHGRID_ENCODE.launches
            got = hashgrid_encode(x, tab, *geo, max_level)
            assert HASHGRID_ENCODE.launches == before + 1
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

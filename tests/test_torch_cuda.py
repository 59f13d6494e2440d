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
from ngp_tpu_torch.ops.cuda_build import launch_counts
from ngp_tpu_torch.ops.hashgrid import (
    HASHGRID_ENCODE,
    hashgrid_backward,
    hashgrid_backward_addends_reference,
    hashgrid_backward_cuda,
    hashgrid_backward_reference,
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
from ngp_tpu_torch.ops.sort import (
    BITONIC_SORT,
    INT32_MAX,
    bitonic_sort_launches,
    bitonic_sort_pos,
    bitonic_sort_pos_cuda,
    bitonic_sort_pos_reference,
)

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(d, f, variant, seed, n=1 << 14, n_levels=4):
    enc = GridEncoding(n_input_dims=d, n_levels=n_levels, n_features_per_level=f,
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


HASH_P1, HASH_P2 = 2654435761, 805459861


def _edge_case(d, f, variant, seed, n_random=4096):
    """Geometry and positions on every edge of the corner math, for each
    pair of corners c, c + 1 (x and x + 1): levels 0 and 1 dense (res 5
    and 9), levels 2 and 3 hashed (64 and 256 rows), T odd, so that every
    level but the first starts at an odd row and a row's vector load sits
    off a 16-byte boundary. Targeted cells: x = -1, 0, res - 2, res - 1,
    res on the dense levels (negative coordinates and the clamped top
    plane); on the hashed levels cells whose corner 0, or whose corner 1,
    hashes to size - 1 under either hash (an additive pair then wraps to
    row 0), and odd and even x (under XOR rows h and h ^ 1, or unrelated).
    Each targeted coordinate's fraction is 0.3, the other coordinates'
    cells drawn from [-1, res]."""
    rng = np.random.default_rng(seed)
    scale = np.asarray([4.0, 8.0, 15.0, 31.0], np.float32)
    res = np.asarray([5, 9, 16, 32], np.int32)
    size = np.asarray([5 ** d, 9 ** d, 64, 256], np.int32)
    hashed = np.asarray([0, 0, 1, 1], np.int32)
    T = (int(size.max()) + 2) | 1
    xs = [rng.uniform(-0.2, 1.2, (n_random, d))]
    for l in range(4):
        r = int(res[l])
        cells = rng.integers(-1, r + 1, (64, d))
        if not hashed[l]:
            cells[:, 0] = np.resize([-1, 0, r - 2, r - 1, r], 64)
        else:
            mask = int(size[l]) - 1
            rest_add = cells[:, 1] * HASH_P1 + (cells[:, 2] * HASH_P2 if d == 3 else 0)
            rest_xor = (cells[:, 1] * HASH_P1) ^ (cells[:, 2] * HASH_P2 if d == 3 else 0)
            wrap_add = (mask - rest_add) & mask  # x whose additive hash is mask
            wrap_xor = (mask ^ rest_xor) & mask
            x0 = np.select([np.arange(64) % 4 == k for k in range(4)],
                           [wrap_add, wrap_add - 1, wrap_xor, wrap_xor - 1])
            reach = (x0 >= -1) & (x0 <= r)
            cells[reach, 0] = x0[reach]
            assert reach.sum() >= 4
            cells[-16:-8, 0] |= 1
            cells[-8:, 0] &= ~1
        xs.append((cells + 0.3 - 0.5) / float(scale[l]))
    x = np.concatenate(xs).astype(np.float32)
    table = rng.uniform(-1, 1, (4, T, f)).astype(np.float32)
    geo = tuple(torch.from_numpy(a).cuda() for a in (scale, res, size, hashed))
    return (torch.from_numpy(x).cuda(), torch.from_numpy(table).cuda(),
            geo + (variant,))


@pytest.mark.cuda
@pytest.mark.parametrize("positions", ["uniform", "edges", "nine_levels"])
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("f", [1, 2, 4, 8])
@pytest.mark.parametrize("variant", ["tcnn", "additive"])
def test_kernel_matches_twin(cuda, variant, f, d, positions):
    """The forward kernel gives the twin's bits: float32 and bf16 tables,
    with and without max_level, on uniform positions, on every edge of the
    corner math, and with nine levels (a warp's run of eight, then one:
    rows of 9·F floats, stored 16 bytes at a time only for F = 4, 8)."""
    if positions == "edges":
        x, table, geo = _edge_case(d, f, variant, 10 * f + d)
    else:
        x, table, geo = _case(d, f, variant, 10 * f + d,
                              n_levels=9 if positions == "nine_levels" else 4)
    for tab in (table, table.to(torch.bfloat16)):
        for max_level in (None, 1):
            before = HASHGRID_ENCODE.launches["hashgrid_encode"]
            got = hashgrid_encode(x, tab, *geo, max_level)
            assert HASHGRID_ENCODE.launches["hashgrid_encode"] == before + 1
            want = hashgrid_encode_reference(x, tab, *geo, max_level)
            assert torch.equal(got, want), float((got - want).abs().max())


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
    many = [t.repeat(9) for t in geo[:4]]  # 36 levels, above the kernel's 32
    with pytest.raises(ValueError):
        hashgrid_encode_cuda(x, table.repeat(9, 1, 1), *many, geo[4])


def _crowded_case(d, f, variant, seed, n=1 << 14):
    """Many samples in few coarse cells: positions within 0.02 of two
    points, so that the coarse levels' warps add to the same few rows."""
    x, table, geo = _case(d, f, variant, seed, n=n)
    rng = np.random.default_rng(seed)
    centre = np.where(rng.random((n, 1)) < 0.5, 0.31, 0.62)
    x = centre + rng.uniform(-0.02, 0.02, (n, d))
    return torch.from_numpy(x.astype(np.float32)).cuda(), table, geo


def _assert_within_order_bound(got, want, keys, vals, n_rows):
    """The kernel adds the twin's bf16-rounded addends in another float32
    order: a float32 sum of n addends in any order is within
    (n − 1)·2^-24·Σ|addend| of the exact one, so two orders differ by at
    most twice that per row. Rows that no nonzero addend touches are +0.0."""
    mass = segment_sum_reference(keys, vals.abs(), n_rows)
    n = segment_count_reference(keys, n_rows)[..., None].float()
    assert ((got - want).abs() <= 2.0 * n * 2.0 ** -24 * mass).all(), \
        float((got - want).abs().max())
    untouched = mass == 0
    assert not got[untouched].any() and not torch.signbit(got[untouched]).any()


@pytest.mark.cuda
@pytest.mark.parametrize("positions", ["uniform", "edges", "nine_levels", "crowded"])
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("f", [1, 2, 4, 8])
@pytest.mark.parametrize("variant", ["tcnn", "additive"])
def test_backward_matches_twin(cuda, variant, f, d, positions):
    """The fused backward kernel against its twin within the float32 order
    bound: with and without max_level, into tables of the levels' rows and
    of an odd number of rows (every odd level then starts off the vector
    atomics' alignment and pairs nothing)."""
    seed = 100 + 10 * f + d
    if positions == "edges":
        x, table, geo = _edge_case(d, f, variant, seed)
    elif positions == "crowded":
        x, table, geo = _crowded_case(d, f, variant, seed)
    else:
        x, table, geo = _case(d, f, variant, seed,
                              n_levels=9 if positions == "nine_levels" else 4)
    L, T = table.shape[:2]
    g = torch.randn((x.shape[0], L * f), generator=torch.Generator().manual_seed(d)).cuda()
    for n_rows in sorted({T, T | 1}):
        for max_level in (None, 1):
            before = HASHGRID_ENCODE.launches["hashgrid_backward"]
            got = hashgrid_backward(x, g, *geo, max_level, n_rows)
            torch.cuda.synchronize()
            assert HASHGRID_ENCODE.launches["hashgrid_backward"] == before + 1
            assert got.shape == (L, n_rows, f)
            keys, vals = hashgrid_backward_addends_reference(x, g, *geo, max_level)
            want = hashgrid_backward_reference(x, g, *geo, max_level, n_rows)
            _assert_within_order_bound(got, want, keys, vals, n_rows)
            if max_level is not None:
                assert not got[max_level + 1:].any()


def _keys_and_vals(kind, L, M, T, F, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, T, (L, M))
    pairs = 2 * (M // 2)
    if kind == "one_hot_row":
        keys[:, : M // 2] = 7
    elif kind == "few_rows":  # most rows empty, must stay exactly zero
        keys = rng.integers(0, 16, (L, M)) * (T // 16)
    elif kind == "pairs":  # keys 2i, 2i + 1 on rows 2r, 2r + 1, either order
        even = rng.integers(0, T // 2, (L, M // 2)) * 2
        swap = rng.random((L, M // 2)) < 0.5
        keys[:, 0:pairs:2], keys[:, 1:pairs:2] = even + swap, even + 1 - swap
    elif kind == "equal":  # keys 2i and 2i + 1 equal
        keys[:, 1:pairs:2] = keys[:, 0:pairs:2]
    elif kind == "crowded":  # four rows: equal keys and pairs throughout
        keys = rng.integers(0, 4, (L, M))
    elif kind == "outside":  # a third below 0, a third at or above T
        keys = rng.integers(-T, 2 * T, (L, M))
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
@pytest.mark.parametrize("kind", ["uniform", "one_hot_row", "few_rows", "pairs",
                                  "equal", "crowded", "outside", "odd_T"])
def test_segment_count_matches_twin(cuda, kind):
    """B3 and B4's count exact against the twin. M is odd, so levels after
    the first start off a 16-byte boundary and end with a partial load's
    keys; with T odd (pairs) every odd level's counters start off the
    64-bit atomic's alignment."""
    T = (1 << 12) + 1 if kind == "odd_T" else 1 << 12
    keys, _ = _keys_and_vals("pairs" if kind == "odd_T" else kind, 3,
                             (1 << 16) + 3, T, 1, 5)
    before = dict(SEGMENT_SUM.launches)
    got = segment_count(keys, T)
    assert torch.equal(got, segment_count_reference(keys, T))
    for l in range(3):
        assert torch.equal(segment_count_onehot(keys[l], T),
                           segment_count_reference(keys[l:l + 1], T)[0])
    assert {k: n - before[k] for k, n in SEGMENT_SUM.launches.items()} == {
        "segment_sum": 0, "segment_count": 1,
        "segment_sum_onehot": 0, "segment_count_onehot": 3}


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
    """d(table) of GridEncoding through the fused backward kernel on the
    card against the same module on the CPU (the twins): bf16 addends are
    identical, only the float32 order of the sums differs. The backward on
    the card launches ``hashgrid_backward`` once and no other kernel."""
    encs = [GridEncoding(n_levels=4, log2_hashmap_size=12, base_resolution=8,
                         hash_variant=variant, device=dev) for dev in ("cpu", "cuda")]
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(0, 1, (1 << 14, 3)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(1 << 14, 8)).astype(np.float32))
    grads = []
    for enc in encs:
        enc.reset_parameters(torch.Generator().manual_seed(0))
        dev = enc.table.device
        y = (enc(x.to(dev)) * g.to(dev)).sum()
        before = launch_counts()
        y.backward()
        launched = {k: n - before[k] for k, n in launch_counts().items() if n != before[k]}
        assert launched == ({"hashgrid_backward": 1} if dev.type == "cuda" else {})
        grads.append(enc.table.grad.cpu())
    mass = grads[0].abs().amax()
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-5, atol=1e-5 * float(mass))


@pytest.mark.cuda
def test_new_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x, table, geo = _case(3, 2, "tcnn", 0, n=64)
    T = table.shape[1]
    g = torch.zeros((64, 8), device="cuda")
    for args in [(x, g.double()), (x, g[:, :7].contiguous()), (x, g.t().contiguous().t()),
                 (x.cpu(), g), (x, g.cpu()), (x.double(), g), (x[:, :1].contiguous(), g),
                 (x[:32], g), (x, g.reshape(64, 8, 1).repeat(1, 1, 3).reshape(64, 24))]:
        with pytest.raises(ValueError):
            hashgrid_backward_cuda(*args, *geo, None, T)
    with pytest.raises(ValueError):  # fewer rows than a level has
        hashgrid_backward_cuda(x, g, *geo, None, T - 1)
    with pytest.raises(ValueError):
        hashgrid_backward_cuda(x, g, *geo[:4], "xor", None, T)
    many = [t.repeat(9) for t in geo[:4]]  # 36 levels, above the kernel's 32
    with pytest.raises(ValueError):
        hashgrid_backward_cuda(x, g.repeat(1, 9), *many, geo[4], None, T)
    keys, vals = _keys_and_vals("uniform", 2, 64, 128, 2, 0)
    for args in [(keys.long(), vals), (keys[0], vals), (keys, vals.double()),
                 (keys, vals[:, :, :1].repeat(1, 1, 3)), (keys.cpu(), vals),
                 (keys, vals.cpu())]:
        with pytest.raises(ValueError):
            segment_sum_cuda(*args, 128)
    with pytest.raises(ValueError):
        segment_sum_cuda(keys, vals, 128, "float16")


def _exact_vals(rng, shape):
    """Multiples of 1/4 in [-2, 2], one in five zero (some -0.0): bf16
    holds them exactly and every float32 sum of them here is exact, so any
    order of summation gives the same bits."""
    vals = rng.integers(-8, 9, shape).astype(np.float32) / 4
    vals[:, ::5] = 0.0
    vals[:, ::10] = -0.0
    return vals


def _pair_case(F, seed, M=1 << 16, T=1 << 14):
    """Keys whose neighbours (elements 2i, 2i + 1) are rows 2r and 2r + 1 in
    either order, the same row, rows 2r + 1 and 2r + 2 (not one vector),
    unrelated, or one of them out of [0, T): every case the kernel's pairing
    tells apart. Level 0 and 1 mix them; level 2 draws from only 64 rows."""
    rng = np.random.default_rng(seed)
    keys = np.empty((3, M), np.int64)
    for l in range(2):
        base = rng.integers(0, T - 2, M // 2)
        kind = rng.integers(0, 6, M // 2)
        even = np.where(kind == 3, base | 1, base & ~1)
        odd = np.select(
            [kind == 0, kind == 1, kind == 2, kind == 3, kind == 4],
            [even + 1, even, even, even + 1, rng.integers(0, T, M // 2)], T)
        keys[l, 0::2], keys[l, 1::2] = even, odd
        swap = kind == 1  # rows 2r + 1, 2r
        keys[l, 0::2][swap], keys[l, 1::2][swap] = even[swap] + 1, even[swap]
    keys[2] = rng.integers(0, 64, M)
    vals = _exact_vals(rng, (3, M, F))
    return (torch.from_numpy(keys.astype(np.int32)).cuda(),
            torch.from_numpy(vals).cuda(), T)


@pytest.mark.cuda
@pytest.mark.parametrize("f,t", [(1, 1 << 14), (2, 1 << 14), (4, 1 << 14),
                                 (8, 1 << 14), (1, 4097), (2, 4097)])
def test_segment_sum_pairs_exact(cuda, f, t):
    """With exact sums the kernel must give the twin's bits whichever way
    it pairs neighbouring addends, with and without ``level_sizes`` (half
    of each level's keys at or above it); rows that no nonzero addend
    touches are +0.0; a key at or beyond T is skipped. With T odd, level 1's
    rows start off the vector atomics' alignment."""
    keys, vals, T = _pair_case(f, 20 + f, T=t)
    want = segment_sum_reference(keys, vals, T)
    untouched = segment_sum_reference(keys, vals.abs(), T) == 0
    assert untouched.any()
    for payload, sizes in [("bfloat16", None), ("bfloat16", [T // 2] * 3),
                           ("float32", None)]:
        got = batched_segment_sum(keys, vals, T, payload, level_sizes=sizes)
        assert torch.equal(got, want)
        assert not torch.signbit(got[untouched]).any()


def _sort_launches(n, tile_log=14, group=5):
    """Launches of one sort call as csrc/bitonic_sort.cu plans them: one
    tile launch for the stages k <= the tile, then for each larger k its
    strides >= the tile in passes of at most ``group``, and a tile launch."""
    log_n = n.bit_length() - 1
    t = min(log_n, tile_log)
    return 1 + sum(-(-(k - t) // group) + 1 for k in range(t + 1, log_n + 1))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", ["random", "equal", "descending", "sorted"])
@pytest.mark.parametrize("b,n", [(1, 128), (3, 1 << 12), (2, 1 << 13), (1, 1 << 13),
                                 (3, 1 << 14), (2, 1 << 15), (1, 1 << 17),
                                 (4, 1 << 20)])
def test_bitonic_sort_matches_twin(cuda, b, n, rows):
    """The kernel runs the twin's network: keys and perm equal exactly,
    dense ties and an INT32_MAX tail included. The shapes cross the tile
    (2^14 elements) and the fused passes over device memory (up to 5
    strides each; (2, 2^15) is the first shape with one, (4, 2^20) has
    stages with two); all-equal rows never swap, descending and sorted
    rows take every exchange or none."""
    rng = np.random.default_rng(n + b)
    keys = rng.integers(0, min(n // 2, 1 << 18), (b, n)).astype(np.int32)
    if rows == "equal":
        keys[:] = 7
    elif rows == "descending":
        keys = -np.sort(-keys, axis=1)
    elif rows == "sorted":
        keys = np.sort(keys, axis=1)
    keys[:, -3:] = INT32_MAX
    keys = torch.from_numpy(keys).cuda()
    copy = keys.clone()
    before = BITONIC_SORT.launches["bitonic_sort_pos"]
    got_k, got_p = bitonic_sort_pos(keys)
    assert BITONIC_SORT.launches["bitonic_sort_pos"] == before + 1
    want_k, want_p = bitonic_sort_pos_reference(keys)
    assert torch.equal(got_k, want_k) and torch.equal(got_p, want_p)
    assert torch.equal(got_k, torch.sort(keys, dim=1).values)
    assert torch.equal(keys.gather(1, got_p.long()), got_k)
    assert torch.equal(keys, copy)
    assert bitonic_sort_launches(n) == _sort_launches(n)


@pytest.mark.cuda
def test_sort_and_segment_sum_wrappers_refuse_bad_inputs(cuda):
    keys = torch.zeros((2, 256), dtype=torch.int32, device="cuda")
    for bad in (keys.cpu(), keys.long(), keys[:, :200].contiguous(),
                keys[:, :64].contiguous(), keys[0], keys.t().contiguous().t()):
        with pytest.raises(ValueError):
            bitonic_sort_pos_cuda(bad)
    k, v = _keys_and_vals("uniform", 2, 64, 128, 2, 0)
    with pytest.raises(ValueError):
        batched_segment_sum(k, v, 128, level_sizes=[64, 64, 64])


@pytest.mark.cuda
def test_capture_load_train_eval_on_card(cuda, tmp_path):
    """A tiny PNG capture (64², OpenCV lens, aabb_scale 2) through
    ``load_nerf``, 50 training steps and the held-out eval on the card: the
    path runs the hash-grid kernels, forward and backward, and scores
    every test view."""
    from ngp_tpu_torch.config import default_config
    from ngp_tpu_torch.data.nerf_loader import load_nerf
    from ngp_tpu_torch.data.synthetic import write_sphere_capture
    from ngp_tpu_torch.engines.nerf import NerfEngine
    from ngp_tpu_torch.ops.cuda_build import reset_launches

    train_json, test_json = write_sphere_capture(str(tmp_path), res=64, device="cuda")
    train, test = load_nerf(train_json), load_nerf(test_json)
    eng = NerfEngine(default_config("tpu"), train, batch_size=1 << 16, grid_size=32,
                     device="cuda")
    state, grid = eng.init_state(), eng.init_grid()
    reset_launches()
    state, grid, metrics = eng.train(state, grid, 50)
    scores = eng.eval_test_transforms(state, grid, test)
    launches = launch_counts()
    assert np.isfinite(float(metrics["loss"]))
    assert scores["n_views"] == 4
    assert all(np.isfinite(v["psnr"]) and np.isfinite(v["ssim"]) for v in scores["per_view"])
    assert launches["hashgrid_encode"] > 0 and launches["hashgrid_backward"] > 0

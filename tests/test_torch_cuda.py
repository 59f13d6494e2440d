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
    hashgrid_input_grad,
    hashgrid_input_grad_cuda,
    hashgrid_input_grad_mass,
    hashgrid_input_grad_reference,
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


def _assert_within_order_bound(got, want, keys, vals, n_rows, payload="bfloat16"):
    """The kernel adds the twin's addends (rounded to ``payload``) in another
    float32 order: a float32 sum of n addends in any order is within
    (n − 1)·2^-24·Σ|addend| of the exact one, so two orders differ by at
    most twice that per row. Rows that no nonzero addend touches are +0.0."""
    mass = segment_sum_reference(keys, vals.abs(), n_rows, payload)
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


@pytest.mark.cuda
@pytest.mark.parametrize("positions", ["uniform", "edges", "crowded"])
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("f", [1, 2, 4, 8])
@pytest.mark.parametrize("variant", ["tcnn", "additive"])
def test_input_grad_matches_twin(cuda, variant, f, d, positions):
    """The input-gradient kernel against its twin on the card, with and
    without max_level: the twin's bits (the kernel keeps its order), and so
    within the float32 order bound 2·(n − 1)·2^-24·Σ|term| per component;
    and the unrounded backward (payload float32) within the order bound of
    its sum."""
    seed = 200 + 10 * f + d
    if positions == "edges":
        x, table, geo = _edge_case(d, f, variant, seed)
    elif positions == "crowded":
        x, table, geo = _crowded_case(d, f, variant, seed)
    else:
        x, table, geo = _case(d, f, variant, seed)
    L, T = table.shape[:2]
    g = torch.randn((x.shape[0], L * f), generator=torch.Generator().manual_seed(d)).cuda()
    for max_level in (None, 1):
        before = HASHGRID_ENCODE.launches["hashgrid_input_grad"]
        got = hashgrid_input_grad(x, g, table, *geo, max_level)
        torch.cuda.synchronize()
        assert HASHGRID_ENCODE.launches["hashgrid_input_grad"] == before + 1
        want = hashgrid_input_grad_reference(x, g, table, *geo, max_level)
        mass, n = hashgrid_input_grad_mass(x, g, table, *geo, max_level)
        assert ((got - want).abs().double() <= 2.0 * (n - 1) * 2.0 ** -24 * mass).all(), \
            float((got - want).abs().max())
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        got = hashgrid_backward(x, g, *geo, max_level, T, "float32")
        keys, vals = hashgrid_backward_addends_reference(x, g, *geo, max_level)
        want = hashgrid_backward_reference(x, g, *geo, max_level, T, "float32")
        _assert_within_order_bound(got, want, keys, vals, T, "float32")


def _grid_case(kind, d, f, variant, seed, n=1 << 14, per_level_scale=2.0):
    """A Tiled or Simplex grid's positions, table and geometry on the card:
    L=4, base resolution 8, T=2^10 (3D) or 2^8 (2D), so that a Tiled grid
    wraps levels 1-3 (3D) or 2-3 (2D) and a Hash grid hashes them; with
    per_level_scale 40 the strides r^d wrap modulo 2^32. Positions: uniform
    in [-0.2, 1.2], the first 2,048 with every coordinate equal (tied
    fractions at every level) and the next 2,048 on the corners of the
    unit cube (the dense top plane)."""
    grid_type = "Hash" if kind == "simplex" else "Tiled"
    interpolation = "Linear" if kind == "tiled" else "Simplex"
    enc = GridEncoding(n_input_dims=d, n_levels=4, n_features_per_level=f,
                       log2_hashmap_size=10 if d == 3 else 8, base_resolution=8,
                       per_level_scale=per_level_scale, grid_type=grid_type,
                       interpolation=interpolation, hash_variant=variant, device="cuda")
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.2, 1.2, (n, d)).astype(np.float32)
    x[:2048, 1:] = x[:2048, :1]
    x[2048:4096] = rng.integers(0, 2, (2048, d))
    table = rng.uniform(-1, 1, tuple(enc.table.shape)).astype(np.float32)
    geo = (enc.level_scale, enc.level_res, enc.level_size, enc.level_hashed, variant)
    return (torch.from_numpy(x).cuda(), torch.from_numpy(table).cuda(), geo, interpolation)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["tiled", "simplex", "tiled_simplex", "tiled_wide_strides"])
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("f", [1, 2, 4, 8])
@pytest.mark.parametrize("variant", ["tcnn", "additive"])
def test_tiled_and_simplex_kernels_match_twins(cuda, variant, f, d, kind):
    """The three grid kernels' Tiled and Simplex instantiations against their
    twins, with and without max_level: the forward (float32 and bf16
    tables) and the position gradient bit for bit, the fused backward (bf16
    and float32 addends, into the levels' rows and an odd row count) within
    the float32 order bound; one launch counted a call."""
    wide = kind == "tiled_wide_strides"
    x, table, geo, interp = _grid_case("tiled" if wide else kind, d, f, variant,
                                       300 + 10 * f + d, per_level_scale=40.0 if wide else 2.0)
    L, T = table.shape[:2]
    g = torch.randn((x.shape[0], L * f), generator=torch.Generator().manual_seed(d)).cuda()
    for max_level in (None, 1):
        for tab in (table, table.to(torch.bfloat16)):
            before = HASHGRID_ENCODE.launches["hashgrid_encode"]
            got = hashgrid_encode(x, tab, *geo, max_level, interp)
            assert HASHGRID_ENCODE.launches["hashgrid_encode"] == before + 1
            want = hashgrid_encode_reference(x, tab, *geo, max_level, interp)
            assert torch.equal(got, want), float((got - want).abs().max())
        for payload in ("bfloat16", "float32"):
            keys, vals = hashgrid_backward_addends_reference(x, g, *geo, max_level, interp)
            for n_rows in sorted({T, T | 1}):
                before = HASHGRID_ENCODE.launches["hashgrid_backward"]
                got = hashgrid_backward(x, g, *geo, max_level, n_rows, payload, interp)
                torch.cuda.synchronize()
                assert HASHGRID_ENCODE.launches["hashgrid_backward"] == before + 1
                want = hashgrid_backward_reference(x, g, *geo, max_level, n_rows, payload,
                                                   interp)
                _assert_within_order_bound(got, want, keys, vals, n_rows, payload)
        before = HASHGRID_ENCODE.launches["hashgrid_input_grad"]
        got = hashgrid_input_grad(x, g, table, *geo, max_level, interp)
        torch.cuda.synchronize()
        assert HASHGRID_ENCODE.launches["hashgrid_input_grad"] == before + 1
        want = hashgrid_input_grad_reference(x, g, table, *geo, max_level, interp)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
            float((got - want).abs().max())


def _assert_input_grad_is_the_twins(x, g, table, geo, max_level):
    """One wrapper call, one launch counted, with the twin's bits and so
    within the order bound."""
    before = HASHGRID_ENCODE.launches["hashgrid_input_grad"]
    got = hashgrid_input_grad_cuda(x, g, table, *geo, max_level)
    torch.cuda.synchronize()
    assert HASHGRID_ENCODE.launches["hashgrid_input_grad"] == before + 1
    want = hashgrid_input_grad_reference(x, g, table, *geo, max_level)
    mass, n = hashgrid_input_grad_mass(x, g, table, *geo, max_level)
    assert ((got - want).abs().double() <= 2.0 * (n - 1) * 2.0 ** -24 * mass).all(), \
        float((got - want).abs().max())
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
        float((got - want).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("max_level", [None, 7, 8, 13])
def test_input_grad_on_a_base_json_table(cuda, max_level):
    """A base.json-size table (16 levels of up to 2^19 rows, the sdf
    config's geometry: 57 MB of level rows) at N = 1,007 (not a multiple of
    32): the kernel's two stages of 8 levels (F = 2), max_level at the end
    of the first (7), one level into the second (8) and inside it (13); the
    twin's bits."""
    enc = GridEncoding(n_input_dims=3, n_levels=16, n_features_per_level=2,
                       log2_hashmap_size=19, base_resolution=16, per_level_scale=2.0,
                       hash_variant="tcnn", device="cuda")
    rng = np.random.default_rng(31)
    table = torch.from_numpy(
        rng.uniform(-1, 1, tuple(enc.table.shape)).astype(np.float32)).cuda()
    x = torch.from_numpy(rng.uniform(-0.05, 1.05, (1007, 3)).astype(np.float32)).cuda()
    g = torch.from_numpy(rng.normal(size=(1007, 32)).astype(np.float32)).cuda()
    geo = (enc.level_scale, enc.level_res, enc.level_size, enc.level_hashed, "tcnn")
    _assert_input_grad_is_the_twins(x, g, table, geo, max_level)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("f", [1, 2, 4, 8])
def test_input_grad_in_stages_of_the_cotangent_tile(cuda, f, d):
    """16 levels at F = 1, 2, 4, 8: stages of 16 / F levels, 1 to 8 of them,
    with N = 4,091 (a partial last block) and max_level at the end of the
    first stage, one level past it, and 11; the twin's bits."""
    variant = "tcnn" if d == 3 else "additive"
    x, table, geo = _case(d, f, variant, 60 + 10 * f + d, n=4091, n_levels=16)
    g = torch.randn((4091, 16 * f), generator=torch.Generator().manual_seed(f)).cuda()
    stage = 16 // f
    for max_level in (None, stage - 1, stage, 11):
        _assert_input_grad_is_the_twins(x, g, table, geo, max_level)


@pytest.mark.cuda
@pytest.mark.parametrize("positions", ["uniform", "edges", "crowded"])
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("f", [1, 2, 8])
def test_input_grad_at_a_ragged_n_matches_twin_bit_for_bit(cuda, f, d, positions):
    """Uniform, edge and crowded positions cut to N = 32·k − 5, with and
    without max_level: the twin's bits, in one launch counted."""
    seed = 200 + 10 * f + d
    if positions == "edges":
        x, table, geo = _edge_case(d, f, "tcnn", seed)
    elif positions == "crowded":
        x, table, geo = _crowded_case(d, f, "tcnn", seed)
    else:
        x, table, geo = _case(d, f, "tcnn", seed)
    n = (x.shape[0] // 32) * 32 - 5
    x = x[:n].contiguous()
    L = table.shape[0]
    g = torch.randn((n, L * f), generator=torch.Generator().manual_seed(d)).cuda()
    for max_level in (None, 1):
        _assert_input_grad_is_the_twins(x, g, table, geo, max_level)


@pytest.mark.cuda
def test_input_grad_negative_zero_first_term_gives_positive_zero(cuda):
    """A first level whose term is −0.0 (scale −0.0, zero cotangents) gives
    the twin's +0.0: the kernel's sum starts from +0.0; and with every
    level, the twin's bits."""
    x, table, geo = _case(3, 2, "tcnn", 41, n=1000)
    scale = geo[0].clone()
    scale[0] = -0.0
    geo = (scale, *geo[1:])
    L = table.shape[0]
    g = torch.randn((1000, L * 2), generator=torch.Generator().manual_seed(41)).cuda()
    g[:, :2] = 0.0
    got = hashgrid_input_grad_cuda(x, g, table, *geo, 0)
    assert not got.any() and not torch.signbit(got).any()
    _assert_input_grad_is_the_twins(x, g, table, geo, 0)
    _assert_input_grad_is_the_twins(x, g, table, geo, None)


@pytest.mark.cuda
def test_input_grad_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x, table, geo = _case(3, 2, "tcnn", 0, n=64)
    g = torch.zeros((64, 8), device="cuda")
    bad = [(x, g, table.to(torch.bfloat16)), (x, g[:, :6].contiguous(), table),
           (x, g.double(), table), (x.cpu(), g, table), (x, g, table.cpu()),
           (x, g, table[:, :16].contiguous()), (x, g, table.transpose(0, 1).contiguous())]
    for args in bad:
        with pytest.raises(ValueError):
            hashgrid_input_grad_cuda(*args, *geo)


@pytest.mark.cuda
def test_normals_render_launches_the_input_gradient_and_no_table_gradient(cuda):
    """A normals frame of the "tpu" tier on the card, served by a model
    whose parameters require grad (no EMA yet): the grid's position
    gradient runs through ``hashgrid_input_grad``, no ``hashgrid_backward``
    launches, the frame is finite and the parameters still require grad
    afterwards."""
    from ngp_tpu_torch.config import default_config
    from ngp_tpu_torch.data.synthetic import tiny_sphere_dataset
    from ngp_tpu_torch.engines.nerf import NerfEngine
    from ngp_tpu_torch.ops.cuda_build import reset_launches

    eng = NerfEngine(default_config("tpu"), tiny_sphere_dataset(2, 24), grid_size=32)
    state = eng.init_state()
    with torch.no_grad():
        state.model.pos_encoding.table.mul_(1e3)
    assert state.ema is None and state.model.pos_encoding.table.requires_grad
    r = (torch.arange(32, device="cuda") + 0.5) / 32 - 0.5
    ball = (r[:, None, None] ** 2 + r[None, :, None] ** 2 + r[None, None, :] ** 2
            <= 0.1).float()
    grid = eng.grid_from_density(ball[None])
    reset_launches()
    rgb = eng.render_image(state, grid, 0, mode="normals")
    torch.cuda.synchronize()
    launched = launch_counts()
    assert launched["hashgrid_input_grad"] > 0 and launched["hashgrid_encode"] > 0
    assert launched["hashgrid_backward"] == 0
    assert rgb.shape == (24, 24, 3) and bool(torch.isfinite(rgb).all())
    assert all(p.requires_grad for p in state.model.parameters())


@pytest.mark.cuda
def test_camera_refinement_trains_on_the_card(cuda):
    """Every camera refinement flag on, on the card: training launches the
    position gradient and the table gradient, the loss stays finite and the
    camera group and its EMA move off zero."""
    import math

    from ngp_tpu_torch.config import default_config
    from ngp_tpu_torch.data.synthetic import tiny_sphere_dataset
    from ngp_tpu_torch.engines.nerf import NerfEngine
    from ngp_tpu_torch.ops.cuda_build import reset_launches

    eng = NerfEngine(default_config("tpu"), tiny_sphere_dataset(4, 32), batch_size=1 << 14,
                     grid_size=32, optimize_extrinsics=True, optimize_exposure=True,
                     optimize_focal_length=True, optimize_distortion=True)
    state, grid = eng.init_state(), eng.init_grid()
    reset_launches()
    state, grid, metrics = eng.train(state, grid, 8)
    torch.cuda.synchronize()
    launched = launch_counts()
    assert launched["hashgrid_input_grad"] > 0 and launched["hashgrid_backward"] > 0
    assert math.isfinite(float(metrics["loss"]))
    assert state.opt_state["camera"].count == 8
    for cam in (state.camera, state.camera_ema):
        assert float(cam.pos.detach().abs().max()) > 0
        assert bool(torch.isfinite(cam.distortion).all())


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


@pytest.mark.cuda
def test_upstream_tier_matches_twin(cuda):
    """The tier that ``Testbed`` and the CLI train by default (instant-ngp's
    base.json: L=16, F=2, T=2^19, XOR hash, float32 table reads,
    per_level_scale for aabb_scale 2): the forward bit for bit and the fused
    backward within the float32 order bound, on uniform positions and on
    positions crowded into one small cube (many samples per row)."""
    import math

    enc = GridEncoding(n_input_dims=3, n_levels=16, n_features_per_level=2,
                       log2_hashmap_size=19, base_resolution=16,
                       per_level_scale=math.exp(math.log(2048.0 * 2 / 16) / 15),
                       hash_variant="tcnn", device="cuda")
    assert not enc.bf16_reads
    L, T, F = enc.table.shape
    geo = (enc.level_scale, enc.level_res, enc.level_size, enc.level_hashed, "tcnn")
    rng = np.random.default_rng(19)
    table = torch.from_numpy(rng.uniform(-1, 1, (L, T, F)).astype(np.float32)).cuda()
    for x in (rng.uniform(0, 1, (1 << 16, 3)), 0.5 + 0.01 * rng.uniform(0, 1, (1 << 16, 3))):
        x = torch.from_numpy(x.astype(np.float32)).cuda()
        got = hashgrid_encode(x, table, *geo)
        want = hashgrid_encode_reference(x, table, *geo)
        assert torch.equal(got, want), float((got - want).abs().max())
        g = torch.from_numpy(rng.normal(0, 1e-3, (x.shape[0], L * F)).astype(np.float32)).cuda()
        before = HASHGRID_ENCODE.launches["hashgrid_backward"]
        got = hashgrid_backward(x, g, *geo, None, T)
        torch.cuda.synchronize()
        assert HASHGRID_ENCODE.launches["hashgrid_backward"] == before + 1
        keys, vals = hashgrid_backward_addends_reference(x, g, *geo)
        want = hashgrid_backward_reference(x, g, *geo, None, T)
        _assert_within_order_bound(got, want, keys, vals, T)


@pytest.mark.cuda
def test_image_tier_matches_twin(cuda):
    """The tier that ``Testbed`` fits images with by default (instant-ngp's
    configs/image/base.json: D=2, L=16, F=2, T=2^24, XOR hash, float32
    table reads, per_level_scale 2): levels 0-8 dense, level 8 exactly 2^24
    rows (4096²), levels 9-15 hashed into 2^24 rows, a 2.15 GB table. The
    forward bit for bit and the fused backward within the float32 order
    bound, on uniform positions and on positions crowded into one small
    square (many samples per row on every level)."""
    enc = GridEncoding(n_input_dims=2, n_levels=16, n_features_per_level=2,
                       log2_hashmap_size=24, base_resolution=16, per_level_scale=2.0,
                       hash_variant="tcnn", device="cuda")
    hashed = enc.level_hashed.tolist()
    assert enc.level_size.tolist()[8] == 1 << 24 and hashed == [0] * 9 + [1] * 7
    assert not enc.bf16_reads
    L, T, F = enc.table.shape
    assert T == 1 << 24
    geo = (enc.level_scale, enc.level_res, enc.level_size, enc.level_hashed, "tcnn")
    gen = torch.Generator(device="cuda").manual_seed(24)
    table = torch.rand((L, T, F), generator=gen, device="cuda") * 2 - 1
    del enc
    n = 1 << 16
    for x in (torch.rand((n, 2), generator=gen, device="cuda"),
              0.3 + 0.001 * torch.rand((n, 2), generator=gen, device="cuda")):
        got = hashgrid_encode(x, table, *geo)
        want = hashgrid_encode_reference(x, table, *geo)
        assert torch.equal(got, want), float((got - want).abs().max())
        g = torch.randn((n, L * F), generator=gen, device="cuda") * 1e-3
        before = HASHGRID_ENCODE.launches["hashgrid_backward"]
        got = hashgrid_backward(x, g, *geo, None, T)
        torch.cuda.synchronize()
        assert HASHGRID_ENCODE.launches["hashgrid_backward"] == before + 1
        keys, vals = hashgrid_backward_addends_reference(x, g, *geo)
        want = hashgrid_backward_reference(x, g, *geo, None, T)
        _assert_within_order_bound(got, want, keys, vals, T)
        del got, want, keys, vals


@pytest.mark.cuda
def test_image_fit_on_card(cuda, tmp_path):
    """``ImageEngine`` on the card with a float16 image (a 256² crop of the
    gigapixel formula, 8 levels of 2^16 rows, Stratified positions): each
    step launches B1 and the fused backward once, 300 steps cut the MSE
    below a quarter of the untrained one, and a native snapshot reloads
    to the same MSE."""
    from ngp_tpu_torch.data.synthetic import gigapixel_image
    from ngp_tpu_torch.engines.image import ImageEngine
    from ngp_tpu_torch.testbed import default_config

    cfg = default_config("image")
    cfg["encoding"].update(n_levels=8, log2_hashmap_size=16)
    eng = ImageEngine(cfg, gigapixel_image(256, "cuda", torch.float16), batch_size=1 << 16)
    state = eng.init_state()
    untrained = eng.compute_mse(state)
    before = launch_counts()
    state, losses = eng.train(state, 300)
    after = launch_counts()
    assert losses.device.type == "cuda" and bool(torch.isfinite(losses).all())
    for name in ("hashgrid_encode", "hashgrid_backward"):
        assert after[name] - before[name] == 300, name
    mse = eng.compute_mse(state)
    assert mse < 0.25 * untrained, (mse, untrained)
    eng.save_snapshot(str(tmp_path / "fit.ingp"), state)
    assert eng.compute_mse(eng.load_snapshot(str(tmp_path / "fit.ingp"))) == mse


@pytest.mark.cuda
def test_cli_round_trip_on_card(cuda, tmp_path, capsys):
    """``python -m ngp_tpu_torch.run`` on the card with its defaults
    (``Testbed``'s base.json config, grid 128) on a 64² capture: 50 steps,
    held-out eval, snapshot, screenshot; then the snapshot loaded with no
    training, scored again (equal within 0.05 dB; the density grid passes
    through float16), a mesh and two video frames. Both runs launch the
    hash-grid kernels; only the first trains."""
    import json

    from ngp_tpu_torch import run
    from ngp_tpu_torch.data.png import read_png
    from ngp_tpu_torch.data.synthetic import write_sphere_capture

    train_json, test_json = write_sphere_capture(str(tmp_path / "cap"), res=64, device="cuda")
    out = tmp_path / "out"
    path = tmp_path / "path.json"
    path.write_text(json.dumps({"loop": False, "path": [
        {"R": [0, 0, 0, 1], "T": [0.5, 0.5, -0.7], "fov": 40.0},
        {"R": [0, 0.3826834, 0, 0.9238795], "T": [0.0, 0.5, -0.4], "fov": 40.0}]}))

    def held_out(text):
        line = next(ln for ln in text.splitlines() if ln.startswith("test_transforms:"))
        return float(line.split("PSNR=")[1].split()[0])

    def launches(text):
        return json.loads(text.splitlines()[-1].split(":", 1)[1])

    run.main([train_json, "--n_steps", "50", "--test_transforms", test_json,
              "--save_snapshot", str(out / "scene.ingp"), "--screenshot", str(out / "shot.png")])
    first = capsys.readouterr().out
    run.main([train_json, "--n_steps", "0", "--load_snapshot", str(out / "scene.ingp"),
              "--test_transforms", test_json, "--save_mesh", str(out / "mesh.obj"),
              "--marching_cubes_res", "64", "--video_camera_path", str(path),
              "--video_n_seconds", "1", "--video_fps", "2", "--video_w", "48",
              "--video_h", "32", "--video_output", str(out / "frames")])
    second = capsys.readouterr().out
    assert "loaded snapshot at step 50" in second
    assert abs(held_out(first) - held_out(second)) <= 0.05
    assert read_png(str(out / "shot.png")).shape == (64, 64, 3)
    assert (out / "mesh.obj").exists()
    assert [read_png(str(out / "frames" / f"frame_{i:04d}.png")).shape
            for i in range(2)] == [(32, 48, 3)] * 2
    assert launches(first)["hashgrid_encode"] > 0 and launches(first)["hashgrid_backward"] > 0
    assert launches(second)["hashgrid_encode"] > 0 and launches(second)["hashgrid_backward"] == 0


def _bvh_case(kind: str, seed: int, n: int = 1 << 14):
    """A tree on the card and its queries. Meshes: the bumpy icosphere of 4
    subdivisions (5,120 triangles, closed), of 6 (81,920: a tree deeper
    than the top levels the kernels keep in shared memory), a 500-triangle
    soup, the 12-triangle cube, 9 random triangles (leaves of 4, 2 and 3
    real triangles) and 1 (the root is a leaf of 1). Points: uniform around the unit
    cube, near the middle of the mesh (the long walks of a closed mesh),
    on the surface, at the mesh's vertices and the midpoints of its edges
    (ties between the triangles that share them), and two far out at the
    padding's corner (where a padding slot can win). Rays from those
    points in seeded unit directions, a quarter along the axes (zero
    components: the clamped inverse)."""
    from ngp_tpu_torch.data.synthetic import bumpy_sphere
    from ngp_tpu_torch.geometry.mesh import normalize_mesh, sample_surface
    from ngp_tpu_torch.geometry.triangle_bvh import FAR, build_bvh

    rng = np.random.default_rng(seed)
    if kind in ("bumpy", "deep"):
        v, f = bumpy_sphere(4 if kind == "bumpy" else 6)
        tris = v[f]
    elif kind == "soup":
        tris = rng.uniform(0.1, 0.9, (500, 3, 3)).astype(np.float32)
    elif kind in ("padded", "root_leaf"):
        tris = rng.uniform(0.2, 0.8, (9 if kind == "padded" else 1, 3, 3)).astype(np.float32)
    else:
        c = np.array([[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
                      [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]], np.float32)
        faces = [(0, 2, 1), (0, 3, 2), (4, 5, 6), (4, 6, 7), (0, 1, 5), (0, 5, 4),
                 (3, 6, 2), (3, 7, 6), (0, 4, 7), (0, 7, 3), (1, 2, 6), (1, 6, 5)]
        tris = (c * 0.25 + 0.5)[np.asarray(faces)]
    mesh = normalize_mesh(tris)
    k = n // 8
    t = mesh.triangles
    edge = rng.integers(0, 3, k)
    pts = np.concatenate([
        rng.uniform(-0.1, 1.1, (n - 4 * k, 3)).astype(np.float32),
        (0.5 + rng.uniform(-0.05, 0.05, (k, 3))).astype(np.float32),
        sample_surface(mesh, rng.uniform(size=(k, 3)).astype(np.float32)),
        t.reshape(-1, 3)[rng.integers(0, mesh.n_triangles * 3, k)],
        0.5 * (t[np.arange(k) % len(t), edge] + t[np.arange(k) % len(t), (edge + 1) % 3])])
    pts[:2] = [[FAR] * 3, [FAR, FAR, 0.9 * FAR]]
    dirs = rng.normal(size=(n, 3))
    dirs[:2 * k] = np.eye(3)[rng.integers(0, 3, 2 * k)] * rng.choice([-1, 1], (2 * k, 1))
    dirs = (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)).astype(np.float32)
    tree = build_bvh(mesh.triangles, "cuda")
    return tree, torch.from_numpy(pts).cuda(), torch.from_numpy(dirs).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bumpy", "soup", "cube", "deep", "padded", "root_leaf"])
def test_bvh_kernels_match_twins(cuda, kind):
    """Both traversal kernels equal their plain twins on the card bit for
    bit (distances, closest points, slots; t, inf on a miss, slots), ties
    at shared vertices and edges included, and each query processes the
    twin's count of nodes (the kernels' optional ``visits`` output); the
    same outputs without it. Each call counts one launch."""
    from ngp_tpu_torch.ops.bvh import (
        TRIANGLE_BVH,
        bvh_closest_point_cuda,
        bvh_closest_point_reference,
        bvh_ray_intersect_cuda,
        bvh_ray_intersect_reference,
    )

    tree, pts, dirs = _bvh_case(kind, 3)
    P = pts.shape[0]
    stats = {}
    want = bvh_closest_point_reference(tree, pts, stats)
    ray_stats = {}
    ray_want = bvh_ray_intersect_reference(tree, pts, dirs, ray_stats)
    assert bool((want[2] >= 0).all())
    assert bool(torch.isfinite(ray_want[0]).any()) and not bool(torch.isfinite(ray_want[0]).all())
    if kind in ("bumpy", "deep", "root_leaf"):  # a far query's best is a padding slot
        assert bool((tree.tri_index[want[2][:2].long()] < 0).all())
    if kind == "deep":  # the middle of the closed mesh prunes little
        assert tree.records.shape[0] > 1023 and int(stats["visits"].max()) > 1000
    before = dict(TRIANGLE_BVH.launches)
    visits = torch.full((P,), -1, dtype=torch.int32, device="cuda")
    got = bvh_closest_point_cuda(tree, pts, visits)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert torch.equal(visits, stats["visits"])
    visits.fill_(-1)
    got = bvh_ray_intersect_cuda(tree, pts, dirs, visits)
    torch.cuda.synchronize()
    for g, w in zip(got, ray_want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert torch.equal(visits, ray_stats["visits"])
    assert TRIANGLE_BVH.launches["bvh_closest_point"] == before["bvh_closest_point"] + 1
    assert TRIANGLE_BVH.launches["bvh_ray_intersect"] == before["bvh_ray_intersect"] + 1
    assert torch.equal(bvh_closest_point_cuda(tree, pts)[2], want[2])  # no visits asked


@pytest.mark.cuda
def test_bvh_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from ngp_tpu_torch.ops.bvh import bvh_closest_point_cuda, bvh_ray_intersect_cuda

    tree, pts, dirs = _bvh_case("cube", 4, n=64)
    for bad in (pts.cpu(), pts.double(), pts[:, :2].contiguous(), pts.t().contiguous().t()):
        with pytest.raises(ValueError):
            bvh_closest_point_cuda(tree, bad)
    with pytest.raises(ValueError):
        bvh_ray_intersect_cuda(tree, pts, dirs[:32])
    with pytest.raises(ValueError):
        bvh_closest_point_cuda(tree._replace(records=tree.records.float()), pts)
    with pytest.raises(ValueError):
        bvh_closest_point_cuda(tree._replace(triangles=tree.triangles.cpu()), pts)
    with pytest.raises(ValueError):
        bvh_closest_point_cuda(tree._replace(depth=64), pts)
    with pytest.raises(ValueError):
        bvh_closest_point_cuda(tree, pts, torch.zeros(64, dtype=torch.int64, device="cuda"))
    empty = bvh_closest_point_cuda(tree, pts[:0])
    assert [t.shape[0] for t in empty] == [0, 0, 0]


@pytest.mark.cuda
def test_sdf_on_card(cuda, tmp_path):
    """The SDF primitive on the card at a small size: training launches the
    closest-point kernel (one refresh a 16 steps), a model normals frame
    launches the grid's position gradient and no table gradient, a ground
    truth frame and the raystab sign launch the traversal kernels, and a
    snapshot reloads to the same IoU."""
    from ngp_tpu_torch.data.synthetic import write_bumpy_sphere_mesh
    from ngp_tpu_torch.ops.cuda_build import reset_launches
    from ngp_tpu_torch.testbed import Testbed

    cfg = {"loss": {"otype": "MAPE"},
           "optimizer": {"otype": "Ema", "decay": 0.95, "nested": {
               "otype": "Adam", "learning_rate": 1e-2, "beta1": 0.9, "beta2": 0.99,
               "epsilon": 1e-15, "l2_reg": 1e-6}},
           "encoding": {"otype": "HashGrid", "n_levels": 8, "n_features_per_level": 2,
                        "log2_hashmap_size": 16, "base_resolution": 16},
           "network": {"otype": "FullyFusedMLP", "activation": "ReLU",
                       "output_activation": "None", "n_neurons": 64, "n_hidden_layers": 2}}
    mesh = write_bumpy_sphere_mesh(str(tmp_path / "b.obj"), 4)
    tb = Testbed(scene=mesh, config=cfg, batch_size=1 << 14)
    reset_launches()
    tb.train(64)
    torch.cuda.synchronize()
    launched = launch_counts()
    assert launched["bvh_closest_point"] == 4 and launched["hashgrid_backward"] == 64
    iou = tb.calculate_iou(1 << 16)
    assert iou > 0.8, iou
    reset_launches()
    rgb, hit = tb.engine.render_image(tb.state, (0.5, 0.5, 2.0), (0.5, 0.5, 0.5), (64, 48),
                                      mode="normals")
    torch.cuda.synchronize()
    launched = launch_counts()
    assert launched["hashgrid_input_grad"] > 0 and launched["hashgrid_backward"] == 0
    assert rgb.shape == (48, 64, 3) and bool(torch.isfinite(rgb).all()) and bool(hit.any())
    reset_launches()
    tb.engine.render_image(tb.state, (0.5, 0.5, 2.0), (0.5, 0.5, 0.5), (64, 48), gt_bvh=True,
                           mode="shade", shadow=True)
    tb.engine.sign_mode = "raystab"
    tb.engine.signed_distance(torch.rand(256, 3, device="cuda"))
    launched = launch_counts()
    assert launched["bvh_closest_point"] > 0 and launched["bvh_ray_intersect"] > 0
    tb.engine.sign_mode = "watertight"
    tb.save_snapshot(str(tmp_path / "s.ingp"))
    tb.train(4)
    tb.load_snapshot(str(tmp_path / "s.ingp"))
    assert tb.calculate_iou(1 << 16) == iou


def _volume_case(seed: int, n: int = 1 << 13):
    """A non-cubic volume on the card (48 × 32 × 24: two dense blobs with an
    empty slab of bit cells between them, one of density up to 8 so that
    episodes are absorbed early) and its rays: starts on a sphere of
    radius 2 toward points of the box, a quarter along the axes (zero
    components: the +1e-12 rule), an eighth pointing away (they miss the
    box)."""
    from ngp_tpu_torch.data.volume import DenseVolume
    from ngp_tpu_torch.ops.marching import ray_aabb_range

    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.arange(s) / s for s in (48, 32, 24)], indexing="ij"), -1)
    blob = lambda c, r: np.clip(1.0 - np.linalg.norm((g - c) / r, axis=-1), 0.0, 1.0)
    density = (2.0 * blob([0.25, 0.5, 0.5], 0.22) + 8.0 * blob([0.8, 0.5, 0.5], 0.15)
               * rng.uniform(0.5, 1.0, g.shape[:3])).astype(np.float32)
    density[20:26] = 0.0
    density[density < 0.05] = 0.0
    vol = DenseVolume.from_dense(density, "cuda")
    lo, hi = vol.aabb_min, vol.aabb_max
    d1 = rng.normal(size=(n, 3))
    start = d1 / np.linalg.norm(d1, axis=1, keepdims=True) * 2.0 + 0.5
    dirs = lo + rng.uniform(size=(n, 3)) * (hi - lo) - start
    k = n // 4
    axis = rng.integers(0, 3, k)
    start[:k] = 0.5 + rng.uniform(-0.2, 0.2, (k, 3))
    start[np.arange(k), axis] = rng.choice([-1.5, 2.5], k)
    dirs[:k] = 0.0
    dirs[np.arange(k), axis] = np.sign(0.5 - start[np.arange(k), axis])
    dirs[k:k + n // 8] *= -1.0
    dirs = (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)).astype(np.float32)
    o, d = (torch.from_numpy(a.astype(np.float32)).cuda() for a in (start, dirs))
    aabb = [torch.from_numpy(a).cuda() for a in (lo, hi)]
    tmin, tmax = ray_aabb_range(o, d, *aabb)
    pos = (o + d * (tmin + 1e-6)[:, None]).contiguous()
    return vol, pos, d.contiguous(), tmin <= tmax


# up, sun direction, sky colour: every term of the sky's radiance nonzero
_ENVMAP = ((0.0, 0.0, 1.0), (0.3, 0.8, 0.52), (0.1, 0.2, 0.3))


@pytest.mark.cuda
@pytest.mark.parametrize("albedo,scattering", [(0.95, 0.0), (0.3, 0.6)])
def test_volume_train_walk_matches_twin(cuda, albedo, scattering):
    """The training walk kernel (starts, walks and targets in one launch)
    equals its twin, the composition ``training_data`` on CUDA tensors, bit
    for bit: positions, targets, valid flags and iterations walked, on
    episodes that cross an empty slab of bit cells, fill all 4 slots or
    none, and are absorbed early (albedo 0.3)."""
    from ngp_tpu_torch.ops.volume_walk import (
        VOLUME_WALK,
        WalkVolume,
        draw_key,
        training_data,
        volume_train_walk_cuda,
    )

    vol = _volume_case(5)[0]
    walk = WalkVolume.of(vol, 0.01, "cuda")
    key = draw_key(1337 ^ 0x701, 3)
    E = 1 << 13
    want = training_data(walk, key, E, albedo, scattering, _ENVMAP)
    before = VOLUME_WALK.launches["volume_train_walk"]
    steps = torch.full((E,), -1, dtype=torch.int32, device="cuda")
    got = volume_train_walk_cuda(walk, key, E, albedo, scattering, _ENVMAP, steps)
    torch.cuda.synchronize()
    for g, w in zip((*got, steps), want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert VOLUME_WALK.launches["volume_train_walk"] == before + 1
    filled = want[2].view(E, 4).sum(1)
    assert bool((filled == 4).any()) and bool((filled == 0).any()) and int(steps.max()) > 1
    absorbed = (want[1][::4, :3] == 0).all(1)
    assert bool(absorbed.any()) and bool((want[1][:, :3] > 0).any())
    if albedo < 0.5:
        assert float(absorbed.float().mean()) > 0.1


@pytest.mark.cuda
def test_volume_engine_training_data_is_one_launch(cuda):
    """On the card ``generate_training_data`` is one launch of the training
    walk kernel and equals the twin's composition on the same stream."""
    from ngp_tpu_torch.engines.volume import VolumeEngine
    from ngp_tpu_torch.ops.volume_walk import VOLUME_WALK, draw_key, training_data

    cfg = {"loss": {"otype": "L2"},
           "optimizer": {"otype": "Adam", "learning_rate": 1e-2},
           "encoding": {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
                        "log2_hashmap_size": 12, "base_resolution": 8},
           "network": {"otype": "FullyFusedMLP", "activation": "ReLU",
                       "output_activation": "ReLU", "n_neurons": 64, "n_hidden_layers": 2}}
    eng = VolumeEngine(cfg, _volume_case(8, n=64)[0], batch_size=1 << 12, seed=9,
                       sky_color=(0.2, 0.1, 0.0))
    launched = dict(VOLUME_WALK.launches)
    got = eng.generate_training_data(4)
    torch.cuda.synchronize()
    assert VOLUME_WALK.launches["volume_train_walk"] == launched["volume_train_walk"] + 1
    want = training_data(eng.walk, draw_key(9 ^ 0x701, 4), 1 << 10, eng.albedo, eng.scattering,
                         eng.envmap)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="explicit draws"):
        eng.generate_training_data(4, start=want[:2])


@pytest.mark.cuda
def test_volume_packed_bitgrid_on_card(cuda):
    """The packed bitgrid and the density bricks built on the card equal
    the CPU's, and the packed grid's reader equals the uint8 grid at every
    cell."""
    from ngp_tpu_torch.ops.volume_walk import brick_density, pack_bitgrid, packed_bit

    vol = _volume_case(9, n=64)[0]
    packed = pack_bitgrid(vol.bitgrid)
    assert packed.is_cuda and torch.equal(packed.cpu(), pack_bitgrid(vol.bitgrid.cpu()))
    bricks = brick_density(vol.density)
    assert bricks.is_cuda and torch.equal(bricks.cpu(), brick_density(vol.density.cpu()))
    cells = torch.stack(torch.meshgrid(*[torch.arange(128, device="cuda")] * 3, indexing="ij"),
                        -1).reshape(-1, 3)
    assert torch.equal(packed_bit(packed, cells), vol.bitgrid.reshape(-1) != 0)


@pytest.mark.cuda
def test_volume_render_walk_matches_twin(cuda):
    """The render walk kernel equals its twin bit for bit: the ground truth
    walk's col, opa and iterations; then learned rounds, each the kernel's
    positions, alive flags, iteration counters and event flags against the
    twin's, the rays at an event kept alive or stopped by a seeded rule in
    place of the model's composite."""
    from ngp_tpu_torch.ops.volume_walk import (
        MAX_WALK_ITERS,
        VOLUME_WALK,
        HashDraws,
        WalkVolume,
        draw_key,
        render_walk,
        volume_render_walk_cuda,
    )

    vol, pos, dirs, alive = _volume_case(6)
    walk = WalkVolume.of(vol, 0.01, "cuda")
    key = draw_key(7, 0)
    col, opa, steps = render_walk(walk, pos, dirs, alive, HashDraws(key), True)
    got_steps = torch.full(alive.shape, -1, dtype=torch.int32, device="cuda")
    got = volume_render_walk_cuda(walk, pos, dirs, alive, key, True, steps=got_steps)
    torch.cuda.synchronize()
    assert torch.equal(got[0], col) and torch.equal(got[1], opa)
    assert torch.equal(got_steps, steps)
    assert bool((opa > 0.99).any()) and bool((opa == 0).any())

    ids = torch.arange(pos.shape[0], device="cuda")
    iters = torch.zeros(ids.shape, dtype=torch.int32, device="cuda")
    p, a, it = pos.clone(), alive.clone(), iters
    before = VOLUME_WALK.launches["volume_render_walk"]
    rng = torch.Generator(device="cuda").manual_seed(1)
    for rnd in range(64):
        want = render_walk(walk, p, dirs, a, HashDraws(key), False, it, ids)
        got = volume_render_walk_cuda(walk, p.clone(), dirs, a.clone(), key, False, it.clone(),
                                      ids)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w), rnd
        p, a, it, event = want
        if not bool(a.any()):
            break
        a = a & (torch.rand(a.shape, generator=rng, device="cuda") < 0.9)
    assert VOLUME_WALK.launches["volume_render_walk"] == before + rnd + 1
    assert rnd > 4 and int(it.max()) <= MAX_WALK_ITERS


@pytest.mark.cuda
def test_volume_on_card(cuda, tmp_path, monkeypatch):
    """The volume primitive on the card at a small size: a step launches the
    training walk once, B1 and the fused backward; a ground-truth frame
    launches the render walk once, a learned frame once a round; a snapshot
    reloads to the same learned frame."""
    import ngp_tpu_torch.engines.volume as engine_module
    from ngp_tpu_torch.data.nanovdb_codec import write_nanovdb
    from ngp_tpu_torch.data.volume import procedural_cloud_density
    from ngp_tpu_torch.ops.cuda_build import reset_launches
    from ngp_tpu_torch.testbed import Testbed

    cfg = {"loss": {"otype": "L2"},
           "optimizer": {"otype": "Ema", "decay": 0.95, "nested": {
               "otype": "Adam", "learning_rate": 1e-2, "beta1": 0.9, "beta2": 0.99,
               "epsilon": 1e-15, "l2_reg": 1e-6}},
           "encoding": {"otype": "HashGrid", "n_levels": 8, "n_features_per_level": 2,
                        "log2_hashmap_size": 16, "base_resolution": 8},
           "network": {"otype": "FullyFusedMLP", "activation": "ReLU",
                       "output_activation": "ReLU", "n_neurons": 64, "n_hidden_layers": 2}}
    path = str(tmp_path / "cloud.nvdb")
    write_nanovdb(path, procedural_cloud_density(64))
    tb = Testbed(scene=path, config=cfg, batch_size=1 << 14)
    reset_launches()
    tb.train(32)
    torch.cuda.synchronize()
    launched = launch_counts()
    assert launched["volume_train_walk"] == 32 and launched["hashgrid_backward"] == 32
    eng = tb.engine
    reset_launches()
    _, opa_gt = eng.render_image(tb.state, (0.5, 0.5, 2.2), (0.5, 0.5, 0.5), (64, 48), gt=True)
    assert launch_counts()["volume_render_walk"] == 1
    rounds, walk = [0], engine_module.volume_render_walk

    def counted_walk(*args, **kwargs):
        rounds[0] += 1
        return walk(*args, **kwargs)

    monkeypatch.setattr(engine_module, "volume_render_walk", counted_walk)
    reset_launches()
    img, opa = eng.render_image(tb.state, (0.5, 0.5, 2.2), (0.5, 0.5, 0.5), (64, 48))
    monkeypatch.undo()
    assert launch_counts()["volume_render_walk"] == rounds[0] > 1
    assert bool(torch.isfinite(img).all()) and float(opa_gt[24, 32]) > 0.5
    tb.save_snapshot(str(tmp_path / "v.ingp"))
    tb.train(4)
    tb.load_snapshot(str(tmp_path / "v.ingp"))
    again, _ = eng.render_image(tb.state, (0.5, 0.5, 2.2), (0.5, 0.5, 0.5), (64, 48))
    assert torch.equal(again, img)


@pytest.mark.cuda
def test_volume_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from ngp_tpu_torch.ops.volume_walk import (
        WalkVolume,
        volume_render_walk,
        volume_render_walk_cuda,
        volume_train_walk_cuda,
    )

    vol, pos, dirs, alive = _volume_case(7, n=64)
    walk = WalkVolume.of(vol, 0.01, "cuda")
    for bad in (walk._replace(density=vol.density.double()),
                walk._replace(packed=walk.packed.long()),
                walk._replace(packed=walk.packed[:100]),
                walk._replace(bricks=walk.bricks[:-1]),
                walk._replace(density=vol.density.cpu())):
        with pytest.raises(ValueError):
            volume_train_walk_cuda(bad, 1, 64, 0.95, 0.0, _ENVMAP)
    with pytest.raises(ValueError):
        volume_train_walk_cuda(walk, 1, -1, 0.95, 0.0, _ENVMAP)
    with pytest.raises(ValueError):
        volume_train_walk_cuda(walk, 1, 64, 0.95, 0.0, _ENVMAP,
                               torch.zeros(32, dtype=torch.int32, device="cuda"))
    for bad in (pos.cpu(), pos.double(), pos[:, :2].contiguous()):
        with pytest.raises(ValueError):
            volume_render_walk_cuda(walk, bad, dirs, alive, 1, True)
    with pytest.raises(ValueError):
        volume_render_walk_cuda(walk, pos, dirs[:32], alive, 1, True)
    with pytest.raises(ValueError):
        volume_render_walk_cuda(walk, pos, dirs, alive, 1, False,
                                torch.zeros(64, dtype=torch.int64, device="cuda"),
                                torch.arange(64, device="cuda"))
    with pytest.raises(ValueError):
        volume_render_walk(walk, pos, dirs, alive, 1, True, draws=object())
    empty = volume_train_walk_cuda(walk, 1, 0, 0.95, 0.0, _ENVMAP)
    assert [t.shape[0] for t in empty] == [0] * 3


@pytest.mark.cuda
def test_envmap_read_on_card_matches_cpu(cuda):
    """``ops/envmap.read_envmap`` (plain PyTorch, no kernel) on the card
    against the same read on the CPU. The card's arccos and atan2 round
    otherwise: its (theta, phi) within 3e-7 of the CPU's (a few float32
    ulps of [0, 1]), which moves each bilinear weight by at most m =
    (W−1)·max|Δphi| + (H−1)·max|Δtheta|. So the read is held within
    (W−1)·|Δphi|·(largest step between x neighbours) + (H−1)·|Δtheta|·
    (largest between y neighbours) + 1e-6 a ray, and the 4-corner deposit
    of its gradient within m·Σ|g| over the rays whose corners touch the
    texel on either device, plus 2e-6 of the texel's deposited mass
    Σ|w·g| (the card sums a texel's deposits with atomics, in no fixed
    order), plus 1e-7."""
    from ngp_tpu_torch.ops.envmap import dir_to_latlong_uv, read_envmap

    rng = np.random.default_rng(0)
    d = rng.normal(size=(1 << 14, 3))
    d = np.concatenate([[[0, 1, 0], [0, -1, 0], [1e-7, 0.3, -1], [-1e-7, 0.3, -1]], d])
    d = torch.from_numpy((d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32))
    H, W = 64, 128
    img = torch.from_numpy(rng.uniform(-0.2, 1.5, (H, W, 4)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(d.shape[0], 4)).astype(np.float32))
    uv = [tuple(t.cpu() for t in dir_to_latlong_uv(d.to(dev))) for dev in ("cpu", "cuda")]
    d_theta, d_phi = (uv[1][0] - uv[0][0]).abs(), (uv[1][1] - uv[0][1]).abs()
    assert float(d_theta.max()) <= 3e-7 and float(d_phi.max()) <= 3e-7
    out, grads = [], []
    for dev in ("cpu", "cuda"):
        image = img.to(dev).clone().requires_grad_(True)
        got = read_envmap(image, d.to(dev))
        (got * w.to(dev)).sum().backward()
        out.append(got.detach().cpu())
        grads.append(image.grad.cpu())
    step_x = float((img.roll(-1, 1) - img).abs().max())
    step_y = float((img[1:] - img[:-1]).abs().max())
    delta = (W - 1) * d_phi * step_x + (H - 1) * d_theta * step_y + 1e-6
    assert ((out[1] - out[0]).abs() <= delta[:, None]).all()
    image = img.clone().requires_grad_(True)
    (read_envmap(image, d) * w.abs()).sum().backward()
    mass = image.grad
    touch = torch.zeros((H, W, 4))  # Σ|g| of the rays whose corners touch a texel
    for theta, phi in uv:
        fx, fy = phi * (W - 1), theta * (H - 1)
        x0, y0 = torch.floor(fx).long(), torch.floor(fy).long()
        for dx in (0, 1):
            for dy in (0, 1):
                touch.index_put_((torch.clamp(y0 + dy, 0, H - 1), (x0 + dx) % W), w.abs(),
                                 accumulate=True)
    m = (W - 1) * float(d_phi.max()) + (H - 1) * float(d_theta.max())
    err = (grads[1] - grads[0]).abs()
    bound = m * touch + 2e-6 * mass + 1e-7
    assert (err <= bound).all(), float((err / bound).max())


@pytest.mark.cuda
def test_supervised_step_on_card_matches_cpu(cuda):
    """One step with every A5c option (latents E = 4, a trained envmap over
    the dataset's, depth supervision on supplied rays) at a small size (a
    4-level 2^12 grid, 32-wide MLPs) from the same state on the same batch,
    on the card and on the CPU: the card launches B1 and the fused grid
    backward; the loss within 1e-4 relative; the MLP gradients within 2e-2
    of each matrix's largest entry, the table's 2^-6 of each level's
    largest, the latents' 2e-2 and the envmap's 1e-3 of their largest (the
    tolerances of ``tests/test_torch_supervision.py``)."""
    from ngp_tpu_torch.config import default_config
    from ngp_tpu_torch.data.synthetic import tiny_sphere_dataset
    from ngp_tpu_torch.engines.nerf import NerfEngine
    from ngp_tpu_torch.interop import export_jax_train_state, load_jax_train_state
    from ngp_tpu_torch.ops.cuda_build import reset_launches

    cfg = default_config("tpu")
    cfg["encoding"].update(n_levels=4, log2_hashmap_size=12)
    cfg["network"]["n_neurons"] = cfg["rgb_network"]["n_neurons"] = 32
    ds = tiny_sphere_dataset(4, 32)
    rng = np.random.default_rng(1)
    ds.n_extra_learnable_dims = 4
    ds.envmap = rng.uniform(0, 1, (16, 32, 4)).astype(np.float32)
    ds.depths = np.where(rng.uniform(size=(4, 32, 32)) < 0.25, 0.0,
                         rng.uniform(0.3, 1.2, (4, 32, 32))).astype(np.float32)
    probe = NerfEngine(cfg, ds, device="cpu", grid_size=32)
    ds.rays = np.stack([torch.cat(probe.view_rays(i)[:2], -1).reshape(32, 32, 6).numpy()
                        for i in range(4)])
    kw = dict(batch_size=1 << 14, grid_size=32, train_envmap=True,
              depth_supervision_lambda=0.5)
    engines = {dev: NerfEngine(cfg, ds, device=dev, **kw) for dev in ("cpu", "cuda")}
    cpu = engines["cpu"]
    state = cpu.init_state()
    r = (torch.arange(32) + 0.5) / 32 - 0.5
    ball = (r[:, None, None] ** 2 + r[None, :, None] ** 2 + r[None, None, :] ** 2
            <= 0.08).float()
    batch, bg = cpu._sample_ray_batch(1 << 10)
    tree = export_jax_train_state(state)
    results = {}
    for dev, eng in engines.items():
        camera, envmap = eng._initial_groups()
        st = load_jax_train_state(eng._new_network(), tree, camera=camera, envmap=envmap)
        grid = eng.grid_from_density(ball[None])
        b = type(batch)(*[t.to(dev) if t is not None else None for t in batch])
        reset_launches()
        loss, _, _ = eng.batch_loss_and_grads(st.model, grid, b, bg.to(dev), 64,
                                              camera=st.camera, envmap=st.envmap)
        if dev == "cuda":
            torch.cuda.synchronize()
            launched = launch_counts()
            assert launched["hashgrid_encode"] > 0 and launched["hashgrid_backward"] > 0
        grads = {n: p.grad.cpu() for n, p in st.model.named_parameters()}
        grads["latents"] = st.camera.latents.grad.cpu()
        grads["envmap"] = st.envmap.image.grad.cpu()
        results[dev] = (float(loss), grads)
    assert results["cuda"][0] == pytest.approx(results["cpu"][0], rel=1e-4)
    for name, want in results["cpu"][1].items():
        got = results["cuda"][1][name]
        assert float(want.abs().max()) > 0, name
        if name.endswith("table"):
            err = (got - want).abs().amax(dim=(1, 2))
            assert (err <= 2.0 ** -6 * want.abs().amax(dim=(1, 2))).all(), name
        else:
            tol = 1e-3 if name == "envmap" else 2e-2
            assert float((got - want).abs().max()) <= tol * float(want.abs().max()), name


def _small_nerf_engines(**kw):
    """The supervised step's small size (a 4-level 2^12 "tpu"-tier grid,
    32-wide MLPs, grid 32) on the sphere views, on the CPU and the card,
    and one state for both, its table scaled to U(±0.3) so that the
    density field varies."""
    from ngp_tpu_torch.config import default_config
    from ngp_tpu_torch.data.synthetic import tiny_sphere_dataset
    from ngp_tpu_torch.engines.nerf import NerfEngine
    from ngp_tpu_torch.interop import export_jax_train_state

    cfg = default_config("tpu")
    cfg["encoding"].update(n_levels=4, log2_hashmap_size=12)
    cfg["network"]["n_neurons"] = cfg["rgb_network"]["n_neurons"] = 32
    ds = tiny_sphere_dataset(4, 32)
    engines = {dev: NerfEngine(cfg, ds, device=dev, batch_size=1 << 14, grid_size=32, **kw)
               for dev in ("cpu", "cuda")}
    state = engines["cpu"].init_state()
    with torch.no_grad():
        state.model.pos_encoding.table.mul_(3e3)
    return engines, export_jax_train_state(state)


@pytest.mark.cuda
def test_probe_sampled_update_on_card_matches_cpu(cuda):
    """One probe-sampled occupancy update (``grid_stride_update=False``, the
    reference cadence's G³/4 cells of each kind) from the same state, grid
    and draws on the card and on the CPU: B1 launched on the card; the
    cells chosen and every culled cell exactly; the densities within 1e-4
    relative (the MLPs' float32 sums in another order, then exp) and 1e-9
    absolute; the max-splat is exact in any order, so no more."""
    from ngp_tpu_torch.interop import load_jax_train_state
    from ngp_tpu_torch.ops import occupancy as occ
    from ngp_tpu_torch.ops.cuda_build import reset_launches

    engines, tree = _small_nerf_engines(grid_stride_update=False)
    cpu = engines["cpu"]
    grid0 = cpu.init_grid()
    rng = np.random.default_rng(2)
    density = torch.where(grid0.density < 0, -1.0, torch.from_numpy(
        rng.uniform(0, 0.02, grid0.density.shape).astype(np.float32)))
    cfg = cpu.grid_cfg
    n = 2 * (cfg.n_cells // 4 * cfg.n_cascades)
    gen = torch.Generator().manual_seed(5)
    draws = dict(mip=torch.randint(0, cfg.n_cascades, (n,), generator=gen),
                 probes=torch.randint(0, cfg.n_cells, (n, 10), generator=gen),
                 jitter=torch.rand((n, 3), generator=gen))
    out = {}
    for dev, eng in engines.items():
        st = load_jax_train_state(eng._new_network(), tree)
        grid = eng.grid_from_density(density)
        reset_launches()
        out[dev] = eng.update_grid(st, grid, False, **{k: v.to(dev) for k, v in draws.items()})
        if dev == "cuda":
            torch.cuda.synchronize()
            assert launch_counts()["hashgrid_encode"] > 0
    got, want = out["cuda"].density.cpu(), out["cpu"].density
    assert torch.equal(got[density < 0], want[density < 0])
    idx, _ = occ.sample_update_cells(cfg, density, n // 2, n // 2, **draws)
    idx_cuda, _ = occ.sample_update_cells(cfg, density.cuda(), n // 2, n // 2,
                                          **{k: v.cuda() for k, v in draws.items()})
    assert torch.equal(idx_cuda.cpu(), idx)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-9)
    assert out["cuda"].ema_step == out["cpu"].ema_step == 1


@pytest.mark.cuda
def test_mesh_vertex_step_on_card_matches_cpu(cuda):
    """One ``optimize_mesh_vertices`` step on a 32³ marching-cubes mesh of
    the same field on the card and on the CPU: the card launches the
    position gradient and no table gradient; σ and ∇σ at the vertices
    within 1e-4 relative; Adam's first step moves each coordinate by lr
    times the sign of its gradient, so the vertices are equal within 1e-6
    wherever every gradient component on the CPU exceeds 1e-3 of the
    largest (elsewhere the card's atomic 1-ring sums, in another order,
    may flip the sign)."""
    from ngp_tpu_torch.interop import load_jax_train_state
    from ngp_tpu_torch.ops import mesh_opt
    from ngp_tpu_torch.ops.cuda_build import reset_launches

    engines, tree = _small_nerf_engines()
    cpu = engines["cpu"]
    st = load_jax_train_state(cpu._new_network(), tree)
    a = np.linspace(0, 1, 16, dtype=np.float32)
    lattice = torch.from_numpy(np.stack(np.meshgrid(a, a, a, indexing="ij"), -1).reshape(-1, 3))
    thresh = float(cpu.chunked_density(st.model, cpu.aabb.relative_pos(lattice)).median())
    verts, faces = cpu.compute_marching_cubes_mesh(st, 32, thresh)
    verts, faces = np.ascontiguousarray(verts), np.ascontiguousarray(faces)
    assert len(faces) > 1000
    out, fields = {}, {}
    for dev, eng in engines.items():
        s = load_jax_train_state(eng._new_network(), tree)
        model = s.inference_model()
        with torch.enable_grad():
            v = torch.from_numpy(verts).to(dev).requires_grad_(True)
            raw = model.density(eng.aabb.relative_pos(v), differentiable_inputs=True)[:, 0]
            fields[dev] = (raw.detach().cpu(), torch.autograd.grad(raw.sum(), v)[0].cpu())
        for p in model.parameters():
            p.grad = None
        reset_launches()
        out[dev] = eng.optimize_mesh_vertices(s, verts, faces, n_steps=1,
                                              density_thresh=thresh).cpu()
        if dev == "cuda":
            torch.cuda.synchronize()
            launched = launch_counts()
            assert launched["hashgrid_input_grad"] > 0 and launched["hashgrid_backward"] == 0
            assert all(p.grad is None for p in s.model.parameters())
    cpu_grad = mesh_opt.mesh_opt_gradient(torch.from_numpy(verts), torch.from_numpy(faces),
                                          *fields["cpu"], thresh)
    for i in range(2):
        torch.testing.assert_close(fields["cuda"][i], fields["cpu"][i], rtol=1e-4,
                                   atol=1e-4 * float(fields["cpu"][i].abs().max()))
    clear = (cpu_grad.abs() > 1e-3 * float(cpu_grad.abs().max())).all(dim=1)
    assert clear.float().mean() > 0.95
    torch.testing.assert_close(out["cuda"][clear], out["cpu"][clear], rtol=0, atol=1e-6)
    moved = (out["cpu"] - torch.from_numpy(verts)).abs()
    assert float(moved.max()) == pytest.approx(1e-4, rel=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [1, 2, 4, 8])
def test_takikawa_table_gradient_runs_the_segment_sum_kernel(cuda, f):
    """The Takikawa encoding on the card: its forward within 1e-6 of the
    largest output of the CPU encoding's, and its table gradient through
    ``segment_sum_cuda`` (one launch a backward) within the float32 order
    bound of the CPU twin's on the same bf16 addends; an F the kernel does
    not take raises."""
    from ngp_tpu_torch.data.synthetic import bumpy_sphere
    from ngp_tpu_torch.geometry.mesh import normalize_mesh
    from ngp_tpu_torch.geometry.triangle_octree import TriangleOctree
    from ngp_tpu_torch.models.takikawa import TakikawaEncoding
    from ngp_tpu_torch.ops.cuda_build import reset_launches

    v, fc = bumpy_sphere(3)
    tris = normalize_mesh(v[fc]).triangles
    encs = {dev: TakikawaEncoding(TriangleOctree.build(tris, 7, device=dev), 2, f,
                                  device=dev) for dev in ("cpu", "cuda")}
    table = torch.randn(encs["cpu"].table.shape, generator=torch.Generator().manual_seed(f))
    x = torch.rand((1 << 14, 3), generator=torch.Generator().manual_seed(1))
    g = torch.randn((1 << 14, encs["cpu"].n_output_dims),
                    generator=torch.Generator().manual_seed(2))
    out, grad = {}, {}
    for dev, enc in encs.items():
        with torch.no_grad():
            enc.table.copy_(table)
        reset_launches()
        y = enc(x.to(dev))
        (grad[dev],) = torch.autograd.grad(y, enc.table, g.to(dev))
        out[dev] = y.detach().cpu()
        if dev == "cuda":
            torch.cuda.synchronize()
            assert launch_counts()["segment_sum"] == 1
    scale = float(out["cpu"].abs().max())
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=0, atol=1e-6 * scale)
    idx, w = encs["cpu"].gather_plan(x)
    L = encs["cpu"].n_levels
    vals = w[..., None] * g.reshape(-1, L, f).transpose(0, 1)[:, :, None, :]
    vals = vals.to(torch.bfloat16).to(torch.float32).reshape(-1, f)
    keys = idx.reshape(-1).long()
    mass = torch.zeros_like(grad["cpu"]).index_add_(0, keys, vals.abs())
    n = torch.zeros(len(mass)).index_add_(0, keys, torch.ones(len(keys)))[:, None]
    assert ((grad["cuda"].cpu() - grad["cpu"]).abs()
            <= 2.0 * n * 2.0 ** -24 * mass).all()
    if f == 8:
        bad = TakikawaEncoding(encs["cuda"].octree, 2, 3, device="cuda")
        with pytest.raises(ValueError, match="F must be 1, 2, 4 or 8, got 3"):
            bad(x.cuda()).sum().backward()


@pytest.mark.cuda
def test_octree_sdf_trains_and_traces_on_the_card(cuda):
    """The Takikawa and the octree hash-grid SDF engines on the card: 30
    steps with a falling loss (the last 5 steps' mean below the first
    5's), a ``segment_sum`` launch a Takikawa step and
    none a hash-grid step, an IoU in (0, 1], and a traced frame of the
    trained model whose hits equal the CPU engine's on the same weights on
    all but 2% of the pixels."""
    import copy

    from ngp_tpu_torch.data.synthetic import bumpy_sphere
    from ngp_tpu_torch.engines.sdf import SdfEngine
    from ngp_tpu_torch.geometry.mesh import normalize_mesh
    from ngp_tpu_torch.interop import export_jax_params, load_jax_params
    from ngp_tpu_torch.ops.cuda_build import reset_launches
    from ngp_tpu_torch.train import TrainState

    v, fc = bumpy_sphere(3)
    mesh = normalize_mesh(v[fc])
    base = {"loss": {"otype": "MAPE"}, "optimizer": {"otype": "Adam", "learning_rate": 1e-2},
            "network": {"otype": "FullyFusedMLP", "n_neurons": 64, "n_hidden_layers": 2},
            "encoding": {"otype": "HashGrid", "n_levels": 8, "log2_hashmap_size": 16}}
    taki = copy.deepcopy(base)
    taki["encoding"] = {"otype": "Takikawa", "n_levels": 7, "starting_level": 2}
    view = ((0.5, 1.3, -0.6), (0.5, 0.45, 0.5), (48, 32))
    for cfg, kw in ((taki, {}), (base, {"use_octree": True, "octree_depth": 7})):
        eng = SdfEngine(cfg, mesh, batch_size=1 << 14, **kw)
        assert eng.octree.codes[0].is_cuda
        state = eng.init_state()
        reset_launches()
        state, losses = eng.train(state, 30)
        torch.cuda.synchronize()
        assert float(losses[-5:].mean()) < float(losses[:5].mean())
        assert launch_counts()["segment_sum"] == (30 if cfg is taki else 0)
        assert 0 < eng.calculate_iou(state, 1 << 14) <= 1
        weights = export_jax_params(state.inference_model())
        hits = []
        for e in (eng, SdfEngine(cfg, mesh, device="cpu", **kw)):
            served = TrainState.create(load_jax_params(e._new_network(), weights))
            hits.append(e.render_image(served, *view, mode="cost")[1].cpu())
        assert (hits[0] != hits[1]).float().mean() <= 0.02 and hits[1].any()

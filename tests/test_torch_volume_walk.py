"""The volume walk's host side on the CPU (``ngp_tpu_torch/ops/volume_walk.py``,
``engines/volume.py``): the packed bitgrid and the density bricks the
training kernel reads, the training data's twin against the composition
of pieces it replaced, and the kernels' parameters as host values.

Sizes are small (``procedural_cloud(32)``, a random 128³ grid, densities
up to 40 × 24 × 17, 1,024 episodes). The comparisons are exact.
"""

import numpy as np
import pytest
import torch

from ngp_tpu_torch.data.volume import DenseVolume, procedural_cloud
from ngp_tpu_torch.engines.volume import VolumeEngine
from ngp_tpu_torch.ops import volume_walk as vw
from ngp_tpu_torch.ops.marching import ray_aabb_range

# One intra-op thread, as every port test module sets (tests/test_torch_sdf.py).
torch.set_num_threads(1)

CONFIG = {
    "loss": {"otype": "L2"},
    "optimizer": {"otype": "Adam", "learning_rate": 1e-3},
    "encoding": {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
                 "log2_hashmap_size": 12, "base_resolution": 8},
    "network": {"otype": "FullyFusedMLP", "activation": "ReLU", "output_activation": "ReLU",
                "n_neurons": 64, "n_hidden_layers": 2},
}


def _cells():
    R = vw.BITGRID_RES
    return torch.stack(torch.meshgrid(*[torch.arange(R)] * 3, indexing="ij"), -1).reshape(-1, 3)


@pytest.mark.parametrize("case", ["random", "cloud"])
def test_packed_bitgrid_reader_equals_the_grid(case):
    """``packed_bit`` (the kernels' addressing) reads every cell of
    ``pack_bitgrid``'s output as the uint8 grid holds it: a random grid of
    values 0-255 (a third empty) and ``procedural_cloud(32)``'s."""
    R = vw.BITGRID_RES
    if case == "random":
        rng = np.random.default_rng(4)
        grid = rng.integers(1, 256, (R, R, R)).astype(np.uint8)
        grid[rng.uniform(size=grid.shape) < 1 / 3] = 0
        bitgrid = torch.from_numpy(grid)
    else:
        bitgrid = procedural_cloud(32, device="cpu").bitgrid
    packed = vw.pack_bitgrid(bitgrid)
    assert packed.dtype == torch.int32 and packed.shape == (R ** 3 // 32,)
    assert torch.equal(vw.packed_bit(packed, _cells()), bitgrid.reshape(-1) != 0)
    # one tile is one 128-byte line: 8 x 8 x 16 cells
    tile = torch.zeros((R, R, R), dtype=torch.uint8)
    tile[8:16, 40:48, 96:112] = 1
    words = vw.pack_bitgrid(tile)
    lit = torch.nonzero(words)[:, 0]
    assert lit.numel() == 32 and int(lit[0]) % 32 == 0 and bool((words[lit] == -1).all())


@pytest.mark.parametrize("shape", [(40, 24, 17), (32, 32, 32), (5, 9, 4)])
def test_density_bricks_round_trip(shape):
    """``brick_index`` (the training kernel's addressing) reads every voxel
    of ``brick_density``'s output back exactly, on shapes that are and are
    not multiples of the brick; the padding holds zeros and one brick is
    ``BRICK``³ successive floats."""
    density = torch.from_numpy(np.random.default_rng(6).uniform(0, 2, shape).astype(np.float32))
    bricks = vw.brick_density(density)
    cells = torch.stack(torch.meshgrid(*[torch.arange(n) for n in shape], indexing="ij"),
                        -1).reshape(-1, 3)
    at = vw.brick_index(cells, shape)
    assert torch.equal(bricks[at], density.reshape(-1))
    B = vw.BRICK
    assert bricks.numel() == np.prod([-(-n // B) * B for n in shape])
    rest = torch.ones(bricks.numel(), dtype=torch.bool)
    rest[at] = False
    assert not bool(bricks[rest].any()) and len(set(at.tolist())) == at.numel()
    corner = vw.brick_index(torch.tensor([[0, 0, 0], [B - 1, B - 1, B - 1]]), shape)
    assert corner.tolist() == [0, B ** 3 - 1]


def _old_envmap(dirs, up_dir, sun_dir, sky_col):
    """The engine's sky as it was computed before the fused kernel: summed
    by ``torch.sum``, the sun's colour divided on the tensor."""
    up, sun, sky = (torch.as_tensor(v, dtype=torch.float32) for v in (up_dir, sun_dir, sky_col))
    skyam = torch.sum(dirs * up, -1) * 0.5 + 0.5
    sunam = torch.clamp_min(torch.sum(dirs * sun, -1), 0.0)
    for _ in range(6):
        sunam = sunam * sunam
    sun_col = torch.tensor([255.0, 215.0, 195.0]) / 255.0
    return sky[None, :] * skyam[:, None] + sun_col[None, :] * (20.0 * sunam)[:, None]


def _old_training_data(eng, step, E):
    """``VolumeEngine.generate_training_data`` as it was composed before
    the fused kernel: the starts' draws, the rays and slab test, the walk,
    the sky targets."""
    key = vw.draw_key(eng.seed ^ 0x701, step)
    d1, ut = vw.start_draws(key, E, "cpu")
    origin = vw.normalize(d1) * 2.0 + 0.5
    target = eng.aabb_min + ut * (eng.aabb_max - eng.aabb_min)
    dirs = vw.normalize(target - origin)
    tmin, tmax = ray_aabb_range(origin, dirs, eng.aabb_min, eng.aabb_max)
    pos = origin + dirs * (tmin + 1e-6)[:, None]
    out_pos, out_den, cursor, dirs, thr, _ = vw.training_walk(
        eng.walk, pos, dirs, tmin <= tmax, vw.HashDraws(key), eng.albedo, eng.scattering)
    sky = _old_envmap(dirs, eng.up_dir, eng.sun_dir, eng.sky_color) * thr[:, None]
    valid = (torch.arange(4)[None, :] < cursor[:, None]).reshape(-1)
    targets = torch.cat([sky[:, None, :].expand(E, 4, 3).reshape(-1, 3),
                         out_den.reshape(-1, 1)], dim=-1)
    return out_pos.reshape(-1, 3), targets, valid


@pytest.mark.parametrize("fields", [{}, {"albedo": 0.4, "scattering": 0.5,
                                         "sky_color": (0.1, 0.2, 0.3),
                                         "up_dir": (0.0, 0.0, 1.0)}])
def test_training_data_twin_equals_the_composition_it_replaced(fields):
    """The engine's training data with no ``start`` (the fused kernel's
    twin, ``training_data``) equals the composition it replaced bit for
    bit on the CPU, at the engine's defaults and with absorption,
    scattering, a coloured sky and another up direction; the twin's own
    iteration counts stay within 512."""
    eng = VolumeEngine(CONFIG, procedural_cloud(32, device="cpu"), batch_size=1 << 12,
                       seed=5, device="cpu", **fields)
    E = 1 << 10
    got = eng.generate_training_data(3)
    want = _old_training_data(eng, 3, E)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    steps = vw.training_data(eng.walk, vw.draw_key(5 ^ 0x701, 3), E, eng.albedo,
                             eng.scattering, eng.envmap)[3]
    assert 0 < int(steps.max()) <= vw.MAX_WALK_ITERS
    assert 0.2 < float(want[2].float().mean()) < 0.9 and bool((want[1][:, :3] > 0).any())


def test_walk_params_are_host_floats(monkeypatch):
    """``WalkVolume.params`` returns the 14 float32 values that the
    launches once read from the device tensors, held as Python floats; the
    launch arguments are built without reading any tensor on the host."""
    vol = DenseVolume.from_dense(np.pad(np.ones((20, 12, 9), np.float32) * 1.7, 3), "cpu")
    walk = vw.WalkVolume.of(vol, 0.01, "cpu")
    before = [*walk.aabb_min.tolist(), *walk.aabb_max.tolist(), *walk.w2i_offset.tolist(),
              walk.w2i_scale, walk.majorant, walk.flight_scale, float(np.float32(0.95)),
              float(np.float32(0.3))]
    got = walk.params(0.95, 0.3)
    assert got == before and len(got) == vw.N_PARAMS
    assert all(type(x) is float and float(np.float32(x)) == x for x in got)

    def no_read(*args, **kwargs):
        raise AssertionError("a launch argument read a tensor on the host")

    for name in ("tolist", "item", "__float__", "__int__", "__bool__", "cpu", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, no_read)
    args = vw._volume_args(walk, vw.draw_key(1, 2), 0.95, 0.3)
    env = vw.envmap_params((0, 1, 0), (0.57735,) * 3, (0, 0, 0))
    monkeypatch.undo()
    assert list(args[7]) == [float(np.float32(x)) for x in got]
    assert len(env) == vw.N_ENVMAP and env[9:] == list(vw._SUN_COL)
    assert vw._SUN_COL[1] == float(torch.tensor(215.0) / torch.tensor(255.0))

"""Delta tracking through a density volume: the CUDA kernels' wrappers
(:func:`volume_train_walk_cuda`, :func:`volume_render_walk_cuda`), their
plain PyTorch twins (:func:`training_data`, :func:`render_walk`) and the
pieces both are made of.

The JAX package has no TPU kernel here: its volume engine runs the two
walks as ``lax.fori_loop``s of ``MAX_WALK_ITERS`` lockstep iterations
(``ngp_tpu/engines/volume.py:128-205``, the training data, and
``:259-298``, the frame). Each iteration is one delta-tracking advance
(:func:`jump`): a Woodcock free flight where the ray's bit cell is
occupied, else a skip to the next bitgrid cell; an event is a landing in an
occupied cell from an occupied cell. The kernels
(``ngp_tpu_torch/csrc/volume_walk.cu``) run a thread an episode or a ray
and stop where the lockstep loop leaves a lane frozen (a dead episode or
ray changes nothing in later iterations); the training kernel also draws
each episode's start and writes its targets, so that a step's training
data is one launch. The twins run the lockstep loop on tensors, gathering
the live rows every ``CHECK_EVERY`` iterations.

The training kernel reads the bitgrid packed to one bit a cell in tiles
of ``PACKED_TILE`` cells, one 128-byte line each (:func:`pack_bitgrid`),
and the density in bricks of ``BRICK``³ voxels (:func:`brick_density`),
both built once by :meth:`WalkVolume.of` (:func:`packed_bit` and
:func:`brick_index` address them as the kernel does); the render kernels
and the twins read the 128³ uint8 grid and the (X, Y, Z) density.

Random draws: the kernels and the twins draw from one counter-based
stream, a 32-bit integer hash of (seed, step, row, iteration, stream)
computed in ``uint32`` in CUDA and in int64 masked to 32 bits here
(:class:`HashDraws`); a uniform is its top 24 bits times 2^-24, exact in
float32. The logarithm and the sine and cosine of the Box–Muller normal
are polynomials in +, −, ×, ÷ (:func:`vlog`, :func:`sincos_2pi`), written
in one order here and in the kernel, which is compiled with
``-fmad=false``: the kernels equal their twins bit for bit on the card.
The twins also take explicit per-iteration arrays (:class:`ArrayDraws`),
which the tests fill from the JAX engine's key schedule.

:func:`volume_train_walk` and :func:`volume_render_walk` pick by the
device of the volume or the positions: the twin for CPU tensors, the
kernel for CUDA tensors, which launches or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ngp_tpu_torch.ops.bvh import dot3
from ngp_tpu_torch.ops.cuda_build import CudaKernel, launch_on
from ngp_tpu_torch.ops.marching import ray_aabb_range

MAX_TRAIN_VERTICES = 4  # testbed_volume.cu:85
MAX_WALK_ITERS = 512  # the JAX engine's lockstep bound
BITGRID_RES = 128
PACKED_TILE = (8, 8, 16)  # bit cells (x, y, z) of one 32-word tile of the packed bitgrid
BRICK = 4  # voxels a side of a brick of the training kernel's density
CHECK_EVERY = 16  # twin iterations between gathers of the live rows
START_ITERATION = MAX_WALK_ITERS  # the draws of an episode's start
_U32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float (a scalar operand that
    a float32 tensor op uses unchanged)."""
    return float(np.float32(x))


# the polynomials' constants, each a float32 value (the kernel's literals)
_LN2_HI, _LN2_LO, _SQRT2 = _f32(0.693145751953125), _f32(1.42860677e-06), _f32(1.41421354)
_LOG_C = tuple(_f32(2.0 / k) for k in (3, 5, 7, 9, 11))
_PI_4 = _f32(0.785398185)
_SIN_C = tuple(_f32(c) for c in (-1 / 6, 1 / 120, -1 / 5040, 1 / 362880, -1 / 39916800))
_COS_C = tuple(_f32(c) for c in (-1 / 2, 1 / 24, -1 / 720, 1 / 40320, -1 / 3628800))
_EPS = _f32(1e-12)
_DT_MIN, _DT_PAD, _OPAQUE = _f32(1e-3), _f32(1e-5), _f32(0.99)
_ENTRY = _f32(1e-6)  # how far past the slab test's entry a walk starts
# the sun's colour, (255, 215, 195) / 255 in float32 (the JAX package's
# float32 division; PyTorch would multiply a CUDA tensor by 1/255)
_SUN_COL = tuple(float(np.float32(c) / np.float32(255.0)) for c in (255.0, 215.0, 195.0))

_vp, _i, _ll, _u = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint
# bits, packed bits, density, bricks, X, Y, Z, params, key
_VOLUME = [_vp, _vp, _vp, _vp, _ll, _ll, _ll, _vp, _u]
N_PARAMS = 14
N_ENVMAP = 12
VOLUME_WALK = CudaKernel(
    "volume_walk.cu",
    {
        "volume_train_walk": (_i, _VOLUME + [_vp, _ll, _vp, _vp, _vp, _vp, _vp]),
        "volume_render_walk": (_i, _VOLUME + [_i, _vp, _vp, _vp, _vp, _vp, _ll, _vp, _vp,
                                              _vp, _vp, _vp]),
        "volume_walk_error_string": (ctypes.c_char_p, [_i]),
    },
    ("volume_train_walk", "volume_render_walk"),
    flags=("-fmad=false",),
)


class WalkVolume(NamedTuple):
    """What a walk reads of a ``data/volume.DenseVolume``, on one device:
    the bitgrid (128³ uint8) and its packed copy (:func:`pack_bitgrid`),
    the density (X, Y, Z float32) and its copy in bricks
    (:func:`brick_density`), the AABB (3,) float32 tensors, the
    world→index scale and offset, the global majorant, the free-flight
    scale (distance scale over majorant), and ``box``: the kernels' first
    12 parameters as Python floats (:meth:`params`), so that a launch reads
    no device tensor."""

    bitgrid: torch.Tensor
    density: torch.Tensor
    aabb_min: torch.Tensor
    aabb_max: torch.Tensor
    w2i_scale: float
    w2i_offset: torch.Tensor
    majorant: float
    flight_scale: float
    packed: torch.Tensor
    bricks: torch.Tensor
    box: tuple

    @staticmethod
    def of(volume, distance_scale: float, device) -> "WalkVolume":
        def f32(a):
            return np.asarray(a, np.float32)

        def t(a):
            return torch.as_tensor(f32(a), device=device)

        scale, majorant = _f32(volume.world2index_scale), _f32(volume.global_majorant)
        flight = _f32(distance_scale / volume.global_majorant)
        box = tuple(float(x) for a in (volume.aabb_min, volume.aabb_max,
                                       volume.world2index_offset) for x in f32(a))
        bitgrid, density = volume.bitgrid.to(device), volume.density.to(device)
        return WalkVolume(bitgrid, density, t(volume.aabb_min), t(volume.aabb_max), scale,
                          t(volume.world2index_offset), majorant, flight,
                          pack_bitgrid(bitgrid), brick_density(density),
                          box + (scale, majorant, flight))

    def params(self, albedo: float = 0.0, scattering: float = 0.0) -> list:
        """The kernels' float parameters, in their order: the AABB's min and
        max, the world→index offset, scale, the majorant, the flight scale,
        the albedo and the scattering, each a float32 value."""
        return [*self.box, _f32(albedo), _f32(scattering)]


def pack_bitgrid(bitgrid: torch.Tensor) -> torch.Tensor:
    """The 128³ bitgrid at one bit a cell, as the kernels read it:
    ``PACKED_TILE`` = 8 × 8 × 16 cells a tile of 32 int32 words (128 bytes,
    one cache line), tiles in (x, y, z) order, and in a tile the cell
    (x % 8, y % 8, z % 16) at bit ((x % 8)·8 + y % 8)·16 + z % 16, word by
    word from the lowest bit. Returns (65,536,) int32 on the grid's
    device."""
    R = BITGRID_RES
    tx, ty, tz = PACKED_TILE
    b = (bitgrid != 0).reshape(R // tx, tx, R // ty, ty, R // tz, tz)
    b = b.permute(0, 2, 4, 1, 3, 5).reshape(-1, 32, 32).long()
    words = (b << torch.arange(32, device=b.device)).sum(-1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32).reshape(-1)


def packed_bit(packed: torch.Tensor, cells: torch.Tensor) -> torch.Tensor:
    """The bits of integer ``cells`` (n, 3) in [0, 128) of a packed bitgrid,
    addressed as the kernels address them (``bit_occupied``)."""
    x, y, z = cells.long().unbind(-1)
    tile = ((x // 8) * 16 + y // 8) * 8 + z // 16
    bit = ((x % 8) * 8 + y % 8) * 16 + z % 16
    word = packed[tile * 32 + bit // 32].long() & _U32
    return ((word >> (bit % 32)) & 1) == 1


def brick_density(density: torch.Tensor) -> torch.Tensor:
    """The (X, Y, Z) density in bricks of ``BRICK``³ voxels, as the
    training kernel reads it: each axis padded with zeros to a multiple of
    ``BRICK``, bricks in (x, y, z) order and the voxels of a brick too.
    Returns a flat float32 tensor on the density's device."""
    B = BRICK
    X, Y, Z = density.shape
    padded = torch.nn.functional.pad(density, (0, -Z % B, 0, -Y % B, 0, -X % B))
    b = padded.reshape(-(-X // B), B, -(-Y // B), B, -(-Z // B), B)
    return b.permute(0, 2, 4, 1, 3, 5).reshape(-1).contiguous()


def brick_index(cells: torch.Tensor, shape) -> torch.Tensor:
    """The indices into :func:`brick_density`'s output of integer voxel
    ``cells`` (n, 3) of a density of ``shape`` (X, Y, Z), as the training
    kernel computes them (``density_at``)."""
    B = BRICK
    _, Y, Z = shape
    x, y, z = cells.long().unbind(-1)
    brick = ((x // B) * -(-Y // B) + y // B) * -(-Z // B) + z // B
    return ((brick * B + x % B) * B + y % B) * B + z % B


def envmap_params(up_dir, sun_dir, sky_col) -> list:
    """The training kernel's sky parameters: up, sun direction, sky
    colour and the sun's colour, each a float32 value."""
    return [_f32(c) for v in (up_dir, sun_dir, sky_col) for c in v] + list(_SUN_COL)


# -- the random stream


def fmix32(x):
    """A 32-bit integer hash (Wellons' lowbias32) of values in [0, 2^32):
    int64 tensors masked to 32 bits after each product, or Python ints."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _U32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _U32
    return x ^ (x >> 16)


def draw_key(seed: int, step: int) -> int:
    """The stream's key of (seed, step), a Python int in [0, 2^32)."""
    return fmix32(fmix32((seed & _U32) ^ _GOLDEN) ^ (step & _U32))


def row_keys(key: int, rows: torch.Tensor) -> torch.Tensor:
    """Each row's key (int64 holding uint32) from the stream's key."""
    return fmix32(rows.long() ^ key)


def _bits(keys: torch.Tensor, it, stream: int) -> torch.Tensor:
    counter = ((torch.as_tensor(it, device=keys.device).long() * 16 + stream) * _GOLDEN) & _U32
    return fmix32(keys ^ counter)


def uniform(keys: torch.Tensor, it, stream: int) -> torch.Tensor:
    """A float32 uniform in [0, 1): the hash's top 24 bits times 2^-24."""
    return (_bits(keys, it, stream) >> 8).to(torch.float32) * 2.0 ** -24


def uniform_open(keys: torch.Tensor, it, stream: int) -> torch.Tensor:
    """A float32 uniform in (0, 1]."""
    return ((_bits(keys, it, stream) >> 8) + 1).to(torch.float32) * 2.0 ** -24


def vlog(x: torch.Tensor) -> torch.Tensor:
    """Natural logarithm of positive normal float32 ``x`` in +, −, ×, ÷
    (the kernel's ``vlog``): x = 2^e·m with m in [√½, √2), log m =
    2·atanh(s), s = (m − 1)/(m + 1), by its odd series to s^11; within
    2 ulp of ``torch.log``."""
    bits = x.view(torch.int32)
    e = (bits >> 23) - 127
    m = ((bits & 0x7FFFFF) | 0x3F800000).view(torch.float32)
    big = m > _SQRT2
    m = torch.where(big, m * 0.5, m)
    e = (e + big.to(torch.int32)).to(torch.float32)
    f = m - 1.0
    s = f / (f + 2.0)
    s2 = s * s
    p = _LOG_C[4]
    for c in _LOG_C[3::-1]:
        p = s2 * p + c
    lm = (s + s) + s * (s2 * p)
    return e * _LN2_HI + (e * _LN2_LO + lm)


def sincos_2pi(u: torch.Tensor):
    """(cos, sin) of 2πu for float32 ``u`` in [0, 1) in +, −, ×, ÷ (the
    kernel's ``sincos_2pi``): the octant of 8u and Taylor polynomials on
    [0, π/4]."""
    t = u * 8.0
    q = torch.floor(t)
    f = t - q
    qi = q.to(torch.int32)
    y = torch.where((qi & 1) == 1, 1.0 - f, f)
    x = y * _PI_4
    x2 = x * x
    ps = _SIN_C[4]
    for c in _SIN_C[3::-1]:
        ps = x2 * ps + c
    s = x + x * (x2 * ps)
    pc = _COS_C[4]
    for c in _COS_C[3::-1]:
        pc = x2 * pc + c
    c = 1.0 + x2 * pc
    swap = ((qi + 1) & 2) != 0
    a, b = torch.where(swap, s, c), torch.where(swap, c, s)
    return torch.where(((qi + 2) & 4) != 0, -a, a), torch.where(qi >= 4, -b, b)


def normal3(keys: torch.Tensor, it, stream: int) -> torch.Tensor:
    """(n, 3) standard normals by Box–Muller from streams ``stream`` …
    ``stream + 3``: (r₁cos θ₁, r₁sin θ₁, r₂cos θ₂), r = √(−2 log u),
    u in (0, 1]."""
    r1 = torch.sqrt(-2.0 * vlog(uniform_open(keys, it, stream)))
    c1, s1 = sincos_2pi(uniform(keys, it, stream + 1))
    r2 = torch.sqrt(-2.0 * vlog(uniform_open(keys, it, stream + 2)))
    c2, _ = sincos_2pi(uniform(keys, it, stream + 3))
    return torch.stack([r1 * c1, r1 * s1, r2 * c2], dim=-1)


class HashDraws:
    """A walk's draws from the counter-based stream of ``key``.
    ``rows(ids)`` binds draw rows ``ids`` (int64); at iteration ``it`` (an
    int, or a tensor of one per row) the bound rows then draw the free
    flight's uniform (``u``, stream 0), the density lookup's jitter (1-3),
    the collision's uniform (``z``, 4) and the scattering normal (5-8)."""

    def __init__(self, key: int):
        self.key = key

    def rows(self, ids: torch.Tensor) -> "_HashRows":
        return _HashRows(row_keys(self.key, ids))


class _HashRows:
    def __init__(self, keys):
        self.keys = keys

    def u(self, it):
        return uniform(self.keys, it, 0)

    def jitter(self, it):
        return torch.stack([uniform(self.keys, it, s) for s in (1, 2, 3)], dim=-1)

    def z(self, it):
        return uniform(self.keys, it, 4)

    def normal(self, it):
        return normal3(self.keys, it, 5)


class ArrayDraws:
    """A walk's draws from explicit arrays: ``u`` (I, N), ``jitter``
    (I, N, 3), ``z`` (I, N), ``normal`` (I, N, 3), indexed by iteration
    and draw row (what the JAX engine's keys draw, for comparisons)."""

    def __init__(self, u, jitter=None, z=None, normal=None):
        self.arrays = {"u": u, "jitter": jitter, "z": z, "normal": normal}

    def rows(self, ids: torch.Tensor) -> "_ArrayRows":
        return _ArrayRows(self.arrays, ids)


class _ArrayRows:
    def __init__(self, arrays, ids):
        self.arrays, self.ids = arrays, ids

    def _at(self, name, it):
        a = self.arrays[name]
        return a[torch.as_tensor(it, device=a.device).long(), self.ids.to(a.device)]

    def u(self, it):
        return self._at("u", it)

    def jitter(self, it):
        return self._at("jitter", it)

    def z(self, it):
        return self._at("z", it)

    def normal(self, it):
        return self._at("normal", it)


def start_draws(key: int, n: int, device):
    """An episode's start draws: a normal (n, 3) (streams 0-3) and a
    uniform (n, 3) (streams 4-6) at iteration ``START_ITERATION``."""
    keys = row_keys(key, torch.arange(n, device=device))
    return (normal3(keys, START_ITERATION, 0),
            torch.stack([uniform(keys, START_ITERATION, s) for s in (4, 5, 6)], dim=-1))


# -- the walk's pieces (the JAX engine's methods)


def normalize(v):
    return v / torch.sqrt(dot3(v, v))[..., None]


def proc_envmap(dirs, up_dir, sun_dir, sky_col):
    """Procedural sun and sky (``proc_envmap``, ``testbed_volume.cu:46-60``;
    the JAX package's ``proc_envmap``): (n, 3) radiance of unit ``dirs``,
    in the training kernel's order: dot products as ``dot3`` sums them,
    the sun's power 64 as six squarings (as ``x ** 64`` is in JAX), the
    parameters and the sun's colour float32 scalars."""
    up, sun, sky = (tuple(_f32(c) for c in v) for v in (up_dir, sun_dir, sky_col))
    skyam = (dirs[:, 0] * up[0] + dirs[:, 1] * up[1] + dirs[:, 2] * up[2]) * 0.5 + 0.5
    sunam = torch.clamp_min(dirs[:, 0] * sun[0] + dirs[:, 1] * sun[1] + dirs[:, 2] * sun[2],
                            0.0)
    for _ in range(6):
        sunam = sunam * sunam
    sun_power = 20.0 * sunam
    return torch.stack([skyam * sky[c] + sun_power * _SUN_COL[c] for c in range(3)], dim=-1)


def extinction(vol: WalkVolume, density: torch.Tensor) -> torch.Tensor:
    """density / majorant, divided by a 0-dim tensor on the density's
    device: PyTorch takes a CUDA tensor over a Python scalar as a product
    with the scalar's reciprocal, which rounds otherwise than the kernel's
    division."""
    return density / density.new_full((), vol.majorant)


def bit_occupied(vol: WalkVolume, pos: torch.Tensor) -> torch.Tensor:
    """Whether unit-cube ``pos`` (n, 3) lies in an occupied cell of the 128³
    bitgrid (``_bit_occupied``, ``engines/volume.py:78-84``); cells are
    centred on integers, outside the grid is empty."""
    f = torch.floor(pos * float(BITGRID_RES) + 0.5)
    ok = torch.all((f >= 0) & (f < BITGRID_RES), dim=-1)
    i = torch.where(ok[:, None], f, 0.0).long()
    flat = (i[:, 0] * BITGRID_RES + i[:, 1]) * BITGRID_RES + i[:, 2]
    return ok & (vol.bitgrid.view(-1)[flat] > 0)


def density_at(vol: WalkVolume, pos: torch.Tensor, jitter: torch.Tensor) -> torch.Tensor:
    """The jittered nearest-voxel density at ``pos`` (``_density_at``,
    ``engines/volume.py:86-96``): the index-space position plus ``jitter``
    (n, 3) in [0, 1), floored; 0 outside the array. int64 voxel indices."""
    X, Y, Z = vol.density.shape
    f = torch.floor(pos * vol.w2i_scale + vol.w2i_offset + jitter)
    shape = torch.tensor([X, Y, Z], dtype=torch.float32, device=pos.device)
    ok = torch.all((f >= 0) & (f < shape), dim=-1)
    i = torch.where(ok[:, None], f, 0.0).long()
    flat = (i[:, 0] * Y + i[:, 1]) * Z + i[:, 2]
    return torch.where(ok, vol.density.view(-1)[flat], 0.0)


def jump(vol: WalkVolume, pos, dirs, alive, u):
    """One delta-tracking advance of each row (``_jump``,
    ``engines/volume.py:98-124``): a free flight of −log(max(1 − u,
    1e-12))·scale where the current bit cell is occupied, else a skip to
    the next bit-cell boundary (a component with |d| ≤ 1e-12 taken as
    +1e-12, the skip clipped to [1e-3, 128] cells, plus 1e-5). Returns
    (positions, at_event, alive): a row leaving the AABB dies; an event is
    a live row landing in an occupied cell from an occupied cell."""
    occ = bit_occupied(vol, pos)
    dt_w = -vlog(torch.clamp_min(1.0 - u, _EPS)) * vol.flight_scale
    p = pos * float(BITGRID_RES)
    boundary = torch.floor(p + 0.5) + 0.5 * torch.sign(dirs)
    t = (boundary - p) / torch.where(torch.abs(dirs) > _EPS, dirs, _EPS)
    t = torch.where(t > 0, t, float("inf"))
    dt_skip = torch.clamp(t.amin(dim=-1), _DT_MIN, float(BITGRID_RES)) / float(BITGRID_RES)
    dt = torch.where(occ, dt_w, dt_skip + _DT_PAD)
    newpos = torch.where(alive[:, None], pos + dirs * dt[:, None], pos)
    inside = torch.all((newpos >= vol.aabb_min) & (newpos <= vol.aabb_max), dim=-1)
    alive = alive & inside
    return newpos, alive & occ & bit_occupied(vol, newpos), alive


# -- the twins


def training_walk(vol: WalkVolume, pos, dirs, alive, draws, albedo: float, scattering: float):
    """Plain PyTorch twin of ``volume_train_walk``: the loop of
    ``generate_training_data`` (``engines/volume.py:128-205``) for episodes
    at ``pos``, ``dirs`` (E, 3), ``alive`` (E,) bool, episode ``e`` drawing
    row ``e`` of ``draws``. Each iteration: a :func:`jump`; at an event the
    jittered density, recorded in the next of ``MAX_TRAIN_VERTICES`` slots
    while one is free; a collision is real with probability
    density/majorant, a scatter (a new direction from the normal, mixed
    with the old by ``scattering``) with ``albedo`` of that, else an
    absorption, which ends the episode at throughput 0. An episode walks
    until it dies or ``MAX_WALK_ITERS`` iterations pass; later scatters
    still turn it after its slots are full. Only the live episodes are
    computed, and only the events draw more than the flight's uniform.
    Returns (vertices (E, 4, 3), densities (E, 4), slots filled (E,)
    int32, final directions (E, 3), throughput (E,), iterations walked
    (E,) int32)."""
    E = pos.shape[0]
    dev = pos.device
    out_pos = torch.zeros((E, MAX_TRAIN_VERTICES, 3), dtype=torch.float32, device=dev)
    out_den = torch.zeros((E, MAX_TRAIN_VERTICES), dtype=torch.float32, device=dev)
    cursor = torch.zeros((E,), dtype=torch.int64, device=dev)
    thr = torch.ones((E,), dtype=torch.float32, device=dev)
    steps = torch.zeros((E,), dtype=torch.int32, device=dev)
    pos, dirs, alive = pos.clone(), dirs.clone(), alive.clone()
    it = 0
    while it < MAX_WALK_ITERS:
        rows = alive.nonzero()[:, 0]
        if rows.numel() == 0:
            break
        p, d, a = pos[rows], dirs[rows], alive[rows]
        row_draws = draws.rows(rows)
        for _ in range(min(CHECK_EVERY, MAX_WALK_ITERS - it)):
            steps[rows] += a.to(torch.int32)
            p, ev, a = jump(vol, p, d, a, row_draws.u(it))
            e = ev.nonzero()[:, 0]
            if e.numel():
                ep = rows[e]
                at = draws.rows(ep)
                den = density_at(vol, p[e], at.jitter(it))
                c = cursor[ep]
                slot = c < MAX_TRAIN_VERTICES
                out_pos[ep[slot], c[slot]] = p[e][slot]
                out_den[ep[slot], c[slot]] = den[slot]
                cursor[ep] = c + slot.long()
                ext = extinction(vol, den)
                z = at.z(it)
                real = z < ext
                scatter = real & (z < ext * _f32(albedo))
                absorb = real & ~scatter
                s = scatter.nonzero()[:, 0]
                if s.numel():
                    nd = d[e[s]] * _f32(scattering) + normalize(draws.rows(ep[s]).normal(it))
                    d[e[s]] = normalize(nd)
                thr[ep[absorb]] = 0.0
                a[e[absorb]] = False
            it += 1
        pos[rows], dirs[rows], alive[rows] = p, d, a
    return out_pos, out_den, cursor.to(torch.int32), dirs, thr, steps


def training_data(vol: WalkVolume, key: int, n: int, albedo: float, scattering: float,
                  envmap, start=None, draws=None):
    """Plain PyTorch twin of ``volume_train_walk``: a step's training data
    as the JAX engine's ``generate_training_data`` makes it
    (``engines/volume.py:128-205``), for ``n`` episodes of stream ``key``.
    Each episode starts on the sphere of radius 2 about the box's centre
    (a normal draw, normalised) toward a uniform point of the box
    (:func:`start_draws`, or ``start`` = (normal (n, 3), uniform (n, 3))),
    enters 1e-6 past the slab test's entry, walks (:func:`training_walk`,
    drawing from ``draws`` if given) and supervises its vertices with the
    sky (``envmap`` = (up, sun direction, sky colour), :func:`proc_envmap`)
    along its final direction times its throughput. Returns (positions
    (n·4, 3), targets (n·4, 4) [rgb, density], valid (n·4,) bool,
    iterations walked (n,) int32)."""
    dev = vol.density.device
    d1, ut = start if start is not None else start_draws(key, n, dev)
    origin = normalize(d1) * 2.0 + 0.5
    target = vol.aabb_min + ut * (vol.aabb_max - vol.aabb_min)
    dirs = normalize(target - origin)
    tmin, tmax = ray_aabb_range(origin, dirs, vol.aabb_min, vol.aabb_max)
    pos = origin + dirs * (tmin + _ENTRY)[:, None]
    out_pos, out_den, cursor, dirs, thr, steps = training_walk(
        vol, pos, dirs, tmin <= tmax, draws or HashDraws(key), albedo, scattering)
    sky = proc_envmap(dirs, *envmap) * thr[:, None]
    V = MAX_TRAIN_VERTICES
    valid = (torch.arange(V, device=dev)[None, :] < cursor[:, None]).reshape(-1)
    targets = torch.cat([sky[:, None, :].expand(n, V, 3).reshape(-1, 3),
                         out_den.reshape(-1, 1)], dim=-1)
    return out_pos.reshape(-1, 3), targets, valid, steps


def render_walk(vol: WalkVolume, pos, dirs, alive, draws, gt: bool, iters=None, ids=None):
    """Plain PyTorch twin of ``volume_render_walk``.

    Ground truth (``gt``): the frame's loop (``_render_rays``,
    ``engines/volume.py:259-298``) of rays at ``pos``, ``dirs`` (B, 3),
    ``alive`` (B,) through the volume's own density, rgb 1: at an event
    ``a = clip(density/majorant, 0, 1)·(1 − opa)`` adds to ``col`` and
    ``opa``; a ray stops once opa > 0.99. Returns (col (B, 3), opa (B,),
    iterations walked (B,) int32), col before the sky.

    Learned (not ``gt``), one round of the event wavefront: each live ray
    (``alive``, iteration counter ``iters`` (B,) int32, draw row ``ids``
    (B,) int64) advances until its next event, its death or iteration
    ``MAX_WALK_ITERS``. Returns (positions, alive, iters, event (B,) bool);
    a ray left alive is at an event, where the caller evaluates the model,
    composites and updates ``alive``. A non-event iteration of the JAX loop
    adds ``rgb·0`` and 0, so the rounds give its result."""
    B = pos.shape[0]
    dev = pos.device
    if ids is None:
        ids = torch.arange(B, device=dev)
    if not gt:
        pos, alive, iters = pos.clone(), alive.clone(), iters.clone()
        event = torch.zeros_like(alive)
        active = alive & (iters < MAX_WALK_ITERS)
        while True:
            rows = active.nonzero()[:, 0]
            if rows.numel() == 0:
                break
            p, ev, a = jump(vol, pos[rows], dirs[rows], alive[rows],
                            draws.rows(ids[rows]).u(iters[rows]))
            pos[rows], alive[rows], event[rows] = p, a, ev
            iters[rows] += 1
            active[rows] = a & ~ev & (iters[rows] < MAX_WALK_ITERS)
        return pos, alive & event, iters, event
    col = torch.zeros((B, 3), dtype=torch.float32, device=dev)
    opa = torch.zeros((B,), dtype=torch.float32, device=dev)
    steps = torch.zeros((B,), dtype=torch.int32, device=dev)
    pos, alive = pos.clone(), alive.clone()
    it = 0
    while it < MAX_WALK_ITERS:
        rows = alive.nonzero()[:, 0]
        if rows.numel() == 0:
            break
        p, d, a = pos[rows], dirs[rows], alive[rows]
        row_draws = draws.rows(ids[rows])
        for _ in range(min(CHECK_EVERY, MAX_WALK_ITERS - it)):
            steps[rows] += a.to(torch.int32)
            p, ev, a = jump(vol, p, d, a, row_draws.u(it))
            e = ev.nonzero()[:, 0]
            if e.numel():
                r = rows[e]
                den = density_at(vol, p[e], draws.rows(ids[r]).jitter(it))
                add = torch.clamp(extinction(vol, den), 0.0, 1.0) * (1.0 - opa[r])
                col[r] = col[r] + add[:, None]
                opa[r] = opa[r] + add
                a[e] = opa[r] <= _OPAQUE
            it += 1
        pos[rows], alive[rows] = p, a
    return col, opa, steps


# -- dispatch by device


def volume_train_walk(vol: WalkVolume, key: int, n: int, albedo: float, scattering: float,
                      envmap, start=None, draws=None):
    """A step's training data (see :func:`training_data`) of ``n``
    episodes of stream ``key``: the twin where the volume lies on the CPU
    (``start`` and ``draws`` replace the stream's starts and walk draws),
    the kernel on the card. Returns (positions, targets, valid)."""
    if vol.density.device.type == "cpu":
        return training_data(vol, key, n, albedo, scattering, envmap, start, draws)[:3]
    if start is not None or draws is not None:
        raise ValueError("the volume_train_walk kernel draws from its key; explicit draws "
                         "and starts are for the CPU twin")
    return volume_train_walk_cuda(vol, key, n, albedo, scattering, envmap)


def volume_render_walk(vol: WalkVolume, pos, dirs, alive, key: int, gt: bool, iters=None,
                       ids=None, draws=None):
    """The render walk (see :func:`render_walk`) of stream ``key``: the
    twin on the CPU (``draws`` replaces the stream), the kernel on the
    card. Ground truth returns (col, opa); learned the round's outputs."""
    if pos.device.type == "cpu":
        out = render_walk(vol, pos, dirs, alive, draws or HashDraws(key), gt, iters, ids)
        return out[:2] if gt else out
    if draws is not None:
        raise ValueError("the volume_render_walk kernel draws from its key; explicit draws "
                         "are for the CPU twin")
    return volume_render_walk_cuda(vol, pos, dirs, alive, key, gt, iters, ids)


# -- the kernels


def _check(cond: bool, msg: str, fn: str):
    if not cond:
        raise ValueError(f"{fn}: {msg}")


def _check_volume(fn: str, vol: WalkVolume, dev):
    _check(dev.type == "cuda", f"the walk's tensors must lie on a CUDA device, got {dev}", fn)
    R = BITGRID_RES
    for name, t, dtype, dims in (("bitgrid", vol.bitgrid, torch.uint8, 3),
                                 ("packed", vol.packed, torch.int32, 1),
                                 ("density", vol.density, torch.float32, 3)):
        _check(t.dtype == dtype and t.dim() == dims, f"{name} must be {dims}-D {dtype}", fn)
        _check(t.device == dev and t.is_contiguous(),
               f"{name} must be contiguous on {dev}", fn)
    _check(tuple(vol.bitgrid.shape) == (R, R, R), f"bitgrid must be {R}³", fn)
    _check(vol.packed.numel() == R ** 3 // 32, f"packed must hold {R ** 3 // 32} words", fn)
    bricks = int(np.prod([-(-n // BRICK) * BRICK for n in vol.density.shape]))
    _check(vol.bricks.dtype == torch.float32 and vol.bricks.device == dev
           and vol.bricks.is_contiguous() and vol.bricks.numel() == bricks,
           f"bricks must be {bricks} contiguous float32 on {dev}", fn)


def _check_rows(fn: str, dev, n: int, **tensors):
    for name, (t, dtype, width) in tensors.items():
        shape = (n,) if width is None else (n, width)
        _check(t.dtype == dtype and tuple(t.shape) == shape,
               f"{name} must be {shape} {dtype}, got {tuple(t.shape)} {t.dtype}", fn)
        _check(t.device == dev and t.is_contiguous(), f"{name} must be contiguous on {dev}",
               fn)


def _volume_args(vol: WalkVolume, key: int, albedo: float = 0.0, scattering: float = 0.0):
    """The kernels' volume arguments, from host values only (no device
    read, so no synchronisation)."""
    X, Y, Z = vol.density.shape
    params = (ctypes.c_float * N_PARAMS)(*vol.params(albedo, scattering))
    return (vol.bitgrid.data_ptr(), vol.packed.data_ptr(), vol.density.data_ptr(),
            vol.bricks.data_ptr(), X, Y, Z, params, key & _U32)


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _raise_on(lib, rc: int, fn: str):
    if rc != 0:
        msg = lib.volume_walk_error_string(rc).decode()
        raise RuntimeError(f"{fn} launch failed: {msg} ({rc})")


def volume_train_walk_cuda(vol: WalkVolume, key: int, n: int, albedo: float,
                           scattering: float, envmap, steps=None):
    """Launch ``volume_train_walk`` of ``csrc/volume_walk.cu`` on the
    current stream: a thread an episode draws its start, walks and writes
    its 4 slots' training data; returns the twin's (positions (n·4, 3),
    targets (n·4, 4), valid (n·4,) bool), on the volume's device.
    ``steps``, an (n,) int32 tensor, receives each episode's iterations
    (measurements; no path asks for it). Raises on any input the kernel
    does not take and on a refused launch."""
    fn = "volume_train_walk_cuda"
    dev = vol.density.device
    _check_volume(fn, vol, dev)
    _check(n >= 0, f"episodes must be >= 0, got {n}", fn)
    if steps is not None:
        _check_rows(fn, dev, n, steps=(steps, torch.int32, None))
    V = MAX_TRAIN_VERTICES
    positions = torch.empty((n * V, 3), dtype=torch.float32, device=dev)
    targets = torch.empty((n * V, 4), dtype=torch.float32, device=dev)
    valid = torch.empty((n * V,), dtype=torch.bool, device=dev)
    if n == 0:
        return positions, targets, valid
    lib = VOLUME_WALK.library()
    env = (ctypes.c_float * N_ENVMAP)(*envmap_params(*envmap))
    rc = launch_on(dev, lambda stream: lib.volume_train_walk(
        *_volume_args(vol, key, albedo, scattering), env, n, positions.data_ptr(),
        targets.data_ptr(), valid.data_ptr(), _ptr(steps), stream))
    _raise_on(lib, rc, "volume_train_walk")
    VOLUME_WALK.launches["volume_train_walk"] += 1
    return positions, targets, valid


def volume_render_walk_cuda(vol: WalkVolume, pos, dirs, alive, key: int, gt: bool,
                            iters=None, ids=None, steps=None):
    """Launch ``volume_render_walk`` of ``csrc/volume_walk.cu`` on the
    current stream, a thread a ray. Ground truth: (col, opa) of the whole
    walk; ``steps`` (B,) int32 receives each ray's iterations. Learned: one
    round, in place on ``pos``, ``alive`` and ``iters`` (int32); returns
    (pos, alive, iters, event). Raises on any input the kernel does not
    take and on a refused launch."""
    fn = "volume_render_walk_cuda"
    dev = pos.device
    _check_volume(fn, vol, dev)
    B = pos.shape[0]
    _check_rows(fn, dev, B, pos=(pos, torch.float32, 3), dirs=(dirs, torch.float32, 3),
                alive=(alive, torch.bool, None))
    if gt:
        _check(iters is None and ids is None, "a ground-truth walk takes no iters or ids", fn)
        if steps is not None:
            _check_rows(fn, dev, B, steps=(steps, torch.int32, None))
        col = torch.empty((B, 3), dtype=torch.float32, device=dev)
        opa = torch.empty((B,), dtype=torch.float32, device=dev)
        event = None
    else:
        _check(steps is None, "a learned round counts its iterations in iters", fn)
        _check_rows(fn, dev, B, iters=(iters, torch.int32, None), ids=(ids, torch.int64, None))
        col = opa = None
        event = torch.empty((B,), dtype=torch.bool, device=dev)
    if B > 0:
        lib = VOLUME_WALK.library()
        rc = launch_on(dev, lambda stream: lib.volume_render_walk(
            *_volume_args(vol, key), int(gt), _ptr(ids), pos.data_ptr(), dirs.data_ptr(),
            alive.data_ptr(), _ptr(iters), B, _ptr(col), _ptr(opa), _ptr(event), _ptr(steps),
            stream))
        _raise_on(lib, rc, "volume_render_walk")
        VOLUME_WALK.launches["volume_render_walk"] += 1
    return (col, opa) if gt else (pos, alive, iters, event)

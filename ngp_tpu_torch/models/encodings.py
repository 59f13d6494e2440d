"""Input encodings as ``nn.Module``s: the port of
``ngp_tpu/models/encodings.py`` (the Takikawa encoding, which needs the
SDF mesh's octree, is ``models/takikawa.py``).

``GridEncoding`` (Hash, Dense and Tiled grids, Linear and Simplex
interpolation, XOR or additive hash) runs through
:func:`ngp_tpu_torch.ops.hashgrid.hashgrid_encode` forward,
:func:`~ngp_tpu_torch.ops.hashgrid.hashgrid_backward` for d(table) and,
with ``differentiable_inputs=True``,
:func:`~ngp_tpu_torch.ops.hashgrid.hashgrid_input_grad` for d(positions):
CUDA kernels on the card, their plain twins on the CPU. Spherical
harmonics (degree ≤ 4), Identity, Frequency, TriangleWave, OneBlob and
Composite are plain tensor code without parameters; autograd gives their
input gradients.

Every module maps ``(N, n_input_dims)`` float32 in the encoding's domain
([0, 1] for grids and SH) to ``(N, n_output_dims)`` float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ngp_tpu_torch.device import resolve_device
from ngp_tpu_torch.ops.hashgrid import (
    hashgrid_backward,
    hashgrid_encode,
    hashgrid_input_grad,
)


def _next_multiple(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class _GridEncode(torch.autograd.Function):
    """Grid forward (kernel B1) whose backward is one kernel, the JAX
    package's ``_pge_bwd``: d(table) float32 for the float32 master table,
    addends rounded to bf16 (the JAX package's default
    ``batched_segment_sum`` payload). Positions get no gradient, as in the
    JAX package's training path."""

    @staticmethod
    def forward(ctx, table, x, enc, max_level):
        read = table.to(torch.bfloat16) if enc.bf16_reads else table
        ctx.save_for_backward(x)
        ctx.enc, ctx.max_level, ctx.table_shape = enc, max_level, table.shape
        return hashgrid_encode(
            x, read.contiguous(), enc.level_scale, enc.level_res,
            enc.level_size, enc.level_hashed, enc.hash_variant, max_level,
            enc.interpolation,
        )

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        enc = ctx.enc
        dtable = hashgrid_backward(
            x, g.contiguous(), enc.level_scale, enc.level_res, enc.level_size,
            enc.level_hashed, enc.hash_variant, ctx.max_level,
            ctx.table_shape[1], interpolation=enc.interpolation,
        )
        return dtable, None, None, None


class _GridEncodeInputs(torch.autograd.Function):
    """Grid forward (kernel B1) differentiable in the positions: the JAX
    package's ``differentiable_inputs=True`` path, plain autodiff of float32
    gathers. The table is read in float32 whatever ``bf16_reads`` says.
    The backward returns dx (kernel ``hashgrid_input_grad``) where the
    positions need it and d(table) with unrounded float32 addends where the
    table needs it. ``needs_input_grad`` follows ``requires_grad``, not the
    inputs an ``autograd.grad`` call asks for: a caller that wants dx alone
    passes a table that does not require grad."""

    @staticmethod
    def forward(ctx, table, x, enc, max_level):
        table = table.contiguous()
        ctx.save_for_backward(table, x)
        ctx.enc, ctx.max_level = enc, max_level
        return hashgrid_encode(
            x, table, enc.level_scale, enc.level_res, enc.level_size,
            enc.level_hashed, enc.hash_variant, max_level, enc.interpolation,
        )

    @staticmethod
    def backward(ctx, g):
        table, x = ctx.saved_tensors
        enc = ctx.enc
        geo = (enc.level_scale, enc.level_res, enc.level_size, enc.level_hashed,
               enc.hash_variant)
        g = g.contiguous()
        dtable = dx = None
        if ctx.needs_input_grad[1]:
            dx = hashgrid_input_grad(x, g, table, *geo, ctx.max_level, enc.interpolation)
        if ctx.needs_input_grad[0]:
            dtable = hashgrid_backward(x, g, *geo, ctx.max_level, table.shape[1],
                                       payload_dtype="float32",
                                       interpolation=enc.interpolation)
        return dtable, dx, None, None


class GridEncoding(nn.Module):
    """Multiresolution hash, dense or tiled grid (tcnn convention, as the
    JAX package): ``scale_l = 2^(l·log2(b))·N_min − 1``, ``res_l =
    ceil(scale_l) + 1``; a level stores ``min(next_multiple(res^D, 8),
    2^log2_hashmap_size)`` rows; a Hash grid hashes a level whose ``res^D``
    does not fit, a Tiled grid wraps its clipped linear index (uint32)
    modulo the level's rows, a Dense grid stores ``res^D`` rows. Parameters:
    one ``(L, T, F)`` float32 ``table``. ``interpolation`` "Linear" blends
    the 2^D cell corners, "Simplex" the D + 1 corners of the JAX package's
    Kuhn simplex (not tcnn's).

    Table reads follow the JAX package's dtypes: where it takes its
    corner-duplicated fast path (Linear, the additive hash, a Hash or Dense
    grid) it reads ``dup_gather_dtype`` rows, by default bf16-rounded
    ("packed_bf16", F even); elsewhere (the XOR hash, Tiled grids, Simplex)
    it reads ``gather_dtype`` rows, float32 by default. The blend itself is
    float32 either way. With ``differentiable_inputs=True`` rows are read
    in float32.

    d(table) sums per-corner addends rounded to bf16 in float32; with
    ``differentiable_inputs=True`` the addends are float32."""

    def __init__(self, n_input_dims: int = 3, n_levels: int = 16,
                 n_features_per_level: int = 2, log2_hashmap_size: int = 19,
                 base_resolution: int = 16, per_level_scale: float = 2.0,
                 grid_type: str = "Hash", interpolation: str = "Linear",
                 gather_dtype: str = "float32", hash_variant: str = "tcnn",
                 dup_gather_dtype: str = "packed_bf16", device="cuda"):
        super().__init__()
        if n_input_dims not in (2, 3):
            raise ValueError(f"grid encoding supports 2D/3D, got {n_input_dims}")
        if grid_type not in ("Hash", "Dense", "Tiled"):
            raise ValueError(f"unsupported grid_type {grid_type!r} "
                             "(Hash | Dense | Tiled)")
        if interpolation not in ("Linear", "Simplex"):
            raise ValueError(f"unsupported interpolation {interpolation!r} "
                             "(Linear | Simplex)")
        if hash_variant not in ("tcnn", "additive"):
            raise ValueError(f"unsupported hash_variant {hash_variant!r} "
                             "(tcnn | additive)")
        if gather_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unsupported gather_dtype {gather_dtype!r}")
        if dup_gather_dtype not in ("packed_bf16", "float32"):
            raise ValueError(f"unsupported dup_gather_dtype {dup_gather_dtype!r}")
        self.n_input_dims = n_input_dims
        self.n_levels = n_levels
        self.n_features_per_level = n_features_per_level
        self.log2_hashmap_size = log2_hashmap_size
        self.base_resolution = base_resolution
        self.per_level_scale = per_level_scale
        self.grid_type = grid_type
        self.interpolation = interpolation
        self.gather_dtype = gather_dtype
        self.hash_variant = hash_variant
        self.dup_gather_dtype = dup_gather_dtype
        dev = resolve_device(device)
        scales, res, sizes, hashed = self.level_geometry()
        self.register_buffer("level_scale", torch.as_tensor(scales, device=dev))
        self.register_buffer("level_res", torch.as_tensor(res, device=dev))
        self.register_buffer("level_size", torch.as_tensor(sizes, device=dev))
        self.register_buffer(
            "level_hashed", torch.as_tensor(hashed.astype(np.int32), device=dev)
        )
        self.table = nn.Parameter(torch.zeros(
            (n_levels, int(sizes.max()), n_features_per_level),
            dtype=torch.float32, device=dev,
        ))

    @property
    def table_size(self) -> int:
        return 1 << self.log2_hashmap_size

    def level_geometry(self):
        """Per-level (scale f32, resolution i32, rows i32, hashed bool)."""
        ls = math.log2(self.per_level_scale)
        scales, res, sizes, hashed = [], [], [], []
        for l in range(self.n_levels):
            s = 2.0 ** (l * ls) * self.base_resolution - 1.0
            r = int(math.ceil(s)) + 1
            dense = r ** self.n_input_dims
            if self.grid_type == "Dense":
                size, h = dense, False
            else:
                size = min(_next_multiple(dense, 8), self.table_size)
                # Tiled wraps its linear index; Hash switches to the hash
                h = self.grid_type == "Hash" and dense > size
            scales.append(s)
            res.append(r)
            sizes.append(size)
            hashed.append(h)
        return (
            np.asarray(scales, np.float32),
            np.asarray(res, np.int32),
            np.asarray(sizes, np.int32),
            np.asarray(hashed, np.bool_),
        )

    @property
    def n_output_dims(self) -> int:
        return self.n_levels * self.n_features_per_level

    @property
    def n_params(self) -> int:
        return int(self.level_geometry()[2].sum()) * self.n_features_per_level

    @property
    def max_table_rows(self) -> int:
        return int(self.level_geometry()[2].max())

    @property
    def bf16_reads(self) -> bool:
        """Whether table rows are read rounded to bf16 (see class doc)."""
        if (self.interpolation == "Linear" and self.hash_variant == "additive"
                and self.grid_type != "Tiled"):  # the JAX pairs_eligible
            return (self.dup_gather_dtype == "packed_bf16"
                    and self.n_features_per_level % 2 == 0)
        return self.gather_dtype == "bfloat16"

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """tcnn's init: features ~ U(-1e-4, 1e-4), drawn on the CPU from
        ``generator`` so that every device gets the same table."""
        t = torch.rand(self.table.shape, generator=generator) * 2e-4 - 1e-4
        self.table.copy_(t)

    def forward(self, x: torch.Tensor, max_level: int | None = None,
                differentiable_inputs: bool = False):
        """(N, D) positions in [0, 1] → (N, L·F); levels above ``max_level``
        are zero, gradients included (the reference's coarse-to-fine
        ``set_max_level``). Gradients reach ``table`` only, unless
        ``differentiable_inputs`` (the JAX package's flag of the same name:
        float32 table reads, gradients to ``x`` and ``table``)."""
        if differentiable_inputs:
            return _GridEncodeInputs.apply(self.table, x.contiguous(), self,
                                           max_level)
        return _GridEncode.apply(self.table, x.detach().contiguous(), self,
                                 max_level)


def sh_basis_deg4(d: torch.Tensor) -> torch.Tensor:
    """Real spherical-harmonics basis, degrees 0..3 (16 coefficients), on
    unit directions ``d`` (N, 3), tcnn's hard-coded polynomial form."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    xy, xz, yz = x * y, x * z, y * z
    x2, y2, z2 = x * x, y * y, z * z
    cols = [
        torch.full_like(x, 0.28209479177387814),
        -0.48860251190291987 * y,
        0.48860251190291987 * z,
        -0.48860251190291987 * x,
        1.0925484305920792 * xy,
        -1.0925484305920792 * yz,
        0.94617469575755997 * z2 - 0.31539156525251999,
        -1.0925484305920792 * xz,
        0.54627421529603959 * (x2 - y2),
        0.59004358992664352 * y * (-3.0 * x2 + y2),
        2.8906114426405538 * xy * z,
        0.45704579946446572 * y * (1.0 - 5.0 * z2),
        0.3731763325901154 * z * (5.0 * z2 - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * z2),
        1.4453057213202769 * z * (x2 - y2),
        0.59004358992664352 * x * (-x2 + 3.0 * y2),
    ]
    return torch.stack(cols, dim=-1)


class SphericalHarmonicsEncoding(nn.Module):
    """SH encoding of directions given in the reference's warped [0, 1]³
    form, mapped to [-1, 1] before the basis, like tcnn."""

    def __init__(self, n_input_dims: int = 3, degree: int = 4):
        super().__init__()
        if n_input_dims != 3 or not 1 <= degree <= 4:
            raise ValueError(
                f"SphericalHarmonics supports 3 input dims and degree 1..4, "
                f"got {n_input_dims} dims, degree {degree}"
            )
        self.n_input_dims = n_input_dims
        self.degree = degree

    @property
    def n_output_dims(self) -> int:
        return self.degree * self.degree

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return sh_basis_deg4(x * 2.0 - 1.0)[:, : self.n_output_dims]


class IdentityEncoding(nn.Module):
    def __init__(self, n_input_dims: int = 3, scale: float = 1.0,
                 offset: float = 0.0):
        super().__init__()
        self.n_input_dims = n_input_dims
        self.scale = scale
        self.offset = offset

    @property
    def n_output_dims(self) -> int:
        return self.n_input_dims

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale + self.offset


class FrequencyEncoding(nn.Module):
    """NeRF's frequency encoding: per dimension d and frequency f, (sin,
    cos) of ``x_d · 2^f · π``, laid out (d, f, sin|cos)."""

    n_params = 0

    def __init__(self, n_input_dims: int = 3, n_frequencies: int = 12):
        super().__init__()
        self.n_input_dims = n_input_dims
        self.n_frequencies = n_frequencies

    @property
    def n_output_dims(self) -> int:
        return self.n_input_dims * self.n_frequencies * 2

    def _freqs(self, x):
        return torch.tensor([2.0 ** f for f in range(self.n_frequencies)],
                            dtype=torch.float32, device=x.device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ang = x[:, :, None] * self._freqs(x) * math.pi  # (N, D, F)
        return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(
            x.shape[0], self.n_output_dims)


class TriangleWaveEncoding(FrequencyEncoding):
    """tcnn's triangle wave, a cheap stand-in for Frequency: per dimension d
    and frequency f, ``|2·frac(x_d · 2^f / 2) − 1| · 2 − 1``. The absolute
    value is a select, so that its gradient at 0 is 1 as JAX's ``abs``
    differentiates (``torch.abs`` gives 0 there)."""

    @property
    def n_output_dims(self) -> int:
        return self.n_input_dims * self.n_frequencies

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        v = x[:, :, None] * self._freqs(x) / 2.0
        u = (v - torch.floor(v)) * 2.0 - 1.0
        return (torch.where(u >= 0.0, u, -u) * 2.0 - 1.0).reshape(x.shape[0], self.n_output_dims)


class OneBlobEncoding(nn.Module):
    """OneBlob (Müller et al., Neural Importance Sampling): each input in
    [0, 1] splatted as a quartic kernel of radius 2 bins, integrated over
    ``n_bins`` uniform bins (the kernel's CDF at the bin edges)."""

    n_params = 0

    def __init__(self, n_input_dims: int = 3, n_bins: int = 16):
        super().__init__()
        self.n_input_dims = n_input_dims
        self.n_bins = n_bins

    @property
    def n_output_dims(self) -> int:
        return self.n_input_dims * self.n_bins

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = self.n_bins
        edges = torch.arange(n + 1, dtype=torch.float32, device=x.device) / n
        u = torch.clamp((edges - x[:, :, None]) * (n / 2.0), -1.0, 1.0)
        c = 0.5 + u * (15.0 / 16.0 + u * u * (-10.0 / 16.0 + u * u * 3.0 / 16.0))
        return (c[:, :, 1:] - c[:, :, :-1]).reshape(x.shape[0], self.n_output_dims)


class CompositeEncoding(nn.Module):
    """Concatenation of nested encodings over consecutive input slices
    (tcnn's Composite; the reference's dir encoding is SH on the first 3
    dims plus Identity on the latent extras)."""

    def __init__(self, nested: list[tuple[nn.Module, int]]):
        super().__init__()
        self.nested = nn.ModuleList(enc for enc, _ in nested)
        self.dims = [n for _, n in nested]

    @property
    def n_input_dims(self) -> int:
        return sum(self.dims)

    @property
    def n_output_dims(self) -> int:
        return sum(e.n_output_dims for e in self.nested)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs, off = [], 0
        for enc, n in zip(self.nested, self.dims):
            outs.append(enc(x[:, off : off + n]))
            off += n
        return torch.cat(outs, dim=-1)

"""The Takikawa (NGLOD) octree encoding, the port of
``ngp_tpu/models/takikawa.py`` (the reference's
``takikawa_encoding.cuh:28-468``).

A position's feature at each output level (octree depths
``starting_level`` … ``max_depth − 1``) is the trilinear blend of the
feature rows of its voxel's 8 dual vertices; a level whose voxel is not
in the octree outputs zeros. The parameters are one (n_vertices, F) table
over the octree's dual vertices, the reference's topology.

The forward is a gather and a weighted sum of 8 rows (plain PyTorch: the
JAX package runs an XLA gather there too). The table gradient is
``batched_segment_sum`` of the corners' bf16-rounded ``w·g`` by vertex id,
one level holding every output level's corners (the JAX package's
``grid_gather_blend`` VJP, ``ngp_tpu/models/encodings.py:292-304``): on the
card the CUDA ``segment_sum`` kernel (``csrc/segment_sum.cu``, B2), on the
CPU its twin. With ``differentiable_inputs=True`` autograd differentiates
the gather and the fractions (float32 addends), for the positions'
gradient that the SDF normals need.
"""

from __future__ import annotations

import torch
from torch import nn

from ngp_tpu_torch.device import resolve_device
from ngp_tpu_torch.geometry.triangle_octree import TriangleOctree
from ngp_tpu_torch.ops.segsum import batched_segment_sum

_BITS = [[(c >> dim) & 1 for c in range(8)] for dim in range(3)]


class _GatherBlend(torch.autograd.Function):
    """``out[r] = Σ_c w[r, c]·table[idx[r, c]]`` for rows r of (R, 8) ids
    and weights; d(table) by :func:`batched_segment_sum` with bf16
    addends. Neither ids nor weights get a gradient."""

    @staticmethod
    def forward(ctx, table, idx, w):
        ctx.save_for_backward(idx, w)
        ctx.n_rows = table.shape[0]
        return _blend(table, idx, w)

    @staticmethod
    def backward(ctx, g):
        idx, w = ctx.saved_tensors
        F = g.shape[-1]
        vals = (w[..., None] * g[:, None, :]).to(torch.float32).reshape(1, -1, F)
        keys = idx.reshape(1, -1).to(torch.int32).contiguous()
        dtable = batched_segment_sum(keys, vals.contiguous(), ctx.n_rows,
                                     payload_dtype="bfloat16")[0]
        return dtable, None, None


def _blend(table, idx, w):
    feats = table[idx.reshape(-1).long()].reshape(idx.shape + (table.shape[-1],))
    return torch.sum(feats * w[..., None], dim=-2)


class TakikawaEncoding(nn.Module):
    """``otype: "Takikawa"`` over ``octree`` (a :class:`TriangleOctree` on
    ``device``): ``n_levels = max_depth − starting_level`` output levels of
    ``n_features_per_level`` features, concatenated level-major (the
    reference's ``data_out``) or summed with ``sum_instead_of_concat``.
    One parameter, ``table`` (n_vertices, F) float32 (the name puts it in
    the optimizer's sparse-Adam group)."""

    def __init__(self, octree: TriangleOctree, starting_level: int = 0,
                 n_features_per_level: int = 2, sum_instead_of_concat: bool = False,
                 device="cuda"):
        super().__init__()
        if octree is None:
            raise ValueError("the Takikawa encoding needs a TriangleOctree (built from "
                             "the scene mesh, reference testbed.cu:4082-4098)")
        if not 0 <= starting_level < octree.max_depth:
            raise ValueError(f"starting_level {starting_level} is outside "
                             f"[0, {octree.max_depth})")
        self.octree = octree
        self.starting_level = starting_level
        self.n_features_per_level = n_features_per_level
        self.sum_instead_of_concat = sum_instead_of_concat
        self.n_input_dims = 3
        dev = resolve_device(device)
        # corner c's offset bit along x, y, z: (3, 8), on the device once
        self.register_buffer("corner_bits", torch.tensor(_BITS, dtype=torch.float32, device=dev))
        self.table = nn.Parameter(torch.zeros((octree.n_vertices, n_features_per_level),
                                              dtype=torch.float32, device=dev))

    @property
    def n_levels(self) -> int:
        return self.octree.max_depth - self.starting_level

    @property
    def n_output_dims(self) -> int:
        if self.sum_instead_of_concat:
            return self.n_features_per_level
        return self.n_levels * self.n_features_per_level

    @property
    def n_params(self) -> int:
        return self.octree.n_vertices * self.n_features_per_level

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """Features ~ U(-1e-4, 1e-4) (the grids' init), drawn on the CPU
        from ``generator``."""
        t = torch.rand(self.table.shape, generator=generator) * 2e-4 - 1e-4
        self.table.copy_(t)

    def gather_plan(self, x: torch.Tensor):
        """Per output level: the vertex ids (L, N, 8) int32 and the
        trilinear weights (L, N, 8) float32, 0 where the level's voxel is
        empty. Corner c's weight is the product over x, y, z of ``bit·frac +
        (1 − bit)·(1 − frac)`` in the JAX package's order, so that the
        weights equal its weights bit for bit."""
        ids, ws = [], []
        for d in range(self.starting_level, self.octree.max_depth):
            found, vid, frac = self.octree.lookup_level(d, x)
            w = torch.ones((x.shape[0], 8), dtype=torch.float32, device=x.device)
            for dim in range(3):
                bit = self.corner_bits[dim][None, :]
                f = frac[:, dim:dim + 1]
                w = w * (bit * f + (1.0 - bit) * (1.0 - f))
            ids.append(vid)
            ws.append(torch.where(found[:, None], w, 0.0))
        return torch.stack(ids), torch.stack(ws)

    def forward(self, x: torch.Tensor, max_level: int | None = None,
                differentiable_inputs: bool = False) -> torch.Tensor:
        """(N, 3) positions in [0, 1]³ → (N, n_output_dims); output levels
        above ``max_level`` are zero. Gradients reach ``table`` only,
        unless ``differentiable_inputs`` (then ``x`` too, by autograd)."""
        if not differentiable_inputs:
            x = x.detach()
        L, N = self.n_levels, x.shape[0]
        idx, w = self.gather_plan(x)
        if max_level is not None:
            keep = torch.arange(L, device=x.device) <= max_level
            w = torch.where(keep[:, None, None], w, 0.0)
        if differentiable_inputs:
            out = _blend(self.table, idx, w)
        else:
            out = _GatherBlend.apply(self.table, idx.reshape(L * N, 8), w.reshape(L * N, 8))
        out = out.reshape(L, N, self.n_features_per_level)
        if self.sum_instead_of_concat:
            return torch.sum(out, dim=0)
        return out.transpose(0, 1).reshape(N, -1)

"""NeRF network: hash-grid density MLP plus SH-conditioned rgb MLP, the
port of ``ngp_tpu/models/nerf_network.py``:

  density_feat = density_mlp(pos_encoding(x))        # 16 wide
  rgb          = rgb_mlp(cat(density_feat, dir_encoding(d, extra)))
  output       = cat(rgb[:, :3], density_feat[:, :1])

Outputs are raw; the engine applies the activations, as the reference's
compositing kernels do.
"""

from __future__ import annotations

import torch
from torch import nn

from ngp_tpu_torch.models.encodings import GridEncoding


class NerfNetwork(nn.Module):
    def __init__(self, pos_encoding: nn.Module, dir_encoding: nn.Module,
                 density_mlp: nn.Module, rgb_mlp: nn.Module):
        super().__init__()
        self.pos_encoding = pos_encoding
        self.dir_encoding = dir_encoding
        self.density_mlp = density_mlp
        self.rgb_mlp = rgb_mlp

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """Draw every parameter from ``generator`` (a CPU generator), in the
        order position encoding, density MLP, rgb MLP."""
        for m in (self.pos_encoding, self.density_mlp, self.rgb_mlp):
            if hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def density(self, pos: torch.Tensor, max_level: int | None = None,
                differentiable_inputs: bool = False):
        """Raw density-network output (N, 16); channel 0 is raw log-density.
        ``differentiable_inputs=True`` lets d(out)/d(pos) flow through a
        grid encoding (analytic normals, camera refinement)."""
        kwargs = {} if max_level is None else {"max_level": max_level}
        if differentiable_inputs and isinstance(self.pos_encoding, GridEncoding):
            kwargs["differentiable_inputs"] = True
        return self.density_mlp(self.pos_encoding(pos, **kwargs))

    def forward(self, pos: torch.Tensor, dirs: torch.Tensor,
                extra: torch.Tensor | None = None,
                max_level: int | None = None,
                differentiable_inputs: bool = False) -> torch.Tensor:
        """(N, 3) warped positions and (N, 3) warped directions (plus
        extras) → (N, 4) raw [r, g, b, sigma]."""
        feat = self.density(pos, max_level=max_level,
                            differentiable_inputs=differentiable_inputs)
        dir_in = dirs if extra is None else torch.cat([dirs, extra], dim=-1)
        rgb = self.rgb_mlp(torch.cat([feat, self.dir_encoding(dir_in)], dim=-1))
        return torch.cat([rgb[:, :3], feat[:, :1]], dim=-1)

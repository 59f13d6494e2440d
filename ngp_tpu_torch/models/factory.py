"""JSON → module factories, the port of ``ngp_tpu/models/factory.py``
(tcnn's ``create_encoding`` / ``create_network``), so reference-format
configs build the port's modules unchanged."""

from __future__ import annotations

import torch
from torch import nn

from ngp_tpu_torch.models.encodings import (
    CompositeEncoding,
    FrequencyEncoding,
    GridEncoding,
    IdentityEncoding,
    OneBlobEncoding,
    SphericalHarmonicsEncoding,
    TriangleWaveEncoding,
)
from ngp_tpu_torch.models.mlp import MLP
from ngp_tpu_torch.models.nerf_network import NerfNetwork
from ngp_tpu_torch.ops.losses import get_loss


def create_encoding(n_input_dims: int, cfg: dict, device="cuda", octree=None):
    """The encoding of a config's ``encoding`` block on ``device``;
    ``octree`` (a ``geometry/triangle_octree.TriangleOctree``) is the one a
    Takikawa encoding is built over, which raises without it."""
    otype = cfg.get("otype", "Identity").lower()
    if otype == "takikawa":
        from ngp_tpu_torch.models.takikawa import TakikawaEncoding

        if octree is None:
            raise ValueError("the Takikawa encoding needs a TriangleOctree (built from "
                             "the scene mesh, reference testbed.cu:4082-4098)")
        return TakikawaEncoding(
            octree,
            starting_level=cfg.get("starting_level", 0),
            n_features_per_level=cfg.get("n_features_per_level", 2),
            sum_instead_of_concat=cfg.get("sum_instead_of_concat", False),
            device=device,
        )
    if otype in ("hashgrid", "densegrid", "tiledgrid", "grid"):
        grid_type = {"hashgrid": "Hash", "densegrid": "Dense", "tiledgrid": "Tiled"}.get(
            otype, cfg.get("type", "Hash")
        )
        return GridEncoding(
            n_input_dims=n_input_dims,
            n_levels=cfg.get("n_levels", 16),
            n_features_per_level=cfg.get("n_features_per_level", 2),
            log2_hashmap_size=cfg.get("log2_hashmap_size", 19),
            base_resolution=cfg.get("base_resolution", 16),
            per_level_scale=cfg.get("per_level_scale", 2.0),
            grid_type=grid_type,
            interpolation=cfg.get("interpolation", "Linear"),
            hash_variant=cfg.get("hash_variant", "tcnn"),
            gather_dtype=cfg.get("gather_dtype", "float32"),
            dup_gather_dtype=cfg.get("dup_gather_dtype", "packed_bf16"),
            device=device,
        )
    if otype == "sphericalharmonics":
        return SphericalHarmonicsEncoding(n_input_dims, cfg.get("degree", 4))
    if otype == "identity":
        return IdentityEncoding(
            n_input_dims, cfg.get("scale", 1.0), cfg.get("offset", 0.0)
        )
    if otype == "frequency":
        return FrequencyEncoding(n_input_dims, cfg.get("n_frequencies", 12))
    if otype == "trianglewave":
        return TriangleWaveEncoding(n_input_dims, cfg.get("n_frequencies", 12))
    if otype == "oneblob":
        return OneBlobEncoding(n_input_dims, cfg.get("n_bins", 16))
    if otype == "composite":
        nested_cfgs = cfg["nested"]
        nested, remaining = [], n_input_dims
        for i, sub in enumerate(nested_cfgs):
            nd = sub.get("n_dims_to_encode")
            if nd is None:
                nd = remaining - sum(
                    s.get("n_dims_to_encode", 0) for s in nested_cfgs[i + 1 :]
                )
            nested.append((create_encoding(nd, sub, device, octree), nd))
            remaining -= nd
        return CompositeEncoding(nested)
    raise ValueError(f"unknown encoding otype {cfg.get('otype')!r}")


def create_network(n_input_dims: int, n_output_dims: int, cfg: dict,
                   device="cuda") -> MLP:
    otype = cfg.get("otype", "FullyFusedMLP").lower()
    if otype not in ("fullyfusedmlp", "cutlassmlp", "megakernelmlp", "mlp"):
        raise ValueError(f"unknown network otype {cfg.get('otype')!r}")
    return MLP(
        n_input_dims=n_input_dims,
        n_output_dims=n_output_dims,
        n_neurons=cfg.get("n_neurons", 64),
        n_hidden_layers=cfg.get("n_hidden_layers", 2),
        activation=cfg.get("activation", "ReLU"),
        output_activation=cfg.get("output_activation", "None"),
        device=device,
    )


def create_loss(cfg: dict):
    """The elementwise loss ``loss(target, prediction)`` of a config's
    ``loss`` block (L2 when it names none)."""
    return get_loss(cfg.get("otype", "L2"))


class NetworkWithInputEncoding(nn.Module):
    """Encoding → MLP composition, tcnn's ``NetworkWithInputEncoding`` that
    the image, SDF and volume modes train (reference
    ``src/testbed.cu:4101-4110``). A grid encoding runs B1 forward and the
    fused grid backward (``GridEncoding``)."""

    def __init__(self, encoding: nn.Module, network: MLP):
        super().__init__()
        self.encoding = encoding
        self.network = network

    @classmethod
    def from_config(cls, n_input_dims: int, n_output_dims: int, cfg: dict,
                    device="cuda", octree=None) -> "NetworkWithInputEncoding":
        enc = create_encoding(n_input_dims, cfg["encoding"], device, octree)
        net = create_network(enc.n_output_dims, n_output_dims, cfg["network"], device)
        return cls(enc, net)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """The encoding's init, then the MLP's, drawn on the CPU from
        ``generator``."""
        if hasattr(self.encoding, "reset_parameters"):
            self.encoding.reset_parameters(generator)
        self.network.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.network(self.encoding(x))

    @property
    def n_params(self) -> int:
        return getattr(self.encoding, "n_params", 0) + self.network.n_params


def create_network_with_input_encoding(n_input_dims: int, n_output_dims: int,
                                       cfg: dict, device="cuda",
                                       octree=None) -> NetworkWithInputEncoding:
    """Parameters start at zero; fill them with ``reset_parameters`` or
    ``interop.load_jax_params``. ``octree``: as :func:`create_encoding`."""
    return NetworkWithInputEncoding.from_config(n_input_dims, n_output_dims, cfg, device,
                                                octree)


def create_nerf_network(cfg: dict, n_extra_dims: int = 0,
                        device="cuda") -> NerfNetwork:
    """Build the two-stage NeRF network from a reference-format config
    (sections ``encoding``, ``network``, ``dir_encoding``,
    ``rgb_network``). Parameters start at zero; fill them with
    ``reset_parameters(generator)`` or ``interop.load_jax_params``."""
    pos_enc = create_encoding(3, cfg["encoding"], device)
    dir_enc = create_encoding(3 + n_extra_dims, cfg["dir_encoding"], device)
    density_cfg = dict(cfg["network"])
    density_out = density_cfg.get("n_output_dims", 16)
    density_mlp = create_network(
        pos_enc.n_output_dims, density_out, density_cfg, device
    )
    rgb_mlp = create_network(
        density_out + dir_enc.n_output_dims, 3, cfg["rgb_network"], device
    )
    return NerfNetwork(pos_enc, dir_enc, density_mlp, rgb_mlp)

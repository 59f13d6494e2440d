"""Weights across packages: the JAX package's ``NerfNetwork`` parameter
pytree, as numpy arrays, to and from the port's modules.

The tree layout is the JAX package's::

    {"pos_encoding": {"table": (L, T, F)},
     "dir_encoding": {...},                  # {} or {"nested_i": {...}}
     "density_mlp": {"weights": [(in, out), ...]},
     "rgb_mlp": {"weights": [(in, out), ...]}}

``data/ingp_snapshot.params_from_reference`` produces the same layout from
a reference ``.ingp`` snapshot.
"""

from __future__ import annotations

import numpy as np
import torch

from ngp_tpu_torch.models.encodings import CompositeEncoding, GridEncoding
from ngp_tpu_torch.models.mlp import MLP


def _copy(param: torch.Tensor, value, name: str):
    arr = np.array(value, np.float32)  # a writable copy
    if tuple(arr.shape) != tuple(param.shape):
        raise ValueError(
            f"{name}: tree has shape {arr.shape}, module {tuple(param.shape)}"
        )
    with torch.no_grad():
        param.copy_(torch.from_numpy(arr))


def _load_encoding(enc, tree: dict, name: str):
    if isinstance(enc, GridEncoding):
        _copy(enc.table, tree["table"], f"{name}.table")
    elif isinstance(enc, CompositeEncoding):
        for i, sub in enumerate(enc.nested):
            _load_encoding(sub, tree.get(f"nested_{i}", {}), f"{name}.nested_{i}")


def _export_encoding(enc) -> dict:
    if isinstance(enc, GridEncoding):
        return {"table": enc.table.detach().cpu().numpy().copy()}
    if isinstance(enc, CompositeEncoding):
        return {f"nested_{i}": _export_encoding(s) for i, s in enumerate(enc.nested)}
    return {}


def _load_mlp(mlp: MLP, tree: dict, name: str):
    ws = tree["weights"]
    if len(ws) != len(mlp.weights):
        raise ValueError(f"{name}: tree has {len(ws)} layers, module "
                         f"{len(mlp.weights)}")
    for i, (p, w) in enumerate(zip(mlp.weights, ws)):
        _copy(p, w, f"{name}.weights[{i}]")


def load_jax_params(network, tree: dict):
    """Fill ``network`` (the port's ``NerfNetwork``) from a JAX-layout
    parameter tree of numpy (or array-like) leaves. Raises on any shape
    mismatch. Returns ``network``."""
    _load_encoding(network.pos_encoding, tree["pos_encoding"], "pos_encoding")
    _load_encoding(network.dir_encoding, tree.get("dir_encoding", {}),
                   "dir_encoding")
    _load_mlp(network.density_mlp, tree["density_mlp"], "density_mlp")
    _load_mlp(network.rgb_mlp, tree["rgb_mlp"], "rgb_mlp")
    return network


def export_jax_params(network) -> dict:
    """The port's ``NerfNetwork`` parameters as a JAX-layout tree of numpy
    float32 arrays (the inverse of :func:`load_jax_params`)."""
    return {
        "pos_encoding": _export_encoding(network.pos_encoding),
        "dir_encoding": _export_encoding(network.dir_encoding),
        "density_mlp": {"weights": [
            w.detach().cpu().numpy().copy() for w in network.density_mlp.weights
        ]},
        "rgb_mlp": {"weights": [
            w.detach().cpu().numpy().copy() for w in network.rgb_mlp.weights
        ]},
    }

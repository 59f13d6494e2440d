"""Weights and training state across packages: the JAX package's
``NerfNetwork`` parameter pytree and ``TrainState``, as numpy arrays, to
and from the port's modules.

The tree layout is the JAX package's::

    {"pos_encoding": {"table": (L, T, F)},
     "dir_encoding": {...},                  # {} or {"nested_i": {...}}
     "density_mlp": {"weights": [(in, out), ...]},
     "rgb_mlp": {"weights": [(in, out), ...]}}

``data/ingp_snapshot.params_from_reference`` produces the same layout from
a reference ``.ingp`` snapshot.

A training state is the tree::

    {"step": int,
     "params": <model tree>,
     "opt": {"dense": {"count": int, "mu": <tree>, "nu": <tree>},
             "grid": {"count": int, "mu": <tree>, "nu": <tree>}},
     "ema": <model tree> or None}

where a group's ``mu``/``nu`` trees hold that group's leaves only (the
tables for ``"grid"``, the MLP weights for ``"dense"``), laid out as in
the model tree: the JAX package's optax states restricted to the model.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ngp_tpu_torch.models.encodings import CompositeEncoding, GridEncoding
from ngp_tpu_torch.models.mlp import MLP
from ngp_tpu_torch.optim import GROUPS, AdamState, param_groups
from ngp_tpu_torch.train import TrainState


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


def _path(name: str):
    """A parameter name (``density_mlp.weights.0``) as tree keys."""
    return [int(k) if k.isdigit() else k for k in name.split(".")]


def _tree_get(tree, name: str):
    for k in _path(name):
        tree = tree[k]
    return tree


def _tree_set(tree: dict, name: str, value):
    keys = _path(name)
    for k, nxt in zip(keys[:-1], keys[1:]):
        if isinstance(tree, list):
            while len(tree) <= k:
                tree.append(None)
        elif k not in tree:
            tree[k] = [] if isinstance(nxt, int) else {}
        tree = tree[k]
    if isinstance(tree, list):
        while len(tree) <= keys[-1]:
            tree.append(None)
    tree[keys[-1]] = value


def _tensor_like(param: torch.Tensor, value, name: str) -> torch.Tensor:
    t = torch.empty_like(param)
    _copy(t, value, name)
    return t


def load_jax_train_state(network, tree: dict) -> TrainState:
    """A ``TrainState`` of ``network`` (the port's ``NerfNetwork``, filled
    in place) from a training-state tree (module docstring)."""
    load_jax_params(network, tree["params"])
    groups = param_groups(network)
    opt = {}
    for g in GROUPS:
        st = tree["opt"][g]
        opt[g] = AdamState(
            int(st["count"]),
            [_tensor_like(p, _tree_get(st["mu"], n), f"opt.{g}.mu.{n}")
             for n, p in groups[g]],
            [_tensor_like(p, _tree_get(st["nu"], n), f"opt.{g}.nu.{n}")
             for n, p in groups[g]],
        )
    ema = None
    if tree.get("ema") is not None:
        ema = load_jax_params(copy.deepcopy(network), tree["ema"]).requires_grad_(False)
    return TrainState(int(tree["step"]), network, opt, ema)


def export_jax_train_state(state: TrainState) -> dict:
    """The training-state tree (module docstring) of a port ``TrainState``;
    an EMA not yet started is the model itself, as the JAX package's
    ``ema_init`` makes it."""
    groups = param_groups(state.model)
    opt = {}
    for g in GROUPS:
        st = state.opt_state[g]
        mu, nu = {}, {}
        for (name, _), m, v in zip(groups[g], st.mu, st.nu):
            _tree_set(mu, name, m.detach().cpu().numpy().copy())
            _tree_set(nu, name, v.detach().cpu().numpy().copy())
        opt[g] = {"count": st.count, "mu": mu, "nu": nu}
    return {
        "step": state.step,
        "params": export_jax_params(state.model),
        "opt": opt,
        "ema": export_jax_params(state.inference_model()),
    }

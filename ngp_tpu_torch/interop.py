"""Weights and training state across packages: the JAX package's
``NerfNetwork`` and ``NetworkWithInputEncoding`` parameter pytrees and
``TrainState``, as numpy arrays, to and from the port's modules.

The tree layouts are the JAX package's::

    {"pos_encoding": {"table": (L, T, F)},   # NerfNetwork
     "dir_encoding": {...},                  # {} or {"nested_i": {...}}
     "density_mlp": {"weights": [(in, out), ...]},
     "rgb_mlp": {"weights": [(in, out), ...]}}

    {"encoding": {"table": (L, T, F)},       # NetworkWithInputEncoding
     "network": {"weights": [(in, out), ...]}}

where a Takikawa encoding's table is ``{"table": (V, F)}``.

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
A NeRF state's camera group adds::

     "camera": <camera tree>, "camera_ema": <camera tree> or None,
     "opt": {..., "camera": {"count": int, "mu": <camera tree>,
                             "nu": <camera tree>}}

where a camera tree is the JAX engine's ``params["camera"]``
(``{"distortion", "exposure", "focal", "latents", "pos", "rot"}``), and
the count is the camera Adam's and its schedule's (the JAX engine steps
both once an update). Its environment map adds, in the same way,
``"envmap"``, ``"envmap_ema"`` and ``opt["envmap"]``, each an envmap tree
``{"image": (H, W, 4)}`` (the JAX engine's ``params["envmap"]``).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ngp_tpu_torch.models.encodings import CompositeEncoding, GridEncoding
from ngp_tpu_torch.models.factory import NetworkWithInputEncoding
from ngp_tpu_torch.models.mlp import MLP
from ngp_tpu_torch.models.takikawa import TakikawaEncoding
from ngp_tpu_torch.optim import GROUPS, AdamState, adam_init, param_groups
from ngp_tpu_torch.train import CameraParams, EnvmapParams, TrainState


def _copy(param: torch.Tensor, value, name: str):
    arr = np.array(value, np.float32)  # a writable copy
    if tuple(arr.shape) != tuple(param.shape):
        raise ValueError(
            f"{name}: tree has shape {arr.shape}, module {tuple(param.shape)}"
        )
    with torch.no_grad():
        param.copy_(torch.from_numpy(arr))


_TABLED = (GridEncoding, TakikawaEncoding)  # encodings whose parameter is one table


def _load_encoding(enc, tree: dict, name: str):
    if isinstance(enc, _TABLED):
        _copy(enc.table, tree["table"], f"{name}.table")
    elif isinstance(enc, CompositeEncoding):
        for i, sub in enumerate(enc.nested):
            _load_encoding(sub, tree.get(f"nested_{i}", {}), f"{name}.nested_{i}")


def _export_encoding(enc) -> dict:
    if isinstance(enc, _TABLED):
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
    """Fill ``network`` (the port's ``NerfNetwork`` or
    ``NetworkWithInputEncoding``) from a JAX-layout parameter tree of
    numpy (or array-like) leaves. Raises on any shape mismatch. Returns
    ``network``."""
    if isinstance(network, NetworkWithInputEncoding):
        _load_encoding(network.encoding, tree.get("encoding", {}), "encoding")
        _load_mlp(network.network, tree["network"], "network")
        return network
    _load_encoding(network.pos_encoding, tree["pos_encoding"], "pos_encoding")
    _load_encoding(network.dir_encoding, tree.get("dir_encoding", {}),
                   "dir_encoding")
    _load_mlp(network.density_mlp, tree["density_mlp"], "density_mlp")
    _load_mlp(network.rgb_mlp, tree["rgb_mlp"], "rgb_mlp")
    return network


def _export_mlp(mlp: MLP) -> dict:
    return {"weights": [w.detach().cpu().numpy().copy() for w in mlp.weights]}


def export_jax_params(network) -> dict:
    """The port's ``NerfNetwork`` or ``NetworkWithInputEncoding``
    parameters as a JAX-layout tree of numpy float32 arrays (the inverse of
    :func:`load_jax_params`)."""
    if isinstance(network, NetworkWithInputEncoding):
        return {"encoding": _export_encoding(network.encoding),
                "network": _export_mlp(network.network)}
    return {
        "pos_encoding": _export_encoding(network.pos_encoding),
        "dir_encoding": _export_encoding(network.dir_encoding),
        "density_mlp": _export_mlp(network.density_mlp),
        "rgb_mlp": _export_mlp(network.rgb_mlp),
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


def load_camera_params(camera: CameraParams, tree: dict) -> CameraParams:
    """Fill ``camera`` from a camera tree. Returns ``camera``."""
    for name in CameraParams.NAMES:
        _copy(getattr(camera, name), tree[name], f"camera.{name}")
    return camera


def export_camera_params(camera: CameraParams) -> dict:
    """The camera tree of ``camera`` (numpy float32, keys sorted)."""
    return {name: getattr(camera, name).detach().cpu().numpy().copy()
            for name in CameraParams.NAMES}


def load_jax_train_state(network, tree: dict, camera: CameraParams | None = None,
                         envmap: EnvmapParams | None = None) -> TrainState:
    """A ``TrainState`` of ``network`` (a port network, filled
    in place) from a training-state tree (module docstring); a group the
    tree's ``opt`` lacks starts with zero moments. With
    ``camera`` (filled in place) the state has a camera group: the tree's
    camera parameters, EMA and Adam state where it holds them, else
    ``camera``'s parameters and zero moments, and an EMA copy of the
    parameters beside the model's. With ``envmap`` the same for its
    environment map."""
    load_jax_params(network, tree["params"])
    groups = param_groups(network)
    opt = {}
    for g in GROUPS:
        opt[g] = _adam_state(tree["opt"].get(g), groups[g], f"opt.{g}")
    ema = None
    if tree.get("ema") is not None:
        ema = load_jax_params(copy.deepcopy(network), tree["ema"]).requires_grad_(False)
    state = TrainState(int(tree["step"]), network, opt, ema)
    if camera is not None:
        if tree.get("camera") is not None:
            load_camera_params(camera, tree["camera"])
        names = [(n, getattr(camera, n)) for n in CameraParams.NAMES]
        opt["camera"] = _adam_state(tree["opt"].get("camera"), names, "opt.camera")
        state.camera = camera
        if ema is not None:
            state.camera_ema = copy.deepcopy(camera).requires_grad_(False)
            if tree.get("camera_ema") is not None:
                load_camera_params(state.camera_ema, tree["camera_ema"])
    if envmap is not None:
        if tree.get("envmap") is not None:
            _copy(envmap.image, tree["envmap"]["image"], "envmap.image")
        opt["envmap"] = _adam_state(tree["opt"].get("envmap"), [("image", envmap.image)],
                                    "opt.envmap")
        state.envmap = envmap
        if ema is not None:
            state.envmap_ema = copy.deepcopy(envmap).requires_grad_(False)
            if tree.get("envmap_ema") is not None:
                _copy(state.envmap_ema.image, tree["envmap_ema"]["image"], "envmap_ema.image")
    return state


def _adam_state(st: dict | None, named_params, where: str) -> AdamState:
    """A group's Adam state from its tree; zero moments where None."""
    if st is None:
        return adam_init([p for _, p in named_params])
    return AdamState(
        int(st["count"]),
        [_tensor_like(p, _tree_get(st["mu"], n), f"{where}.mu.{n}") for n, p in named_params],
        [_tensor_like(p, _tree_get(st["nu"], n), f"{where}.nu.{n}") for n, p in named_params],
    )


def export_jax_train_state(state: TrainState) -> dict:
    """The training-state tree (module docstring) of a port ``TrainState``;
    an EMA not yet started is the model itself, as the JAX package's
    ``ema_init`` makes it."""
    groups = param_groups(state.model)
    opt = {}
    for g in GROUPS:
        opt[g] = _export_adam(state.opt_state[g], groups[g])
    tree = {
        "step": state.step,
        "params": export_jax_params(state.model),
        "opt": opt,
        "ema": export_jax_params(state.inference_model()),
    }
    if state.camera is not None:
        names = [(n, getattr(state.camera, n)) for n in CameraParams.NAMES]
        opt["camera"] = _export_adam(state.opt_state["camera"], names)
        tree["camera"] = export_camera_params(state.camera)
        tree["camera_ema"] = export_camera_params(state.inference_camera())
    if state.envmap is not None:
        opt["envmap"] = _export_adam(state.opt_state["envmap"], [("image", state.envmap.image)])
        tree["envmap"] = export_envmap_params(state.envmap)
        tree["envmap_ema"] = export_envmap_params(state.inference_envmap())
    return tree


def export_envmap_params(envmap: EnvmapParams) -> dict:
    """The envmap tree of ``envmap`` (numpy float32)."""
    return {"image": envmap.image.detach().cpu().numpy().copy()}


def _export_adam(st: AdamState, named_params) -> dict:
    mu, nu = {}, {}
    for (name, _), m, v in zip(named_params, st.mu, st.nu):
        _tree_set(mu, name, m.detach().cpu().numpy().copy())
        _tree_set(nu, name, v.detach().cpu().numpy().copy())
    return {"count": st.count, "mu": mu, "nu": nu}

"""Network configs: the flagship NeRF configs (the port's copy of the JAX
package's ``__graft_entry__._default_config``) and reference-format JSON
config files (the port's copy of ``ngp_tpu/config.py``): ``//`` comments and
``"parent"`` inheritance, so the reference's shipped configs load
unchanged."""

from __future__ import annotations

import copy
import json
import os

TIERS = ("tpu", "upstream", "fork")


def default_config(tier: str = "tpu") -> dict:
    """Reference-format NeRF config (loss, optimizer, encoding, networks)
    for one of three encoding tiers:

    - ``"tpu"``: HashGrid L=8, F=2, T=2^18, per_level_scale 2.0, additive
      spatial hash;
    - ``"upstream"``: L=16, F=2, T=2^19, XOR hash, per_level_scale derived
      by the engine (instant-ngp ``base.json``);
    - ``"fork"``: L=4, F=4, T=2^19, XOR hash, per_level_scale 2.0.

    Directions go through SH degree 4 (plus Identity on any extra dims);
    the density MLP has one hidden layer and the rgb MLP two, 64 wide."""
    if tier not in TIERS:
        raise ValueError(f"unknown config tier {tier!r} ({' | '.join(TIERS)})")
    upstream = tier == "upstream"
    encoding = {
        "otype": "HashGrid",
        "base_resolution": 16,
        "log2_hashmap_size": 18 if tier == "tpu" else 19,
        "n_levels": 16 if upstream else (4 if tier == "fork" else 8),
        "n_features_per_level": 4 if tier == "fork" else 2,
    }
    if tier in ("fork", "tpu"):
        encoding["per_level_scale"] = 2.0
    if tier == "tpu":
        encoding["hash_variant"] = "additive"
    return {
        "loss": {"otype": "Huber"},
        "optimizer": {
            "otype": "Ema",
            "decay": 0.95,
            "nested": {
                "otype": "ExponentialDecay",
                "decay_start": 20000, "decay_interval": 10000, "decay_base": 0.33,
                "nested": {
                    "otype": "Adam", "learning_rate": 1e-2, "beta1": 0.9,
                    "beta2": 0.99, "epsilon": 1e-15, "l2_reg": 1e-6,
                },
            },
        },
        "encoding": encoding,
        "network": {
            "otype": "FullyFusedMLP", "activation": "ReLU",
            "output_activation": "None", "n_neurons": 64, "n_hidden_layers": 1,
        },
        "dir_encoding": {
            "otype": "Composite",
            "nested": [
                {"n_dims_to_encode": 3, "otype": "SphericalHarmonics", "degree": 4},
                {"otype": "Identity"},
            ],
        },
        "rgb_network": {
            "otype": "FullyFusedMLP", "activation": "ReLU",
            "output_activation": "None", "n_neurons": 64, "n_hidden_layers": 2,
        },
    }


def _strip_comments(text: str) -> str:
    """Remove ``//`` line comments outside of string literals."""
    out, i, n, in_str = [], 0, len(text), False
    while i < n:
        c = text[i]
        if in_str:
            out.append(c)
            if c == "\\" and i + 1 < n:
                out.append(text[i + 1])
                i += 1
            elif c == '"':
                in_str = False
        elif c == '"':
            in_str = True
            out.append(c)
        elif c == "/" and i + 1 < n and text[i + 1] == "/":
            while i < n and text[i] != "\n":
                i += 1
            continue
        else:
            out.append(c)
        i += 1
    return "".join(out)


def loads_jsonc(text: str) -> dict:
    """Parse JSON with ``//`` comments, as the reference's configs use them."""
    return json.loads(_strip_comments(text))


def load_config(path: str) -> dict:
    """Load a network config, resolving ``"parent"`` inheritance as the
    reference's ``merge_parent_network_config`` does
    (``src/testbed.cu:95-106``): the parent (relative to the child's
    directory) is loaded first and the child's top-level keys replace its
    own."""
    with open(path) as f:
        cfg = loads_jsonc(f.read())
    if "parent" in cfg:
        parent = load_config(os.path.join(os.path.dirname(path), cfg.pop("parent")))
        parent.update(cfg)
        cfg = parent
    return cfg


def merge(base: dict, override: dict) -> dict:
    """Recursive dict merge, ``override`` winning; for overrides in code."""
    out = copy.deepcopy(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out

"""Native snapshots, the port's copy of ``ngp_tpu/utils/snapshot.py``:
versioned msgpack, zlib-compressed when the extension is ``.ingp``.

After the reference's snapshot design (``testbed.cu:4873-5057``): a msgpack
document with a ``"snapshot"`` section holding parameters and metadata
(training step, loss EMA, density grid). ``.ingp`` files are
zlib-compressed msgpack, other extensions raw msgpack, the reference's
extension switch (``testbed.cu:4928``).

Array leaves (numpy arrays and scalars, torch tensors) are stored as
``{"__nd__": True, "dtype", "shape", "data" (bin)}``, so parameter and
optimizer trees round-trip exactly. The file is the JAX package's format,
byte for byte for the same document: each package reads the other's.
"""

from __future__ import annotations

import zlib
from typing import Any

import numpy as np
import torch

from ngp_tpu_torch.data import msgpack_lite

SNAPSHOT_FORMAT_VERSION = 1


def _encode(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        obj = obj.detach().cpu().numpy()
    if isinstance(obj, (np.ndarray, np.generic)):
        arr = np.asarray(obj)
        return {"__nd__": True, "dtype": arr.dtype.str, "shape": list(arr.shape),
                "data": arr.tobytes()}
    if isinstance(obj, dict):
        return {k: _encode(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_encode(v) for v in obj]
    return obj


def _decode(obj: Any) -> Any:
    if isinstance(obj, dict):
        if obj.get("__nd__"):
            return np.frombuffer(obj["data"], np.dtype(obj["dtype"])).reshape(
                obj["shape"]).copy()
        return {k: _decode(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_decode(v) for v in obj]
    return obj


def save_snapshot(path: str, payload: dict) -> None:
    doc = {"version": SNAPSHOT_FORMAT_VERSION, **_encode(payload)}
    raw = msgpack_lite.packb(doc)
    if path.endswith(".ingp"):
        raw = zlib.compress(raw)
    with open(path, "wb") as f:
        f.write(raw)


def load_snapshot(path: str) -> dict:
    with open(path, "rb") as f:
        raw = f.read()
    if path.endswith(".ingp"):
        raw = zlib.decompress(raw)
    doc = msgpack_lite.unpackb(raw)
    version = doc.get("version")
    if version is None or version > SNAPSHOT_FORMAT_VERSION:
        raise ValueError(f"unsupported snapshot version {version}")
    return _decode(doc)

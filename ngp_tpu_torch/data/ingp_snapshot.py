"""Reference ``.ingp`` snapshots, the port's copy of
``ngp_tpu/data/ingp_snapshot.py``: reading, and writing the file the
reference's ``Testbed::save_snapshot`` writes.

A snapshot is msgpack of the network config with a ``"snapshot"`` key,
zlib-wrapped for ``.ingp``. Inside it:

- ``params_binary``: tcnn's flat parameter buffer (``params_type``
  ``"__half"`` or float), in the order density MLP, rgb MLP, position grid
  encoding (nothing for a position encoding without parameters, such as
  Frequency). Each MLP stores its matrices layer by layer, row-major
  ``[n_out, n_in]``, the last output width padded to 16; grid levels are
  consecutive ``(rows_in_level, F)`` blocks.
- ``density_grid_binary``: a float16 occupancy grid of ``G³`` cells per
  cascade, Morton-ordered within each cascade.
"""

from __future__ import annotations

import zlib

import numpy as np

from ngp_tpu_torch.data import msgpack_lite

SNAPSHOT_FORMAT_VERSION = 1  # testbed.cu:80
_ALIGN = 16  # FullyFusedMLP output alignment


def _next_multiple(x: int, m: int) -> int:
    return -(-x // m) * m


def load_ingp(path: str) -> dict:
    """Decode a reference snapshot file (zlib-, gzip- or un-wrapped
    msgpack) into a plain dict; msgpack bin fields come back as bytes."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:2] == b"\x1f\x8b":  # gzip-wrapped zlib stream
        blob = zlib.decompress(blob, wbits=47)
    else:
        try:
            blob = zlib.decompress(blob)
        except zlib.error:
            pass  # raw msgpack (.msgpack)
    return msgpack_lite.unpackb(blob)


def save_ingp(path: str, config: dict, compress: bool = True) -> None:
    """Encode ``config`` as the reference writes it: msgpack, wrapped in a
    zlib stream (level 6, or 0 without ``compress``) when the extension is
    ``.ingp``."""
    blob = msgpack_lite.packb(config)
    if path.lower().endswith(".ingp"):
        blob = zlib.compress(blob, 6 if compress else 0)
    with open(path, "wb") as f:
        f.write(blob)


def _mlp_padded_layout(mlp) -> list[tuple[int, int]]:
    """tcnn layer shapes ``[(out, in), ...]`` with the padded output width."""
    out_pad = _next_multiple(mlp.n_output_dims, _ALIGN)
    if mlp.n_hidden_layers == 0:
        return [(out_pad, mlp.n_input_dims)]
    dims = [(mlp.n_neurons, mlp.n_input_dims)]
    dims += [(mlp.n_neurons, mlp.n_neurons)] * (mlp.n_hidden_layers - 1)
    dims += [(out_pad, mlp.n_neurons)]
    return dims


def _mlp_from_flat(flat: np.ndarray, off: int, mlp) -> tuple[dict, int]:
    layout = _mlp_padded_layout(mlp)
    ws = []
    for i, (rows, cols) in enumerate(layout):
        m = flat[off:off + rows * cols].reshape(rows, cols)
        off += rows * cols
        w = m.T  # (in, out)
        if i == len(layout) - 1:
            w = w[:, : mlp.n_output_dims]
        ws.append(np.ascontiguousarray(w, np.float32))
    return {"weights": ws}, off


def _mlp_to_flat(params: dict, mlp, dtype) -> list[np.ndarray]:
    """One MLP's ``{"weights": [(in, out), ...]}`` as tcnn's row-major
    ``[n_out, n_in]`` matrices, the last output width padded with zeros."""
    out = []
    for w, (rows, cols) in zip(params["weights"], _mlp_padded_layout(mlp)):
        w = np.asarray(w, np.float32).T  # (out, in)
        if w.shape[0] < rows:
            w = np.concatenate([w, np.zeros((rows - w.shape[0], cols), np.float32)], 0)
        if w.shape != (rows, cols):
            raise ValueError(f"MLP layer of shape {w.shape}, tcnn layout {(rows, cols)}")
        out.append(w.astype(dtype).reshape(-1))
    return out


def _grid_from_flat(flat: np.ndarray, off: int, enc) -> tuple[dict, int]:
    if not hasattr(enc, "level_geometry"):  # Frequency, OneBlob, ...: no parameters
        return {}, off
    _, _, sizes, _ = enc.level_geometry()
    F = enc.n_features_per_level
    table = np.zeros((enc.n_levels, enc.max_table_rows, F), np.float32)
    for l, size in enumerate(sizes):
        n = int(size) * F
        table[l, : int(size)] = flat[off:off + n].reshape(int(size), F)
        off += n
    return {"table": table}, off


def _grid_to_flat(params: dict, enc, dtype) -> list[np.ndarray]:
    """The grid table's live rows, level after level (none for a position
    encoding without parameters)."""
    if not hasattr(enc, "level_geometry"):
        return []
    _, _, sizes, _ = enc.level_geometry()
    table = np.asarray(params["table"], np.float32)
    return [table[l, : int(size)].astype(dtype).reshape(-1)
            for l, size in enumerate(sizes)]


def reference_n_params(network) -> int:
    """tcnn parameter count of a ``NerfNetwork``, padding included."""
    total = sum(
        r * c
        for mlp in (network.density_mlp, network.rgb_mlp)
        for r, c in _mlp_padded_layout(mlp)
    )
    return total + network.pos_encoding.n_params


def params_from_reference(snapshot: dict, network) -> dict:
    """``snapshot["params_binary"]`` → a JAX-layout parameter tree of numpy
    arrays for ``network`` (load it with ``interop.load_jax_params``)."""
    ptype = snapshot.get("params_type", "__half")
    dtype = np.float16 if ptype == "__half" else np.float32
    flat = np.frombuffer(snapshot["params_binary"], dtype=dtype).astype(np.float32)
    expect = reference_n_params(network)
    if flat.size < expect:
        raise ValueError(
            f"snapshot has {flat.size} params; network needs {expect} "
            "(config mismatch?)"
        )
    off = 0
    density, off = _mlp_from_flat(flat, off, network.density_mlp)
    rgb, off = _mlp_from_flat(flat, off, network.rgb_mlp)
    pos, off = _grid_from_flat(flat, off, network.pos_encoding)
    return {"pos_encoding": pos, "density_mlp": density, "rgb_mlp": rgb}


def params_to_reference(model_params: dict, network, dtype=np.float16) -> bytes:
    """A JAX-layout parameter tree of ``network`` (``interop.export_jax_params``)
    → tcnn's flat parameter buffer: density MLP, rgb MLP, grid levels."""
    chunks = _mlp_to_flat(model_params["density_mlp"], network.density_mlp, dtype)
    chunks += _mlp_to_flat(model_params["rgb_mlp"], network.rgb_mlp, dtype)
    chunks += _grid_to_flat(model_params["pos_encoding"], network.pos_encoding, dtype)
    return np.concatenate(chunks).tobytes()


def morton_codes(G: int) -> np.ndarray:
    """Morton code of every cell in row-major (x, y, z) order, tcnn's
    ``morton3D`` (x in the least significant interleaved bits)."""

    def expand(v: np.ndarray) -> np.ndarray:
        v = v.astype(np.uint64)
        v = (v | (v << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
        v = (v | (v << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
        v = (v | (v << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
        v = (v | (v << np.uint64(2))) & np.uint64(0x1249249249249249)
        return v

    r = np.arange(G, dtype=np.uint64)
    x, y, z = np.meshgrid(r, r, r, indexing="ij")
    return (expand(x) | (expand(y) << np.uint64(1))
            | (expand(z) << np.uint64(2))).reshape(-1).astype(np.int64)


def density_grid_from_reference(blob: bytes, n_cascades: int,
                                grid_size: int = 128) -> np.ndarray:
    """float16 Morton-ordered grid bytes → row-major ``(C, G, G, G)``
    float32."""
    g = np.frombuffer(blob, dtype=np.float16).astype(np.float32)
    n_cells = grid_size ** 3
    if g.size != n_cascades * n_cells:
        raise ValueError(
            f"density grid has {g.size} cells, expected {n_cascades}x{n_cells}"
        )
    codes = morton_codes(grid_size)
    out = np.empty((n_cascades, n_cells), np.float32)
    for c in range(n_cascades):
        out[c] = g[c * n_cells:][codes]
    return out.reshape(n_cascades, grid_size, grid_size, grid_size)


def density_grid_to_reference(density: np.ndarray) -> bytes:
    """Row-major ``(C, G, G, G)`` grid → float16 Morton-ordered bytes."""
    C, G = density.shape[0], density.shape[1]
    codes = morton_codes(G)
    out = np.empty((C, G ** 3), np.float16)
    flat = np.asarray(density, np.float32).reshape(C, -1)
    for c in range(C):
        out[c, codes] = flat[c]
    return out.tobytes()

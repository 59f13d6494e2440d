"""The inputs of the JPEG encoder's digests in ``manifest.json``
(``encode_sha256``): every RGB fixture's decode and seeded arrays of odd
sizes, each encoded at ``ENCODE_QUALITIES``. ``make_fixtures.py`` records
PIL's digests with PIL's decoder; ``chip_smoke.py jpeg_encode``, on a host
without PIL, checks the port's encoder with the port's decoder (the same
arrays: ``tests/test_torch_jpeg_encode.py``). Imports numpy only."""

import json
import os

import numpy as np

ENCODE_QUALITIES = (75, 90)
ENCODE_SIZES = ((1, 1), (9, 17), (31, 33), (359, 641))  # (height, width)


def seeded_pixels(h: int, w: int, seed: int) -> np.ndarray:
    """(h, w, 3) uint8 noise from integer arithmetic alone (a multiplicative
    hash of the sample index), the same under any numpy."""
    i = np.arange(h * w * 3, dtype=np.uint64) + np.uint64(seed) * np.uint64(0x9E3779B9)
    v = (i * np.uint64(2654435761)) & np.uint64(0xFFFFFFFF)
    v ^= v >> np.uint64(15)
    v = (v * np.uint64(2246822519)) & np.uint64(0xFFFFFFFF)
    return (v >> np.uint64(24)).astype(np.uint8).reshape(h, w, 3)


def encode_inputs(root: str, decode) -> dict:
    """name → (H, W, 3) uint8: ``decode(path)`` of each fixture that the
    manifest lists (a grey file's 2-D decode left out), then
    ``seeded/<w>x<h>`` for each of ``ENCODE_SIZES``."""
    manifest = json.load(open(os.path.join(root, "manifest.json")))
    out = {}
    for rel in sorted(manifest["rgba_sha256"]):
        a = decode(os.path.join(root, rel))
        if a.ndim == 3:
            out[rel] = np.ascontiguousarray(a)
    for seed, (h, w) in enumerate(ENCODE_SIZES):
        out[f"seeded/{w}x{h}"] = seeded_pixels(h, w, seed)
    return out

"""Regenerate the JPEG fixtures (tests/fixtures/jpeg/): files that PIL
writes on a host that has PIL, which the port's decoder reads on a host
that has none (``chip_smoke.py jpeg`` on the card's machine).

- ``capture/``: the port's ``data/synthetic.write_sphere_capture`` at its
  default 800×800 (24 train and 4 test views, OpenCV lens, aabb_scale 2),
  each RGBA frame composited over black (its transparent pixels are
  black already) and saved by PIL as a 4:2:0 quality-90 JPEG, with the
  capture's two transforms jsons naming the ``.jpg`` files.
- ``modes/``: small files (at most 64×64) of seeded data, one a mode:
  each subsampling, grey, Adobe RGB, progressive, restart markers,
  qualities 1 and 100.
- ``manifest.json``: the sha256 of PIL's RGBA decode
  (``np.asarray(Image.open(p).convert("RGBA"))``, C order) of every file,
  the JAX package's ``convert.sharpness`` of each capture frame, the PIL
  and libjpeg-turbo versions that wrote them, and ``encode_sha256``: the
  sha256 of the JPEG file PIL writes at each quality for each input of
  ``encode_inputs.py`` (every RGB fixture's decode and seeded arrays of
  odd sizes), which ``chip_smoke.py jpeg_encode`` holds the port's
  encoder to.

``tests/test_torch_jpeg.py`` recomputes the manifest with PIL and holds
the port's decoder to it; ``tests/test_torch_jpeg_encode.py`` recomputes
``encode_sha256`` and holds the port's encoder to it. ``python
tests/fixtures/jpeg/make_fixtures.py --encode`` rewrites that key alone. Run from the repository root on the CPU:

    python tests/fixtures/jpeg/make_fixtures.py

Regenerate only where the capture or the modes change, and commit the
files with the manifest.
"""

import hashlib
import json
import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "..", ".."))

import numpy as np
import PIL
from PIL import Image, features

from encode_inputs import ENCODE_QUALITIES, encode_inputs

CAPTURE_QUALITY = 90
CAPTURE_SUBSAMPLING = 2  # 4:2:0
# name → (height, width, content, grey, PIL save options)
MODES = {
    "s444_q90.jpg": (61, 45, "noisy", False, {"quality": 90, "subsampling": 0}),
    "s422_q75.jpg": (37, 29, "smooth", False, {"quality": 75, "subsampling": 1}),
    "s420_q50.jpg": (64, 64, "noisy", False, {"quality": 50, "subsampling": 2}),
    "grey_q90.jpg": (29, 37, "smooth", True, {"quality": 90}),
    "adobe_rgb_q90.jpg": (45, 61, "noisy", False, {"quality": 90, "keep_rgb": True}),
    "progressive_q80.jpg": (64, 48, "noisy", False, {"quality": 80, "progressive": True}),
    "progressive_optimized_q60.jpg": (
        33, 50, "smooth", False, {"quality": 60, "progressive": True, "optimize": True}),
    "restart_blocks_q85.jpg": (40, 56, "noisy", False,
                               {"quality": 85, "restart_marker_blocks": 3}),
    "restart_rows_progressive_q70.jpg": (
        48, 40, "noisy", False, {"quality": 70, "progressive": True, "restart_marker_rows": 1}),
    "q100.jpg": (7, 5, "noisy", False, {"quality": 100}),
    "q1.jpg": (64, 64, "noisy", False, {"quality": 1}),
}


def pil_rgb(path: str) -> np.ndarray:
    """PIL's decode: (H, W) for a grey file, (H, W, 3) RGB otherwise."""
    with Image.open(path) as im:
        return np.asarray(im if im.mode == "L" else im.convert("RGB"))


def encode_digests(root: str) -> dict:
    """name → {quality: sha256 of PIL's JPEG file} over ``encode_inputs``
    (``encode_inputs.py``) of PIL's decodes."""
    import hashlib
    import io

    out = {}
    for name, a in encode_inputs(root, pil_rgb).items():
        out[name] = {}
        for q in ENCODE_QUALITIES:
            buf = io.BytesIO()
            Image.fromarray(a).save(buf, format="JPEG", quality=q)
            out[name][str(q)] = hashlib.sha256(buf.getvalue()).hexdigest()
    return out


def mode_pixels(h: int, w: int, content: str, seed: int) -> np.ndarray:
    """(h, w, 3) uint8: ``noisy`` uniform noise over a smooth ramp, or
    ``smooth`` ramps and a soft disc, from ``seed``."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    ramp = np.stack([255 * x / max(w - 1, 1), 255 * y / max(h - 1, 1),
                     127.5 * (1 + np.sin((x + y) / 5.0))], -1)
    if content == "noisy":
        return np.clip(0.5 * ramp + rng.uniform(0, 128, (h, w, 3)), 0, 255).astype(np.uint8)
    disc = 80.0 * np.exp(-((x - w / 2) ** 2 + (y - h / 3) ** 2) / (0.1 * h * w + 1))
    return np.clip(ramp * 0.8 + disc[..., None], 0, 255).astype(np.uint8)


def pil_rgba_sha256(path: str) -> str:
    with Image.open(path) as im:
        rgba = np.ascontiguousarray(np.asarray(im.convert("RGBA"), np.uint8))
    return hashlib.sha256(rgba.tobytes()).hexdigest()


def write_capture(out: str) -> list:
    """The JPEG capture in ``out``; returns its frames' paths relative to
    ``out``."""
    from ngp_tpu_torch.data.synthetic import write_sphere_capture

    frames = []
    with tempfile.TemporaryDirectory() as tmp:
        jsons = write_sphere_capture(tmp, res=800, device="cpu")
        for path in jsons:
            meta = json.load(open(path))
            for fr in meta["frames"]:
                rel = fr["file_path"] + ".jpg"
                with Image.open(os.path.join(tmp, fr["file_path"] + ".png")) as im:
                    rgba = np.asarray(im.convert("RGBA"), np.uint16)
                # over black: rgb · a / 255, rounded (a is 0 or 255 here)
                rgb = (rgba[..., :3] * rgba[..., 3:] + 127) // 255
                os.makedirs(os.path.dirname(os.path.join(out, rel)), exist_ok=True)
                Image.fromarray(rgb.astype(np.uint8)).save(
                    os.path.join(out, rel), quality=CAPTURE_QUALITY,
                    subsampling=CAPTURE_SUBSAMPLING)
                fr["file_path"] = rel
                frames.append(os.path.normpath(rel))
            with open(os.path.join(out, os.path.basename(path)), "w") as f:
                json.dump(meta, f, indent=1)
    return frames


def write_modes(out: str) -> list:
    os.makedirs(out, exist_ok=True)
    for seed, (name, (h, w, content, grey, opts)) in enumerate(sorted(MODES.items())):
        pix = mode_pixels(h, w, content, seed)
        Image.fromarray(pix[..., 1] if grey else pix).save(os.path.join(out, name), **opts)
    return sorted(MODES)


def manifest(root: str, capture_frames: list, modes: list) -> dict:
    from ngp_tpu.data.convert import sharpness

    files = [f"capture/{p}" for p in capture_frames] + [f"modes/{m}" for m in modes]
    return {
        "pil": PIL.__version__,
        "libjpeg_turbo": features.version("libjpeg_turbo"),
        "capture": {"quality": CAPTURE_QUALITY, "subsampling": "4:2:0", "res": 800},
        "rgba_sha256": {f: pil_rgba_sha256(os.path.join(root, f)) for f in files},
        "sharpness": {f"capture/{p}": sharpness(os.path.join(root, "capture", p))
                      for p in capture_frames},
    }


def main():
    if sys.argv[1:] == ["--encode"]:
        path = os.path.join(HERE, "manifest.json")
        m = json.load(open(path))
        m["encode_sha256"] = encode_digests(HERE)
        with open(path, "w") as f:
            json.dump(m, f, indent=1, sort_keys=True)
        print(f"{len(m['encode_sha256'])} encoder inputs -> {path}")
        return
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    for sub in ("capture", "modes"):
        shutil.rmtree(os.path.join(HERE, sub), ignore_errors=True)
    frames = write_capture(os.path.join(HERE, "capture"))
    modes = write_modes(os.path.join(HERE, "modes"))
    m = manifest(HERE, frames, modes)
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(m, f, indent=1, sort_keys=True)
    m["encode_sha256"] = encode_digests(HERE)
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(m, f, indent=1, sort_keys=True)
    print(f"{len(frames)} capture frames, {len(modes)} mode files -> {HERE}")


if __name__ == "__main__":
    main()

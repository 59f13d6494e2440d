"""The port's JPEG encoder (``ngp_tpu_torch/hostsrc/jpeg_encode.cpp``
through ``data/jpeg.encode_jpeg``) and its numpy twin
(``encode_jpeg_reference``) against PIL on the CPU: every file must be
PIL's ``Image.fromarray(a).save(f, format="JPEG", quality=q)`` byte for
byte, over odd and even sizes from 1×1 to 641×359, qualities 1-100 and
flat, noise and gradient images; the port's decoder reads each back as
PIL does. Then the port's writers of JPEG files (``run.write_image``,
``scripts/convert_image.py``) against the JAX package's, the refusals, a
failed build, and the digests that ``tests/fixtures/jpeg/manifest.json``
records for ``chip_smoke.py`` (a host with no PIL).

Tolerance: none, bytes and arrays compared for equality; ``convert_image``
from 8-bit inputs within one level (the sRGB curve's float32 ``pow``
differs between torch and XLA in the last bit, as in
``tests/test_torch_convert.py``).
"""

import hashlib
import importlib.util
import io
import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from ngp_tpu_torch.data.jpeg import (
    encode_jpeg,
    encode_jpeg_reference,
    read_jpeg,
    write_jpeg,
)
from ngp_tpu_torch.ops import host_build

# One intra-op thread, as in every port test module (test_torch_capture.py).
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "jpeg")
# (height, width): a single pixel, widths and heights under one block, one
# MCU and a block more, odd both ways, and the 641×359 frame
SIZES = [(1, 1), (3, 2), (5, 7), (9, 17), (16, 16), (31, 33), (48, 64), (359, 641)]
QUALITIES = (1, 50, 75, 90, 95, 100)
CONTENTS = ("flat", "noise", "gradient")


def pixels(h: int, w: int, content: str, seed: int) -> np.ndarray:
    """(h, w, 3) uint8: one seeded colour, uniform noise, or ramps."""
    rng = np.random.default_rng(seed)
    if content == "flat":
        return np.broadcast_to(rng.integers(0, 256, 3, dtype=np.uint8), (h, w, 3)).copy()
    if content == "noise":
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    y, x = np.mgrid[0:h, 0:w]
    return np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1), (3 * x + 5 * y) % 256],
                    -1).astype(np.uint8)


def pil_jpeg(a: np.ndarray, quality: int) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


@pytest.mark.parametrize("h,w", SIZES)
def test_encode_jpeg_is_pils_bytes(h, w, tmp_path):
    """The C++ encoder and the numpy twin write PIL's bytes at every
    quality and content; the port's decoder reads them as PIL does."""
    for ci, content in enumerate(CONTENTS):
        a = pixels(h, w, content, seed=1000 * h + w + ci)
        for q in QUALITIES:
            want = pil_jpeg(a, q)
            assert encode_jpeg(a, q) == want, (h, w, content, q)
            assert encode_jpeg_reference(a, q) == want, (h, w, content, q)
        path = str(tmp_path / f"{content}.jpg")
        write_jpeg(path, a)
        with Image.open(path) as im:
            assert np.array_equal(read_jpeg(path), np.asarray(im)), (h, w, content)


def test_default_quality_and_edge_qualities():
    """Quality 75 by default, as PIL's; the quantiser's reciprocal rounding
    and the clamp to 255 at every quality from 1 to 100 on one noise image."""
    a = pixels(23, 29, "noise", seed=5)
    assert encode_jpeg(a) == pil_jpeg(a, 75) == encode_jpeg(a, 75)
    for q in range(1, 101):
        assert encode_jpeg(a, q) == pil_jpeg(a, q), q


def test_refusals():
    """What PIL will not write as RGB JPEG raises, naming the mode; so do a
    quality outside 1-100 and an empty image."""
    rgba = np.zeros((4, 4, 4), np.uint8)
    with pytest.raises(OSError, match="cannot write mode RGBA as JPEG"):
        Image.fromarray(rgba).save(io.BytesIO(), format="JPEG")
    for encode in (encode_jpeg, encode_jpeg_reference):
        with pytest.raises(ValueError, match="cannot write mode RGBA as JPEG"):
            encode(rgba)
        with pytest.raises(ValueError, match="float32"):
            encode(np.zeros((4, 4, 3), np.float32))
        with pytest.raises(ValueError, match="uint16"):
            encode(np.zeros((4, 4, 3), np.uint16))
        with pytest.raises(ValueError, match="cannot write mode L"):
            encode(np.zeros((4, 4), np.uint8))
        with pytest.raises(ValueError, match="quality 0"):
            encode(np.zeros((4, 4, 3), np.uint8), 0)
        with pytest.raises(ValueError, match="0x4"):
            encode(np.zeros((4, 0, 3), np.uint8))


def test_a_failed_encoder_build_raises(monkeypatch, tmp_path):
    """The encoder is built with the host library; where the compiler
    fails it raises, and nothing falls back to the numpy twin."""
    monkeypatch.setattr(host_build, "_LIB", None)
    monkeypatch.setattr(host_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(host_build, "CXX_FLAGS", host_build.CXX_FLAGS + ("-DNGP_BOGUS",))
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for .*jpeg_encode.cpp"):
        encode_jpeg(np.zeros((8, 8, 3), np.uint8))


def _jax_script(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_run_write_image_jpg_matches_jax(tmp_path):
    """The CLI's ``.jpg``/``.jpeg`` screenshots: the JAX CLI's bytes (PIL at
    quality 75 of ``clip(img, 0, 1)·255`` truncated) for a float image
    with values outside [0, 1]."""
    from ngp_tpu_torch import run

    jrun = _jax_script("run")
    img = np.random.default_rng(3).uniform(-0.2, 1.2, (37, 53, 3)).astype(np.float32)
    for ext in (".jpg", ".jpeg"):
        run.write_image(str(tmp_path / f"port{ext}"), img)
        jrun.write_image(str(tmp_path / f"jax{ext}"), img)
        assert (tmp_path / f"port{ext}").read_bytes() == (tmp_path / f"jax{ext}").read_bytes()
    assert (tmp_path / "port.jpg").read_bytes() == pil_jpeg(
        (np.clip(img, 0, 1) * 255).astype(np.uint8), 75)


def test_convert_image_jpg_matches_jax(tmp_path, monkeypatch):
    """``convert_image --output x.jpg``: the JAX script's bytes from a
    linear EXR; from 8-bit JPEG and PNG inputs (whose linear round trip
    lands on whole levels, where the last bit of the sRGB curve decides the
    truncation) the port's file is its own pixels' ``encode_jpeg``, the JAX
    script's is PIL's of its own, and the pixels agree within a level."""
    from ngp_tpu.data.exr import write_exr
    from ngp_tpu_torch.data.png import read_png
    from ngp_tpu_torch.scripts import convert_image

    jconvert = _jax_script("convert_image")
    rng = np.random.default_rng(8)
    write_exr(str(tmp_path / "in.exr"), rng.uniform(0, 1, (21, 34, 4)).astype(np.float32))
    Image.fromarray(np.cumsum(rng.integers(0, 30, (30, 41, 3)), 1).astype(np.uint8)).save(
        tmp_path / "in.jpg", quality=90)
    Image.fromarray(rng.integers(0, 256, (17, 23, 4), dtype=np.uint8)).save(tmp_path / "in.png")
    monkeypatch.chdir(tmp_path)
    for src in ("in.exr", "in.jpg", "in.png"):
        for who, ext in (("port", ".jpg"), ("port", ".png"), ("jax", ".jpg"), ("jax", ".png")):
            argv = ["--input", src, "--output", f"{who}_{src[3:]}{ext}"]
            if who == "port":
                convert_image.main(argv)
            else:
                monkeypatch.setattr(sys, "argv", ["convert_image.py", *argv])
                jconvert.main()
        port = (tmp_path / f"port_{src[3:]}.jpg").read_bytes()
        jax = (tmp_path / f"jax_{src[3:]}.jpg").read_bytes()
        port_px, jax_px = (read_png(str(tmp_path / f"{w}_{src[3:]}.png")) for w in ("port", "jax"))
        assert port == encode_jpeg(port_px) and jax == pil_jpeg(jax_px, 75), src
        if src == "in.exr":
            assert port == jax
        else:
            assert np.abs(port_px.astype(int) - jax_px.astype(int)).max() <= 1, src


def test_manifest_encode_digests():
    """``tests/fixtures/jpeg/manifest.json``'s ``encode_sha256``, which
    ``chip_smoke.py jpeg_encode`` checks on a host with no PIL: the sha256
    of PIL's file at each quality for every RGB fixture's decode and for
    the seeded odd-size arrays, recomputed here with PIL, and the encoder's
    bytes hash to each."""
    sys.path.insert(0, FIXTURES)
    try:
        import encode_inputs
        import make_fixtures
    finally:
        sys.path.remove(FIXTURES)
    manifest = json.load(open(os.path.join(FIXTURES, "manifest.json")))
    recorded = manifest["encode_sha256"]
    inputs = encode_inputs.encode_inputs(FIXTURES, make_fixtures.pil_rgb)
    assert sorted(recorded) == sorted(inputs) and len(inputs) == 28 + 10 + 4
    # the port's decoder gives the same inputs (the card host has no PIL)
    ported = encode_inputs.encode_inputs(FIXTURES, read_jpeg)
    assert sorted(ported) == sorted(inputs)
    assert all(np.array_equal(ported[k], inputs[k]) for k in inputs)
    for name, a in inputs.items():
        for q in encode_inputs.ENCODE_QUALITIES:
            digest = recorded[name][str(q)]
            assert hashlib.sha256(pil_jpeg(a, q)).hexdigest() == digest, (name, q)
            assert hashlib.sha256(encode_jpeg(a, q)).hexdigest() == digest, (name, q)


def test_port_imports_no_pil():
    """The card host has no PIL: no module of ``ngp_tpu_torch``, not
    ``chip_smoke.py`` and not the encoder's digest inputs import it."""
    import re

    pattern = re.compile(r"^\s*(?:import|from)\s+PIL(?:[\s.,]|$)", re.M)
    files = [os.path.join(REPO, "chip_smoke.py"), os.path.join(FIXTURES, "encode_inputs.py")]
    for root, _, names in os.walk(os.path.join(REPO, "ngp_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert not [f for f in files if pattern.search(open(f).read())]
    assert pattern.search(open(os.path.join(FIXTURES, "make_fixtures.py")).read())

"""The port's JPEG decoder (``ngp_tpu_torch/hostsrc/jpeg_decode.cpp``
through ``data/jpeg.py``) against PIL and the JAX package, on the CPU: PIL
writes the files from seeded numpy data, and every decode must equal the
JAX loader's ``_load_frame_image`` (PIL's ``convert("RGBA")``) and
``np.asarray(Image.open(p))`` exactly (``np.array_equal``). Then the image
and NeRF loaders on JPEG files against the JAX package's, array for array,
the refusals, and the committed fixtures of ``tests/fixtures/jpeg``
against a fresh PIL decode.

Tolerance: none anywhere; every array is compared for equality.
"""

import hashlib
import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from ngp_tpu.data import convert as jconvert
from ngp_tpu.data import image_loader as jimage
from ngp_tpu.data import nerf_loader as jloader
from ngp_tpu_torch.data import image_loader as pimage
from ngp_tpu_torch.data import nerf_loader as ploader
from ngp_tpu_torch.data.jpeg import jpeg_size, read_jpeg, read_jpeg_rgba, read_jpegs_rgba
from test_torch_capture import _assert_same_dataset, _nerf_matrix

# One intra-op thread, as in every port test module (test_torch_capture.py).
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "jpeg")
# (height, width): the 1×1, 3×4, 7×5, 37×29, 61×45 and 64×64 images
# (W×H); at widths 3 and 4 the subsampled chroma is 2 samples wide, where
# libjpeg replicates rather than filters
SIZES = [(1, 1), (4, 3), (5, 7), (29, 37), (45, 61), (64, 64)]
SUBSAMPLING = {"444": 0, "422": 1, "420": 2}
CODINGS = {"baseline": {}, "optimize": {"optimize": True}, "progressive": {"progressive": True},
           "progressive_optimize": {"progressive": True, "optimize": True}}
QUALITIES = (1, 50, 90, 100)


def _pixels(h, w, content, seed):
    """(h, w, 3) uint8: ``smooth`` ramps and a soft disc, ``noisy``
    uniform noise, ``mixed`` noise over ramps, from ``seed``."""
    rng = np.random.default_rng(seed)
    if content == "noisy":
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    ramp = np.stack([255 * x / max(w - 1, 1), 255 * y / max(h - 1, 1),
                     127.5 * (1 + np.sin((x - y) / 3.0))], -1)
    if content == "mixed":
        return np.clip(0.6 * ramp + rng.uniform(-60, 60, (h, w, 3)) + 30, 0, 255).astype(np.uint8)
    disc = 90.0 * np.exp(-((x - w / 3) ** 2 + (y - h / 2) ** 2) / (0.05 * h * w + 1))
    return np.clip(0.8 * ramp + disc[..., None], 0, 255).astype(np.uint8)


def _assert_decodes_as_pil(path):
    """The port's RGBA and raw decodes and header size equal the JAX
    loader's PIL frame, ``np.asarray(Image.open(p))`` and PIL's size."""
    with Image.open(path) as im:
        raw, size = np.asarray(im), im.size
    want = jloader._load_frame_image(str(path))
    got = read_jpeg_rgba(str(path))
    assert got.dtype == np.uint8 and got.shape == want.shape, path
    assert np.array_equal(got, want), (path, int(np.abs(got.astype(int) - want).max()))
    got_raw = read_jpeg(str(path))
    assert got_raw.shape == raw.shape and np.array_equal(got_raw, raw), path
    assert jpeg_size(str(path)) == size


def _save(pixels, path, **options):
    Image.fromarray(pixels).save(path, **options)
    return str(path)


@pytest.mark.parametrize("subsampling", sorted(SUBSAMPLING))
@pytest.mark.parametrize("content", ["smooth", "noisy"])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[1]}x{s[0]}")
def test_colour_decodes_as_pil(tmp_path, size, content, subsampling):
    """YCbCr at each subsampling, size and content: baseline, optimized
    Huffman tables, progressive with and without them, at qualities 1, 50,
    90 and 100 (16 files a case)."""
    pix = _pixels(*size, content, seed=2 * SIZES.index(size) + (content == "noisy"))
    for q in QUALITIES:
        for name, coding in CODINGS.items():
            _assert_decodes_as_pil(_save(pix, tmp_path / f"{name}_{q}.jpg", quality=q,
                                         subsampling=SUBSAMPLING[subsampling], **coding))


@pytest.mark.parametrize("content", ["smooth", "noisy"])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[1]}x{s[0]}")
def test_grey_and_adobe_rgb_decode_as_pil(tmp_path, size, content):
    """One component (grey; RGBA replicates it) in every coding, and RGB
    stored as it is (``keep_rgb=True``: an Adobe marker, transform 0)."""
    pix = _pixels(*size, content, seed=7 + SIZES.index(size))
    for q in QUALITIES:
        for name, coding in CODINGS.items():
            _assert_decodes_as_pil(_save(pix[..., 1], tmp_path / f"g_{name}_{q}.jpg", quality=q,
                                         **coding))
        for name in ("baseline", "progressive"):
            _assert_decodes_as_pil(_save(pix, tmp_path / f"rgb_{name}_{q}.jpg", quality=q,
                                         keep_rgb=True, **CODINGS[name]))


@pytest.mark.parametrize("coding", ["baseline", "progressive"])
@pytest.mark.parametrize("subsampling", sorted(SUBSAMPLING))
@pytest.mark.parametrize("restart", ["blocks_1", "blocks_3", "rows_1", "rows_2"])
def test_restart_markers_decode_as_pil(tmp_path, restart, subsampling, coding):
    """Restart intervals (``restart_marker_blocks``/``_rows``) over
    interleaved and single-component scans, 61×45 and grey 37×29."""
    kind, n = restart.split("_")
    opts = {f"restart_marker_{kind}": int(n), **CODINGS[coding]}
    for q in (50, 95):
        pix = _pixels(45, 61, "mixed", seed=q)
        _assert_decodes_as_pil(_save(pix, tmp_path / f"c{q}.jpg", quality=q,
                                     subsampling=SUBSAMPLING[subsampling], **opts))
        _assert_decodes_as_pil(_save(pix[:29, :37, 0], tmp_path / f"g{q}.jpg", quality=q,
                                     **opts))


def test_seeded_sweep_decodes_as_pil(tmp_path):
    """300 files of seeded random size (1-80 a side), content, mode,
    quality, subsampling, coding and restart interval."""
    rng = np.random.default_rng(2024)
    for i in range(300):
        h, w = (int(v) for v in rng.integers(1, 81, 2))
        pix = _pixels(h, w, ["smooth", "noisy", "mixed"][i % 3], seed=i)
        opts = {"quality": int(rng.integers(1, 101)), **CODINGS[list(CODINGS)[i % 4]]}
        mode = rng.integers(0, 4)
        if mode == 0:
            pix = pix[..., 0]
        elif mode == 1:
            opts["keep_rgb"] = True
        else:
            opts["subsampling"] = int(rng.integers(0, 3))
        if i % 5 == 0:
            opts["restart_marker_blocks"] = int(rng.integers(1, 6))
        _assert_decodes_as_pil(_save(pix, tmp_path / f"s{i}.jpg", **opts))


def test_thread_count_does_not_change_the_output(tmp_path):
    """Many files decoded over 1-7 C++ threads give PIL's frames each
    time."""
    paths = []
    for i in range(14):
        pix = _pixels(40 + i, 64 - i, ["smooth", "noisy", "mixed"][i % 3], seed=100 + i)
        opts = {"quality": 40 + 4 * i, "subsampling": i % 3, **CODINGS[list(CODINGS)[i % 4]]}
        paths.append(_save(pix[..., 0] if i % 5 == 4 else pix, tmp_path / f"t{i}.jpg", **opts))
    want = [jloader._load_frame_image(p) for p in paths]
    for n_threads in range(1, 8):
        got = read_jpegs_rgba(paths, n_threads=n_threads)
        assert all(np.array_equal(g, w) for g, w in zip(got, want)), n_threads


def _patched(data: bytes, marker: bytes, offset: int, value: int) -> bytes:
    """``data`` with the byte ``offset`` after the first ``marker`` set to
    ``value``."""
    i = data.index(marker) + offset
    return data[:i] + bytes([value]) + data[i + 1:]


def _unfinished_progressive(data: bytes) -> bytes:
    """A progressive file cut after its first scan, EOI appended: every AC
    coefficient unsent."""
    first = data.index(b"\xff\xda")
    second = data.index(b"\xff\xda", first + 2)
    return data[:second] + b"\xff\xd9"


REFUSALS = {
    # name: (how the file is made from a written 4:2:0 baseline one, error, match)
    "cmyk": (None, NotImplementedError, "4-component"),
    "truncated": (lambda d: d[:len(d) // 2], ValueError, "truncated"),
    "soi_only": (lambda d: b"\xff\xd8\xff", ValueError, "truncated"),
    "not_a_jpeg": (lambda d: b"\x89PNG" + d[4:], ValueError, "not a JPEG"),
    "arithmetic": (lambda d: _patched(d, b"\xff\xc0", 1, 0xC9), NotImplementedError,
                   "arithmetic coding"),
    "12_bit": (lambda d: _patched(d, b"\xff\xc0", 4, 12), NotImplementedError,
               "12-bit precision"),
    "lossless": (lambda d: _patched(d, b"\xff\xc0", 1, 0xC3), NotImplementedError, "lossless"),
    "hierarchical": (lambda d: _patched(d, b"\xff\xc0", 1, 0xC5), NotImplementedError,
                     "hierarchical"),
    # the second component's factors 2×2 (the frame header's 14th byte)
    "sampling": (lambda d: _patched(d, b"\xff\xc0", 14, 0x22), NotImplementedError,
                 "sampling factors"),
    "unrefined_progressive": (None, NotImplementedError, "unrefined"),
    "corrupt_entropy": (lambda d: d[:d.index(b"\xff\xda") + 30] + b"\xff\xff\xff\xff"
                        + d[d.index(b"\xff\xda") + 34:], ValueError, "corrupt"),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals_name_the_mode(tmp_path, name):
    """Each mode the decoder does not reproduce raises, naming it: CMYK
    written by PIL, a truncated file, arithmetic coding (the SOF marker set
    to 0xC9), 12-bit samples (the precision byte), lossless and
    hierarchical frames, chroma sampling other than 1×1, a progressive file
    whose AC scans never came, and corrupt entropy data."""
    pix = _pixels(40, 48, "mixed", seed=5)
    make, error, match = REFUSALS[name]
    path = tmp_path / "x.jpg"
    if name == "cmyk":
        Image.fromarray(pix).convert("CMYK").save(path, quality=90)
    elif name == "unrefined_progressive":
        _save(pix, path, quality=90, progressive=True)
        path.write_bytes(_unfinished_progressive(path.read_bytes()))
    else:
        _save(pix, path, quality=90, subsampling=2)
        path.write_bytes(make(path.read_bytes()))
    with pytest.raises(error, match=match):
        read_jpeg_rgba(str(path))
    with pytest.raises(error, match=match):
        read_jpegs_rgba([str(path)])


@pytest.mark.parametrize("kind", ["rgb420", "grey", "progressive", "adobe_rgb"])
def test_load_image_matches_jax(tmp_path, kind):
    """``load_image`` on a JPEG (sRGB → linear) equals the JAX package's."""
    pix = _pixels(45, 61, "mixed", seed=11)
    opts = {"rgb420": {"subsampling": 2}, "grey": {}, "progressive": {"progressive": True},
            "adobe_rgb": {"keep_rgb": True}}[kind]
    path = _save(pix[..., 2] if kind == "grey" else pix, tmp_path / "i.jpeg", quality=85, **opts)
    got, want = pimage.load_image(path), jimage.load_image(path)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _write_jpeg_capture(root, rng, h=24, w=30):
    """A directory of two json files (train and test JPEG frames of mixed
    modes) and a JPEG envmap."""
    os.makedirs(root / "train")
    os.makedirs(root / "test")
    _save(_pixels(16, 32, "smooth", seed=3), root / "sky.jpg", quality=92)
    k = 0
    for split, n in (("train", 4), ("test", 2)):
        frames = []
        for i in range(n):
            k += 1
            opts = {"quality": 60 + 8 * k, "subsampling": k % 3, **CODINGS[list(CODINGS)[k % 4]]}
            pix = _pixels(h, w, ["smooth", "noisy", "mixed"][k % 3], seed=k)
            _save(pix, root / split / f"r_{i}.jpg", **opts)
            frames.append({"file_path": f"./{split}/r_{i}",
                           "transform_matrix": _nerf_matrix(rng).tolist()})
        meta = {"x_fov": 50.0, "y_fov": 40.0, "aabb_scale": 2, "envmap": "sky.jpg",
                "frames": frames}
        with open(root / f"transforms_{split}.json", "w") as f:
            json.dump(meta, f)
    return str(root)


def test_load_nerf_jpeg_capture_matches_jax(tmp_path):
    """``load_nerf`` of a split capture of JPEG frames (extension resolved
    by the loader) with a JPEG envmap equals the JAX loader's, array for
    array, for the directory and for each split."""
    path = _write_jpeg_capture(tmp_path / "cap", np.random.default_rng(3))
    for p in (path, os.path.join(path, "transforms_train.json"),
              os.path.join(path, "transforms_test.json")):
        got, want = ploader.load_nerf(p), jloader.load_nerf(p)
        _assert_same_dataset(got, want)
    assert got.n_images == 2 and got.envmap is not None and got.envmap.shape == (16, 32, 4)


def test_fixtures_match_their_manifest():
    """The committed fixtures: PIL's RGBA decode of every file hashes to
    the manifest's sha256, and so does the port's; the JAX package's
    ``convert.sharpness`` of each capture frame is the manifest's; the
    capture loads as the JAX loader loads it."""
    manifest = json.load(open(os.path.join(FIXTURES, "manifest.json")))
    files = manifest["rgba_sha256"]
    on_disk = sorted(os.path.relpath(os.path.join(d, f), FIXTURES).replace(os.sep, "/")
                     for d, _, names in os.walk(FIXTURES) for f in names if f.endswith(".jpg"))
    assert sorted(files) == on_disk and len(files) == 28 + 11
    for rel, digest in files.items():
        path = os.path.join(FIXTURES, rel)
        with Image.open(path) as im:
            pil = np.ascontiguousarray(np.asarray(im.convert("RGBA"), np.uint8))
        assert hashlib.sha256(pil.tobytes()).hexdigest() == digest, rel
        assert hashlib.sha256(read_jpeg_rgba(path).tobytes()).hexdigest() == digest, rel
    for rel, value in manifest["sharpness"].items():
        assert jconvert.sharpness(os.path.join(FIXTURES, rel)) == value, rel
    train = os.path.join(FIXTURES, "capture", "transforms_train.json")
    _assert_same_dataset(ploader.load_nerf(train), jloader.load_nerf(train))


def test_testbed_trains_on_jpeg_scenes(tmp_path):
    """``Testbed`` takes a capture of JPEG frames (NeRF) and a ``.jpg``
    image (image mode) on the CPU: the images it trains on are the JAX
    package's loads, and a few steps run."""
    from ngp_tpu_torch.data.synthetic import write_sphere_capture
    from ngp_tpu_torch.testbed import Testbed

    train_json, _ = write_sphere_capture(str(tmp_path / "cap"), res=32)
    meta = json.load(open(train_json))
    for fr in meta["frames"]:
        png = os.path.join(tmp_path / "cap", fr["file_path"] + ".png")
        with Image.open(png) as im:
            im.convert("RGB").save(png[:-4] + ".jpg", quality=90)
        os.remove(png)
    tb = Testbed(scene=train_json, device="cpu", grid_size=16, batch_size=1 << 12)
    assert np.array_equal(tb.engine.images.cpu().numpy(), jloader.load_nerf(train_json).images)
    tb.train(2)
    shutil.copy(png[:-4] + ".jpg", tmp_path / "img.jpg")
    img = Testbed(scene=str(tmp_path / "img.jpg"), device="cpu")
    assert img.mode == "image"
    assert np.array_equal(img.engine.image.cpu().numpy(),
                          jimage.load_image(str(tmp_path / "img.jpg")))

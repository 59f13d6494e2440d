"""The port's capture path against PIL and the JAX package, on the CPU: the
PNG decoder and writer (``ngp_tpu_torch/data/png.py``), the EXR and image
loaders, ``load_nerf`` on synthetic captures written with PIL, and every
lens model of ``geometry/camera.py``.

Tolerances: decoded pixels exact (against PIL's ``convert("RGBA")`` and
``np.asarray``); ``load_nerf`` arrays exact; camera directions 1e-6
absolute on unit directions against the JAX package (its undistortion
takes the Jacobian by autodiff, the port's in closed form); undistortion
inverts distortion within 1e-5.
"""

import json
import os
import struct
import zlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from ngp_tpu.data import exr as jexr
from ngp_tpu.data import image_loader as jimage
from ngp_tpu.data import nerf_loader as jloader
from ngp_tpu.engines.nerf import NerfEngine as JaxNerfEngine
from ngp_tpu.geometry import camera as jcam
from ngp_tpu_torch.data import exr as pexr
from ngp_tpu_torch.data import image_loader as pimage
from ngp_tpu_torch.data import nerf_loader as ploader
from ngp_tpu_torch.data.png import (
    decode_png,
    encode_png,
    read_png,
    read_png_rgba,
    read_pngs_rgba,
    write_png,
)
from ngp_tpu_torch.geometry import camera as pcam

# One intra-op thread: with two, torch's CPU sqrt (MKL's vsSqrt, split across
# the intra-op threads) now and then returned one thread's chunk ~3e-4 off
# on an AVX-512 Xeon (torch 2.13, MKL 2024.2), never with one
# (scripts/torch_sqrt_threads.py counts it).
# Every port test module sets the same count, so that a pytest worker's
# count does not depend on which module it imported last.
torch.set_num_threads(1)


def _pil(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA")), np.asarray(im)


def _assert_decodes_as_pil(path):
    want_rgba, want_raw = _pil(path)
    got_rgba, got_raw = read_png_rgba(path), read_png(path)
    np.testing.assert_array_equal(got_rgba, want_rgba)
    assert got_rgba.dtype == np.uint8
    np.testing.assert_array_equal(got_raw, want_raw)
    assert got_raw.dtype == want_raw.dtype and got_raw.shape == want_raw.shape


def _pil_images(rng, h=19, w=23):
    """(name, PIL image, save kwargs) for every colour type PIL writes."""
    rgba = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    grey16 = rng.integers(0, 65536, (h, w)).astype(np.uint16)
    grey16[0, :4] = (0, 255, 256, 65535)
    out = [
        ("L", Image.fromarray(rgba[..., 0], "L"), {}),
        ("LA", Image.fromarray(rgba[..., :2], "LA"), {}),
        ("RGB", Image.fromarray(rgba[..., :3], "RGB"), {}),
        ("RGBA", Image.fromarray(rgba, "RGBA"), {}),
        ("I;16", Image.fromarray(grey16), {}),
        ("L_trns", Image.fromarray(rgba[..., 0], "L"), {"transparency": int(rgba[0, 0, 0])}),
        ("RGB_trns", Image.fromarray(rgba[..., :3], "RGB"),
         {"transparency": tuple(int(v) for v in rgba[0, 0, :3])}),
    ]
    for bits in (1, 2, 4, 8):
        k = 1 << bits
        idx = rng.integers(0, k, (h, w)).astype(np.uint8)
        im = Image.fromarray(idx, "P")
        im.putpalette(rng.integers(0, 256, 3 * k).astype(np.uint8).tolist())
        alphas = bytes(rng.integers(0, 256, max(1, k // 2)).astype(np.uint8))
        out.append((f"P{bits}", im, {"bits": bits}))
        out.append((f"P{bits}_trns", im, {"bits": bits, "transparency": alphas}))
    return out


def test_png_decoder_matches_pil_on_files_pil_writes(tmp_path):
    rng = np.random.default_rng(0)
    for name, im, kw in _pil_images(rng):
        path = str(tmp_path / f"{name}.png")
        im.save(path, **kw)
        _assert_decodes_as_pil(path)
    # an RGB image large enough that PIL's encoder picks several filters
    rgb = np.clip(np.cumsum(rng.integers(-3, 4, (64, 96, 3)), axis=1) + 128, 0, 255)
    path = str(tmp_path / "smooth.png")
    Image.fromarray(rgb.astype(np.uint8)).save(path)
    _assert_decodes_as_pil(path)


@pytest.mark.parametrize("filters", [(0, 1, 2, 3, 4), (0, 1, 2), (3,), (4,), (2, 4, 1)])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_png_writer_filter_cycles_read_back_by_pil(tmp_path, dtype, channels, filters):
    """The hand writer's files, with each filter cycle, decoded by PIL and
    by the port alike."""
    rng = np.random.default_rng(channels)
    hi = 256 if dtype == np.uint8 else 65536
    img = rng.integers(0, hi, (21, 17, channels)).astype(dtype)
    path = str(tmp_path / "w.png")
    write_png(path, img, filters=filters)
    _assert_decodes_as_pil(path)
    got = decode_png(open(path, "rb").read()).samples
    np.testing.assert_array_equal(got, img)  # lossless
    raw = zlib.decompress(open(path, "rb").read()[8 + 25 + 8:-12 - 4])  # IDAT
    stride = 17 * channels * (2 if dtype == np.uint16 else 1)
    kinds = np.frombuffer(raw, np.uint8).reshape(21, stride + 1)[:, 0]
    np.testing.assert_array_equal(kinds, [filters[r % len(filters)] for r in range(21)])


def test_png_batched_decoding_matches_pil(tmp_path):
    """``read_pngs_rgba`` unfilters files of one shape together, ``BATCH``
    at a time: files of two shapes (one with more files than a batch
    holds), several colour types, each with its own filter cycle, PIL's
    files among them."""
    from ngp_tpu_torch.data import png

    rng = np.random.default_rng(5)
    paths = []
    for i in range(png.BATCH + 4):
        h, w = (9, 20) if i % 4 == 0 else (15, 13)
        img = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
        path = str(tmp_path / f"b{i}.png")
        if i % 4 == 3:
            Image.fromarray(img).save(path)
        else:
            cycle = [(0, 1, 2, 3, 4), (1, 2), (4, 3, 0), (2,)][i % 4]
            write_png(path, img if i % 2 else img[..., :3], filters=cycle)
        paths.append(path)
    for path, got in zip(paths, read_pngs_rgba(paths)):
        np.testing.assert_array_equal(got, _pil(path)[0])


def _with_chunks(data: bytes, color_type: int, chunks) -> bytes:
    """``encode_png``'s bytes with another colour type in IHDR and the
    (kind, body) ``chunks`` (PLTE, tRNS) inserted after it."""
    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ihdr = bytearray(data[16:29])
    ihdr[9] = color_type
    return (data[:8] + chunk(b"IHDR", bytes(ihdr))
            + b"".join(chunk(k, b) for k, b in chunks) + data[33:])


def test_png_palette_and_transparency_match_pil(tmp_path):
    """Palette files and ``tRNS`` keys on 8- and 16-bit grey and RGB, some
    of which PIL cannot write: PIL compares its 8-bit samples with the
    key's low byte, and the port does the same."""
    rng = np.random.default_rng(3)
    pal = rng.integers(0, 256, (9, 3)).astype(np.uint8).tobytes()
    idx = rng.integers(0, 9, (13, 11)).astype(np.uint8)
    grey16 = np.array([[0, 44, 255, 256, 300, 555, 65535]], np.uint16)
    rgb8 = rng.integers(0, 4, (5, 6, 3)).astype(np.uint8)
    rgb16 = (rng.integers(0, 3, (5, 6, 3)) * 257).astype(np.uint16)
    cases = [
        (idx, 3, [(b"PLTE", pal), (b"tRNS", bytes([0, 77, 255]))]),
        (idx, 3, [(b"PLTE", pal)]),
        (grey16, 0, [(b"tRNS", struct.pack(">H", 300))]),
        (grey16, 0, [(b"tRNS", struct.pack(">H", 255))]),
        (rgb8, 2, [(b"tRNS", struct.pack(">3H", 1, 2, 3))]),
        (rgb16, 2, [(b"tRNS", struct.pack(">3H", 257, 514, 0))]),
    ]
    for i, (img, color_type, chunks) in enumerate(cases):
        path = str(tmp_path / f"p{i}.png")
        open(path, "wb").write(_with_chunks(encode_png(img), color_type, chunks))
        _assert_decodes_as_pil(path)


def test_png_refuses_interlaced_and_unsupported_files(tmp_path):
    data = bytearray(encode_png(np.zeros((4, 4, 3), np.uint8)))
    data[8 + 8 + 12] = 1  # IHDR's interlace byte: Adam7
    crc = zlib.crc32(bytes(data[12:8 + 8 + 13]))
    data[8 + 8 + 13:8 + 8 + 17] = struct.pack(">I", crc)
    path = str(tmp_path / "adam7.png")
    open(path, "wb").write(bytes(data))
    with pytest.raises(NotImplementedError, match="adam7.png.*Adam7"):
        read_png_rgba(path)
    Image.fromarray(np.zeros((4, 4), bool)).save(str(tmp_path / "one_bit.png"))
    with pytest.raises(NotImplementedError, match="bit depth 1"):
        read_png(str(tmp_path / "one_bit.png"))
    bad = bytearray(encode_png(np.zeros((4, 4), np.uint8)))
    bad[-20] ^= 1
    with pytest.raises(ValueError, match="CRC"):
        decode_png(bytes(bad))


def test_exr_and_image_loader_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    hdr = rng.uniform(0, 4, (18, 22, 4)).astype(np.float32)
    pexr.write_exr(str(tmp_path / "p.exr"), hdr)
    jexr.write_exr(str(tmp_path / "j.exr"), hdr)
    assert open(tmp_path / "p.exr", "rb").read() == open(tmp_path / "j.exr", "rb").read()
    np.testing.assert_array_equal(pexr.read_exr(str(tmp_path / "j.exr")),
                                  jexr.read_exr(str(tmp_path / "j.exr")))
    ldr = rng.integers(0, 256, (18, 22, 3), dtype=np.uint8)
    Image.fromarray(ldr).save(str(tmp_path / "a.png"))
    Image.fromarray(ldr).save(str(tmp_path / "x.jpg"), quality=90)
    pimage.save_binary_image(str(tmp_path / "b.bin"), hdr)
    for name in ("a.png", "p.exr", "b.bin", "x.jpg"):
        p = str(tmp_path / name)
        np.testing.assert_array_equal(pimage.load_image(p), jimage.load_image(p))
    for load in (pimage.load_image, jimage.load_image):
        with pytest.raises(FileNotFoundError):
            load(str(tmp_path / "missing.jpg"))


# -- load_nerf


def _nerf_matrix(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    m = np.eye(4)
    m[:3, :3] = q
    m[:3, 3] = rng.normal(size=3) * 2.0
    return m


def _write_ldr_capture(root, rng, n=8, h=12, w=16):
    """PNG frames of every colour type written by PIL; every key of the
    dialect; one frame missing, one without its extension, one culled by
    sharpness; start/end matrices; 16-bit depth maps; rays files; a PNG
    envmap."""
    os.makedirs(root / "images")
    frames = []
    modes = ["RGBA", "RGB", "L", "LA", "P", "RGBA", "RGB", "RGBA"]
    for i in range(n):
        arr = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
        mode = modes[i % len(modes)]
        if mode == "P":
            im = Image.fromarray(arr[..., 0] % 16, "P")
            im.putpalette(rng.integers(0, 256, 48).astype(np.uint8).tolist())
            im.save(root / "images" / f"f{i}.png", transparency=bytes(range(0, 240, 30)))
        else:
            sl = {"RGBA": 4, "RGB": 3, "L": 1, "LA": 2}[mode]
            Image.fromarray(arr[..., :sl].squeeze(-1) if sl == 1 else arr[..., :sl],
                            mode).save(root / "images" / f"f{i}.png")
        depth = rng.integers(0, 65536, (h, w)).astype(np.uint16)
        Image.fromarray(depth).save(root / "images" / f"d{i}.png")
        rays = rng.normal(size=(h * w * 6 + 5)).astype(np.float32)
        rays.tofile(root / "images" / f"rays_f{i}.dat")
        fr = {"file_path": f"images/f{i}" if i == 2 else f"images/f{i}.png",
              "transform_matrix": _nerf_matrix(rng).tolist(),
              "sharpness": float(rng.uniform(50, 100)) if i != 5 else 1.0,
              "depth_path": f"images/d{i}.png"}
        if i == 3:
            fr.pop("transform_matrix")
            fr["transform_matrix_start"] = _nerf_matrix(rng).tolist()
            fr["transform_matrix_end"] = _nerf_matrix(rng).tolist()
        if i == 6:
            fr["fl_x"], fr["cx"] = 21.5, 8.7  # per-frame intrinsics
        frames.append(fr)
    frames.append({"file_path": "images/missing.png",
                   "transform_matrix": _nerf_matrix(rng).tolist()})
    Image.fromarray(rng.integers(0, 256, (8, 16, 3), dtype=np.uint8)).save(root / "env.png")
    meta = {"fl_x": 20.0, "fl_y": 21.0, "cx": 7.5, "cy": 6.25, "k1": -0.1, "k2": 0.02,
            "p1": 1e-3, "p2": -1e-3, "aabb_scale": 4, "aabb": [[-1, -2, -1], [3, 1, 2]],
            "up": [0.1, 0.2, 0.97], "render_aabb": [[-0.5, -0.5, -0.5], [0.5, 0.6, 0.7]],
            "n_extra_learnable_dims": 3, "sharpness_discard_threshold": 0.5,
            "integer_depth_scale": 1.0 / 65535, "rolling_shutter": [0.1, 0.2, 0.3],
            "envmap": "env.png", "frames": frames}
    with open(root / "transforms.json", "w") as f:
        json.dump(meta, f)
    return str(root / "transforms.json")


def _write_hdr_capture(root, rng, n=4, h=10, w=12):
    """EXR frames (three and four channels) sharpened at load, a fisheye
    lens, a focal from ``camera_angle_x``, an EXR envmap."""
    os.makedirs(root)
    frames = []
    for i in range(n):
        img = rng.uniform(0.05, 2.0, (h, w, 3 + i % 2)).astype(np.float32)
        pexr.write_exr(str(root / f"h{i}.exr"), img)
        frames.append({"file_path": f"h{i}.exr",
                       "transform_matrix": _nerf_matrix(rng).tolist()})
    pexr.write_exr(str(root / "env.exr"), rng.uniform(0, 3, (6, 12, 3)).astype(np.float32))
    meta = {"camera_angle_x": 0.9, "k1": 0.05, "k2": -0.01, "k3": 0.002, "k4": -0.001,
            "is_fisheye": True, "scale": 0.5, "offset": 0.25, "sharpen": 0.7,
            "envmap": "env.exr", "frames": frames}
    with open(root / "transforms.json", "w") as f:
        json.dump(meta, f)
    return str(root / "transforms.json")


def _write_split_capture(root, rng, h=8, w=10):
    """A directory of two json files (train and test frames), with
    ``x_fov`` focals and no depth or rays."""
    os.makedirs(root / "train")
    os.makedirs(root / "test")
    for split, n in (("train", 3), ("test", 2)):
        frames = []
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (h, w, 4), dtype=np.uint8)).save(
                root / split / f"r_{i}.png")
            frames.append({"file_path": f"./{split}/r_{i}",
                           "transform_matrix": _nerf_matrix(rng).tolist()})
        with open(root / f"transforms_{split}.json", "w") as f:
            json.dump({"x_fov": 50.0, "y_fov": 40.0, "aabb_scale": 2, "frames": frames}, f)
    return str(root)


_FIELDS = ("images", "xforms", "focal_lengths", "principal_points", "resolution",
           "scale", "offset", "aabb_scale", "up", "paths", "is_hdr",
           "n_extra_learnable_dims", "wants_importance_sampling", "render_aabb",
           "depths", "sharpness", "rolling_shutter", "envmap", "rays")


def _assert_same_dataset(p, j, skip=()):
    assert tuple(p.lens.params) == tuple(j.lens.params) and p.lens.mode == j.lens.mode
    for name in _FIELDS:
        if name in skip:
            continue
        a, b = getattr(p, name), getattr(j, name)
        if name == "render_aabb" and a is not None:
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
            continue
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            assert a is not None and b is not None, name
            assert np.asarray(a).dtype == np.asarray(b).dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name


@pytest.mark.parametrize("kind", ["ldr", "hdr", "split"])
def test_load_nerf_matches_jax(tmp_path, kind):
    rng = np.random.default_rng({"ldr": 10, "hdr": 11, "split": 12}[kind])
    writer = {"ldr": _write_ldr_capture, "hdr": _write_hdr_capture,
              "split": _write_split_capture}[kind]
    path = writer(tmp_path / kind, rng)
    p, j = ploader.load_nerf(path), jloader.load_nerf(path)
    if kind == "hdr":
        # C.ref 7: the JAX loader's sharpen filter reuses the name ``up``
        # for its index array, which then replaces the dataset's up vector
        _assert_same_dataset(p, j, skip=("up",))
        np.testing.assert_array_equal(p.up, np.asarray([0, 0, 1], np.float32)[[1, 2, 0]])
        assert p.is_hdr and p.images.dtype == np.float16
        assert p.lens.mode == pcam.LENS_OPENCV_FISHEYE
        raw = pexr.read_exr(str(tmp_path / kind / "h1.exr")).astype(np.float16)
        assert not np.array_equal(p.images[1], raw)  # sharpened at load
    else:
        _assert_same_dataset(p, j)
    if kind == "ldr":
        assert p.n_images == 7  # one frame missing, one culled by sharpness
        assert p.depths is not None and p.rays is not None and p.envmap is not None
        assert p.lens.mode == pcam.LENS_OPENCV
        assert not np.array_equal(p.xforms[3, 0], p.xforms[3, 1])  # start/end
    if kind == "split":
        assert p.n_images == 5 and p.paths[0].endswith(".png")


def test_dataset_subset_and_conversions_match_jax(tmp_path):
    rng = np.random.default_rng(13)
    path = _write_ldr_capture(tmp_path / "c", rng)
    p, j = ploader.load_nerf(path), jloader.load_nerf(path)
    _assert_same_dataset(p.subset([4, 0, 2]), j.subset([4, 0, 2]))
    pts = rng.normal(size=(7, 3)).astype(np.float32)
    for fn in ("nerf_direction_to_ngp", "nerf_position_to_ngp", "ngp_position_to_nerf"):
        np.testing.assert_array_equal(getattr(p, fn)(pts), getattr(j, fn)(pts))
    m = rng.normal(size=(3, 4)).astype(np.float32)
    off = np.asarray([0.5, 0.4, 0.3], np.float32)
    np.testing.assert_array_equal(ploader.nerf_matrix_to_ngp(m, 0.33, off),
                                  jloader.nerf_matrix_to_ngp(m, 0.33, off))
    np.testing.assert_array_equal(ploader.ngp_matrix_to_nerf(m, 0.33, off),
                                  jloader.ngp_matrix_to_nerf(m, 0.33, off))


def test_load_nerf_refuses_what_the_reference_refuses(tmp_path):
    rng = np.random.default_rng(14)
    path = _write_split_capture(tmp_path / "s", rng)
    meta = json.load(open(os.path.join(path, "transforms_train.json")))
    for bad in (3, 256):
        meta["aabb_scale"] = bad
        with open(os.path.join(path, "transforms_train.json"), "w") as f:
            json.dump(meta, f)
        with pytest.raises(ValueError, match="aabb_scale"):
            ploader.load_nerf(os.path.join(path, "transforms_train.json"))
    # a JPEG frame of the capture's size loads as the JAX loader loads it;
    # one of another size is refused by both (mixed resolutions)
    Image.fromarray(np.zeros((8, 10, 3), np.uint8)).save(tmp_path / "s" / "train" / "r_0.jpg")
    meta["aabb_scale"] = 1
    meta["frames"][0]["file_path"] = "./train/r_0.jpg"
    with open(os.path.join(path, "transforms_train.json"), "w") as f:
        json.dump(meta, f)
    train_json = os.path.join(path, "transforms_train.json")
    _assert_same_dataset(ploader.load_nerf(train_json), jloader.load_nerf(train_json))
    Image.fromarray(np.zeros((9, 10, 3), np.uint8)).save(tmp_path / "s" / "train" / "r_0.jpg")
    for load in (ploader.load_nerf, jloader.load_nerf):
        with pytest.raises(NotImplementedError, match="mixed image resolutions"):
            load(train_json)


# -- lenses

LENSES = {
    "pinhole": (pcam.LENS_PINHOLE, (0.0,) * 7),
    "opencv": (pcam.LENS_OPENCV, (-0.1, 0.02, 1e-3, -1e-3, 0.0, 0.0, 0.0)),
    "fisheye": (pcam.LENS_OPENCV_FISHEYE, (0.05, -0.01, 0.002, -0.001, 0.0, 0.0, 0.0)),
    "ftheta": (pcam.LENS_FTHETA, (0.0, 1.5e-3, 1e-7, -1e-10, 1e-14, 800.0, 600.0)),
    "latlong": (pcam.LENS_LATLONG, (0.0,) * 7),
    "equirect": (pcam.LENS_EQUIRECT, (0.0,) * 7),
}


def _unit(a):
    a = np.array(a, np.float64)
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


@pytest.mark.parametrize("name", list(LENSES))
def test_uv_to_ray_matches_jax(name):
    mode, params = LENSES[name]
    rng = np.random.default_rng(20)
    uv = rng.uniform(0, 1, (2048, 2)).astype(np.float32)
    xf = rng.normal(size=(3, 4)).astype(np.float32)
    ap = rng.uniform(0, 1, (2048, 2)).astype(np.float32)
    for kw in ({}, {"aperture_size": 0.05, "focus_z": 2.0, "near_distance": 0.1}):
        o, d = jcam.uv_to_ray(jnp.asarray(uv), (800, 600), jnp.asarray([700.0, 710.0]),
                              jnp.asarray(xf), jnp.asarray([0.52, 0.47]),
                              jcam.Lens(mode, params), aperture_uv=jnp.asarray(ap), **kw)
        po, pd = pcam.uv_to_ray(torch.from_numpy(uv), (800, 600), [700.0, 710.0],
                                torch.from_numpy(xf), [0.52, 0.47], pcam.Lens(mode, params),
                                aperture_uv=torch.from_numpy(ap), **kw)
        np.testing.assert_allclose(_unit(pd.numpy()), _unit(d), rtol=0, atol=1e-6)
        np.testing.assert_allclose(po.numpy(), np.asarray(o), rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", list(LENSES))
def test_pixel_dirs_cam_matches_jax_engine(name):
    """The training rays' and ``view_rays``' camera directions against the
    JAX engine's ``_pixel_dirs_cam``, with per-ray intrinsics."""
    mode, params = LENSES[name]
    rng = np.random.default_rng(21)
    n = 4096
    uv = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    focal = rng.uniform(600, 800, (n, 2)).astype(np.float32)
    pp = rng.uniform(0.45, 0.55, (n, 2)).astype(np.float32)
    fake = SimpleNamespace(lens=jcam.Lens(mode, params), resolution=(800, 600))
    want = JaxNerfEngine._pixel_dirs_cam(fake, jnp.asarray(uv), jnp.asarray(focal),
                                         jnp.asarray(pp))
    got = pcam.pixel_dirs_cam(pcam.Lens(mode, params), (800, 600), torch.from_numpy(uv),
                              torch.from_numpy(focal), torch.from_numpy(pp))
    np.testing.assert_allclose(_unit(got.numpy()), _unit(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["opencv", "fisheye"])
def test_undistortion_inverts_distortion(name):
    _, params = LENSES[name]
    delta = {"opencv": pcam.opencv_lens_distortion_delta,
             "fisheye": pcam.opencv_fisheye_lens_distortion_delta}[name]
    rng = np.random.default_rng(22)
    u, v = (torch.from_numpy(rng.uniform(-0.6, 0.6, 5000).astype(np.float32))
            for _ in range(2))
    p = torch.tensor(params, dtype=torch.float32)
    x, y = pcam.iterative_undistortion(delta, p, u, v)
    du, dv = delta(p, x, y)
    torch.testing.assert_close(x + du, u, rtol=0, atol=1e-5)
    torch.testing.assert_close(y + dv, v, rtol=0, atol=1e-5)
    # the closed-form Jacobian against forward-mode autodiff of the delta
    jac = {"opencv": pcam.opencv_lens_distortion_jacobian,
           "fisheye": pcam.opencv_fisheye_lens_distortion_jacobian}[name](p, x, y)
    ones = torch.ones_like(x)
    for axis, (d_du, d_dv) in enumerate(((jac[0], jac[2]), (jac[1], jac[3]))):
        tangents = (ones, 0 * ones) if axis == 0 else (0 * ones, ones)
        _, (tu, tv) = torch.func.jvp(lambda a, b: delta(p, a, b), (x, y), tangents)
        torch.testing.assert_close(d_du, tu, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(d_dv, tv, rtol=1e-5, atol=1e-6)


def test_camera_helpers_match_jax():
    rng = np.random.default_rng(23)
    sq = rng.uniform(-1, 1, (512, 2)).astype(np.float32)
    sq[:3] = ((0, 0), (0.5, 0), (0, -0.5))
    np.testing.assert_allclose(pcam.square2disk_shirley(torch.from_numpy(sq)).numpy(),
                               np.asarray(jcam.square2disk_shirley(jnp.asarray(sq))),
                               rtol=0, atol=1e-6)
    grid = rng.normal(size=(7, 9, 2)).astype(np.float32)
    uv = rng.uniform(-0.1, 1.1, (300, 2)).astype(np.float32)
    np.testing.assert_allclose(
        pcam.grid_at_lerp(torch.from_numpy(grid), torch.from_numpy(uv)).numpy(),
        np.asarray(jcam.grid_at_lerp(jnp.asarray(grid), jnp.asarray(uv))), rtol=0, atol=1e-6)
    px = rng.integers(0, 50, (20, 2)).astype(np.int32)
    jit = rng.uniform(0, 1, (20, 2)).astype(np.float32)
    for j in (None, jit):
        np.testing.assert_array_equal(
            pcam.pixel_to_uv(torch.from_numpy(px), (64, 48),
                             None if j is None else torch.from_numpy(j)).numpy(),
            np.asarray(jcam.pixel_to_uv(jnp.asarray(px), (64, 48),
                                        None if j is None else jnp.asarray(j))))
    assert pcam.fov_to_focal_length(800, 50.0) == jcam.fov_to_focal_length(800, 50.0)
    assert pcam.focal_length_to_fov(800, 700.0) == jcam.focal_length_to_fov(800, 700.0)

"""The port's dataset converters (``ngp_tpu_torch/data/convert.py``) and
their entry points (``python -m ngp_tpu_torch.scripts.<name>``) against
the JAX package's ``ngp_tpu/data/convert.py`` and ``scripts/``, on the
CPU, on ``tests/test_convert.py``'s synthetic scenes.

Tolerances: outputs compare as equal trees (dict keys, list lengths,
strings, ints and bools equal) with floats within 1e-12 absolute;
``sharpness`` exactly; images written by ``convert_image`` byte for byte
(``.bin``, ``.exr``), and ``.png`` within one 8-bit level at no more than
5% of the samples (the sRGB curve's float32 ``pow`` in torch and in XLA
differ in the last bit at some inputs, and the PNG truncates).
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from ngp_tpu.data import convert as jconv
from ngp_tpu_torch.data import convert as pconv
from ngp_tpu_torch.data.png import read_png
from test_convert import _look_at_c2w, _make_colmap_scene, _rotmat_to_quat, _write

# One intra-op thread, as in every port test module (test_torch_capture.py).
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-12


def _assert_same_tree(a, b, where="out"):
    """``a`` and ``b`` (json-like, numpy arrays as lists) are equal, floats
    within ``TOL``."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a).tolist(), np.asarray(b).tolist()
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), where
        for k in a:
            _assert_same_tree(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tree(x, y, f"{where}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert isinstance(a, (int, float)) and isinstance(b, (int, float)), where
        assert abs(a - b) <= TOL, (where, a, b)
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


# -- the math helpers


def test_math_helpers_match_jax():
    """``qvec2rotmat``, ``rotmat_between`` (the antiparallel perturbation
    drawn from the same numpy seed), ``closest_point_2_lines``."""
    rng = np.random.default_rng(0)
    for _ in range(50):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        _assert_same_tree(pconv.qvec2rotmat(q), jconv.qvec2rotmat(q))
        a, b = rng.normal(size=3), rng.normal(size=3)
        _assert_same_tree(pconv.rotmat_between(a, b), jconv.rotmat_between(a, b))
        oa, da, ob, db = (rng.normal(size=3) for _ in range(4))
        _assert_same_tree(list(pconv.closest_point_2_lines(oa, da, ob, db)),
                          list(jconv.closest_point_2_lines(oa, da, ob, db)))
    a = np.array([0.0, 0.0, 1.0])
    np.random.seed(3)
    got = pconv.rotmat_between(a, -a)
    np.random.seed(3)
    _assert_same_tree(got, jconv.rotmat_between(a, -a))


def _frames(rng, n=7):
    frames = []
    for _ in range(n):
        m = np.eye(4)
        m[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        m[:3, 3] = rng.uniform(-2, 2, 3)
        frames.append({"transform_matrix": m})
    return frames


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_frame_geometry_matches_jax(seed):
    """``center_of_attention``, ``reorient_and_rescale`` (in place, both
    target distances) and ``min_line_dist_center`` on random frames."""
    rng = np.random.default_rng(seed)
    frames = _frames(rng)
    copy = lambda fs: [{"transform_matrix": f["transform_matrix"].copy()} for f in fs]  # noqa: E731
    _assert_same_tree(pconv.center_of_attention(frames), jconv.center_of_attention(frames))
    _assert_same_tree(pconv.min_line_dist_center(frames), jconv.min_line_dist_center(frames))
    for target in (4.0, 1.5):
        p, j = copy(frames), copy(frames)
        _assert_same_tree(pconv.reorient_and_rescale(p, target),
                          jconv.reorient_and_rescale(j, target))


# -- COLMAP

COLMAP_CAMERAS = {
    "SIMPLE_PINHOLE": "1 SIMPLE_PINHOLE 640 480 500.5 320.25 240.75",
    "PINHOLE": "1 PINHOLE 640 480 500.0 510.0 320.0 240.0",
    "SIMPLE_RADIAL": "1 SIMPLE_RADIAL 2048 1536 1580.46 1024 768 0.0045691",
    "RADIAL": "1 RADIAL 800 600 700 400 300 0.01 -0.002",
    "OPENCV": "1 OPENCV 640 480 500.0 510.0 320.0 240.0 0.01 -0.002 0.0001 0.0002",
    "SIMPLE_RADIAL_FISHEYE": "1 SIMPLE_RADIAL_FISHEYE 1920 1080 900 960 540 0.05",
    "RADIAL_FISHEYE": "1 RADIAL_FISHEYE 1920 1080 900 960 540 0.05 -0.01",
    "OPENCV_FISHEYE": "1 OPENCV_FISHEYE 3840 2160 1800 1810 1920 1080 0.1 0.01 0.001 0.0001",
}


@pytest.mark.parametrize("model", sorted(COLMAP_CAMERAS))
def test_parse_colmap_cameras_matches_jax(tmp_path, model):
    """Every camera model the JAX parser takes, after a comment and a
    first camera that the last one replaces."""
    p = tmp_path / "cameras.txt"
    _write(p, "# cameras\n\n1 PINHOLE 10 10 5 5 5 5\n" + COLMAP_CAMERAS[model] + "\n")
    _assert_same_tree(pconv.parse_colmap_cameras(str(p)), jconv.parse_colmap_cameras(str(p)))


def test_parse_colmap_refusals_match_jax(tmp_path):
    p = tmp_path / "cameras.txt"
    for text, match in (("1 FOV 640 480 500 320 240 0.9\n", "unknown COLMAP camera model"),
                        ("# none\n", "no cameras")):
        _write(p, text)
        for parse in (pconv.parse_colmap_cameras, jconv.parse_colmap_cameras):
            with pytest.raises(ValueError, match=match):
                parse(str(p))


def test_parse_colmap_images_matches_jax(tmp_path):
    text = _make_colmap_scene(tmp_path, n=6)
    path = os.path.join(text, "images.txt")
    with open(path, "a") as f:  # a name with spaces joins with "_"
        f.write("7 1 0 0 0 0.5 0.25 2 1 frame with spaces.png\n1 2 3\n")
    got, want = pconv.parse_colmap_images(path), jconv.parse_colmap_images(path)
    assert [g[0] for g in got] == [w[0] for w in want] and len(got) == 7
    for g, w in zip(got, want):
        _assert_same_tree(list(g[1:]), list(w[1:]))


def _write_images(folder, n, suffix, rng, grey=False):
    os.makedirs(folder, exist_ok=True)
    for i in range(n):
        pix = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
        pix = np.cumsum(pix, 1).astype(np.uint8)  # structure, not noise only
        img = Image.fromarray(pix[..., 0] if grey and i % 2 else pix)
        img.save(os.path.join(folder, f"img_{i}{suffix}"), **(
            {"quality": 85} if suffix == ".jpg" else {}))


@pytest.mark.parametrize("keep", [False, True], ids=["reoriented", "colmap_coords"])
@pytest.mark.parametrize("sharp", [False, True], ids=["plain", "sharpness"])
def test_colmap_to_transforms_matches_jax(tmp_path, monkeypatch, keep, sharp):
    """The COLMAP conversion, reoriented or in COLMAP's coordinates, with
    the sharpness of JPEG frames (the paths relative to the working
    directory, as the JAX converter reads them)."""
    text = _make_colmap_scene(tmp_path)
    monkeypatch.chdir(tmp_path)
    _write_images("images", 8, ".jpg", np.random.default_rng(4), grey=True)
    kw = dict(image_dir="images", aabb_scale=16, skip_early=0, keep_colmap_coords=keep,
              compute_sharpness=sharp)
    # a ring's mean up vector can be antiparallel to +z, where
    # rotmat_between perturbs it from np.random: both calls draw the same
    np.random.seed(11)
    got = pconv.colmap_to_transforms(text, **kw)
    np.random.seed(11)
    _assert_same_tree(got, jconv.colmap_to_transforms(text, **kw))
    assert len(got["frames"]) == 8 and ("sharpness" in got["frames"][0]) == sharp
    json.dumps(got)


# -- sharpness


@pytest.mark.parametrize("kind", ["rgb_png", "rgba_png", "grey_png", "grey_alpha_png",
                                  "palette_png", "rgb_jpg", "grey_jpg", "progressive_jpg",
                                  "adobe_rgb_jpg"])
def test_sharpness_matches_jax_exactly(tmp_path, kind):
    """``sharpness`` equals the JAX value exactly: PIL's ``convert("L")``
    integer rule on RGB(A), a grey file as it is."""
    rng = np.random.default_rng(len(kind))
    pix = np.cumsum(rng.integers(0, 40, (57, 71, 4)), 1).astype(np.uint8)
    name, fmt = kind.rsplit("_", 1)
    img = {"rgb": Image.fromarray(pix[..., :3]), "rgba": Image.fromarray(pix),
           "grey": Image.fromarray(pix[..., 0]), "grey_alpha": Image.fromarray(pix[..., :2], "LA"),
           "palette": Image.fromarray(pix[..., :3]).convert("P"),
           "progressive": Image.fromarray(pix[..., :3]),
           "adobe_rgb": Image.fromarray(pix[..., :3])}[name]
    path = str(tmp_path / f"x.{fmt}")
    opts = {"png": {}, "jpg": {"quality": 80}}[fmt]
    if name == "progressive":
        opts["progressive"] = True
    if name == "adobe_rgb":
        opts["keep_rgb"] = True
    img.save(path, **opts)
    got, want = pconv.sharpness(path), jconv.sharpness(path)
    assert got == want and got > 0


# -- NSVF, Record3D, NeRFCapture


def _write_nsvf(scene, suffix, k_matrix):
    (scene / "rgb").mkdir(parents=True)
    (scene / "pose").mkdir()
    rng = np.random.default_rng(5)
    for split, idx in [("0", 0), ("0", 1), ("1", 0), ("2", 0), ("2", 1)]:
        Image.fromarray(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)).save(
            scene / "rgb" / f"{split}_{idx:04d}{suffix}")
        m = np.eye(4)
        m[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        m[:3, 3] = [idx * 0.5, 1.0, 2.0]
        _write(scene / "pose" / f"{split}_{idx:04d}.txt", " ".join(str(v) for v in m.reshape(-1)))
    intr = ("100.0 0 32.0 0\n0 101.0 24.0 0\n0 0 1 0\n0 0 0 1\n" if k_matrix
            else "100.0 32.0 24.0 0.\n0. 0. 0.\n0.\n1.\n")
    _write(scene / "intrinsics.txt", intr)
    _write(scene / "bbox.txt", "-1 -1.5 -1 1 1 2 0.1\n")
    return str(scene)


@pytest.mark.parametrize("suffix", [".png", ".jpg"])
@pytest.mark.parametrize("k_matrix", [False, True], ids=["f_cx_cy", "k_matrix"])
def test_nsvf_to_transforms_matches_jax(tmp_path, suffix, k_matrix):
    """NSVF splits, both intrinsics forms; the image size from the first
    file's PNG IHDR or JPEG frame header."""
    scene = _write_nsvf(tmp_path / "s", suffix, k_matrix)
    _assert_same_tree(pconv.nsvf_to_transforms(scene, 4), jconv.nsvf_to_transforms(scene, 4))
    assert pconv.image_size(os.path.join(scene, "rgb", f"0_0000{suffix}")) == (64, 48)


def _write_record3d(root, n=5):
    (root / "rgbd").mkdir(parents=True)
    poses = []
    for i in range(n):
        Image.fromarray(np.zeros((32, 24, 3), np.uint8)).save(root / "rgbd" / f"{i}.jpg")
        a = 2 * math.pi * i / n
        eye = [2 * math.cos(a), 2 * math.sin(a), 0.5 + 0.1 * i]
        w, x, y, z = _rotmat_to_quat(_look_at_c2w(eye, [0, 0.1, 0])[:3, :3])
        poses.append([x, y, z, w, *eye])
    _write(root / "metadata", json.dumps({"poses": poses,
                                          "K": [100.0, 0, 0, 0, 110.5, 0, 12.25, 16, 1],
                                          "w": 24, "h": 32}))
    return str(root)


@pytest.mark.parametrize("subsample", [1, 2])
def test_record3d_to_transforms_matches_jax(tmp_path, subsample):
    scene = _write_record3d(tmp_path / "r")
    _assert_same_tree(pconv.record3d_to_transforms(scene, subsample),
                      jconv.record3d_to_transforms(scene, subsample))


@pytest.mark.parametrize("depth_scale", [None, 10.0])
def test_nerfcapture_to_transforms_matches_jax(depth_scale):
    rng = np.random.default_rng(6)
    frames = [{"file_path": f"images/{i}.png", "fl_x": 500 + i, "fl_y": 505.5,
               "cx": 320 - i, "cy": 240, "transform_matrix": rng.normal(size=(4, 4)),
               **({"depth_path": f"images/{i}.depth.png"} if i % 2 else {})}
              for i in range(4)]
    _assert_same_tree(pconv.nerfcapture_to_transforms(frames, 640, 480, 8, depth_scale),
                      jconv.nerfcapture_to_transforms(frames, 640, 480, 8, depth_scale))


# -- the entry points


def _run(args, cwd):
    env = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu"}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_colmap2nerf_entry_point_matches_jax(tmp_path):
    """``python -m ngp_tpu_torch.scripts.colmap2nerf`` writes the JSON the
    JAX script writes, with sharpness on and off, reoriented and in
    COLMAP's coordinates. The reoriented run skips a frame of the ring:
    the whole ring's mean up vector is antiparallel to +z, which both
    scripts perturb from an unseeded np.random."""
    _make_colmap_scene(tmp_path)
    _write_images(tmp_path / "images", 8, ".jpg", np.random.default_rng(7))
    for extra in (["--skip_early", "1"], ["--keep_colmap_coords", "--no_sharpness",
                                          "--aabb_scale", "4", "--skip_early", "2"]):
        port = _run(["-m", "ngp_tpu_torch.scripts.colmap2nerf", "--out", "p.json", *extra],
                    tmp_path)
        jax = _run([os.path.join(REPO, "scripts", "colmap2nerf.py"), "--out", "j.json", *extra],
                   tmp_path)
        assert port.returncode == 0 and jax.returncode == 0, (port.stderr, jax.stderr)
        assert port.stdout.replace("p.json", "j.json") == jax.stdout
        _assert_same_tree(json.load(open(tmp_path / "p.json")),
                          json.load(open(tmp_path / "j.json")))


def test_colmap2nerf_runs_colmap_as_the_jax_script_does(tmp_path, monkeypatch):
    """``--run_colmap`` runs the JAX script's ``colmap`` command lines, in
    order (neither host has the binary: the calls are recorded)."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import colmap2nerf as jscript

    from ngp_tpu_torch.scripts import colmap2nerf as pscript

    class Stop(Exception):
        pass

    def stop(*args, **kwargs):
        raise Stop

    argv = ["--run_colmap", "--colmap_matcher", "exhaustive", "--images", "imgs",
            "--text", "txt", "--colmap_db", "db.db", "--colmap_camera_model", "PINHOLE"]
    monkeypatch.chdir(tmp_path)
    calls = {}
    for name, script in (("port", pscript), ("jax", jscript)):
        calls[name] = []
        monkeypatch.setattr(script.subprocess, "check_call", calls[name].append)
        monkeypatch.setattr(script, "colmap_to_transforms", stop)
        with pytest.raises(Stop):
            if name == "port":
                script.main(argv)
            else:
                monkeypatch.setattr(sys, "argv", ["colmap2nerf.py", *argv])
                script.main()
    assert calls["port"] == calls["jax"] and len(calls["port"]) == 5
    assert calls["port"][1][1] == "exhaustive_matcher"


def test_nsvf2nerf_and_record3d2nerf_entry_points_match_jax(tmp_path):
    """Both write the JAX scripts' json files for the same arguments."""
    for name, writer, args in (
            ("nsvf2nerf", lambda p: _write_nsvf(p, ".jpg", True), ["--aabb_scale", "8"]),
            ("record3d2nerf", _write_record3d, ["--subsample", "2"])):
        outs = {}
        for who in ("port", "jax"):
            scene = writer(tmp_path / f"{name}_{who}")
            cmd = (["-m", f"ngp_tpu_torch.scripts.{name}"] if who == "port"
                   else [os.path.join(REPO, "scripts", f"{name}.py")])
            proc = _run([*cmd, "--scene", scene, *args], tmp_path)
            assert proc.returncode == 0, proc.stderr
            outs[who] = {f: json.load(open(os.path.join(scene, f)))
                         for f in sorted(os.listdir(scene)) if f.endswith(".json")}
        assert outs["port"] and sorted(outs["port"]) == sorted(outs["jax"])
        # the NSVF file paths name each run's own folder
        text = json.dumps(outs["port"]).replace(f"{name}_port", f"{name}_jax")
        _assert_same_tree(json.loads(text), outs["jax"])


def test_convert_image_entry_point_matches_jax(tmp_path):
    """``convert_image`` from a JPEG and a PNG: ``.bin`` and ``.exr`` the
    JAX script's bytes, ``.png`` its pixels within a level; another output
    type raises ``ValueError`` naming the four (``.jpg`` output is held to
    the JAX script in ``tests/test_torch_jpeg_encode.py``)."""
    rng = np.random.default_rng(8)
    Image.fromarray(np.cumsum(rng.integers(0, 30, (30, 41, 3)), 1).astype(np.uint8)).save(
        tmp_path / "in.jpg", quality=90)
    Image.fromarray(rng.integers(0, 256, (17, 23, 4), dtype=np.uint8)).save(tmp_path / "in.png")
    for src in ("in.jpg", "in.png"):
        for ext in (".bin", ".exr", ".png"):
            outs = {}
            for who in ("port", "jax"):
                out = f"{who}_{src[3:6]}{ext}"
                cmd = (["-m", "ngp_tpu_torch.scripts.convert_image"] if who == "port"
                       else [os.path.join(REPO, "scripts", "convert_image.py")])
                proc = _run([*cmd, "--input", src, "--output", out], tmp_path)
                assert proc.returncode == 0, proc.stderr
                outs[who] = tmp_path / out
            if ext == ".png":
                # the sRGB curve's float32 pow: torch's and XLA's differ in
                # the last bit now and then, and an 8-bit input's round trip
                # lands on whole levels, where the truncation then differs
                diff = (read_png(str(outs["port"])).astype(int)
                        - read_png(str(outs["jax"])).astype(int))
                assert np.abs(diff).max() <= 1 and (diff != 0).mean() <= 0.05, src
            else:
                assert outs["port"].read_bytes() == outs["jax"].read_bytes(), (src, ext)
    proc = _run(["-m", "ngp_tpu_torch.scripts.convert_image", "--input", "in.jpg",
                 "--output", "x.tga"], tmp_path)
    assert proc.returncode != 0 and "ValueError" in proc.stderr
    assert ".bin, .exr, .png and .jpg" in proc.stderr
    default = _run(["-m", "ngp_tpu_torch.scripts.convert_image", "--input", "in.jpg"], tmp_path)
    assert default.returncode == 0 and (tmp_path / "in.bin").exists()

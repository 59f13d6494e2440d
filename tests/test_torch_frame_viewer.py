"""``Testbed.frame()`` and the web viewer (``ngp_tpu_torch/utils/viewer.py``)
against the JAX package's on the CPU.

- ``frame()``: the same keys, and under one fake ``time.monotonic`` (patched
  from here, in both packages) advanced by given render times, the same
  resolutions, render and frame ms, the same frame ms EMA; a real frame
  trains its chunk and renders at its resolution.
- The viewer: every endpoint of ``tests/test_viewer.py`` on the port's
  server (port 0, image mode with a narrow config; NeRF mode on a tiny
  engine); ``/frame.jpg`` is the port's JPEG, decoded alike by the port's
  decoder and PIL; ``/path.json`` equals the JAX viewer's after the same
  posts; ``/histograms`` equals the JAX viewer's on the same weights
  (counts exactly, mean |w| within 1e-6 relative: float32 sums in another
  order); the entry point serves.

Tolerance: as stated above; everything else is compared for equality.
"""

import io
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

import test_testbed as jtt
from ngp_tpu_torch.data.jpeg import decode_jpeg

# One intra-op thread, as in every port test module (test_torch_capture.py).
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_IMAGE_ENCODING = {"n_levels": 4, "log2_hashmap_size": 10}
# render ms a frame: over twice the 50 ms budget (20 fps) halves the scale,
# under a quarter of it doubles the scale
RENDER_MS = (10.0, 250.0, 120.0, 101.0, 300.0, 400.0, 500.0, 60.0, 12.0, 3.0, 1.0, 1.0,
             1.0, 1.0, 200.0, 12.5, 12.4)


@pytest.fixture(scope="module")
def image_file(tmp_path_factory):
    return jtt._small_image(tmp_path_factory.mktemp("frame"))


def _image_config(package):
    cfg = package.default_config("image")
    cfg["encoding"].update(SMALL_IMAGE_ENCODING)
    return cfg


@pytest.fixture(scope="module")
def testbeds(image_file):
    """Both packages' image-mode Testbeds on one small EXR, narrow grids."""
    from ngp_tpu import testbed as jtb_mod
    from ngp_tpu_torch import testbed as ptb_mod

    ptb = ptb_mod.Testbed(scene=image_file, config=_image_config(ptb_mod), batch_size=1 << 10,
                          device="cpu")
    jtb = jtb_mod.Testbed(scene=image_file, config=_image_config(jtb_mod), batch_size=1 << 10)
    return ptb, jtb


def _frames(tb, monkeypatch, width, height):
    """``frame()`` once a render time of ``RENDER_MS``, under a clock that
    moves only by those times; training off."""
    clock = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    times = iter(RENDER_MS)

    def render(w, h, **kw):
        clock[0] += next(times) / 1e3
        return np.zeros((h, w, 3), np.float32)

    monkeypatch.setattr(tb, "render", render)
    outs = [tb.frame(width=width, height=height, n_train_steps=0) for _ in RENDER_MS]
    monkeypatch.undo()
    return outs


@pytest.mark.parametrize("size", [(640, 360), (96, 200)])
def test_frame_resolutions_match_jax(testbeds, monkeypatch, size):
    """The dynamic resolution: power-of-two scales from 1/4, the 2×/¼
    margins, 32 pixels a side at least; the same sequence in both packages
    under the same render times."""
    ptb, jtb = testbeds
    ptb.dyn_res_log2, ptb.frame_meters = 2, None
    for attr in ("_dyn_res_log2", "_frame_meters"):
        if hasattr(jtb, attr):
            delattr(jtb, attr)
    got = _frames(ptb, monkeypatch, *size)
    want = _frames(jtb, monkeypatch, *size)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert g["resolution"] == w["resolution"]
        assert g["image"].shape == w["image"].shape == (w["resolution"][1], w["resolution"][0], 3)
        for k in ("frame_ms", "train_ms", "render_ms", "training_step"):
            assert g[k] == w[k], k
        assert g["frame_ms_ema"] == pytest.approx(w["frame_ms_ema"], rel=1e-12)
    res = [g["resolution"] for g in got]
    assert len(set(res)) >= 3 and min(min(r) for r in res) == 32


def test_frame_trains_and_renders(testbeds):
    """A real heartbeat in image mode: the chunk trains (the step and the
    loss move), the image has the resolution reported, the meters update;
    without ``render`` no image; with ``shall_train`` off no step."""
    ptb, _ = testbeds
    ptb.dyn_res_log2 = 2
    step = ptb.training_step
    out = ptb.frame(width=128, height=128, n_train_steps=3)
    assert out["training_step"] == step + 3 and np.isfinite(out["loss"])
    assert out["resolution"] == (32, 32) and out["image"].shape == (32, 32, 3)
    assert out["train_ms"] > 0 and out["render_ms"] > 0 and out["frame_ms"] >= out["render_ms"]
    assert out["frame_ms_ema"] > 0 and out["loss_ema"] is None
    out = ptb.frame(width=128, height=128, n_train_steps=2, render=False)
    assert out["image"] is None and out["resolution"] == (0, 0)
    assert out["training_step"] == step + 5
    ptb.shall_train = False
    try:
        assert ptb.frame(width=64, height=64, n_train_steps=2)["training_step"] == step + 5
    finally:
        ptb.shall_train = True


# -- the viewer


def _serve(make_server, tb, **kw):
    srv = make_server(tb, port=0, **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _get(srv, path):
    host, port = srv.server_address
    with urllib.request.urlopen(f"http://{host}:{port}{path}", timeout=120) as r:
        return r.read(), r.headers.get("Content-Type")


def _post(srv, path, payload):
    host, port = srv.server_address
    req = urllib.request.Request(f"http://{host}:{port}{path}",
                                 data=json.dumps(payload).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read() or b"{}")


def test_viewer_endpoints_image_mode(testbeds):
    """``tests/test_viewer.py``'s endpoints on the port's server: the page,
    a frame (the port's JPEG at the resolution ``/state`` reports, decoded
    alike by the port and PIL), the state after a trained chunk, a camera
    update, ``/crop`` refused outside NeRF mode, no histograms in image
    mode (as the JAX viewer answers), unknown paths 404."""
    from ngp_tpu.utils.viewer import make_server as jax_make_server
    from ngp_tpu_torch.utils.viewer import make_server

    ptb, jtb = testbeds
    ptb.dyn_res_log2 = 0
    srv = _serve(make_server, ptb, n_train_steps=2)
    jsrv = _serve(jax_make_server, jtb, n_train_steps=2)
    try:
        page, ctype = _get(srv, "/")
        assert ctype == "text/html" and b"canvas" in page and b"/frame.jpg" in page
        step = ptb.training_step
        jpg, ctype = _get(srv, "/frame.jpg?w=64&h=48")
        assert ctype == "image/jpeg" and jpg[:2] == b"\xff\xd8"
        s = json.loads(_get(srv, "/state")[0])
        assert s["step"] == step + 2 and s["resolution"] == [64, 48]
        assert s["render_ms"] > 0 and s["frame_ms"] > 0
        with Image.open(io.BytesIO(jpg)) as im:
            pil = np.asarray(im)
        assert pil.shape == (48, 64, 3) and np.array_equal(decode_jpeg(jpg), pil)
        # the keys of the JAX viewer's state, and two of the port's own
        js = json.loads(_get(jsrv, "/state")[0])
        assert set(s) == set(js) | {"resolution", "render_ms"}
        assert s["crop"] is None and js["crop"] is None
        assert _post(srv, "/camera", {"yaw": 1.25, "fov": 40}) == {}
        assert srv.viewer_camera.yaw == 1.25 and srv.viewer_camera.fov == 40.0
        assert json.loads(_get(srv, "/state")[0])["camera"]["yaw"] == 1.25
        for path in ("/crop", "/nowhere"):
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(srv, path, {"min": [0, 0, 0], "max": [1, 1, 1]})
            assert err.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(srv, "/nowhere")
        assert err.value.code == 404
        h, jh = (json.loads(_get(x, "/histograms")[0]) for x in (srv, jsrv))
        assert h["levels"] == jh["levels"] == [] and "error" in h
        # without training the step stays
        _get(srv, "/frame.jpg?w=32&h=32&train=0")
        assert json.loads(_get(srv, "/state")[0])["step"] == step + 2
    finally:
        srv.shutdown()
        jsrv.shutdown()


def test_orbit_xform_matches_jax():
    from ngp_tpu.utils.viewer import ViewerState as JaxViewerState
    from ngp_tpu_torch.utils.viewer import ViewerState

    for yaw, pitch, radius in ((0.0, 0.3, 1.6), (1.3, -0.7, 2.5), (-2.0, 1.5, 0.9)):
        v, jv = ViewerState(), JaxViewerState()
        for s in (v, jv):
            s.yaw, s.pitch, s.radius = yaw, pitch, radius
        np.testing.assert_array_equal(v.xform(), jv.xform())


@pytest.fixture(scope="module")
def nerf_testbeds(tmp_path_factory):
    """A port NeRF Testbed on the JAX engine test's tiny scene (4 views),
    its table set to seeded values across [-1.5, 1.5] so that every
    histogram bin fills, and a JAX Testbed holding the same weights (the
    port's native snapshot loaded by the JAX engine)."""
    import test_nerf_engine as tn
    from test_torch_render import port_golden_engine

    from ngp_tpu.engines.nerf import NerfEngine as JaxNerfEngine
    from ngp_tpu.testbed import Testbed as JaxTestbed
    from ngp_tpu_torch.testbed import Testbed

    tb = Testbed(mode="nerf", config=dict(tn.CONFIG), device="cpu")
    tb.engine = port_golden_engine(batch_size=1 << 10)
    tb.state, tb.grid = tb.engine.init_state(), tb.engine.init_grid()
    rng = np.random.default_rng(4)
    with torch.no_grad():
        for model in (tb.state.model, tb.state.inference_model()):
            t = model.pos_encoding.table
            t.copy_(torch.from_numpy(rng.uniform(-1.5, 1.5, t.shape).astype(np.float32)))
    snap = str(tmp_path_factory.mktemp("viewer") / "s.ingp")
    tb.engine.save_snapshot(snap, tb.state, tb.grid)
    jtb = JaxTestbed(mode="nerf", config=dict(tn.CONFIG))
    jtb.engine = JaxNerfEngine(dict(tn.CONFIG), tn._make_dataset(6), batch_size=1 << 10,
                               grid_size=16, n_steps_per_unit=128)
    jtb.state, jtb.grid = jtb.engine.load_snapshot(snap)
    return tb, jtb


def test_viewer_nerf_extras_match_jax(nerf_testbeds, tmp_path):
    """Crop box, camera-path editor and level histograms (the GUI's extras,
    ``src/testbed.cu:1409-1541, 1019-1147, 1932``) as the JAX viewer answers
    them; a playback frame renders."""
    from ngp_tpu.utils.viewer import make_server as jax_make_server
    from ngp_tpu_torch.utils.camera_path import CameraPath
    from ngp_tpu_torch.utils.viewer import make_server

    tb, jtb = nerf_testbeds
    srv = _serve(make_server, tb, n_train_steps=1)
    jsrv = _serve(jax_make_server, jtb, n_train_steps=1)
    try:
        for s in (srv, jsrv):
            assert _post(s, "/crop", {"min": [0.2, 0.2, 0.2], "max": [0.8, 0.8, 0.8]}) == {}
        np.testing.assert_allclose(json.loads(_get(srv, "/state")[0])["crop"],
                                   [[0.2] * 3, [0.8] * 3], rtol=1e-7)
        lo, hi = tb.render_aabb
        assert lo.dtype == np.float32 and np.allclose(hi, 0.8)
        for s in (srv, jsrv):
            assert _post(s, "/path", {"op": "add"}) == {"n_keyframes": 1, "playing": False}
            s.viewer_camera.yaw = 1.0
            s.viewer_camera.fov = 35.0
            assert _post(s, "/path", {"op": "add"})["n_keyframes"] == 2
            assert _post(s, "/path", {"op": "play"}) == {"n_keyframes": 2, "playing": True}
        body = _get(srv, "/path.json")[0]
        assert body == _get(jsrv, "/path.json")[0]
        (tmp_path / "path.json").write_bytes(body)  # the CLI's camera-path reader
        keys = CameraPath.load(str(tmp_path / "path.json")).keyframes
        assert len(keys) == 2 and keys[1].fov == 35.0
        jpg, ctype = _get(srv, "/frame.jpg?w=32&h=32&train=0")
        assert ctype == "image/jpeg" and decode_jpeg(jpg).shape[2] == 3
        assert _post(srv, "/path", {"op": "stop"})["playing"] is False
        assert _post(srv, "/path", {"op": "clear"}) == {"n_keyframes": 0, "playing": False}
        h, jh = (json.loads(_get(x, "/histograms")[0]) for x in (srv, jsrv))
        assert "error" not in h and "error" not in jh
        assert len(h["levels"]) == 8 and h["levels"] == jh["levels"]
        assert sum(map(sum, h["levels"])) > 0 and all(lev[-1] > 0 for lev in h["levels"])
        np.testing.assert_allclose(h["mean_abs_w"], jh["mean_abs_w"], rtol=1e-6)
    finally:
        tb.render_aabb = None
        srv.shutdown()
        jsrv.shutdown()


def test_viewer_entry_point_serves(image_file, tmp_path):
    """``python -m ngp_tpu_torch.scripts.viewer SCENE --port 0 --device cpu``
    names its port and answers ``/state``."""
    from ngp_tpu_torch import testbed

    net = tmp_path / "net.json"
    net.write_text(json.dumps(_image_config(testbed)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "ngp_tpu_torch.scripts.viewer", image_file, "--port", "0",
         "--device", "cpu", "--network", str(net), "--batch_size", "1024"],
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO}, stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("ngp_tpu_torch viewer on http://127.0.0.1:"), line
        url = line.split()[-1]
        with urllib.request.urlopen(url + "state", timeout=60) as r:
            s = json.loads(r.read())
        assert s["step"] == 0 and s["resolution"] is None
        with urllib.request.urlopen(url + "frame.jpg?w=64&h=64", timeout=60) as r:
            assert decode_jpeg(r.read()).shape == (32, 32, 3)
    finally:
        proc.kill()
        proc.wait()

"""The port's image primitive (``ngp_tpu_torch/ops/image_sampler.py``,
``models/factory.py:NetworkWithInputEncoding``, ``train.py:Trainer``,
``engines/image.py``, ``Testbed`` and ``run`` in image mode, the
procedural gigapixel image) against the JAX package on the CPU.

Sizes are small: a 64×48 image (the gigapixel formula's), a 4-level 2^10
grid (levels 0-1 dense, 2-3 hashed) with a 32-wide MLP, 2^12 positions a
step. Tolerances are stated in each test; where both packages compute the
same integer or float32 formula in the same order the comparison is exact.
"""

import importlib.util
import json
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ngp_tpu.data import image_loader as jloader
from ngp_tpu.engines import image as jimage
from ngp_tpu.models import factory as jfactory
from ngp_tpu.ops import image_sampler as jsampler
from ngp_tpu.train import Trainer as JaxTrainer
from ngp_tpu_torch.data import image_loader as ploader
from ngp_tpu_torch.engines import image as pimage
from ngp_tpu_torch.interop import export_jax_params, load_jax_params
from ngp_tpu_torch.models import factory as pfactory
from ngp_tpu_torch.ops import image_sampler as psampler
from ngp_tpu_torch.train import Trainer, TrainState

# One intra-op thread: with two, torch's CPU sqrt (MKL's vsSqrt, split across
# the intra-op threads) now and then returned one thread's chunk ~3e-4 off
# on an AVX-512 Xeon (torch 2.13, MKL 2024.2), never with one
# (scripts/torch_sqrt_threads.py counts it).
# Every port test module sets the same count, so that a pytest worker's
# count does not depend on which module it imported last.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 1 << 12
# the image base.json's loss and optimizer (decay starting at step 4, so
# that 8 steps cross it), a narrow network
CONFIG = {
    "loss": {"otype": "RelativeL2"},
    "optimizer": {"otype": "Ema", "decay": 0.99, "nested": {
        "otype": "ExponentialDecay", "decay_start": 4, "decay_interval": 2,
        "decay_base": 0.33, "nested": {"otype": "Adam", "learning_rate": 1e-2, "beta1": 0.9,
                                       "beta2": 0.99, "epsilon": 1e-8, "l2_reg": 1e-6}}},
    "encoding": {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
                 "log2_hashmap_size": 10, "base_resolution": 16},
    "network": {"otype": "FullyFusedMLP", "activation": "ReLU", "output_activation": "None",
                "n_neurons": 32, "n_hidden_layers": 2},
}


def _image():
    """(48, 64, 4) float32: a crop of the procedural gigapixel formula."""
    from ngp_tpu_torch.data.synthetic import gigapixel_image

    return gigapixel_image(64, "cpu", torch.float32).numpy()[:48]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# -- samplers


@pytest.mark.parametrize("base", [0, 12345, (1 << 32) - 100])
def test_halton_and_sobol_equal_jax(base):
    """Exact: uint32 arithmetic in masked int64, radical inverses summed in
    float32 digit by digit; a base near 2^32 wraps the indices."""
    want = np.asarray(jsampler.halton23(jnp.uint32(base), 4096))
    np.testing.assert_array_equal(psampler.halton23(base, 4096).numpy(), want)
    for seed in (0, 1337, (1 << 32) - 1):
        want = np.asarray(jsampler.sobol2(jnp.uint32(base), 4096, jnp.uint32(seed)))
        np.testing.assert_array_equal(psampler.sobol2(base, 4096, seed).numpy(), want)


@pytest.mark.parametrize("log2", [10, 12])
def test_stratify2_equals_jax(log2):
    """Exact, given the same uniforms."""
    u = np.random.default_rng(log2).uniform(0, 1, (1 << log2, 2)).astype(np.float32)
    want = np.asarray(jsampler.stratify2(jnp.asarray(u), log2))
    np.testing.assert_array_equal(psampler.stratify2(torch.from_numpy(u), log2).numpy(), want)


def test_sample_positions_by_mode():
    """Halton and Sobol equal the JAX package's at steps whose base index
    wraps 2^32 too; Uniform and Stratified (own stream, see the module)
    are [0, 1)² draws fixed by (seed, step), a new one each step and seed,
    and Stratified puts sample i in cell i of a 32×32 grid."""
    for step in (0, 3, 5 << 22):
        for mode in ("halton", "sobol"):
            want = np.asarray(jsampler.sample_positions(mode, None, step, 1 << 10, 1337))
            got = psampler.sample_positions(mode.capitalize(), step, 1 << 10, 1337)
            np.testing.assert_array_equal(got.numpy(), want)
    draws = {(s, t): psampler.sample_positions("Uniform", t, 1 << 10, s)
             for s in (1, 2) for t in (0, 1)}
    assert torch.equal(draws[1, 0], psampler.sample_positions("uniform", 0, 1 << 10, 1))
    assert len({tuple(d[:4].flatten().tolist()) for d in draws.values()}) == 4
    strat = psampler.sample_positions("Stratified", 7, 1 << 10, 1)
    for d in (*draws.values(), strat):
        assert d.dtype == torch.float32 and d.shape == (1 << 10, 2)
        assert bool((d >= 0).all() and (d < 1).all())
    cell = torch.floor(strat * 32).long()
    i = torch.arange(1 << 10)
    assert torch.equal(cell[:, 0], i % 32) and torch.equal(cell[:, 1], i // 32)


# -- training targets


@pytest.mark.parametrize("linear", [False, True])
@pytest.mark.parametrize("snap", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_targets_match_jax(dtype, snap, linear):
    """Positions exactly; targets in the JAX function's dtype (float16 for
    a snapped float16 image, float32 when bilinear weights enter). Exact
    where the same float16 or linear float32 arithmetic runs; the float32
    sRGB curve within one float32 ulp (rtol 2^-22: ``pow`` rounds
    differently in the last bit). Texels beyond 1 and below the curve's
    linear segment are included; positions reach past the image."""
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1.2, (48, 64, 4)).astype(np.float32)
    img[:3, :3, :3] = rng.uniform(0, 0.003, (3, 3, 3))
    img = img.astype(dtype)
    pos = rng.uniform(-0.05, 1.05, (4096, 2)).astype(np.float32)
    jp, jt = jimage.eval_image_and_snap(jnp.asarray(img), jnp.asarray(pos), snap, linear)
    pp, pt = pimage.eval_image_and_snap(torch.from_numpy(img), torch.from_numpy(pos),
                                        snap, linear)
    jt = np.asarray(jt)
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
    assert pt.numpy().dtype == jt.dtype
    if linear or jt.dtype == np.float16:
        np.testing.assert_array_equal(pt.numpy(), jt)
    else:
        np.testing.assert_allclose(pt.numpy(), jt, rtol=2.0 ** -22, atol=0)


# -- the network and the trainer's loss


def test_network_forward_and_gradients_match_jax():
    """``NetworkWithInputEncoding`` from the JAX package's initial
    parameters (carried by ``interop``): parameter count equal; outputs
    within 1e-4 (float32 products of bf16-rounded operands summed in
    another order can flip a hidden unit's bf16 rounding, 2^-8 of it);
    the trainer's loss 1e-4 relative; MLP weight gradients within 2e-2 of
    each matrix's largest entry and the table gradient within 2^-6 of each
    level's largest (the bounds of ``test_torch_train_step.py``: bf16
    roundings passed in bf16, bf16 addends)."""
    jnet = jfactory.create_network_with_input_encoding(2, 3, CONFIG)
    params = jnet.init(jax.random.PRNGKey(0))
    pnet = load_jax_params(pfactory.create_network_with_input_encoding(2, 3, CONFIG, "cpu"),
                           _np(params))
    assert pnet.n_params == jnet.n_params
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 1, (BATCH, 2)).astype(np.float32)
    t = rng.uniform(0, 1, (BATCH, 3)).astype(np.float32)
    jtrainer = JaxTrainer(jnet.__call__, jfactory.create_loss(CONFIG["loss"]),
                          CONFIG["optimizer"])
    jloss, jgrad = jax.jit(jax.value_and_grad(jtrainer.loss))(params, jnp.asarray(x),
                                                              jnp.asarray(t))
    ptrainer = Trainer(pfactory.create_loss(CONFIG["loss"]), CONFIG["optimizer"])
    np.testing.assert_allclose(pnet(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jnet(params, jnp.asarray(x))), rtol=0, atol=1e-4)
    ploss = ptrainer.loss(pnet, torch.from_numpy(x), torch.from_numpy(t))
    ploss.backward()
    np.testing.assert_allclose(float(ploss.detach()), float(jloss), rtol=1e-4)
    for w, jw in zip(pnet.network.weights, jgrad["network"]["weights"]):
        jw = np.asarray(jw)
        np.testing.assert_allclose(w.grad.numpy(), jw, rtol=0, atol=2e-2 * np.abs(jw).max())
    jt = np.asarray(jgrad["encoding"]["table"])
    for level, (got, want) in enumerate(zip(pnet.encoding.table.grad.numpy(), jt)):
        np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -6 * np.abs(want).max(),
                                   err_msg=f"level {level}")


# -- the slice as a whole


@pytest.fixture(scope="module")
def fitted():
    """Both engines from the JAX package's initial parameters, Halton
    positions (both packages draw the same), 8 steps each."""
    img = _image()
    jeng = jimage.ImageEngine(CONFIG, img, batch_size=BATCH, random_mode="Halton")
    jstate = jeng.init_state()
    peng = pimage.ImageEngine(CONFIG, img, batch_size=BATCH, random_mode="Halton",
                              device="cpu")
    pstate = TrainState.create(load_jax_params(peng._new_network(), _np(jstate.params)))
    jstate, jlosses = jeng.train(jstate, 8)
    pstate, plosses = peng.train(pstate, 8)
    return jeng, jstate, np.asarray(jlosses), peng, pstate, plosses


def test_fit_matches_jax(fitted):
    """Per-step losses within 1e-4 relative (measured 2.9e-5); the served
    (EMA) MLP weights within 1e-3 (measured 5.0e-4); the served table
    within 2e-2 everywhere and 1e-4 on all but 1% of its entries (measured
    5.1e-3 and 0.17%: Adam scales a gradient entry near zero, whose sign
    the other package's sum order can flip, to a step of the learning rate
    1e-2); the render of every texel within 5e-3 (measured 2.4e-3) and the
    MSE within 1e-3 relative (measured 1.1e-5). A failure prints every
    measured margin."""
    jeng, jstate, jlosses, peng, pstate, plosses = fitted
    assert pstate.step == int(jstate.step) == 8
    assert plosses.shape == (8,) and plosses.dtype == torch.float32
    want = _np(jeng.trainer.inference_params(jstate))
    got = export_jax_params(pstate.inference_model())
    d = np.abs(got["encoding"]["table"] - want["encoding"]["table"])
    renders = [(peng.render(pstate, *wh).numpy(), np.asarray(jeng.render(jstate, *wh)))
               for wh in ((), (16, 12))]
    assert [p.shape for p, _ in renders] == [j.shape for _, j in renders] == [(48, 64, 3),
                                                                              (12, 16, 3)]
    # every margin is measured first, so that any failure reports them all
    margins = {
        "loss_rel": float(np.max(np.abs(plosses.numpy() - jlosses) / np.abs(jlosses))),
        "loss_last_over_first": float(jlosses[-1] / jlosses[0]),
        "weights_abs": [float(np.abs(g - w).max()) for g, w in
                        zip(got["network"]["weights"], want["network"]["weights"])],
        "table_max": float(d.max()), "table_share_above_1e-4": float((d > 1e-4).mean()),
        "render_abs": float(np.abs(renders[0][0] - renders[0][1]).max()),
        "render_16x12_abs": float(np.abs(renders[1][0] - renders[1][1]).max()),
        "mse_rel": [abs(peng.compute_mse(pstate, q) / jeng.compute_mse(jstate, q) - 1.0)
                    for q in (False, True)],
    }
    assert margins["loss_rel"] <= 1e-4, margins
    assert margins["loss_last_over_first"] < 0.1, margins
    assert max(margins["weights_abs"]) <= 1e-3, margins
    assert margins["table_max"] <= 2e-2, margins
    assert margins["table_share_above_1e-4"] <= 0.01, margins
    assert margins["render_abs"] <= 5e-3, margins
    assert margins["render_16x12_abs"] <= 5e-3, margins
    assert max(margins["mse_rel"]) <= 1e-3, margins


def test_snapshots_cross_packages(fitted, tmp_path):
    """The JAX engine's file loaded by the port and saved again is the
    same bytes; the port's file loaded by the JAX engine holds the port's
    parameters and EMA exactly and scores as the port does (1e-6
    relative); each package's load starts fresh moments at the file's
    step."""
    jeng, jstate, _, peng, pstate, _ = fitted
    jfile, pfile = str(tmp_path / "jax.msgpack"), str(tmp_path / "port.msgpack")
    jeng.save_snapshot(jfile, jstate)
    loaded = peng.load_snapshot(jfile)
    assert loaded.step == 8 and loaded.opt_state["grid"].count == 0
    assert not loaded.opt_state["grid"].mu[0].any()
    peng.save_snapshot(pfile, loaded)
    assert open(pfile, "rb").read() == open(jfile, "rb").read()

    peng.save_snapshot(str(tmp_path / "port.ingp"), pstate)
    back = jeng.load_snapshot(str(tmp_path / "port.ingp"))
    assert int(back.step) == 8
    for tree, model in ((back.params, pstate.model), (back.ema.params, pstate.ema)):
        want = export_jax_params(model)
        np.testing.assert_array_equal(np.asarray(tree["encoding"]["table"]),
                                      want["encoding"]["table"])
        for g, w in zip(tree["network"]["weights"], want["network"]["weights"]):
            np.testing.assert_array_equal(np.asarray(g), w)
    np.testing.assert_allclose(jeng.compute_mse(back), peng.compute_mse(pstate), rtol=1e-6)


# -- Testbed and the CLI


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A 64×48 PNG and EXR, a 64² ``.bin`` of the gigapixel formula, the
    network config file."""
    from ngp_tpu_torch.data.exr import write_exr
    from ngp_tpu_torch.data.png import write_png
    from ngp_tpu_torch.data.synthetic import write_gigapixel_bin

    root = tmp_path_factory.mktemp("image")
    srgb = np.clip(_image()[..., :3], 0, 1) ** (1 / 2.2)
    write_png(str(root / "img.png"), (srgb * 255).astype(np.uint8))
    write_exr(str(root / "img.exr"), _image())
    write_gigapixel_bin(str(root / "img.bin"), 64)
    (root / "net.json").write_text(json.dumps(CONFIG))
    return {"png": str(root / "img.png"), "exr": str(root / "img.exr"),
            "bin": str(root / "img.bin"),
            "network": str(root / "net.json"), "root": root}


def _jax_cli():
    spec = importlib.util.spec_from_file_location("jax_run_cli",
                                                  os.path.join(REPO, "scripts", "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kind", ["png", "exr", "bin"])
def test_testbed_image_mode(files, kind, tmp_path):
    """``Testbed(mode="image")`` loads the file and trains (20 steps at
    least halve the MSE), renders, scores and round-trips a snapshot; the JAX package's ``Testbed`` loads
    the image alike (equal arrays) and scores the port's snapshot as the
    port does (1e-6 relative)."""
    from ngp_tpu.testbed import Testbed as JaxTestbed
    from ngp_tpu_torch.testbed import Testbed

    tb = Testbed(mode="image", config=files["network"], device="cpu", batch_size=BATCH)
    tb.load_training_data(files[kind])
    assert tb.mode == "image" and tb.training_step == 0
    np.testing.assert_array_equal(tb.engine.image.numpy(),
                                  jloader.load_image(files[kind]))
    untrained = tb.compute_image_mse()
    tb.train(20)
    assert tb.training_step == 20 and np.isfinite(tb.loss)
    img = tb.render(16, 12)
    assert img.shape == (12, 16, 3) and img.dtype == np.float32 and np.isfinite(img).all()
    mse = tb.compute_image_mse()
    assert 0 < mse < 0.5 * untrained
    snap = str(tmp_path / "fit.ingp")
    tb.save_snapshot(snap)
    tb.train(5)
    tb.load_snapshot(snap)
    assert tb.training_step == 20 and tb.compute_image_mse() == mse
    jtb = JaxTestbed(scene=files[kind], config=files["network"], batch_size=BATCH)
    jtb.load_snapshot(snap)
    np.testing.assert_allclose(jtb.compute_image_mse(), mse, rtol=1e-6)


@pytest.mark.parametrize("kind", ["png", "bin"])
def test_cli_image_mode_matches_the_jax_cli(files, kind, capsys):
    """``python -m ngp_tpu_torch.run IMAGE --device cpu`` prints the JAX
    CLI's lines (``trained ...``, ``MSE: ...  PSNR: ... dB``, ``saved
    snapshot ...``, ``wrote ...``) and last its kernel launches (none on
    the CPU); reloaded with no steps it prints the same MSE line, and so
    does the JAX CLI on the port's snapshot. ``--render_mode`` is ignored
    in image mode, as the JAX CLI ignores it."""
    from ngp_tpu_torch import run
    from ngp_tpu_torch.data.png import read_png

    root = files["root"]
    snap, shot = str(root / f"cli_{kind}.ingp"), str(root / f"cli_{kind}.png")
    run.main([files[kind], "--network", files["network"], "--device", "cpu",
              "--n_steps", "30", "--batch_size", str(BATCH), "--save_snapshot", snap,
              "--screenshot", shot, "--screenshot_w", "40", "--screenshot_h", "24",
              "--render_mode", "normals"])
    lines = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"trained 30 steps in \S+s \(\S+ steps/s\), loss=\d+\.\d{6}", lines[0])
    assert re.fullmatch(r"MSE: \d\.\d{6}  PSNR: \d+\.\d\d dB", lines[1])
    assert lines[2:4] == [f"saved snapshot to {snap}", f"wrote {shot}"]
    assert json.loads(lines[4].split(":", 1)[1]) == dict.fromkeys(
        json.loads(lines[4].split(":", 1)[1]), 0)
    assert read_png(shot).shape == (24, 40, 3)
    run.main([files[kind], "--network", files["network"], "--device", "cpu",
              "--n_steps", "0", "--load_snapshot", snap])
    again = capsys.readouterr().out.splitlines()
    assert again[:2] == ["loaded snapshot at step 30", lines[1]]
    _jax_cli().main([files[kind], "--network", files["network"], "--n_steps", "0",
                     "--load_snapshot", snap, "--compile_cache", ""])
    assert capsys.readouterr().out.splitlines()[:2] == again[:2]


def test_image_mode_refusals(files, tmp_path, capsys):
    """NeRF-only calls and flags raise in image mode, as the JAX package's
    do; a truncated JPEG raises. ``frame()`` (ported; held to the JAX
    package in ``tests/test_torch_frame_viewer.py``) renders an image-mode
    frame at its first scale, a quarter of the asked size."""
    from ngp_tpu_torch import run
    from ngp_tpu_torch.testbed import Testbed

    common = [files["png"], "--network", files["network"], "--device", "cpu",
              "--n_steps", "0"]
    with pytest.raises(ValueError, match="mesh export needs nerf"):
        run.main(common + ["--save_mesh", str(tmp_path / "m.obj")])
    with pytest.raises(ValueError, match="--metrics_file"):
        run.main(common + ["--metrics_file", str(tmp_path / "m.jsonl")])
    capsys.readouterr()
    tb = Testbed(scene=files["png"], config=files["network"], device="cpu")
    with pytest.raises(ValueError, match="psnr needs nerf mode"):
        tb.psnr()
    out = tb.frame(width=256, height=128, n_train_steps=0)
    assert out["resolution"] == (64, 32) and out["image"].shape == (32, 64, 3)
    # a JPEG scene loads (tests/test_torch_jpeg.py); a cut-off file raises
    (tmp_path / "x.jpg").write_bytes(b"\xff\xd8\xff")
    with pytest.raises(ValueError, match="truncated"):
        Testbed(scene=str(tmp_path / "x.jpg"), device="cpu")


def test_image_entry_points_run_on_the_card_unless_asked(files):
    """Without a card ``ImageEngine``, ``Testbed`` and the CLI raise rather
    than fall back to the CPU."""
    from ngp_tpu_torch import run
    from ngp_tpu_torch.testbed import Testbed

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for call in (lambda: pimage.ImageEngine(CONFIG, _image()),
                 lambda: Testbed(scene=files["bin"], config=files["network"]),
                 lambda: run.main([files["bin"], "--n_steps", "0"])):
        with pytest.raises(RuntimeError, match="device 'cuda' requested"):
            call()


# -- the gigapixel image


def test_gigapixel_image_and_bin_file(tmp_path):
    """The formula of ``scripts/bench_gigapixel.py`` within one float16 ulp
    of values up to 1 (4.9e-4; float32 ``sin`` and ``exp`` differ in the
    last bits between numpy and torch, and a float16 rounding can flip),
    on under 0.1% of the entries; the ``.bin`` file reads back the same
    float16 values in both packages' loaders."""
    import sys

    from ngp_tpu_torch.data.synthetic import gigapixel_image, write_gigapixel_bin

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from bench_gigapixel import synth_image

    got = gigapixel_image(300).numpy()
    want = synth_image(300)
    assert got.dtype == np.float16 and got.shape == (300, 300, 4)
    d = np.abs(got.astype(np.float32) - want.astype(np.float32))
    assert d.max() <= 2.0 ** -11 and (d > 0).mean() < 1e-3
    path = write_gigapixel_bin(str(tmp_path / "g.bin"), 96)
    img = gigapixel_image(96).numpy().astype(np.float32)
    np.testing.assert_array_equal(ploader.load_binary_image(path), img)
    np.testing.assert_array_equal(jloader.load_binary_image(path), img)

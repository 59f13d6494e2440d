#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ngp_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. env: the card (``nvidia-smi`` name and power limit), torch, CUDA, nvcc.
2. build: compiles every CUDA source of ``ngp_tpu_torch/csrc`` (one nvcc
   each, in parallel) into ``build/ngp_tpu_torch/``.
3. kernel: ``hashgrid_encode_cuda`` against its plain PyTorch twin on the
   card, at N = 2^20 samples, "tpu" tier (L=8, F=2, T=2^18, additive) and
   "upstream" tier (L=16, F=2, T=2^19, XOR), float32 and bf16 tables:
   error, kernel time (CUDA events), twin time, a one-call PyTorch
   yardstick and the bound.
4. golden: the reference snapshot ``tests/golden/golden.ingp`` rendered by
   the port (view 0, stride 4) against the JAX package's frozen render
   ``tests/golden/golden.npz``.
5. serve: three 960×540 views of the full-width "tpu" tier with seeded
   weights over an analytic occupancy grid, through ``render_image``; per
   frame its time, the samples evaluated and the kernel launches, then one
   more frame under ``torch.profiler``: device time per stage, the busiest
   kernels, and the device's busy share of the frame.
6. kernel_main_path: the kernel case again at the serve path's shape
   (its mean samples per launch).
7. train: the bench's fallback configuration (``bench.py``: the synthetic
   sphere, 12 views at 128², full-width "tpu" tier, 2^18 sample slots per
   step, grid 128), 400 steps through ``NerfEngine.train``: ms per step,
   network samples per second, final loss, batch geometry, kernel launches
   per step, and the PSNR of view 0, which must reach ``TRAIN_PSNR_MIN``.
8. kernel_train: the training kernels against their twins at the training
   step's shapes ("tpu" tier, L=8 levels of M = 8·N corner addends, F=2,
   T=2^18, for N the path's mean network samples per step and for N the
   full budget of 163,840): the grid backward's addends (B1's backward
   half), the segment sum (B2), the key histogram (B3) and the one-level
   entry points (B4); error, kernel time, twin time, a one-call PyTorch
   yardstick and the bound of each.
9. train_profile: two windows of 16 more steps (one occupancy-update
   cycle) under ``torch.profiler``: one run as phase train runs them, for
   the device's busy share of a step; one with the backward on the calling
   thread, for the device time per stage (march, network forward, loss,
   backward, grid backward, optimizer, grid update). Then the ``kernels`` line, the card's ``name, power.limit``, and
   last the ``{"ok": true, ...}`` line.

Any failure raises and ends the run with a non-zero exit; so does a host
without CUDA. The script imports torch, numpy and ``ngp_tpu_torch`` only.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores
N_KERNEL = 1 << 20
# The card's bf16 matmul products may sum in another order than the CPU that
# froze the golden render; a hidden unit's bf16 rounding can then flip
# (2^-8 of one activation). Composited over a ray that stays well below
# 1e-3, five times the CPU bound of 2e-4.
GOLDEN_TOL = 1e-3
KERNEL_REL_TOL = 1e-5
TRAIN_STEPS = 400
TRAIN_PROFILE_STEPS = 16  # one cycle of the stride-residue occupancy updates
# The JAX package's test_train_sphere_to_psnr asks for 20 dB; two sound card
# runs of this configuration read 51.4 and 53.0 dB, so the gate sits well
# above 20 dB to catch a table gradient that is badly wrong.
TRAIN_PSNR_MIN = 40.0


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` by CUDA events, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_env():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        sys.exit(1)
    from ngp_tpu_torch.ops.cuda_build import nvcc_path

    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    emit({"phase": "env", "gpu": nvidia_smi(),
          "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(), "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda, "nvcc": nvcc})


def phase_build():
    from ngp_tpu_torch.ops.cuda_build import build_all

    t0 = time.perf_counter()
    logs = build_all()
    usage = {
        name: [ln.strip() for ln in log.splitlines() if "registers" in ln]
        for name, log in logs.items()
    }
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": usage})


def _encoding(tier: str, aabb_scale: int = 4):
    """The tier's position encoding on the card, per_level_scale filled in
    as the engine does for ``aabb_scale``."""
    from ngp_tpu_torch.config import default_config
    from ngp_tpu_torch.models.factory import create_encoding

    cfg = dict(default_config(tier)["encoding"])
    cfg.setdefault("per_level_scale", math.exp(
        math.log(2048.0 * aabb_scale / cfg["base_resolution"]) / (cfg["n_levels"] - 1)))
    return create_encoding(3, cfg, "cuda")


def _bound(n_bytes: float, n_ops: float) -> dict:
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_ops / H100_F32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _kernel_case(tier: str, table_dtype, gen, n: int = N_KERNEL):
    import torch
    import torch.nn.functional as tnf

    from ngp_tpu_torch.ops.hashgrid import (
        HASH_PRIMES,
        hashgrid_encode_cuda,
        hashgrid_encode_reference,
    )

    enc = _encoding(tier)
    L, T, F = enc.table.shape
    D, C = 3, 8
    table = (torch.rand((L, T, F), generator=gen) * 2 - 1).cuda().to(table_dtype)
    x = torch.rand((n, D), generator=gen).cuda()
    geo = (enc.level_scale, enc.level_res, enc.level_size, enc.level_hashed,
           enc.hash_variant)
    out = hashgrid_encode_cuda(x, table, *geo)
    torch.cuda.synchronize()
    ref = hashgrid_encode_reference(x, table, *geo)
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    if not err <= KERNEL_REL_TOL * scale:
        raise AssertionError(f"{tier} {table_dtype}: max abs err {err} > "
                             f"{KERNEL_REL_TOL} x {scale}")
    ms = cuda_ms(lambda: hashgrid_encode_cuda(x, table, *geo), iters=50)
    plain_ms = cuda_ms(lambda: hashgrid_encode_reference(x, table, *geo),
                       iters=3, warmup=1)

    # Yardstick: the gather and weighted sum as one library call
    # (embedding_bag, mode "sum", per-corner weights), given corner rows and
    # weights computed beforehand with the twin's arithmetic (excluded).
    scales, ress, sizes, hashed = (t.tolist() for t in geo[:4])
    additive = enc.hash_variant == "additive"
    idx = torch.empty((n, L, C), dtype=torch.int64, device="cuda")
    wts = torch.empty((n, L, C), dtype=torch.float32, device="cuda")
    for l in range(L):
        p = x * scales[l] + 0.5
        p0 = torch.floor(p)
        frac, p0 = p - p0, p0.long()
        for c in range(C):
            w, h, lin, stride = 1.0, 0, 0, 1
            for d in range(D):
                b = (c >> d) & 1
                w = w * (frac[:, d] if b else 1.0 - frac[:, d])
                cd = p0[:, d] + b
                term = (cd * HASH_PRIMES[d]) & 0xFFFFFFFF
                h = (h + term) & 0xFFFFFFFF if additive else h ^ term
                lin = lin + cd.clamp(0, ress[l] - 1) * stride
                stride *= ress[l]
            idx[:, l, c] = l * T + (h & (sizes[l] - 1) if hashed[l] else lin)
            wts[:, l, c] = w
    flat = table.float().reshape(L * T, F)
    bags, bag_w = idx.reshape(-1, C), wts.reshape(-1, C)
    lib = tnf.embedding_bag(bags, flat, per_sample_weights=bag_w, mode="sum")
    lib_err = float((lib.reshape(n, L * F) - ref).abs().max())
    if not lib_err <= 1e-4 * scale:
        raise AssertionError(f"yardstick disagrees with the twin: {lib_err}")
    library_ms = cuda_ms(lambda: tnf.embedding_bag(
        bags, flat, per_sample_weights=bag_w, mode="sum"), iters=10)
    del idx, wts, bags, bag_w, lib

    # bound: positions read and features written once, each live table row
    # read once; operations: 3D for p, 2^D·(D-1) weight products and
    # 2·2^D·F multiply-adds per (sample, level), float32 rate
    item = table.element_size()
    return {
        "tier": tier, "table": str(table_dtype).replace("torch.", ""),
        "N": n, "L": L, "T": T, "F": F, "hash": enc.hash_variant,
        "max_abs_err": err, "max_abs_ref": scale, "ms": ms, "plain_ms": plain_ms,
        "library_ms": library_ms,
        **_bound(n * D * 4 + n * L * F * 4 + sum(sizes) * F * item,
                 n * L * (3 * D + C * (D - 1) + 2 * C * F)),
        "table_bf16_reads_on_main_path": enc.bf16_reads,
    }


def phase_kernel():
    import torch

    gen = torch.Generator().manual_seed(0)
    for tier in ("tpu", "upstream"):
        for dt in (torch.float32, torch.bfloat16):
            emit({"phase": "kernel", **_kernel_case(tier, dt, gen)})


def _lookat(eye, target):
    """Camera-to-world (3, 4) looking from ``eye`` at ``target`` with +z up,
    in float32 as tests/test_nerf_engine.py:_lookat_xform computes it."""
    import numpy as np

    fwd = target - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray([0.0, 0.0, 1.0], np.float32))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    return np.stack([right, down, fwd, eye], axis=1).astype(np.float32)


def _dataset(eyes, res, focal, aabb_scale):
    import numpy as np

    from ngp_tpu_torch.data.nerf_loader import NerfDataset
    from ngp_tpu_torch.geometry.camera import Lens

    center = np.full(3, 0.5, np.float32)
    xf = np.stack([_lookat(e, center) for e in eyes])
    n = len(eyes)
    return NerfDataset(
        images=np.zeros((n, res[1], res[0], 4), np.uint8),
        xforms=np.stack([xf, xf], axis=1),
        focal_lengths=np.full((n, 2), focal, np.float32),
        principal_points=np.full((n, 2), 0.5, np.float32),
        lens=Lens(), resolution=res, aabb_scale=aabb_scale,
    )


def phase_golden():
    """The golden fixture: settings of tests/golden/make_golden.py, the
    camera ring of tests/test_nerf_engine.py:_make_dataset(6) (RES 48,
    FOCAL 48, eyes at 1.1 from the center, z = 0.3·sin(3·angle))."""
    import numpy as np
    import torch

    from ngp_tpu_torch.engines.nerf import NerfEngine
    from ngp_tpu_torch.ops.hashgrid import HASHGRID_ENCODE

    cfg = {
        "encoding": {"otype": "HashGrid", "n_levels": 8, "n_features_per_level": 2,
                     "log2_hashmap_size": 15, "base_resolution": 16,
                     "per_level_scale": 1.5},
        "network": {"otype": "FullyFusedMLP", "activation": "ReLU",
                    "output_activation": "None", "n_neurons": 64,
                    "n_hidden_layers": 1},
        "dir_encoding": {"otype": "Composite", "nested": [
            {"n_dims_to_encode": 3, "otype": "SphericalHarmonics", "degree": 4},
            {"otype": "Identity"}]},
        "rgb_network": {"otype": "FullyFusedMLP", "activation": "ReLU",
                        "output_activation": "None", "n_neurons": 64,
                        "n_hidden_layers": 2},
    }
    center = np.full(3, 0.5, np.float32)
    eyes = []
    for i in range(6):
        a = 2 * math.pi * i / 6
        eyes.append(center + np.asarray(
            [math.cos(a), math.sin(a), 0.3 * math.sin(3 * a)], np.float32) * 1.1)
    eng = NerfEngine(cfg, _dataset(eyes, (48, 48), 48.0, 1), grid_size=16,
                     n_steps_per_unit=128, seed=11)
    state, grid = eng.load_reference_snapshot(
        os.path.join(ROOT, "tests", "golden", "golden.ingp"))
    HASHGRID_ENCODE.launches["hashgrid_encode"] = 0
    img = eng.render_image(state, grid, 0, stride=4)
    torch.cuda.synchronize()
    launches = HASHGRID_ENCODE.launches["hashgrid_encode"]
    gold = np.load(os.path.join(ROOT, "tests", "golden", "golden.npz"))["render"]
    got = img.cpu().numpy()
    err = float(np.abs(got - gold).max())
    emit({"phase": "golden", "shape": list(got.shape), "max_abs_err": err,
          "tol": GOLDEN_TOL, "samples": eng.last_render_samples,
          "hashgrid_launches": launches})
    if got.shape != gold.shape or not np.allclose(got, gold, rtol=GOLDEN_TOL,
                                                  atol=GOLDEN_TOL):
        raise AssertionError(f"golden render differs: max abs err {err}")
    if launches == 0:
        raise AssertionError("golden render did not launch hashgrid_encode_cuda")


def _sphere_density(grid_cfg, radius: float):
    """An analytic occupancy grid: density 1 inside a ball of ``radius``
    around the scene center (0.5,)³, 0 elsewhere, in every cascade."""
    import torch

    G, C = grid_cfg.grid_size, grid_cfg.n_cascades
    r = (torch.arange(G, device="cuda", dtype=torch.float32) + 0.5) / G - 0.5
    dens = []
    for c in range(C):
        x = r * (2.0 ** c)
        d2 = x[:, None, None] ** 2 + x[None, :, None] ** 2 + x[None, None, :] ** 2
        dens.append((d2 <= radius * radius).float())
    return torch.stack(dens)


def _profile_summary(prof, stages: tuple, outer: str, outer_default: str) -> dict:
    """Device time per stage of a trace whose work sits in ``outer``
    ranges that hold ``stages`` ranges: a kernel belongs to the shortest
    range whose device span holds it; kernels in an ``outer`` range and in
    no stage count as ``outer_default``, kernels outside every range as
    "other". Also the device's busy time (union of kernel and copy
    intervals) and the eight kernels with the most device time. The
    profiler puts each range on the device timeline as an annotation span;
    those spans only attribute kernels to stages."""
    from torch.autograd import DeviceType

    names = set(stages) | {outer}
    spans = []
    ops = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        if e.name in names:
            spans.append((e.time_range.start, e.time_range.end, e.name))
        elif not e.is_user_annotation:
            ops.append((e.time_range.start, e.time_range.end, e.name))

    stage_us = dict.fromkeys((*stages, outer_default, "other"), 0.0)
    for a, b, _ in ops:
        held = [(t - s, n) for s, t, n in spans if s <= a and b <= t]
        name = min(held)[1] if held else "other"
        stage_us[outer_default if name == outer else name] += b - a
    busy_us, end = 0.0, float("-inf")
    for a, b, _ in sorted(ops):
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    by_name = {}
    for a, b, name in ops:
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (b - a) / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {
        "stage_device_ms": {k: v / 1e3 for k, v in stage_us.items()},
        "device_busy_ms": busy_us / 1e3, "device_ops": len(ops),
        "top_device_ms": [[name[:90], ms, n] for name, (ms, n) in top],
    }


def _ranged(name, fn):
    from torch.profiler import record_function

    def run(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)
    return run


def phase_serve():
    """Full-width "tpu" tier, seeded weights, aabb_scale 4, three 960×540
    views of an orbit at radius 2 (60° horizontal field of view) around a
    ball of radius 0.5 in the occupancy grid; K = 192, compaction 0.625."""
    import numpy as np
    import torch

    from ngp_tpu_torch.config import default_config
    from ngp_tpu_torch.engines.nerf import NerfEngine
    from ngp_tpu_torch.ops.cuda_build import launch_counts, reset_launches

    res = (960, 540)
    focal = 0.5 * res[0] / math.tan(math.radians(30.0))
    eyes = [np.full(3, 0.5, np.float32)
            + np.asarray([math.cos(a), math.sin(a), 0.3], np.float32) * 2.0
            for a in (0.0, 2.0 * math.pi / 3, 4.0 * math.pi / 3)]
    eng = NerfEngine(default_config("tpu"), _dataset(eyes, res, focal, 4))
    state = eng.init_state()
    grid = eng.grid_from_density(_sphere_density(eng.grid_cfg, 0.5))
    torch.cuda.synchronize()

    reset_launches()
    frames = []
    for view in range(len(eyes)):
        before = launch_counts()
        t0 = time.perf_counter()
        img = eng.render_image(state, grid, view)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if tuple(img.shape) != (res[1], res[0], 3) or not bool(torch.isfinite(img).all()):
            raise AssertionError(f"frame {view}: shape {tuple(img.shape)} or non-finite")
        frame = {"phase": "serve", "frame": view, "ms": ms,
                 "samples": eng.last_render_samples,
                 "launches": {k: n - before[k] for k, n in launch_counts().items()},
                 "mean_rgb": float(img.mean()), "n_lattice": eng.n_lattice,
                 "chunk_rays": eng.ray_chunk}
        frames.append(frame)
        emit(frame)
    launches = launch_counts()
    if launches["hashgrid_encode"] == 0:
        raise AssertionError("serve path launched hashgrid_encode no time")

    # One more render of view 0 under torch.profiler, each ray chunk's
    # stages inside record_function ranges: device time per stage, the
    # heaviest kernels, and the share of the frame the device was busy.
    from torch.profiler import ProfilerActivity, profile

    eng._render_chunk = _ranged("chunk", eng._render_chunk)
    eng._eval_marched = _ranged("shade", eng._eval_marched)
    eng._finish_shade = _ranged("composite", eng._finish_shade)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.render_image(state, grid, 0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    emit({"phase": "serve_profile", "view": 0, "wall_ms": wall_ms,
          **_profile_summary(prof, ("shade", "composite"), "chunk", "march")})
    return frames, launches


def phase_kernel_train(n_samples: int, shape: str) -> dict:
    """Each training kernel against its twin at a step's shapes: the grid
    backward of ``n_samples`` network samples of the "tpu" tier at
    aabb_scale 1, whose keys and addends then feed the segment sum, the
    histogram and the one-level entry points. Returns the kernels' rows of
    the ``kernels`` line (without launches)."""
    import torch

    from ngp_tpu_torch.ops import segsum
    from ngp_tpu_torch.ops.hashgrid import (
        hashgrid_backward_addends_cuda,
        hashgrid_backward_addends_reference,
    )

    enc = _encoding("tpu", aabb_scale=1)
    L, T, F = enc.table.shape
    geo = (enc.level_scale, enc.level_res, enc.level_size, enc.level_hashed,
           enc.hash_variant)
    gen = torch.Generator().manual_seed(2)
    x = torch.rand((n_samples, 3), generator=gen).cuda()
    g = (torch.randn((n_samples, L * F), generator=gen) * 1e-3).cuda()
    rows = {}

    # B1 backward: corner keys and addends w_c·g
    keys, vals = hashgrid_backward_addends_cuda(x, g, *geo)
    torch.cuda.synchronize()
    wkeys, wvals = hashgrid_backward_addends_reference(x, g, *geo)
    if not torch.equal(keys, wkeys):
        raise AssertionError("hashgrid_backward_addends: keys differ from the twin")
    err = float((vals - wvals).abs().max())
    if not err <= KERNEL_REL_TOL * float(wvals.abs().max()):
        raise AssertionError(f"hashgrid_backward_addends: max abs err {err}")
    del wkeys, wvals
    M = keys.shape[1]
    rows["hashgrid_backward_addends"] = {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: hashgrid_backward_addends_cuda(x, g, *geo), iters=20),
        "plain_ms": cuda_ms(lambda: hashgrid_backward_addends_reference(x, g, *geo),
                            iters=3, warmup=1),
        "library_ms": None,
        # positions and cotangents read once, keys and addends written once;
        # 3D + 8·(D−1) + 8·F float operations per (sample, level)
        **_bound(n_samples * (12 + 4 * L * F) + L * M * (4 + 4 * F),
                 n_samples * L * (9 + 16 + 8 * F)),
    }

    # B2: the segment sum of those addends (bf16 payloads)
    def sum_error(got, want, k, v):
        n = segsum.segment_count_reference(k, T)[..., None].float()
        mass = segsum.segment_sum_reference(k, v.abs(), T)
        excess = (got - want).abs() - 2.0 * n * 2.0 ** -24 * mass
        if float(excess.max()) > 0:
            raise AssertionError("segment_sum: beyond the float32 order bound")
        return float((got - want).abs().max())

    got = segsum.segment_sum_cuda(keys, vals, T)
    torch.cuda.synchronize()
    err = sum_error(got, segsum.segment_sum_reference(keys, vals, T), keys, vals)
    flat_keys = (keys.long() + torch.arange(L, device="cuda")[:, None] * T).reshape(-1)
    flat_vals = vals.to(torch.bfloat16).float().reshape(-1, F)
    lib_out = torch.zeros((L * T, F), device="cuda")
    rows["segment_sum"] = {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: segsum.segment_sum_cuda(keys, vals, T), iters=20),
        "plain_ms": cuda_ms(lambda: segsum.segment_sum_reference(keys, vals, T),
                            iters=3, warmup=1),
        # yardstick: one index_add_ of the pre-rounded addends into a
        # flattened table (keys offset per level beforehand, excluded)
        "library_ms": cuda_ms(lambda: lib_out.index_add_(0, flat_keys, flat_vals),
                              iters=20),
        # keys and addends read once, the dense table written once
        **_bound(L * M * (4 + 4 * F) + L * T * F * 4, L * M * F),
    }

    # B3: the per-level histogram of the same keys
    got = segsum.segment_count_cuda(keys, T)
    torch.cuda.synchronize()
    if not torch.equal(got, segsum.segment_count_reference(keys, T)):
        raise AssertionError("segment_count differs from the twin")
    rows["segment_count"] = {
        "max_abs_err": 0.0,
        "ms": cuda_ms(lambda: segsum.segment_count_cuda(keys, T), iters=20),
        "plain_ms": cuda_ms(lambda: segsum.segment_count_reference(keys, T),
                            iters=3, warmup=1),
        "library_ms": cuda_ms(lambda: torch.bincount(flat_keys, minlength=L * T),
                              iters=20),
        **_bound(L * M * 4 + L * T * 4, L * M),
    }

    # B4: the one-level entry points, on the finest level's keys
    k1, v1 = keys[-1].contiguous(), vals[-1].contiguous()
    got = segsum.segment_sum_onehot(k1, v1, T)
    torch.cuda.synchronize()
    err = sum_error(got[None], segsum.segment_sum_reference(k1[None], v1[None], T),
                    k1[None], v1[None])
    k1l, v1b = k1.long(), v1.to(torch.bfloat16).float()
    lib1 = torch.zeros((T, F), device="cuda")
    rows["segment_sum_onehot"] = {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: segsum.segment_sum_onehot(k1, v1, T), iters=20),
        "plain_ms": cuda_ms(lambda: segsum.segment_sum_reference(k1[None], v1[None], T),
                            iters=3, warmup=1),
        "library_ms": cuda_ms(lambda: lib1.index_add_(0, k1l, v1b), iters=20),
        **_bound(M * (4 + 4 * F) + T * F * 4, M * F),
    }
    got = segsum.segment_count_onehot(k1, T)
    torch.cuda.synchronize()
    if not torch.equal(got, segsum.segment_count_reference(k1[None], T)[0]):
        raise AssertionError("segment_count_onehot differs from the twin")
    rows["segment_count_onehot"] = {
        "max_abs_err": 0.0,
        "ms": cuda_ms(lambda: segsum.segment_count_onehot(k1, T), iters=20),
        "plain_ms": cuda_ms(lambda: segsum.segment_count_reference(k1[None], T),
                            iters=3, warmup=1),
        "library_ms": cuda_ms(lambda: torch.bincount(k1l, minlength=T), iters=20),
        **_bound(M * 4 + T * 4, M),
    }
    for name, row in rows.items():
        emit({"phase": "kernel_train", "shape": shape, "kernel": name,
              "N": n_samples, "L": L, "M": M, "T": T, "F": F, **row})
    return rows


def phase_train():
    """The bench's fallback configuration, 400 steps through
    ``NerfEngine.train`` one step per call (each synchronized and timed);
    then the PSNR of view 0."""
    import numpy as np
    import torch

    from ngp_tpu_torch.config import default_config
    from ngp_tpu_torch.data.synthetic import tiny_sphere_dataset
    from ngp_tpu_torch.engines.nerf import NerfEngine
    from ngp_tpu_torch.ops.cuda_build import launch_counts, reset_launches

    eng = NerfEngine(default_config("tpu"), tiny_sphere_dataset(n_views=12, res=128),
                     batch_size=1 << 18)
    state, grid = eng.init_state(), eng.init_grid()
    torch.cuda.synchronize()
    reset_launches()
    step_ms, samples, geometry = [], [], []
    t_start = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, grid, metrics = eng.train(state, grid, 1)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        samples.append(metrics["network_samples"])
        geometry.append(eng.batch_geometry)
    wall_s = time.perf_counter() - t_start
    launches = launch_counts()
    loss = float(metrics["loss"])
    psnr = eng.psnr(state, grid, 0)
    steady = step_ms[256:]  # after the all-cells warm-up sweeps
    result = {
        "phase": "train", "steps": TRAIN_STEPS, "wall_s": wall_s,
        "median_ms_per_step": float(np.median(steady)),
        "median_ms_per_step_warmup_32_256": float(np.median(step_ms[32:256])),
        "first_step_ms": step_ms[0],
        "network_samples_per_s": float(sum(samples[256:]) / (sum(steady) / 1e3)),
        "network_samples_per_step": float(np.mean(samples[256:])),
        "final_loss": loss, "k_and_rays": list(geometry[-1]),
        "geometry_changes": sorted({tuple(gm) for gm in geometry}),
        "seg_budget": eng._seg_budget,
        "launches_per_step": {k: n / TRAIN_STEPS for k, n in launches.items()},
        "occupied_fraction": float(grid.bitfield[0].float().mean()),
        "psnr_view0": psnr, "psnr_min": TRAIN_PSNR_MIN,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    emit(result)
    if not math.isfinite(loss):
        raise AssertionError(f"training loss is not finite: {loss}")
    if not psnr >= TRAIN_PSNR_MIN:
        raise AssertionError(f"PSNR {psnr} dB after {TRAIN_STEPS} steps < {TRAIN_PSNR_MIN}")
    for name in ("hashgrid_encode", "hashgrid_backward_addends", "segment_sum"):
        if launches[name] == 0:
            raise AssertionError(f"the training path launched {name} no time")
    return eng, state, grid, launches, result


def _profile_steps(eng, state, grid, n_steps: int, threaded: bool):
    """``n_steps`` steps as phase train times them (one ``NerfEngine.train``
    call and a synchronize each) under torch.profiler, each step in a
    "step" range. Returns the grid, the trace and the wall ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
            torch.autograd.set_multithreading_enabled(threaded):
        t0 = time.perf_counter()
        for _ in range(n_steps):
            with record_function("step"):
                state, grid, _ = eng.train(state, grid, 1)
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return grid, prof, wall_ms


def phase_train_profile(eng, state, grid, timed_median_ms: float):
    """Two windows of 16 more steps (one occupancy-update cycle each) under
    torch.profiler, each stage in a record_function range. The first runs
    as phase train does: its device busy time per step over its wall time,
    and over the unprofiled median step, is the device's busy share. The
    second runs the backward on the calling thread, so that its kernels
    fall in the "backward" range (autograd's device thread launches them
    outside it): its device ms per stage is the breakdown."""
    import torch

    from ngp_tpu_torch.engines import nerf as engine_mod
    from ngp_tpu_torch.models import encodings

    engine_mod.march_rays = _ranged("march", engine_mod.march_rays)
    engine_mod.nerf_training_loss = _ranged("loss", engine_mod.nerf_training_loss)
    eng._network_on_samples = _ranged("network_forward", eng._network_on_samples)
    eng.apply_grads = _ranged("optimizer", eng.apply_grads)
    eng.update_grid = _ranged("grid_update", eng.update_grid)
    grid_bwd = encodings._GridEncode.backward
    encodings._GridEncode.backward = staticmethod(_ranged("grid_backward", grid_bwd))
    backward = torch.Tensor.backward
    torch.Tensor.backward = _ranged("backward", backward)
    stages = ("march", "network_forward", "loss", "backward", "grid_backward",
              "optimizer", "grid_update")
    n = TRAIN_PROFILE_STEPS
    try:
        for window, threaded in (("as_timed", True), ("backward_on_caller", False)):
            first = state.step
            grid, prof, wall_ms = _profile_steps(eng, state, grid, n, threaded)
            summary = _profile_summary(prof, stages, "step", "step_other")
            busy_ms = summary["device_busy_ms"] / n
            emit({"phase": "train_profile", "window": window,
                  "autograd_multithreading": threaded, "steps": [first, state.step - 1],
                  "wall_ms_per_step": wall_ms / n, "device_busy_ms_per_step": busy_ms,
                  "busy_share_of_profiled_wall": busy_ms / (wall_ms / n),
                  "busy_share_of_unprofiled_median": busy_ms / timed_median_ms,
                  "device_ops_per_step": summary["device_ops"] / n,
                  "stage_device_ms_per_step": {
                      k: v / n for k, v in summary["stage_device_ms"].items()},
                  "top_device_ms": summary["top_device_ms"]})
    finally:
        torch.Tensor.backward = backward
        encodings._GridEncode.backward = staticmethod(grid_bwd)


def main():
    phase_env()
    import torch

    phase_build()
    phase_kernel()
    phase_golden()
    frames, launches = phase_serve()

    # B1 at the serve path's shape: "tpu" tier, bf16 table reads, as many
    # samples as the path's launches averaged
    n_main = sum(f["samples"] for f in frames) // launches["hashgrid_encode"]
    main_case = _kernel_case("tpu", torch.bfloat16, torch.Generator().manual_seed(1),
                             n_main)
    emit({"phase": "kernel_main_path", **main_case})

    eng, state, grid, train_launches, train = phase_train()
    # the kernels at the path's mean network samples per step (the kernels
    # line) and at the step's full sample budget
    train_rows = phase_kernel_train(int(train["network_samples_per_step"]), "main_path")
    phase_kernel_train(eng.samples_per_step, "full_budget")
    phase_train_profile(eng, state, grid, train["median_ms_per_step"])

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{
        "name": "hashgrid_encode_cuda", "route": "cuda",
        "source": "ngp_tpu_torch/csrc/hashgrid_encode.cu",
        "replaces": "ngp_tpu/ops/pallas/hashgrid.py:66",
        "launches": launches["hashgrid_encode"] + train_launches["hashgrid_encode"],
        **{k: main_case[k] for k in keys},
    }]
    for name, source, replaces, launched in (
        ("hashgrid_backward_addends", "hashgrid_encode.cu",
         "ngp_tpu/models/encodings.py:378", train_launches["hashgrid_backward_addends"]),
        ("segment_sum", "segment_sum.cu", "ngp_tpu/ops/pallas/segsum_sorted.py:67",
         train_launches["segment_sum"]),
        ("segment_count", "segment_sum.cu", "ngp_tpu/ops/pallas/segsum.py:135",
         train_launches["segment_count"]),
        # B4's entry points run the two kernels above with one level and
        # count their launches under their own names; the main path (like
        # the JAX package's, _MXU_DIRECT_MAX_T = 0) does not call them
        ("segment_sum_onehot", "segment_sum.cu", "ngp_tpu/ops/pallas/segsum.py:47",
         train_launches["segment_sum_onehot"]),
        ("segment_count_onehot", "segment_sum.cu", "ngp_tpu/ops/pallas/segsum.py:47",
         train_launches["segment_count_onehot"]),
    ):
        kernels.append({"name": name, "route": "cuda",
                        "source": f"ngp_tpu_torch/csrc/{source}",
                        "replaces": replaces, "launches": launched,
                        **{k: train_rows[name][k] for k in keys}})
    emit({"kernels": kernels})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()

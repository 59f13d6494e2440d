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
   (its mean samples per launch), then the ``kernels`` line, the card's
   ``name, power.limit``, and last the ``{"ok": true, ...}`` line.

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
    n_bytes = n * D * 4 + n * L * F * 4 + sum(sizes) * F * item
    n_ops = n * L * (3 * D + C * (D - 1) + 2 * C * F)
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_ops / H100_F32_FLOPS * 1e3
    return {
        "tier": tier, "table": str(table_dtype).replace("torch.", ""),
        "N": n, "L": L, "T": T, "F": F, "hash": enc.hash_variant,
        "max_abs_err": err, "max_abs_ref": scale, "ms": ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
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
    HASHGRID_ENCODE.launches = 0
    img = eng.render_image(state, grid, 0, stride=4)
    torch.cuda.synchronize()
    launches = HASHGRID_ENCODE.launches
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


def _profile_summary(prof) -> dict:
    """From a trace whose ray chunks sit in "chunk" ranges holding "shade"
    and "composite" ranges: device time of the kernels of each stage (a
    kernel belongs to the innermost range whose device span holds it; the
    rest of a chunk is the march), the device's busy time (union of kernel
    and copy intervals), and the eight kernels with the most device time.
    The profiler puts each range on the device timeline as an annotation
    span; those spans only attribute kernels to stages."""
    from torch.autograd import DeviceType

    spans = {"chunk": [], "shade": [], "composite": []}
    ops = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        if e.name in spans:
            spans[e.name].append((e.time_range.start, e.time_range.end))
        elif not e.is_user_annotation:
            ops.append((e.time_range.start, e.time_range.end, e.name))

    stage_us = {"shade": 0.0, "composite": 0.0, "march": 0.0, "other": 0.0}
    for a, b, _ in ops:
        held = [k for k, v in spans.items() if any(s <= a and b <= t for s, t in v)]
        key = next((k for k in ("shade", "composite") if k in held),
                   "march" if held else "other")
        stage_us[key] += b - a
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


def phase_serve():
    """Full-width "tpu" tier, seeded weights, aabb_scale 4, three 960×540
    views of an orbit at radius 2 (60° horizontal field of view) around a
    ball of radius 0.5 in the occupancy grid; K = 192, compaction 0.625."""
    import numpy as np
    import torch

    from ngp_tpu_torch.config import default_config
    from ngp_tpu_torch.engines.nerf import NerfEngine
    from ngp_tpu_torch.ops.cuda_build import KERNELS

    res = (960, 540)
    focal = 0.5 * res[0] / math.tan(math.radians(30.0))
    eyes = [np.full(3, 0.5, np.float32)
            + np.asarray([math.cos(a), math.sin(a), 0.3], np.float32) * 2.0
            for a in (0.0, 2.0 * math.pi / 3, 4.0 * math.pi / 3)]
    eng = NerfEngine(default_config("tpu"), _dataset(eyes, res, focal, 4))
    state = eng.init_state()
    grid = eng.grid_from_density(_sphere_density(eng.grid_cfg, 0.5))
    torch.cuda.synchronize()

    for k in KERNELS:
        k.launches = 0
    frames = []
    for view in range(len(eyes)):
        before = {k.name: k.launches for k in KERNELS}
        t0 = time.perf_counter()
        img = eng.render_image(state, grid, view)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if tuple(img.shape) != (res[1], res[0], 3) or not bool(torch.isfinite(img).all()):
            raise AssertionError(f"frame {view}: shape {tuple(img.shape)} or non-finite")
        frame = {"phase": "serve", "frame": view, "ms": ms,
                 "samples": eng.last_render_samples,
                 "launches": {k.name: k.launches - before[k.name] for k in KERNELS},
                 "mean_rgb": float(img.mean()), "n_lattice": eng.n_lattice,
                 "chunk_rays": eng.ray_chunk}
        frames.append(frame)
        emit(frame)
    launches = {k.name: k.launches for k in KERNELS}
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"serve path launched {name} no time")

    # One more render of view 0 under torch.profiler, each ray chunk's
    # stages inside record_function ranges: device time per stage, the
    # heaviest kernels, and the share of the frame the device was busy.
    from torch.profiler import ProfilerActivity, profile, record_function

    def ranged(name, fn):
        def run(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return run

    eng._render_chunk = ranged("chunk", eng._render_chunk)
    eng._eval_marched = ranged("shade", eng._eval_marched)
    eng._finish_shade = ranged("composite", eng._finish_shade)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.render_image(state, grid, 0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    emit({"phase": "serve_profile", "view": 0, "wall_ms": wall_ms,
          **_profile_summary(prof)})
    return frames, launches


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
    kernels = [{
        "name": "hashgrid_encode_cuda", "route": "cuda",
        "source": "ngp_tpu_torch/csrc/hashgrid_encode.cu",
        "replaces": "ngp_tpu/ops/pallas/hashgrid.py:66",
        "launches": launches["hashgrid_encode"],
        "max_abs_err": main_case["max_abs_err"], "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"], "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"], "library_ms": main_case["library_ms"],
    }]
    emit({"kernels": kernels})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()

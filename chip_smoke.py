#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ngp_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. env: the card (``nvidia-smi`` name and power limit), torch, CUDA, nvcc.
2. build: compiles every CUDA source of ``ngp_tpu_torch/csrc`` (one nvcc
   each, in parallel) into ``build/ngp_tpu_torch/``, and counts the atomic
   instructions of each kernel in the libraries' SASS (``cuobjdump``).
3. kernel: ``hashgrid_encode_cuda`` against its plain PyTorch twin on the
   card, bit for bit, at N = 2^20 samples, "tpu" tier (L=8, F=2, T=2^18,
   additive) and "upstream" tier (L=16, F=2, T=2^19, XOR), float32 and
   bf16 tables: error, times, a one-call PyTorch yardstick and the bound.
4. kernel_sort: ``bitonic_sort_pos_cuda`` (B5) against its twin, exactly,
   at (B, n) = (4, 2^20) with dense ties; ``torch.sort`` as yardstick;
   the kernel launches one call makes, and each one's device time.
5. golden: the reference snapshot ``tests/golden/golden.ingp`` rendered by
   the port (view 0, stride 4) against the JAX package's frozen render
   ``tests/golden/golden.npz``.
6. serve: three 960×540 views of the full-width "tpu" tier with seeded
   weights over an analytic occupancy grid, through ``render_image``; per
   frame its time, the samples evaluated and the kernel launches, then one
   more frame under ``torch.profiler``: device time per stage, the busiest
   kernels, and the device's busy share of the frame.
7. kernel_main_path and kernel_serve_positions: the kernel case again
   at the serve path's shape (its mean samples per launch, uniform
   positions), then on the positions of the profiled frame's largest
   launch; each also times the encoding's cast of its float32 table to
   bf16 before the call.
8. train: the bench's fallback configuration (``bench.py``: the synthetic
   sphere, 12 views at 128², full-width "tpu" tier, 2^18 sample slots per
   step, grid 128), 400 steps through ``NerfEngine.train``: ms per step,
   network samples per second, final loss, batch geometry, kernel launches
   per step, and the PSNR of view 0, which must reach ``TRAIN_PSNR_MIN``.
   Then one more step, whose grid backward's positions and cotangents
   (x, g) are kept (by reference) for phase 9.
9. kernel_train, segsum_levels and backward_levels: the training kernels
   against their twins at the training step's shapes ("tpu" tier, L=8
   levels, F=2, T=2^18; uniform positions for N the path's mean network
   samples per step and for N the full budget of 163,840, then the kept
   step's own (x, g)): B1's forward on the same uniform positions, the
   fused grid backward (x, g → d(table)), and, on the corner keys and
   addends that the backward's twin makes on the card (L levels of
   M = 8·N), the segment sum (B2, also level by level), the key histogram
   (B3) and the one-level entry points (B4); error, times, a one-call
   PyTorch yardstick and the bound of each. The grid backward and B3 also
   level by level (phase ``backward_levels``).
10. train_profile: two windows of 16 more steps (one occupancy-update
   cycle) under ``torch.profiler``: one run as phase train runs them, for
   the device's busy share of a step; one with the backward on the calling
   thread, for the device time per stage (march, network forward, loss,
   backward, grid backward, optimizer, grid update).
11. capture: a real capture end to end. Writes a textured sphere in the
   transforms dialect of instant-ngp's fox scene (OpenCV lens, off-center
   principal point, aabb_scale 2) as 24 train and 4 held-out 800×800 RGBA
   PNG frames into ``build/capture_smoke/``; loads both files with
   ``load_nerf`` (the port's own PNG decoder); trains the full-width "tpu"
   tier (2^18 sample slots per step) for 1,000 steps; scores the held-out
   views with ``eval_test_transforms``, whose mean PSNR must reach
   ``CAPTURE_PSNR_MIN``; then holds B1 against its twin, bit for bit, on
   the positions of the eval's largest launch (phase
   ``kernel_capture_positions``, timed by CUDA events only).
Then the ``kernels`` line, the card's ``name, power.limit``, and last the
``{"ok": true, ...}`` line.

Each kernel has two times: ``ms``, the device time of one call (the
kernels and the zero-fill of its output that the call puts on the card,
from ``torch.profiler`` over 20 calls), and ``call_ms``, what a caller pays
per call (CUDA events around 20 back-to-back calls of the Python wrapper,
which host issue may bound). The library yardstick's ``library_ms`` is
timed as ``ms`` is, its zeroed output made inside the timed call.

Any failure raises and ends the run with a non-zero exit; so does a host
without CUDA. The script imports torch, numpy and ``ngp_tpu_torch`` only.
"""

from __future__ import annotations

import json
import math
import os
import re
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
TRAIN_STEPS = 400
TRAIN_PROFILE_STEPS = 16  # one cycle of the stride-residue occupancy updates
# host sleep between a profiler window's edges and the calls it times
PROFILER_PAD_S = 0.05
# The JAX package's test_train_sphere_to_psnr asks for 20 dB; two sound card
# runs of this configuration read 51.4 and 53.0 dB, so the gate sits well
# above 20 dB to catch a table gradient that is badly wrong.
TRAIN_PSNR_MIN = 40.0
# phase capture: nerf_synthetic's frame size, the steps, and the gate on the
# held-out views' mean PSNR, fixed before the first card run
CAPTURE_RES = 800
CAPTURE_STEPS = 1000
CAPTURE_PSNR_MIN = 30.0


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, iters: int = 20, warmup: int = 2, windows: int = 3) -> float:
    """Mean device milliseconds per call of ``fn``: the summed durations of
    the kernels and copies that ``iters`` calls put on the card, read from
    ``torch.profiler`` after warm-up. The host's time between them (Python,
    checks, launch issue) is not in it; :func:`cuda_ms` measures that.

    The trace may lack records: 19 of 20 launches of one kernel, and 16 of
    20 in a process's first window, on an H100. The profiler keeps the
    device records that fall inside its window, whose edges it takes on the
    host's clock, so the calls run ``PROFILER_PAD_S`` of host sleep away
    from both edges. A window that still lacks more than one record of an
    operation is reported (phase ``profiler_retry``) and profiled again, up
    to ``windows`` times; then the run fails."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for window in range(windows):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILER_PAD_S)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILER_PAD_S)
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
                by_name.setdefault(e.name, []).append(e.time_range.end - e.time_range.start)
        # Each operation counts as its mean time times its records per
        # call, rounded; one record short is tolerated.
        us, short = 0.0, {}
        for name, spans in by_name.items():
            per_call = max(1, round(len(spans) / iters))
            if abs(len(spans) - per_call * iters) > 1:
                short[name[:90]] = len(spans)
            us += sum(spans) / len(spans) * per_call
        if not short and us > 0:
            return us / 1e3
        emit({"phase": "profiler_retry", "window": window, "calls": iters,
              "records": short or "none"})
    raise AssertionError(f"in {windows} windows of {iters} calls the profiler kept "
                         f"no whole number of device records a call: {short or 'none'}")


def _kernel_name(signature: str) -> str:
    """A kernel's name without its namespace and arguments."""
    found = re.search(r"(\w+(?:<\d+>)?)\(", signature)
    return found.group(1) if found else signature[:40]


def launch_sequence_ms(fn, launches: int, windows: int = 3) -> list:
    """Device milliseconds of each kernel one call of ``fn`` launches, in
    launch order, as ``[name, ms]`` pairs: one call under ``torch.profiler``
    padded as in :func:`device_ms`, profiled again (up to ``windows`` times)
    when the trace does not hold ``launches`` records."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for window in range(windows):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILER_PAD_S)
            fn()
            torch.cuda.synchronize()
            time.sleep(PROFILER_PAD_S)
        records = sorted(
            (e.time_range.start, e.time_range.end, e.name) for e in prof.events()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
        if len(records) == launches:
            return [[_kernel_name(name), (b - a) / 1e3] for a, b, name in records]
        emit({"phase": "profiler_retry", "window": window, "calls": 1,
              "records": len(records)})
    raise AssertionError(f"in {windows} windows the profiler kept no {launches} "
                         "device records of one call")


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` by CUDA events, after warm-up:
    what a caller pays per call, host issue included when the card waits
    for it."""
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


def sass_atomics(library: str) -> dict:
    """The atomic instructions (RED, REDG, ATOM, ATOMG, ATOMS) of each kernel in
    a library's SASS, by opcode: {kernel: {opcode: count}}."""
    from ngp_tpu_torch.ops.cuda_build import nvcc_path

    cuobjdump = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", library], capture_output=True,
                          text=True, check=True).stdout
    found, kernel = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            kernel = line.split("Function :")[1].strip()[:80]
            continue
        op = re.search(r"\b(?:REDG|RED|ATOMG|ATOMS|ATOM)\.[\w.]+", line)
        if op and kernel:
            ops = found.setdefault(kernel, {})
            ops[op.group(0)] = ops.get(op.group(0), 0) + 1
    return found


def phase_build():
    from ngp_tpu_torch.ops.cuda_build import KERNELS, build_all

    t0 = time.perf_counter()
    logs = build_all()
    usage = {
        name: [ln.strip() for ln in log.splitlines() if "registers" in ln]
        for name, log in logs.items()
    }
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": usage})
    emit({"phase": "sass", "atomics": {
        k.name: sass_atomics(str(k.lib_path())) for k in KERNELS}})


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


def _kernel_case(tier: str, table_dtype, gen, n: int = N_KERNEL, x=None,
                 aabb_scale: int = 4, profiled: bool = True):
    """B1 against its twin, exactly, on ``n`` uniform positions (or the
    positions ``x``) with a random table of ``table_dtype``. With a bf16
    table it also times the cast of the float32 table that the encoding
    makes before each call ("cast_ms"). ``profiled=False`` times by CUDA
    events only (``call_ms``, ``plain_ms``): no ``ms``, ``cast_ms`` or
    library yardstick."""
    import torch
    import torch.nn.functional as tnf

    from ngp_tpu_torch.ops.hashgrid import (
        HASH_PRIMES,
        hashgrid_encode_cuda,
        hashgrid_encode_reference,
    )

    enc = _encoding(tier, aabb_scale)
    L, T, F = enc.table.shape
    D, C = 3, 8
    master = (torch.rand((L, T, F), generator=gen) * 2 - 1).cuda()
    table = master.to(table_dtype)
    if x is None:
        x = torch.rand((n, D), generator=gen).cuda()
    n = x.shape[0]
    geo = (enc.level_scale, enc.level_res, enc.level_size, enc.level_hashed,
           enc.hash_variant)
    out = hashgrid_encode_cuda(x, table, *geo)
    torch.cuda.synchronize()
    ref = hashgrid_encode_reference(x, table, *geo)
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    if not torch.equal(out, ref):
        raise AssertionError(f"{tier} {table_dtype}: differs from the twin, "
                             f"max abs err {err}")
    ms = device_ms(lambda: hashgrid_encode_cuda(x, table, *geo)) if profiled else None
    call_ms = cuda_ms(lambda: hashgrid_encode_cuda(x, table, *geo), iters=20)
    plain_ms = cuda_ms(lambda: hashgrid_encode_reference(x, table, *geo),
                       iters=3, warmup=1)
    # bound: positions read and features written once, each live table row
    # read once; operations: 3D for p, 2^D·(D-1) weight products and
    # 2·2^D·F multiply-adds per (sample, level), float32 rate
    sizes = geo[2].tolist()
    row = {
        "tier": tier, "table": str(table_dtype).replace("torch.", ""),
        "N": n, "L": L, "T": T, "F": F, "hash": enc.hash_variant,
        "max_abs_err": err, "max_abs_ref": scale, "call_ms": call_ms, "plain_ms": plain_ms,
        **_bound(n * D * 4 + n * L * F * 4 + sum(sizes) * F * table.element_size(),
                 n * L * (3 * D + C * (D - 1) + 2 * C * F)),
        "table_bf16_reads_on_main_path": enc.bf16_reads,
    }
    if not profiled:
        return row
    cast = ({"cast_ms": device_ms(lambda: master.to(torch.bfloat16))}
            if table_dtype == torch.bfloat16 else {})

    # Yardstick: the gather and weighted sum as one library call
    # (embedding_bag, mode "sum", per-corner weights), given corner rows and
    # weights computed beforehand with the twin's arithmetic (excluded).
    scales, ress, _, hashed = (t.tolist() for t in geo[:4])
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
    library_ms = device_ms(lambda: tnf.embedding_bag(
        bags, flat, per_sample_weights=bag_w, mode="sum"), iters=10)
    del idx, wts, bags, bag_w, lib
    return {**row, "ms": ms, "library_ms": library_ms, **cast}


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

    # The same render also keeps the positions of its largest B1 launch (a
    # reference, no copy), on which phase kernel_serve_positions times B1.
    from ngp_tpu_torch.ops import hashgrid as hashgrid_ops

    encode = hashgrid_ops.hashgrid_encode_cuda
    largest = []

    def keep_largest(x, *args, **kwargs):
        if not largest or x.shape[0] > largest[0].shape[0]:
            largest[:] = [x]
        return encode(x, *args, **kwargs)

    eng._render_chunk = _ranged("chunk", eng._render_chunk)
    eng._eval_marched = _ranged("shade", eng._eval_marched)
    eng._finish_shade = _ranged("composite", eng._finish_shade)
    hashgrid_ops.hashgrid_encode_cuda = keep_largest
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.render_image(state, grid, 0)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        hashgrid_ops.hashgrid_encode_cuda = encode
    emit({"phase": "serve_profile", "view": 0, "wall_ms": wall_ms,
          **_profile_summary(prof, ("shade", "composite"), "chunk", "march")})
    return frames, launches, largest[0]


def train_inputs(n_samples: int):
    """The grid backward's inputs at a training step's shape: ``n_samples``
    uniform positions and small cotangents for the "tpu" tier at aabb_scale
    1. Returns (x, g, geometry, T), geometry being the encoding's (scale,
    res, size, hashed, hash_variant)."""
    import torch

    enc = _encoding("tpu", aabb_scale=1)
    L, T, F = enc.table.shape
    geo = (enc.level_scale, enc.level_res, enc.level_size, enc.level_hashed,
           enc.hash_variant)
    gen = torch.Generator().manual_seed(2)
    x = torch.rand((n_samples, 3), generator=gen).cuda()
    g = (torch.randn((n_samples, L * F), generator=gen) * 1e-3).cuda()
    return x, g, geo, T


def segsum_times(keys, vals, T: int, sizes: list) -> dict:
    """Device ms of ``batched_segment_sum`` (zero-fill and kernel) over all
    levels and for each level alone (``sizes``: its rows), beside the
    ``index_add_`` yardstick timed alike: a zeroed output made inside the
    timed call, then one ``index_add_`` of addends rounded to bf16 and keys
    offset per level beforehand (outside the timing, which favours the
    library)."""
    import torch

    from ngp_tpu_torch.ops.segsum import batched_segment_sum

    L, M, F = vals.shape

    def index_add(k, v, rows):
        return lambda: torch.zeros((rows, F), device="cuda").index_add_(0, k, v)

    def times(k, v, lib):
        return {"ms": device_ms(lambda: batched_segment_sum(k, v, T)),
                "library_ms": device_ms(lib)}

    rounded = vals.to(torch.bfloat16).float()
    flat_keys = (keys.long() + torch.arange(L, device="cuda")[:, None] * T).reshape(-1)
    out = {"all_levels": times(keys, vals,
                               index_add(flat_keys, rounded.reshape(-1, F), L * T))}
    out["levels"] = [
        {"level": l, "rows": sizes[l],
         **times(keys[l:l + 1], vals[l:l + 1], index_add(keys[l].long(), rounded[l], T))}
        for l in range(L)]
    return out


def _sum_error(name, got, want, k, v, T):
    """Max abs error of a float32 sum of bf16 addends against its twin's:
    within 2·(n−1)·2^-24·Σ|addend| per row (a float32 sum of n addends in
    any order is within half that of the exact one), untouched rows +0.0."""
    import torch

    from ngp_tpu_torch.ops import segsum

    n = segsum.segment_count_reference(k, T)[..., None].float()
    mass = segsum.segment_sum_reference(k, v.abs(), T)
    excess = (got - want).abs() - 2.0 * n * 2.0 ** -24 * mass
    if float(excess.max()) > 0:
        raise AssertionError(f"{name}: beyond the float32 order bound")
    if bool(torch.signbit(got[mass == 0]).any()) or bool((got[mass == 0] != 0).any()):
        raise AssertionError(f"{name}: an untouched row is not +0.0")
    return float((got - want).abs().max())


def backward_levels(x, g, geo, keys, T: int) -> list:
    """Device ms of the fused grid backward and of the histogram for each
    level alone: the backward on that level's geometry and cotangents, B3
    on its keys (each with its zeroed output)."""
    from ngp_tpu_torch.ops.hashgrid import hashgrid_backward_cuda
    from ngp_tpu_torch.ops.segsum import segment_count_cuda

    L = geo[0].shape[0]
    F = g.shape[1] // L
    out = []
    for l in range(L):
        one = tuple(t[l:l + 1] for t in geo[:4]) + (geo[4],)
        gl = g[:, l * F:(l + 1) * F].contiguous()
        kl = keys[l:l + 1]
        out.append({
            "level": l, "rows": int(geo[2][l]),
            "backward_ms": device_ms(lambda: hashgrid_backward_cuda(x, gl, *one, None, T)),
            "segment_count_ms": device_ms(lambda: segment_count_cuda(kl, T)),
        })
    return out


def phase_kernel_train(shape: str, x, g, geo, T: int) -> dict:
    """Each training kernel against its twin at a step's shapes: the fused
    grid backward of positions ``x`` (N, 3) and cotangents ``g`` (N, L·F)
    at the encoding geometry ``geo``, then the segment sum, the histogram
    and the one-level entry points on the corner keys and addends that the
    backward's twin makes of them; on uniform positions also B1's forward.
    Per kernel: ``ms``, the device time of a call (its output's zero-fill
    included) from the profiler; ``call_ms``, CUDA events around 20 calls
    of the wrapper; the twin's time, the library yardstick's device time
    (timed alike) and the bound. The segment sum also per level (phase
    ``segsum_levels``), the backward and the histogram too (phase
    ``backward_levels``). Returns the kernels' rows of the ``kernels``
    line (without launches)."""
    import torch

    from ngp_tpu_torch.ops import segsum
    from ngp_tpu_torch.ops.hashgrid import (
        hashgrid_backward_addends_reference,
        hashgrid_backward_cuda,
        hashgrid_backward_reference,
    )

    n_samples = x.shape[0]
    sizes = geo[2].tolist()
    # the corner keys (L, 8N) and addends (L, 8N, F) as the backward's twin
    # makes them on the card: the inputs of B2, B3 and B4
    keys, vals = hashgrid_backward_addends_reference(x, g, *geo)
    L, M, F = vals.shape
    rows = {}

    if shape != "captured_step":
        # B1 forward at the step's shape: the same positions, bf16 reads
        emit({"phase": "kernel_train", "shape": shape, "kernel": "hashgrid_encode",
              **_kernel_case("tpu", torch.bfloat16, torch.Generator().manual_seed(3),
                             x=x, aabb_scale=1)})

    # B1 backward, fused: (x, g) → d(table), bf16 addends summed in float32
    bwd = lambda: hashgrid_backward_cuda(x, g, *geo, None, T)  # noqa: E731
    got = bwd()
    torch.cuda.synchronize()
    err = _sum_error("hashgrid_backward", got,
                     segsum.segment_sum_reference(keys, vals, T), keys, vals, T)
    del got
    rows["hashgrid_backward"] = {
        "max_abs_err": err, "ms": device_ms(bwd), "call_ms": cuda_ms(bwd, iters=20),
        "plain_ms": cuda_ms(lambda: hashgrid_backward_reference(x, g, *geo, None, T),
                            iters=3, warmup=1),
        "library_ms": None,
        # positions and cotangents read once, d(table) written once;
        # 3D + 8·(D−1) weight products and 8·F products and sums per
        # (sample, level)
        **_bound(n_samples * (12 + 4 * L * F) + L * T * F * 4,
                 n_samples * L * (9 + 16 + 16 * F)),
    }
    emit({"phase": "backward_levels", "shape": shape, "N": n_samples,
          "levels": backward_levels(x, g, geo, keys, T)})

    # B2: the segment sum of those addends (bf16 payloads)
    got = segsum.segment_sum_cuda(keys, vals, T)
    torch.cuda.synchronize()
    err = _sum_error("segment_sum", got, segsum.segment_sum_reference(keys, vals, T),
                     keys, vals, T)
    del got
    times = segsum_times(keys, vals, T, sizes)
    emit({"phase": "segsum_levels", "shape": shape, "N": n_samples, "M": M, **times})
    b2 = lambda: segsum.segment_sum_cuda(keys, vals, T)  # noqa: E731
    rows["segment_sum"] = {
        "max_abs_err": err, "ms": times["all_levels"]["ms"],
        "call_ms": cuda_ms(b2, iters=20),
        "plain_ms": cuda_ms(lambda: segsum.segment_sum_reference(keys, vals, T),
                            iters=3, warmup=1),
        # yardstick: one index_add_ into a zeroed flattened table
        # (segsum_times)
        "library_ms": times["all_levels"]["library_ms"],
        # keys and addends read once, the dense table written once
        **_bound(L * M * (4 + 4 * F) + L * T * F * 4, L * M * F),
    }

    # B3: the per-level histogram of the same keys
    got = segsum.segment_count_cuda(keys, T)
    torch.cuda.synchronize()
    if not torch.equal(got, segsum.segment_count_reference(keys, T)):
        raise AssertionError("segment_count differs from the twin")
    flat_keys = (keys.long() + torch.arange(L, device="cuda")[:, None] * T).reshape(-1)
    b3 = lambda: segsum.segment_count_cuda(keys, T)  # noqa: E731
    rows["segment_count"] = {
        "max_abs_err": 0.0, "ms": device_ms(b3), "call_ms": cuda_ms(b3, iters=20),
        "plain_ms": cuda_ms(lambda: segsum.segment_count_reference(keys, T),
                            iters=3, warmup=1),
        # bincount makes its zeroed output itself
        "library_ms": device_ms(lambda: torch.bincount(flat_keys, minlength=L * T)),
        **_bound(L * M * 4 + L * T * 4, L * M),
    }

    # B4: the one-level entry points, on the finest level's keys
    k1, v1 = keys[-1].contiguous(), vals[-1].contiguous()
    got = segsum.segment_sum_onehot(k1, v1, T)
    torch.cuda.synchronize()
    err = _sum_error("segment_sum_onehot", got[None],
                     segsum.segment_sum_reference(k1[None], v1[None], T),
                     k1[None], v1[None], T)
    k1l, v1b = k1.long(), v1.to(torch.bfloat16).float()
    b4 = lambda: segsum.segment_sum_onehot(k1, v1, T)  # noqa: E731
    rows["segment_sum_onehot"] = {
        "max_abs_err": err, "ms": device_ms(b4), "call_ms": cuda_ms(b4, iters=20),
        "plain_ms": cuda_ms(lambda: segsum.segment_sum_reference(k1[None], v1[None], T),
                            iters=3, warmup=1),
        "library_ms": device_ms(
            lambda: torch.zeros((T, F), device="cuda").index_add_(0, k1l, v1b)),
        **_bound(M * (4 + 4 * F) + T * F * 4, M * F),
    }
    got = segsum.segment_count_onehot(k1, T)
    torch.cuda.synchronize()
    if not torch.equal(got, segsum.segment_count_reference(k1[None], T)[0]):
        raise AssertionError("segment_count_onehot differs from the twin")
    b4c = lambda: segsum.segment_count_onehot(k1, T)  # noqa: E731
    rows["segment_count_onehot"] = {
        "max_abs_err": 0.0, "ms": device_ms(b4c), "call_ms": cuda_ms(b4c, iters=20),
        "plain_ms": cuda_ms(lambda: segsum.segment_count_reference(k1[None], T),
                            iters=3, warmup=1),
        "library_ms": device_ms(lambda: torch.bincount(k1l, minlength=T)),
        **_bound(M * 4 + T * 4, M),
    }
    for name, row in rows.items():
        emit({"phase": "kernel_train", "shape": shape, "kernel": name,
              "N": n_samples, "L": L, "M": M, "T": T, "F": F, **row})
    return rows


def phase_kernel_sort() -> dict:
    """B5 against its twin at the size the JAX kernel was written for
    (``ngp_tpu/ops/pallas/sort.py``: 2^20 keys a row): (B, n) = (4, 2^20),
    keys uniform in [0, 2^18) (the "tpu" tier's T, so ties are dense), the
    last 3 of each row INT32_MAX. Keys and perm must equal the twin's
    exactly. Yardstick: ``torch.sort`` along the rows (it writes int64
    indices, 4 bytes an element more than the kernel)."""
    import torch

    from ngp_tpu_torch.ops.sort import (
        INT32_MAX,
        bitonic_sort_launches,
        bitonic_sort_pos_cuda,
        bitonic_sort_pos_reference,
    )

    B, n = 4, 1 << 20
    keys = torch.randint(0, 1 << 18, (B, n), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(5))
    keys[:, -3:] = INT32_MAX
    keys = keys.cuda()
    got_k, got_p = bitonic_sort_pos_cuda(keys)
    torch.cuda.synchronize()
    want_k, want_p = bitonic_sort_pos_reference(keys)
    if not (torch.equal(got_k, want_k) and torch.equal(got_p, want_p)):
        raise AssertionError("bitonic_sort_pos differs from the twin")
    lib_k = torch.sort(keys, dim=1).values
    if not (torch.equal(got_k, lib_k) and torch.equal(keys.gather(1, got_p.long()), got_k)):
        raise AssertionError("bitonic_sort_pos: keys not sorted or perm not theirs")
    del want_k, want_p, lib_k
    stages = int(math.log2(n)) * (int(math.log2(n)) + 1) // 2
    b5 = lambda: bitonic_sort_pos_cuda(keys)  # noqa: E731
    row = {
        "max_abs_err": 0.0, "ms": device_ms(b5), "call_ms": cuda_ms(b5, iters=20),
        "plain_ms": cuda_ms(lambda: bitonic_sort_pos_reference(keys), iters=3, warmup=1),
        "library_ms": device_ms(lambda: torch.sort(keys, dim=1)),
        # keys read once, sorted keys and perm written once; one comparison
        # per pair per stage
        **_bound(B * n * 12, B * n // 2 * stages),
    }
    launches = bitonic_sort_launches(n)
    emit({"phase": "kernel_sort", "B": B, "n": n, "stages": stages,
          "launches_per_call": launches,
          "launch_ms": launch_sequence_ms(b5, launches), **row})
    return row


def phase_train():
    """The bench's fallback configuration, 400 steps through
    ``NerfEngine.train`` one step per call (each synchronized and timed);
    then the PSNR of view 0, and one more step whose grid backward's
    arguments are kept (positions, cotangents, geometry; by reference)."""
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
    for name in ("hashgrid_encode", "hashgrid_backward"):
        if launches[name] == 0:
            raise AssertionError(f"the training path launched {name} no time")

    from ngp_tpu_torch.ops import hashgrid as hashgrid_ops

    backward = hashgrid_ops.hashgrid_backward_cuda
    kept = []

    def keep(x, g, *geo_and_rows):
        kept[:] = [(x, g, *geo_and_rows)]
        return backward(x, g, *geo_and_rows)

    hashgrid_ops.hashgrid_backward_cuda = keep
    try:
        state, grid, _ = eng.train(state, grid, 1)
        torch.cuda.synchronize()
    finally:
        hashgrid_ops.hashgrid_backward_cuda = backward
    x, g, scale, res, size, hashed, variant, _, n_rows = kept[0]
    return eng, state, grid, launches, result, (x, g, (scale, res, size, hashed, variant),
                                                n_rows)


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

    march, loss = engine_mod.march_rays, engine_mod.nerf_training_loss
    engine_mod.march_rays = _ranged("march", march)
    engine_mod.nerf_training_loss = _ranged("loss", loss)
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
        engine_mod.march_rays, engine_mod.nerf_training_loss = march, loss


def phase_capture():
    """Write a PNG capture, load it, train on it and score its held-out
    views; then B1 on the eval's positions. Returns the launches of the
    path (load, train, eval), counted from zero."""
    import shutil

    import numpy as np
    import torch

    from ngp_tpu_torch.config import default_config
    from ngp_tpu_torch.data.nerf_loader import load_nerf
    from ngp_tpu_torch.data.synthetic import (
        CAPTURE_TEST_VIEWS,
        CAPTURE_TRAIN_VIEWS,
        write_sphere_capture,
    )
    from ngp_tpu_torch.engines.nerf import NerfEngine
    from ngp_tpu_torch.ops import hashgrid as hashgrid_ops
    from ngp_tpu_torch.ops.cuda_build import launch_counts, reset_launches

    out = os.path.join(ROOT, "build", "capture_smoke")
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    train_json, test_json = write_sphere_capture(out, res=CAPTURE_RES, device="cuda")
    write_s = time.perf_counter() - t0

    reset_launches()
    t0 = time.perf_counter()
    ds, test = load_nerf(train_json), load_nerf(test_json)
    load_s = time.perf_counter() - t0
    n_frames = ds.n_images + test.n_images
    if ds.images.shape != (CAPTURE_TRAIN_VIEWS, CAPTURE_RES, CAPTURE_RES, 4) or \
            test.images.shape != (CAPTURE_TEST_VIEWS, CAPTURE_RES, CAPTURE_RES, 4):
        raise AssertionError(f"load_nerf: frames {ds.images.shape}, {test.images.shape}")

    eng = NerfEngine(default_config("tpu"), ds, batch_size=1 << 18)
    state, grid = eng.init_state(), eng.init_grid()
    torch.cuda.synchronize()
    step_ms, samples = [], []
    for _ in range(CAPTURE_STEPS):
        t0 = time.perf_counter()
        state, grid, metrics = eng.train(state, grid, 1)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        samples.append(metrics["network_samples"])
    train_launches = launch_counts()

    # the eval keeps the positions of its largest B1 launch (a reference)
    encode = hashgrid_ops.hashgrid_encode_cuda
    largest = []

    def keep_largest(x, *args, **kwargs):
        if not largest or x.shape[0] > largest[0].shape[0]:
            largest[:] = [x]
        return encode(x, *args, **kwargs)

    hashgrid_ops.hashgrid_encode_cuda = keep_largest
    try:
        t0 = time.perf_counter()
        scores = eng.eval_test_transforms(state, grid, test)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
    finally:
        hashgrid_ops.hashgrid_encode_cuda = encode
    launches = launch_counts()
    eval_launches = {k: n - train_launches[k] for k, n in launches.items()}

    # one more render of held-out view 0, alone: the render's share of a view
    t0 = time.perf_counter()
    rgb, _, _ = eng.render_view(state, grid, test.xforms[0, 0], test.focal_lengths[0],
                                test.principal_points[0], lens=test.lens,
                                min_transmittance=1e-4)
    torch.cuda.synchronize()
    render_ms = (time.perf_counter() - t0) * 1e3
    steady = step_ms[256:]
    result = {
        "phase": "capture", "res": CAPTURE_RES, "train_views": ds.n_images,
        "test_views": test.n_images, "lens": [ds.lens.mode, list(ds.lens.params)],
        "aabb_scale": eng.aabb_scale, "cascades": eng.grid_cfg.n_cascades,
        "write_s": write_s, "load_s": load_s, "load_s_per_image": load_s / n_frames,
        "steps": CAPTURE_STEPS, "median_ms_per_step": float(np.median(steady)),
        "median_ms_per_step_warmup_32_256": float(np.median(step_ms[32:256])),
        "network_samples_per_step": float(np.mean(samples[256:])),
        "final_loss": float(metrics["loss"]), "k_and_rays": list(eng.batch_geometry),
        "launches_per_step": {k: n / CAPTURE_STEPS for k, n in train_launches.items()},
        "eval_launches": eval_launches,
        "psnr": scores["psnr"], "min_psnr": scores["min_psnr"],
        "max_psnr": scores["max_psnr"], "ssim": scores["ssim"],
        "per_view_psnr": [v["psnr"] for v in scores["per_view"]],
        "psnr_gate": CAPTURE_PSNR_MIN,
        "eval_ms_per_view": eval_s * 1e3 / scores["n_views"],
        "render_ms_view0": render_ms, "render_samples_view0": eng.last_render_samples,
        "render_finite": bool(torch.isfinite(rgb).all()),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    emit(result)
    if not result["render_finite"] or tuple(rgb.shape) != (CAPTURE_RES, CAPTURE_RES, 3):
        raise AssertionError(f"held-out render: shape {tuple(rgb.shape)} or non-finite")
    if not scores["psnr"] >= CAPTURE_PSNR_MIN:
        raise AssertionError(f"held-out PSNR {scores['psnr']} dB after {CAPTURE_STEPS} "
                             f"steps < {CAPTURE_PSNR_MIN}")
    for name in ("hashgrid_encode", "hashgrid_backward"):
        if launches[name] == 0:
            raise AssertionError(f"the capture path launched {name} no time")
    if eval_launches["hashgrid_encode"] == 0:
        raise AssertionError("the held-out eval launched hashgrid_encode no time")

    # By CUDA events: after phase train_profile's windows, the profiler
    # keeps 13 of 20 records of a kernel in every later window of the
    # process (H100, torch 2.11), and device_ms then fails.
    positions = _kernel_case("tpu", torch.bfloat16, torch.Generator().manual_seed(4),
                             x=largest[0], aabb_scale=eng.aabb_scale, profiled=False)
    emit({"phase": "kernel_capture_positions", **positions})
    return launches


def main():
    phase_env()
    import torch

    phase_build()
    phase_kernel()
    sort_row = phase_kernel_sort()
    phase_golden()
    frames, launches, x_serve = phase_serve()

    # B1 at the serve path's shape: "tpu" tier, bf16 table reads, as many
    # uniform samples as the path's launches averaged; then on the positions
    # of the frame's largest launch, whose neighbours lie near in space
    n_main = sum(f["samples"] for f in frames) // launches["hashgrid_encode"]
    main_case = _kernel_case("tpu", torch.bfloat16, torch.Generator().manual_seed(1),
                             n_main)
    emit({"phase": "kernel_main_path", **main_case})
    emit({"phase": "kernel_serve_positions",
          **_kernel_case("tpu", torch.bfloat16, torch.Generator().manual_seed(1),
                         x=x_serve)})
    del x_serve

    eng, state, grid, train_launches, train, step_inputs = phase_train()
    # the kernels at the path's mean network samples per step on uniform
    # positions (the kernels line), at the step's full sample budget, and on
    # the kept step's own positions and cotangents
    train_rows = phase_kernel_train(
        "main_path", *train_inputs(int(train["network_samples_per_step"])))
    phase_kernel_train("full_budget", *train_inputs(eng.samples_per_step))
    phase_kernel_train("captured_step", *step_inputs)
    del step_inputs
    phase_train_profile(eng, state, grid, train["median_ms_per_step"])
    del eng, state, grid
    capture_launches = phase_capture()

    keys = ("max_abs_err", "ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = [{
        "name": "hashgrid_encode_cuda", "route": "cuda",
        "source": "ngp_tpu_torch/csrc/hashgrid_encode.cu",
        "replaces": "ngp_tpu/ops/pallas/hashgrid.py:66",
        "launches": (launches["hashgrid_encode"] + train_launches["hashgrid_encode"]
                     + capture_launches["hashgrid_encode"]),
        **{k: main_case[k] for k in keys},
    }]
    for name, source, replaces, launched in (
        ("hashgrid_backward", "hashgrid_encode.cu",
         "ngp_tpu/models/encodings.py:378", train_launches["hashgrid_backward"]),
        # B2's work on the path is done by the fused backward; its launches
        # there are counted all the same
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
                        "replaces": replaces,
                        "launches": launched + capture_launches[name],
                        **{k: train_rows[name][k] for k in keys}})
    # B5 is on no path of either package (ngp_tpu/ops/pallas/sort.py:24-31):
    # its launches on the serve, train and capture paths are counted all the same
    kernels.append({"name": "bitonic_sort_pos", "route": "cuda",
                    "source": "ngp_tpu_torch/csrc/bitonic_sort.cu",
                    "replaces": "ngp_tpu/ops/pallas/sort.py:77",
                    "launches": launches["bitonic_sort_pos"]
                    + train_launches["bitonic_sort_pos"]
                    + capture_launches["bitonic_sort_pos"],
                    **{k: sort_row[k] for k in keys}})
    emit({"kernels": kernels})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()

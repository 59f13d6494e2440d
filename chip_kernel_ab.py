#!/usr/bin/env python3
"""Time the kernels of two checkouts of this repository on one NVIDIA GPU,
in turns, so that a change to a kernel is measured against its parent on
the same card in the same run:

    python3 chip_kernel_ab.py BEFORE AFTER [--kernels regs b1 b5 segsum bwd b3 bvh igrad walk]

BEFORE and AFTER are repository roots, for example the parent commit
unpacked with ``git archive`` into a git-ignored directory, and ``.``. Each
turn runs in a process of its own that imports that root's
``ngp_tpu_torch`` (and so builds that root's kernels), in the order BEFORE,
AFTER, AFTER, BEFORE, and prints one JSON line per measurement as it ends;
then the card's ``name, power.limit``. Device ms are ``device_ms`` of this
script's ``chip_smoke.py`` (the profiler's device time per call, output
allocation included). Kernels:

- ``regs``: ptxas's registers a thread of every Linear instantiation of
  the three grid kernels (forward, fused backward, position gradient)
  from each checkout's build log (:func:`grid_registers`).
- ``b1``: ``hashgrid_encode_cuda`` on a bf16 table: the "tpu" tier at
  aabb_scale 4 on ``--b1-samples`` uniform positions and on the positions
  of a rendered frame's largest launch (captured once, by a first process
  that runs ``chip_smoke.phase_serve`` with AFTER's package, and shared by
  every turn), and the "upstream" tier on 2^20 uniform positions; beside
  each, the cast ``table.to(bfloat16)`` that the encoding makes first.
- ``b5``: ``bitonic_sort_pos_cuda`` at (4, 2^20) on the keys of
  ``chip_smoke.phase_kernel_sort``, beside ``torch.sort``.
- ``segsum``: ``segsum_times`` of ``chip_smoke.py`` (``batched_segment_sum``
  over all levels and each level alone, beside ``index_add_``) on the grid
  backward's keys and addends for each of ``--samples`` uniform positions.
- ``bwd``: the grid backward, (x, g) → d(table), as each checkout computes
  it: one ``hashgrid_backward_cuda`` where the root has it, else
  ``hashgrid_backward_addends_cuda`` then ``batched_segment_sum`` (the two
  launches before the fused kernel); on each of ``--samples`` uniform
  positions and on one training step's own (x, g), captured once, by a
  first process that runs ``chip_smoke.phase_train`` with AFTER's package,
  and shared by every turn.
- ``b3``: ``segment_count_cuda`` over all levels and each level alone, on
  the corner keys of the same positions.
- ``bvh``: the triangle-BVH traversal kernels, each checkout on a tree it
  builds itself from one mesh, chip_smoke.py's 327,680-triangle bumpy
  sphere: ``bvh_closest_point_cuda`` on one data refresh's own 131,072
  queries and ``bvh_ray_intersect_cuda`` on the 960×540 frame's 518,400
  camera rays (the mesh, queries and rays written once, by a first process
  with AFTER's package), timed by CUDA events (``cuda_ms``: the profiler
  drops records of these kernels), with a hash of their outputs (equal in
  every turn when the kernels agree bit for bit), and, printed once by
  that first process, the bound of those inputs (``chip_smoke._bvh_bound``
  from the twins' visits).
- ``igrad``: the grid's position gradient ``hashgrid_input_grad_cuda`` on
  four inputs, each captured once, by a first process with AFTER's package,
  and shared by every turn: the normals frame's own (x, g, table) (the
  largest launch of ``chip_smoke.phase_normals``' 960×540 normals frame of
  the sphere ``chip_smoke.phase_train`` trains, "tpu" tier); the largest
  launch of a base.json normals render (training view 0 at stride 2) of
  ``chip_smoke.py``'s 800×800 sphere capture after ``CLI_STEPS`` steps
  through ``Testbed``, as phase ``cli_checks`` renders it; one step's own
  (x, g) of the sdf config on the 327,680-triangle bumpy sphere after
  ``IGRAD_SDF_STEPS`` steps; and ``chip_smoke.image_geometry_2d_case``.
  Timed by CUDA events: ``ms`` around 50 calls queued behind a spin kernel
  (``chip_smoke.queued_ms``, the calls' device time), ``call_ms`` around 20 calls
  issued one after another (host issue included); with a digest of dx
  (equal in every turn when the kernels agree bit for bit). Every
  checkout also prints the SASS of its input-gradient kernels:
  instructions, and those of each loop with its global loads, and ptxas's
  registers (``igrad_sass``), and writes their SASS to ``IGRAD_DIR``.
  ``--igrad-variants 256x16 512x16 ...`` also times, in each AFTER turn,
  AFTER's kernel rebuilt with other constants: ``THREADSxFLOATS`` sets
  ``kGradThreads`` (threads a block) and ``kGradStageFloats`` (a sample's
  cotangents a stage of the g tile) in a copy of its source
  (:func:`igrad_variants`).
- ``walk``: the volume engine's delta-tracking walks on the 512³
  procedural cloud at the Testbed's volume config, on inputs captured
  once, by a first process with AFTER's package, into ``WALK_DIR``: a
  step's training data (``VolumeEngine.generate_training_data`` of one
  step's key, 16,384 episodes: before the fused kernel, the starts'
  launches, then the walk kernel, then the targets; after it, one
  launch), and ``volume_render_walk_cuda`` on the 960×540 ground-truth
  frame's 518,400 rays and on the learned frame's first round (413,556
  rays; the first round does not depend on the model). Each checkout
  builds the cloud and its own ``WalkVolume``. ``ms`` is CUDA events
  around calls queued behind a spin kernel (``chip_smoke.queued_ms``),
  ``call_ms`` around 20 calls issued one after another, with a digest of
  the outputs (equal in every turn when the walks agree bit for bit).
  Then, on the host's clock, what the walks' users wait for: ms a
  training step and ms a learned 960×540 frame of the seeded initial
  model (:func:`walk_end_to_end`).
  Every checkout also prints its walk kernels' SASS (``walk_sass``:
  instructions, each loop's instructions and global loads, whether the
  loads of one pass are in flight together) and ptxas's registers.
  ``--walk-variants T64 nocarry packed nobricks ...`` also times, in each
  AFTER turn, AFTER's kernels rebuilt with the ``WALK_*`` macros of
  ``csrc/volume_walk.cu`` set (``T<n>`` the block size; an element's
  name, ``carry``, ``packed``, ``overlap`` or ``bricks``, forces design
  element (a)-(d) on in every kernel, ``no`` before it off; ``+`` joins
  them, e.g. ``nocarry+nopacked+nooverlap+nobricks``), called through
  AFTER's wrappers.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
POSITIONS = os.path.join(HERE, "build", "kernel_ab_serve_positions.pt")
STEP_INPUTS = os.path.join(HERE, "build", "kernel_ab_train_step.pt")
BVH_MESH = os.path.join(HERE, "build", "kernel_ab_bvh", "bumpy_sphere.obj")
BVH_INPUTS = os.path.join(HERE, "build", "kernel_ab_bvh", "queries.pt")
IGRAD_DIR = os.path.join(HERE, "build", "kernel_ab_igrad")
IGRAD_INPUTS = os.path.join(IGRAD_DIR, "inputs.pt")
IGRAD_SDF_STEPS = 200
WALK_DIR = os.path.join(HERE, "build", "kernel_ab_walk")
WALK_INPUTS = os.path.join(WALK_DIR, "inputs.pt")
WALK_STEP = 1000  # the training data's step: its key
WALK_E2E_FRAMES, WALK_E2E_CALLS, WALK_E2E_STEPS = 3, 5, 20
WALK_ELEMENTS = ("carry", "packed", "overlap", "bricks")  # csrc/volume_walk.cu (a)-(d)


def _helpers(root: str):
    """This script's chip_smoke.py as a module, with ``root`` first on the
    path so that its ``ngp_tpu_torch`` imports are that root's."""
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(HERE, "chip_smoke.py"))
    helpers = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(helpers)
    import torch

    import ngp_tpu_torch

    if not torch.cuda.is_available():
        sys.exit("chip_kernel_ab: torch.cuda.is_available() is False")
    package_root = os.path.dirname(os.path.dirname(os.path.abspath(ngp_tpu_torch.__file__)))
    if package_root != root:
        sys.exit(f"chip_kernel_ab: imported ngp_tpu_torch from {package_root}, not {root}")
    return helpers


def b1_times(helpers, x, tier: str = "tpu") -> dict:
    import torch

    from ngp_tpu_torch.ops.hashgrid import hashgrid_encode_cuda

    enc = helpers._encoding(tier)
    L, T, F = enc.table.shape
    master = (torch.rand((L, T, F), generator=torch.Generator().manual_seed(1))
              * 2 - 1).cuda()
    table = master.to(torch.bfloat16)
    geo = (enc.level_scale, enc.level_res, enc.level_size, enc.level_hashed,
           enc.hash_variant)
    return {"tier": tier, "N": x.shape[0],
            "ms": helpers.device_ms(lambda: hashgrid_encode_cuda(x, table, *geo)),
            "cast_ms": helpers.device_ms(lambda: master.to(torch.bfloat16))}


def b5_times(helpers) -> dict:
    import torch

    from ngp_tpu_torch.ops.sort import INT32_MAX, bitonic_sort_pos_cuda

    B, n = 4, 1 << 20
    keys = torch.randint(0, 1 << 18, (B, n), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(5))
    keys[:, -3:] = INT32_MAX
    keys = keys.cuda()
    got = bitonic_sort_pos_cuda(keys)[0]
    if not torch.equal(got, torch.sort(keys, dim=1).values):
        raise AssertionError("bitonic_sort_pos_cuda: keys not sorted")
    return {"B": B, "n": n,
            "ms": helpers.device_ms(lambda: bitonic_sort_pos_cuda(keys)),
            "library_ms": helpers.device_ms(lambda: torch.sort(keys, dim=1))}


def bwd_times(helpers, x, g, geo, T: int) -> dict:
    from ngp_tpu_torch.ops import hashgrid

    if hasattr(hashgrid, "hashgrid_backward_cuda"):
        route = "hashgrid_backward"
        fn = lambda: hashgrid.hashgrid_backward_cuda(x, g, *geo, None, T)  # noqa: E731
    else:  # a checkout from before the fused kernel
        from ngp_tpu_torch.ops.segsum import batched_segment_sum

        route = "hashgrid_backward_addends+segment_sum"
        fn = lambda: batched_segment_sum(  # noqa: E731
            *hashgrid.hashgrid_backward_addends_cuda(x, g, *geo), T)
    return {"route": route, "ms": helpers.device_ms(fn)}


def b3_times(helpers, keys, T: int) -> dict:
    from ngp_tpu_torch.ops.segsum import segment_count_cuda

    return {"ms": helpers.device_ms(lambda: segment_count_cuda(keys, T)),
            "levels_ms": [helpers.device_ms(lambda: segment_count_cuda(keys[l:l + 1], T))
                          for l in range(keys.shape[0])]}


def _digest(tensors) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def bvh_times(helpers) -> list[dict]:
    """Both traversal kernels of the imported checkout on its own tree of
    ``BVH_MESH``: ms by CUDA events and an output hash."""
    import torch

    from ngp_tpu_torch.geometry.mesh import load_mesh
    from ngp_tpu_torch.geometry.triangle_bvh import build_bvh
    from ngp_tpu_torch.ops.bvh import bvh_closest_point_cuda, bvh_ray_intersect_cuda

    tree = build_bvh(load_mesh(BVH_MESH).triangles, "cuda")
    points, o, d = (t.cuda() for t in torch.load(BVH_INPUTS))
    rows = []
    for name, fn, n in (
            ("bvh_closest_point", lambda: bvh_closest_point_cuda(tree, points), points.shape[0]),
            ("bvh_ray_intersect", lambda: bvh_ray_intersect_cuda(tree, o, d), o.shape[0])):
        out = fn()
        rows.append({"kernel": name, "N": n, "ms": helpers.cuda_ms(fn, iters=20),
                     "outputs": _digest(out)})
    return rows


def _loop_paths(code: list, head: int, back: int) -> list[int]:
    """The fewest and the most instructions on a path through one pass of
    a SASS loop, from its first instruction at ``head`` to its branch back
    at ``back`` (``code``: (address, text) in order), each forward branch
    inside the loop followed both ways and an inner loop's branch back not
    taken; a path that leaves the loop is left out."""
    import re

    at = {a: i for i, (a, _) in enumerate(code)}
    found, todo = set(), [(head, 0)]
    while todo and len(found) < 256:
        pc, n = todo.pop()
        while True:
            text = code[at[pc]][1]
            n += 1
            if pc == back:
                found.add(n)
                break
            target = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", text)
            if target:
                to = int(target.group(1), 16)
                if not head <= to <= back:
                    break
                if to <= pc:  # an inner loop's branch back: once through it
                    pc = code[at[pc] + 1][0]
                    continue
                if not text.startswith("@"):
                    pc = to
                    continue
                todo.append((to, n))
            if text.startswith("EXIT"):
                break
            pc = code[at[pc] + 1][0]
    return [min(found), max(found)] if found else []


def igrad_sass(helpers) -> list[dict]:
    """The imported checkout's input-gradient kernels in SASS: for each, its
    instructions, and each loop (a branch back to an earlier address) as
    [instructions, global loads, the fewest and the most on a path through
    one pass (:func:`_loop_paths`)]; with
    ptxas's registers from the build log (``chip_smoke.ptxas_registers``)."""
    import re

    from ngp_tpu_torch.ops.cuda_build import nvcc_path
    from ngp_tpu_torch.ops.hashgrid import HASHGRID_ENCODE

    lib = HASHGRID_ENCODE.lib_path()
    HASHGRID_ENCODE.library()
    cuobjdump = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    os.makedirs(IGRAD_DIR, exist_ok=True)
    with open(os.path.join(IGRAD_DIR, f"{lib.stem}.sass"), "w") as f:
        on = False
        for line in sass.splitlines():
            on = "hashgrid_input_grad_kernel" in line if "Function :" in line else on
            if on:
                f.write(line.split(";")[0].strip() + "\n")
    registers = helpers.ptxas_registers(HASHGRID_ENCODE)
    kernels, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            continue
        found = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if name and "hashgrid_input_grad_kernel" in name and found:
            kernels.setdefault(name, []).append((int(found.group(1), 16), found.group(2)))
    rows = []
    for name, code in kernels.items():
        loops = []
        for at, text in code:
            target = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", text)
            if target and int(target.group(1), 16) < at:
                head = int(target.group(1), 16)
                body = [t for a, t in code if head <= a <= at]
                loops.append([len(body), sum("LDG" in t for t in body),
                              *_loop_paths(code, head, at)])
        shape = re.search(r"ILi(\d)ELi(\d)E(?:Li(\d)E)?", name)
        rows.append({"kernel": "igrad_sass", "D": int(shape.group(1)) if shape else None,
                     "F": int(shape.group(2)) if shape else None,
                     "additive": shape.group(3) if shape else None,
                     "simplex": "Lb1EE" in name,
                     "instructions": len(code), "loops": loops,
                     "ptxas_registers": registers.get(name)})
    return rows


def grid_registers(helpers) -> dict:
    """ptxas's registers a thread of the imported checkout's Linear
    instantiations of the three grid kernels (``chip_smoke._registers``),
    keyed ``kernel<D, F, last template argument>``: the forward's table
    type, the backward's bf16 rounding, the position gradient's hash."""
    from ngp_tpu_torch.ops.hashgrid import HASHGRID_ENCODE

    HASHGRID_ENCODE.library()
    last = {"hashgrid_encode_kernel": ("f", "13__nv_bfloat16"),
            "hashgrid_backward_kernel": ("Lb0E", "Lb1E"),
            "hashgrid_input_grad_kernel": ("Li0E", "Li1E")}
    return {f"{k}<{D},{F},{a}>": helpers._registers(k, f"Li{D}ELi{F}E{a}")
            for k, args in last.items() for D in (2, 3) for F in (1, 2, 4, 8) for a in args}


def igrad_times(helpers) -> list[dict]:
    """The imported checkout's ``hashgrid_input_grad_cuda`` on each captured
    input: ms by CUDA events and a digest of dx."""
    import torch

    from ngp_tpu_torch.ops import hashgrid

    rows = []
    for name, (x, g, table, geo4, variant) in torch.load(IGRAD_INPUTS).items():
        x, g, table = x.cuda(), g.cuda(), table.cuda()
        geo = tuple(t.cuda() for t in geo4) + (variant,)
        L, _, F = table.shape
        fn = lambda: hashgrid.hashgrid_input_grad_cuda(x, g, table, *geo)  # noqa: E731
        rows.append({"kernel": "igrad", "input": name, "N": x.shape[0], "D": x.shape[1],
                     "L": L, "F": F, "hash": variant, "dx": _digest([fn()]),
                     "ms": helpers.queued_ms(fn), "call_ms": helpers.cuda_ms(fn, iters=20)})
        del x, g, table
    return rows


def igrad_variants(variants: list[str]) -> list[dict]:
    """The imported checkout's input-gradient kernel rebuilt with other
    constants, each ``THREADSxFLOATS`` a copy of ``csrc/hashgrid_encode.cu``
    with ``kGradThreads`` and ``kGradStageFloats`` set (all compiled at
    once with the package's flags), called through its C entry on each
    captured input: ms (``chip_smoke.queued_ms``) and a digest of dx."""
    import ctypes
    import re

    import torch

    from ngp_tpu_torch.ops import hashgrid
    from ngp_tpu_torch.ops.cuda_build import NVCC_FLAGS, launch_on, nvcc_path

    src = hashgrid.HASHGRID_ENCODE.source
    os.makedirs(IGRAD_DIR, exist_ok=True)
    builds = {}
    for v in variants:
        threads, floats = (int(n) for n in v.split("x"))
        code = re.sub(r"(constexpr int kGradThreads = )\d+", rf"\g<1>{threads}",
                      src.read_text())
        code = re.sub(r"(constexpr int kGradStageFloats = )\d+", rf"\g<1>{floats}", code)
        copy = os.path.join(IGRAD_DIR, f"variant_{v}.cu")
        with open(copy, "w") as f:
            f.write(code)
        lib = copy[:-3] + ".so"
        builds[v] = (lib, subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-I", str(src.parent), "-o", lib, copy],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for v, (path, proc) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {v}:\n{log}")
        lib = ctypes.CDLL(path)
        lib.hashgrid_input_grad.restype = ctypes.c_int
        lib.hashgrid_input_grad.argtypes = hashgrid.HASHGRID_ENCODE.library() \
            .hashgrid_input_grad.argtypes
        libs[v] = lib
    rows = []
    for name, (x, g, table, geo4, variant) in torch.load(IGRAD_INPUTS).items():
        x, g, table = x.cuda(), g.cuda(), table.cuda()
        geo = hashgrid._host_geometry(*(t.cuda() for t in geo4))
        (N, D), (L, T, F) = x.shape, table.shape
        dx = torch.empty_like(x)
        for v, lib in libs.items():
            def fn(lib=lib):
                rc = launch_on(x.device, lambda stream: lib.hashgrid_input_grad(
                    x.data_ptr(), g.data_ptr(), table.data_ptr(), ctypes.addressof(geo),
                    dx.data_ptr(), N, L, T, F, D, hashgrid.HASH_VARIANTS[variant], L - 1,
                    stream))
                if rc != 0:
                    raise RuntimeError(f"variant {v}: launch failed ({rc})")
                return dx
            rows.append({"kernel": "igrad", "input": name, "design": v,
                         "dx": _digest([fn()]), "ms": helpers.queued_ms(fn)})
        del x, g, table, dx
    return rows


def _walk_engine(helpers):
    """The imported checkout's ``VolumeEngine`` at the Testbed's volume
    config on ``chip_smoke.VOLUME_RES``³ procedural cloud, on the card."""
    from ngp_tpu_torch.data.volume import procedural_cloud
    from ngp_tpu_torch.engines.volume import VolumeEngine
    from ngp_tpu_torch.testbed import _DEFAULT_CONFIGS

    return VolumeEngine(_DEFAULT_CONFIGS["volume"], procedural_cloud(helpers.VOLUME_RES))


def _sass_loops(code: list) -> list:
    """Each loop of a kernel's SASS (``code``: (address, text) in order):
    [instructions, global loads, the fewest and the most on a path through
    one pass (:func:`_loop_paths`), and, for each two successive global
    loads of the loop, whether the second issues before any instruction
    reads the first's result (both in flight together)]."""
    import re

    loops = []
    for at, text in code:
        target = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", text)
        if not (target and int(target.group(1), 16) < at):
            continue
        head = int(target.group(1), 16)
        body = [t for a, t in code if head <= a <= at]
        loads = [i for i, t in enumerate(body) if "LDG" in t]
        together = []
        for i, j in zip(loads, loads[1:]):
            dest = re.search(r"LDG\S*\s+(R\d+)", body[i])
            reg = dest.group(1) if dest else None
            used = reg and any(re.search(rf"\b{reg}\b", t.split(None, 2)[-1])
                               for t in body[i + 1:j])
            together.append(not used)
        loops.append([len(body), len(loads), *_loop_paths(code, head, at), together])
    return loops


def walk_sass(helpers) -> list[dict]:
    """The imported checkout's walk kernels in SASS: instructions, each
    loop (:func:`_sass_loops`), ptxas's registers; the SASS is written to
    ``WALK_DIR``."""
    import re

    from ngp_tpu_torch.ops.cuda_build import nvcc_path
    from ngp_tpu_torch.ops.volume_walk import VOLUME_WALK

    VOLUME_WALK.library()
    lib = VOLUME_WALK.lib_path()
    cuobjdump = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    os.makedirs(WALK_DIR, exist_ok=True)
    with open(os.path.join(WALK_DIR, f"{lib.stem}.sass"), "w") as f:
        f.write(sass)
    registers = helpers.ptxas_registers(VOLUME_WALK)
    kernels, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            continue
        found = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if name and found:
            kernels.setdefault(name, []).append((int(found.group(1), 16), found.group(2)))
    return [{"kernel": "walk_sass",
             "name": re.search(r"(\w+_kernel)", name).group(1),
             "instructions": len(code), "loops": _sass_loops(code),
             "ptxas_registers": registers.get(name)} for name, code in kernels.items()]


def _walk_variant_libs(variants: list[str]) -> dict:
    """AFTER's ``csrc/volume_walk.cu`` built once a variant with its
    ``WALK_*`` macros set (all compiled at once), loaded with the
    wrappers' signatures."""
    import ctypes
    import re

    from ngp_tpu_torch.ops.cuda_build import NVCC_FLAGS, nvcc_path
    from ngp_tpu_torch.ops.volume_walk import VOLUME_WALK

    os.makedirs(WALK_DIR, exist_ok=True)
    builds = {}
    for v in variants:
        defs = []
        for part in v.split("+"):
            if part.startswith("T"):
                defs.append(f"-DWALK_THREADS={part[1:]}")
            else:
                on = part in WALK_ELEMENTS
                name = part if on else part.removeprefix("no")
                if name not in WALK_ELEMENTS:
                    raise ValueError(f"unknown walk variant part {part!r}")
                defs.append(f"-DWALK_{name.upper()}={int(on)}")
        lib = os.path.join(WALK_DIR, f"variant_{v.replace('+', '_')}.so")
        builds[v] = (lib, subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, *VOLUME_WALK.flags, *defs, "-o", lib,
             str(VOLUME_WALK.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for v, (path, proc) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {v}:\n{log}")
        lib = ctypes.CDLL(path)
        for fn, (restype, argtypes) in VOLUME_WALK.signatures.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        registers, entry = {}, None
        for line in log.splitlines():
            name = re.search(r"entry function '\w*?(train_walk|render_gt|render_round)_kernel",
                             line)
            entry = name.group(1) if name else entry
            used = re.search(r"Used (\d+) registers", line)
            if used and entry:
                registers[entry] = int(used.group(1))
        libs[v] = (lib, registers)
    return libs


def walk_times(helpers, variants: dict) -> list[dict]:
    """The imported checkout's walks on the captured inputs (module
    docstring): ms, call_ms and a digest of the outputs of each; then,
    for each of ``variants`` ({name: (library, registers)}), the same
    through the wrappers with that library in place of the package's."""
    import torch

    from ngp_tpu_torch.ops import volume_walk as vw

    eng = _walk_engine(helpers)
    cap = torch.load(WALK_INPUTS)
    gt = [t.cuda() for t in cap["gt"]]
    rnd = [t.cuda() for t in cap["round"]]
    copies = []

    def one_round():
        if not copies:
            copies.extend((rnd[0].clone(), rnd[2].clone(), rnd[3].clone()) for _ in range(80))
        p, a, it = copies.pop()
        return vw.volume_render_walk_cuda(eng.walk, p, rnd[1], a, cap["frame_key"], False,
                                          it, rnd[4])

    cases = (("train_data", lambda: eng.generate_training_data(WALK_STEP), cap["episodes"],
              400_000_000),
             ("gt_frame", lambda: vw.volume_render_walk_cuda(eng.walk, *gt, cap["frame_key"],
                                                             True),
              gt[0].shape[0], 100_000_000),
             ("learned_round", one_round, rnd[0].shape[0], 100_000_000))
    rows = []
    for design, (lib, registers) in {"package": (None, None), **variants}.items():
        saved = vw.VOLUME_WALK._lib
        if lib is not None:
            vw.VOLUME_WALK._lib = lib
        try:
            for name, fn, n, spin in cases:
                out = fn()
                row = {"kernel": "walk", "input": name, "N": n, "design": design,
                       "outputs": _digest(out), "ms": helpers.queued_ms(fn, 20, spin),
                       "call_ms": helpers.cuda_ms(fn, iters=20)}
                if name == "train_data":
                    # positions, valid flags and densities; the sky apart
                    # (capture_walk: the engine once computed it otherwise on
                    # the card)
                    row["outputs"] = _digest([out[0], out[2], out[1][:, 3]])
                    row["sky"] = _digest([out[1][:, :3]])
                    # a call that synchronises the host cannot queue: the
                    # profiler's sum of the call's kernels and copies
                    row["device_ms"] = helpers.device_ms(fn)
                rows.append({**row, **({"registers": registers} if registers else {})})
                copies.clear()
        finally:
            vw.VOLUME_WALK._lib = saved
    return rows + walk_end_to_end(eng, cap)


def walk_end_to_end(eng, cap) -> list[dict]:
    """What the walks' users wait for, on the host's clock with the card
    synchronised: ms a training step (``WALK_E2E_CALLS`` calls of
    ``WALK_E2E_STEPS`` steps after as many warm-up steps; the median and
    each call's) and ms a learned 960×540 frame (``WALK_E2E_FRAMES``
    frames of the seeded initial model; the median and each), with a digest
    of the frame."""
    import statistics
    import time

    import torch

    state = eng.init_state()
    o, d = (t.cuda() for t in cap["rays"])
    frame = eng.render_rays(state, o, d, False)
    torch.cuda.synchronize()
    frames = []
    for _ in range(WALK_E2E_FRAMES):
        t0 = time.perf_counter()
        eng.render_rays(state, o, d, False)
        torch.cuda.synchronize()
        frames.append((time.perf_counter() - t0) * 1e3)
    eng.train(state, WALK_E2E_STEPS)
    torch.cuda.synchronize()
    steps = []
    for _ in range(WALK_E2E_CALLS):
        t0 = time.perf_counter()
        eng.train(state, WALK_E2E_STEPS)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3 / WALK_E2E_STEPS)
    return [{"kernel": "walk", "input": "learned_frame_wall", "design": "package",
             "outputs": _digest(frame), "ms": statistics.median(frames), "each_ms": frames},
            {"kernel": "walk", "input": "train_step_wall", "design": "package",
             "ms": statistics.median(steps), "each_ms": steps}]


def step_cases(helpers, samples: list[int]):
    """(label, x, g, geometry, T) for each of ``samples`` uniform positions
    and for the captured training step."""
    import torch

    for n in samples:
        yield ("uniform", *helpers.train_inputs(n))
    x, g, scale, res, size, hashed, variant, T = torch.load(STEP_INPUTS)
    yield ("train_step", x.cuda(), g.cuda(),
           tuple(t.cuda() for t in (scale, res, size, hashed)) + (variant,), T)


def turn(root: str, label: str, kernels: list[str], b1_samples: int,
         samples: list[int], variants: list[str], walk_variants: list[str]):
    import torch

    root = os.path.abspath(root)
    helpers = _helpers(root)
    from ngp_tpu_torch.ops.hashgrid import hashgrid_backward_addends_reference

    base = {"turn": label, "root": root}
    if "regs" in kernels:
        helpers.emit({**base, "kernel": "regs", "registers": grid_registers(helpers)})
    if "b1" in kernels:
        x = torch.rand((b1_samples, 3), generator=torch.Generator().manual_seed(1)).cuda()
        helpers.emit({**base, "kernel": "b1", "positions": "uniform", **b1_times(helpers, x)})
        x = torch.load(POSITIONS).cuda()
        helpers.emit({**base, "kernel": "b1", "positions": "serve_frame",
                      **b1_times(helpers, x)})
        x = torch.rand((1 << 20, 3), generator=torch.Generator().manual_seed(1)).cuda()
        helpers.emit({**base, "kernel": "b1", "positions": "uniform",
                      **b1_times(helpers, x, "upstream")})
    if "b5" in kernels:
        helpers.emit({**base, "kernel": "b5", **b5_times(helpers)})
    if "segsum" in kernels:
        for n in samples:
            x, g, geo, T = helpers.train_inputs(n)
            keys, vals = hashgrid_backward_addends_reference(x, g, *geo)
            helpers.emit({**base, "kernel": "segsum", "N": n, "M": keys.shape[1],
                          **helpers.segsum_times(keys, vals, T, geo[2].tolist())})
    if "bvh" in kernels:
        for row in bvh_times(helpers):
            helpers.emit({**base, **row})
    if "igrad" in kernels:
        for row in igrad_sass(helpers) + igrad_times(helpers):
            helpers.emit({**base, **row})
        if variants and label == "after":
            for row in igrad_variants(variants):
                helpers.emit({**base, **row})
    if "walk" in kernels:
        libs = _walk_variant_libs(walk_variants) if walk_variants and label == "after" else {}
        for row in walk_sass(helpers) + walk_times(helpers, libs):
            helpers.emit({**base, **row})
    if "bwd" in kernels or "b3" in kernels:
        for positions, x, g, geo, T in step_cases(helpers, samples):
            case = {**base, "positions": positions, "N": x.shape[0]}
            if "bwd" in kernels:
                helpers.emit({**case, "kernel": "bwd", **bwd_times(helpers, x, g, geo, T)})
            if "b3" in kernels:
                keys, _ = hashgrid_backward_addends_reference(x, g, *geo)
                helpers.emit({**case, "kernel": "b3", **b3_times(helpers, keys, T)})
                del keys


def capture(root: str):
    """Render the serve phase's frames with ``root``'s package and keep the
    positions of the profiled frame's largest B1 launch."""
    import torch

    helpers = _helpers(os.path.abspath(root))
    x = helpers.phase_serve()[2]
    os.makedirs(os.path.dirname(POSITIONS), exist_ok=True)
    torch.save(x.cpu(), POSITIONS)


def capture_step(root: str):
    """Train with ``root``'s package as phase train does and keep one more
    step's grid-backward inputs: positions, cotangents, geometry, rows."""
    import torch

    helpers = _helpers(os.path.abspath(root))
    x, g, geo, T = helpers.phase_train()[5]
    os.makedirs(os.path.dirname(STEP_INPUTS), exist_ok=True)
    torch.save((x.cpu(), g.cpu(), *(t.cpu() for t in geo[:4]), geo[4], T),
               STEP_INPUTS)


def capture_bvh(root: str):
    """Write chip_smoke.py's bumpy sphere, load it through ``Testbed`` with
    ``root``'s package, and keep the closest-point kernel's queries of one
    data refresh (step 0) and the sdf frame's camera rays."""
    import torch

    helpers = _helpers(os.path.abspath(root))
    from ngp_tpu_torch.data.synthetic import write_bumpy_sphere_mesh
    from ngp_tpu_torch.ops import bvh as bvh_ops
    from ngp_tpu_torch.testbed import SDF_EYE, SDF_FOV_DEG, SDF_LOOKAT, Testbed

    os.makedirs(os.path.dirname(BVH_MESH), exist_ok=True)
    write_bumpy_sphere_mesh(BVH_MESH, helpers.SDF_SUBDIVISIONS)
    eng = Testbed(scene=BVH_MESH).engine
    kept, launch = [], bvh_ops.bvh_closest_point_cuda
    bvh_ops.bvh_closest_point_cuda = lambda tree, points: kept.append(points) or launch(
        tree, points)
    try:
        eng.training_batch(0)
    finally:
        bvh_ops.bvh_closest_point_cuda = launch
    o, d = eng.camera_rays(SDF_EYE, SDF_LOOKAT, helpers.SDF_FRAME, SDF_FOV_DEG)
    torch.save((kept[0].cpu(), torch.from_numpy(o), torch.from_numpy(d)), BVH_INPUTS)
    # the bound both turns are held against: the work these inputs need
    o, d = torch.from_numpy(o).cuda(), torch.from_numpy(d).cuda()
    cp_stats, ray_stats = {}, {}
    bvh_ops.bvh_closest_point_reference(eng.bvh, kept[0], cp_stats)
    bvh_ops.bvh_ray_intersect_reference(eng.bvh, o, d, ray_stats)
    for name, stats, bound in (
            ("bvh_closest_point", cp_stats, (kept[0].shape[0], 12, 20, helpers.BOX_SQ_DIST_OPS,
                                             helpers.POINT_TRIANGLE_OPS)),
            ("bvh_ray_intersect", ray_stats, (o.shape[0], 24, 8, helpers.BOX_RAY_OPS,
                                              helpers.RAY_TRIANGLE_OPS))):
        helpers.emit({"turn": "capture_bvh", "kernel": name, "N": bound[0],
                      "twin_iterations": stats["iterations"],
                      **helpers._bvh_bound(stats, eng.bvh, *bound)})


def capture_igrad(root: str):
    """Capture the four inputs of the ``igrad`` set with ``root``'s package
    (module docstring) into ``IGRAD_INPUTS``: for each, (x, g, table, the
    geometry's four tensors, the hash variant), on the host."""
    import torch

    helpers = _helpers(os.path.abspath(root))
    from ngp_tpu_torch.data.synthetic import write_bumpy_sphere_mesh, write_sphere_capture
    from ngp_tpu_torch.ops import hashgrid as hashgrid_ops
    from ngp_tpu_torch.testbed import Testbed

    def largest(render):
        kept = []
        original = helpers._keep_largest(hashgrid_ops, "hashgrid_input_grad_cuda", kept)
        try:
            render()
            torch.cuda.synchronize()
        finally:
            hashgrid_ops.hashgrid_input_grad_cuda = original
        x, g, table, *geo = kept[0]
        return x.detach(), g, table, *geo[:5]

    cases = {}
    eng, state, grid = helpers.phase_train()[:3]
    o, d = helpers.normals_rays()
    cases["normals_frame"] = largest(lambda: eng.render_rays(state, grid, o, d, mode="normals"))
    del eng, state, grid
    train_json, _ = write_sphere_capture(os.path.join(IGRAD_DIR, "capture"),
                                         res=helpers.CAPTURE_RES, device="cuda")
    tb = Testbed(scene=train_json)
    tb.train(helpers.CLI_STEPS)
    cases["normals_positions"] = largest(lambda: tb.engine.render_image(
        tb.state, tb.grid, 0, stride=2, mode="normals"))
    del tb
    tb = Testbed(scene=write_bumpy_sphere_mesh(os.path.join(IGRAD_DIR, "bumpy_sphere.obj"),
                                               helpers.SDF_SUBDIVISIONS))
    tb.train(IGRAD_SDF_STEPS)
    kept, backward = [], hashgrid_ops.hashgrid_backward_cuda
    hashgrid_ops.hashgrid_backward_cuda = lambda x, g, *rest: kept.append((x, g, *rest)) or \
        backward(x, g, *rest)
    try:
        tb.train(1)
        torch.cuda.synchronize()
    finally:
        hashgrid_ops.hashgrid_backward_cuda = backward
    x, g, *geo = kept[-1][:7]
    cases["step_positions"] = (x, g, tb.state.model.encoding.table.detach(), *geo)
    del tb
    x, g, table, geo = helpers.image_geometry_2d_case()
    cases["image_geometry_2d"] = (x, g, table, *geo)
    torch.save({name: (x.cpu(), g.cpu(), t.cpu(), [v.cpu() for v in geo[:4]], geo[4])
                for name, (x, g, t, *geo) in cases.items()}, IGRAD_INPUTS)
    for name, (x, g, t, *geo) in cases.items():
        helpers.emit({"turn": "capture_igrad", "input": name, "N": x.shape[0],
                      "D": x.shape[1], "L": t.shape[0], "T": t.shape[1], "F": t.shape[2],
                      "hash": geo[4], "level_rows": geo[2].tolist()})


def capture_walk(root: str):
    """Capture the ``walk`` set's inputs with ``root``'s package into
    ``WALK_INPUTS``: the training data's key and episodes, and the
    ground-truth frame's and the learned frame's first round's walk
    inputs, on the host; prints AFTER's walk lengths of each."""
    import torch

    helpers = _helpers(os.path.abspath(root))
    from ngp_tpu_torch.ops import volume_walk as vw
    from ngp_tpu_torch.testbed import VOLUME_EYE, VOLUME_LOOKAT

    eng = _walk_engine(helpers)
    state = eng.init_state()
    kept, launch = {}, vw.volume_render_walk_cuda

    def keep(vol, pos, dirs, alive, key, gt, iters=None, ids=None, **kw):
        name = "gt" if gt else "round"
        if name not in kept:
            kept[name] = ((pos, dirs, alive) if gt else
                          (pos.clone(), dirs, alive.clone(), iters.clone(), ids))
            kept["frame_key"] = key
        return launch(vol, pos, dirs, alive, key, gt, iters, ids, **kw)

    o, d = (torch.from_numpy(a).cuda() for a in
            eng.camera_rays(VOLUME_EYE, VOLUME_LOOKAT, helpers.VOLUME_FRAME, 50.0))
    vw.volume_render_walk_cuda = keep
    try:
        eng.render_rays(state, o, d, True)
        eng.render_rays(state, o, d, False)
        torch.cuda.synchronize()
    finally:
        vw.volume_render_walk_cuda = launch
    E = eng.batch_size // vw.MAX_TRAIN_VERTICES
    os.makedirs(WALK_DIR, exist_ok=True)
    torch.save({"episodes": E, "frame_key": kept["frame_key"], "rays": [o.cpu(), d.cpu()],
                "gt": [t.cpu() for t in kept["gt"]],
                "round": [t.cpu() for t in kept["round"]]}, WALK_INPUTS)
    key = vw.draw_key(eng.seed ^ 0x701, WALK_STEP)
    steps = torch.zeros((E,), dtype=torch.int32, device="cuda")
    vw.volume_train_walk_cuda(eng.walk, key, E, eng.albedo, eng.scattering, eng.envmap, steps)
    pos, dirs, alive = kept["gt"]
    gt_steps = torch.zeros(alive.shape, dtype=torch.int32, device="cuda")
    vw.volume_render_walk_cuda(eng.walk, pos, dirs, alive, kept["frame_key"], True,
                               steps=gt_steps)
    p, d, a, it, ids = kept["round"]
    after = vw.volume_render_walk_cuda(eng.walk, p.clone(), d, a.clone(), kept["frame_key"],
                                       False, it.clone(), ids)[2]
    for name, n in (("train_data", steps), ("gt_frame", gt_steps), ("learned_round", after - it)):
        helpers.emit({"turn": "capture_walk", "input": name, "N": n.shape[0],
                      **helpers._walk_stats(n)})
    # the sky of the step's final directions as the twin computes it and as
    # the engine did on the card before the fused kernel (torch.sum, and
    # / 255.0, which PyTorch takes as a product with the reciprocal on a
    # CUDA tensor)
    d1, ut = vw.start_draws(key, E, "cuda")
    origin = vw.normalize(d1) * 2.0 + 0.5
    lo, hi = eng.walk.aabb_min, eng.walk.aabb_max
    dirs = vw.normalize(lo + ut * (hi - lo) - origin)
    tmin, tmax = vw.ray_aabb_range(origin, dirs, lo, hi)
    walked = vw.training_walk(eng.walk, origin + dirs * (tmin + 1e-6)[:, None], dirs,
                              tmin <= tmax, vw.HashDraws(key), eng.albedo, eng.scattering)
    final = walked[3]
    up, sun, sky = (torch.tensor(v, dtype=torch.float32, device="cuda") for v in eng.envmap)
    sunam = torch.clamp_min(torch.sum(final * sun, -1), 0.0)
    for _ in range(6):
        sunam = sunam * sunam
    sun_col = torch.tensor([255.0, 215.0, 195.0], device="cuda") / 255.0
    earlier = (sky[None, :] * (torch.sum(final * up, -1) * 0.5 + 0.5)[:, None]
            + sun_col[None, :] * (20.0 * sunam)[:, None])
    now = vw.proc_envmap(final, *eng.envmap)
    helpers.emit({"turn": "capture_walk", "input": "train_data_sky",
                  "values_differing_from_earlier_route": int((now != earlier).sum()),
                  "max_abs_difference": float((now - earlier).abs().max()),
                  "sun_colour_differing": int((sun_col.cpu() != torch.tensor(
                      vw._SUN_COL)).sum())})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("before")
    ap.add_argument("after")
    ap.add_argument("--kernels", nargs="+", default=["b1", "b5"],
                    choices=["regs", "b1", "b5", "segsum", "bwd", "b3", "bvh", "igrad",
                             "walk"])
    ap.add_argument("--b1-samples", type=int, default=470671,
                    help="uniform positions for b1 (the serve path's mean launch)")
    ap.add_argument("--samples", type=int, nargs="+", default=[78827, 163840],
                    help="network samples for segsum, bwd and b3")
    ap.add_argument("--igrad-variants", nargs="+", default=[],
                    help="THREADSxFLOATS constants of AFTER's input-gradient kernel for igrad")
    ap.add_argument("--walk-variants", nargs="+", default=[],
                    help="WALK_* macro sets of AFTER's walk kernels for walk (T<threads>, "
                         "[no]carry, [no]packed, [no]overlap, [no]bricks, joined by +)")
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn == "capture":
        capture(args.after)
        return
    if args.turn == "capture_step":
        capture_step(args.after)
        return
    if args.turn == "capture_bvh":
        capture_bvh(args.after)
        return
    if args.turn == "capture_igrad":
        capture_igrad(args.after)
        return
    if args.turn == "capture_walk":
        capture_walk(args.after)
        return
    if args.turn:
        turn(getattr(args, args.turn), args.turn, args.kernels, args.b1_samples,
             args.samples, args.igrad_variants, args.walk_variants)
        return
    common = ["--kernels", *args.kernels, "--b1-samples", str(args.b1_samples),
              "--samples", *map(str, args.samples)]
    if args.igrad_variants:
        common += ["--igrad-variants", *args.igrad_variants]
    if args.walk_variants:
        common += ["--walk-variants", *args.walk_variants]
    labels = ["before", "after", "after", "before"]
    if "b1" in args.kernels:
        labels.insert(0, "capture")
    if "bwd" in args.kernels or "b3" in args.kernels:
        labels.insert(0, "capture_step")
    if "bvh" in args.kernels:
        labels.insert(0, "capture_bvh")
    if "igrad" in args.kernels:
        labels.insert(0, "capture_igrad")
    if "walk" in args.kernels:
        labels.insert(0, "capture_walk")
    for label in labels:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), args.before, args.after,
             "--turn", label, *common],
            capture_output=True, text=True, check=False)
        for ln in out.stdout.splitlines():
            if ln.startswith("{") and '"turn"' in ln:
                print(ln, flush=True)
        if out.returncode != 0:
            sys.stderr.write(out.stderr)
            sys.exit(f"chip_kernel_ab: the {label} turn failed ({out.returncode})")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()

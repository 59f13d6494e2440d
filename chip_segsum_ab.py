#!/usr/bin/env python3
"""Time the segment sum of two checkouts of this repository on one NVIDIA
GPU, in turns, so that a change to ``csrc/segment_sum.cu`` is measured
against its parent on the same card in the same run:

    python3 chip_segsum_ab.py BEFORE AFTER [--samples N [N ...]]

BEFORE and AFTER are repository roots, for example the parent commit
unpacked with ``git archive`` into a git-ignored directory, and ``.``. Each
turn runs in a process of its own that imports that root's
``ngp_tpu_torch`` (and so builds that root's kernels), in the order BEFORE,
AFTER, AFTER, BEFORE. For each number of network samples a turn prints one
JSON line: ``segsum_times`` of this script's ``chip_smoke.py`` (device ms of
``batched_segment_sum`` over all levels and for each level alone, beside
``index_add_`` timed alike) on
the grid backward's keys and addends for that many uniform positions
(``chip_smoke.train_addends``), as each turn ends; then the card's
``name, power.limit``.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def turn(root: str, label: str, samples: list[int]):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(HERE, "chip_smoke.py"))
    helpers = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(helpers)
    import torch

    import ngp_tpu_torch

    if not torch.cuda.is_available():
        sys.exit("chip_segsum_ab: torch.cuda.is_available() is False")
    package_root = os.path.dirname(os.path.dirname(os.path.abspath(ngp_tpu_torch.__file__)))
    if package_root != root:
        sys.exit(f"chip_segsum_ab: imported ngp_tpu_torch from {package_root}, not {root}")
    for n in samples:
        _, _, _, keys, vals, T, sizes = helpers.train_addends(n)
        helpers.emit({"turn": label, "root": root, "N": n, "M": keys.shape[1],
                      **helpers.segsum_times(keys, vals, T, sizes)})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("before")
    ap.add_argument("after")
    ap.add_argument("--samples", type=int, nargs="+", default=[78827, 163840])
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        turn(getattr(args, args.turn), args.turn, args.samples)
        return
    for label in ("before", "after", "after", "before"):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), args.before, args.after,
             "--turn", label, "--samples", *map(str, args.samples)],
            capture_output=True, text=True, check=False)
        for ln in out.stdout.splitlines():
            if ln.startswith("{"):
                print(ln, flush=True)
        if out.returncode != 0:
            sys.stderr.write(out.stderr)
            sys.exit(f"chip_segsum_ab: the {label} turn failed ({out.returncode})")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()

"""ATen operations dispatched per NeRF training step of the PyTorch port,
on the CPU: a count of the host-issued work a step makes, which on the
card is its kernel launches and sets the time of a host-bound step.

Trains the sphere of ``tiny_sphere_dataset`` (16 views of 32²) at
instant-ngp's base.json widths (L=16, F=2, T=2^19, 64-wide MLPs) with
2^14 sample slots a step for ``--warm`` steps, then counts the operations
of each of ``--steps`` more steps through a ``TorchDispatchMode`` and
prints one JSON line: the median count a step and the counts of the
forward (everything up to the backward), the backward and the optimizer.
On the CPU the port's kernel wrappers run their plain PyTorch twins, so
the count includes the twins' operations; it compares two trees or two
flag sets, not the card's launch count.

    python scripts/step_op_count.py                       # refinement off
    python scripts/step_op_count.py --flags optimize_extrinsics optimize_exposure \\
        optimize_focal_length optimize_distortion

Run it from the root of the tree to count (a parent checkout too).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
from collections import Counter

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--flags", nargs="*", default=[])
    ap.add_argument("--warm", type=int, default=20)
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args()

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from ngp_tpu_torch.config import default_config
    from ngp_tpu_torch.data.synthetic import tiny_sphere_dataset
    from ngp_tpu_torch.engines.nerf import NerfEngine

    torch.set_num_threads(1)

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = Counter()
            self.part = "forward"

        def __torch_dispatch__(self, func, types, a=(), kw=None):
            self.ops[self.part] += 1
            return func(*a, **(kw or {}))

    eng = NerfEngine(default_config("upstream"), tiny_sphere_dataset(16, 32),
                     batch_size=1 << 14, device="cpu", **{f: True for f in args.flags})
    state, grid = eng.init_state(), eng.init_grid()
    state, grid, _ = eng.train(state, grid, args.warm)

    counter = Count()
    backward, apply = torch.Tensor.backward, eng.apply_grads

    def counted_backward(*a, **kw):
        counter.part = "backward"
        return backward(*a, **kw)

    def counted_apply(*a, **kw):
        counter.part = "optimizer"
        return apply(*a, **kw)

    torch.Tensor.backward = counted_backward
    eng.apply_grads = counted_apply
    steps = []
    try:
        for _ in range(args.steps):
            counter.ops.clear()
            counter.part = "forward"
            with counter:
                state, grid, _ = eng.train(state, grid, 1)
            steps.append(dict(counter.ops))
    finally:
        torch.Tensor.backward = backward
    total = [sum(s.values()) for s in steps]
    print(json.dumps({"flags": args.flags, "steps": steps, "median_ops_per_step":
                      statistics.median(total), "batch_geometry": list(eng.batch_geometry)}))


if __name__ == "__main__":
    main()

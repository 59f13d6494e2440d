#!/usr/bin/env python3
"""Count the calls of torch's CPU ``sqrt`` that leave numpy's correctly
rounded square root by more than 1e-6 relative, in fresh processes with one
and with two intra-op threads:

    python scripts/torch_sqrt_threads.py [--processes 64] [--calls 100]

Each process takes the square root of the same 2^16 float32 values
``--calls`` times. On an AVX-512 Xeon (torch 2.13's CPU build, MKL
2024.2), torch's CPU sqrt (MKL's vsSqrt, split across the intra-op threads)
now and then returned one thread's chunk off by up to ~3e-4 with two
threads; that is why the port's parity tests set one thread
(``tests/test_torch_*.py``). Prints one JSON line per thread count:
processes, calls, bad calls, the largest relative error seen.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

_PROBE = """
import json, sys
import numpy as np, torch
torch.set_num_threads(int(sys.argv[1]))
y = np.random.default_rng(0).uniform(0.1, 1.0, 1 << 16).astype(np.float32)
want = np.sqrt(y.astype(np.float64))
bad, worst = 0, 0.0
for _ in range(int(sys.argv[2])):
    got = torch.sqrt(torch.from_numpy(y)).numpy().astype(np.float64)
    rel = float(np.max(np.abs(got - want) / want))
    bad += rel > 1e-6
    worst = max(worst, rel)
print(json.dumps([bad, worst]))
"""


def probe(threads: int, calls: int) -> tuple[int, float]:
    out = subprocess.run([sys.executable, "-c", _PROBE, str(threads), str(calls)],
                         capture_output=True, text=True, check=True)
    bad, worst = json.loads(out.stdout.strip().splitlines()[-1])
    return bad, worst


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--processes", type=int, default=64)
    ap.add_argument("--calls", type=int, default=100)
    ap.add_argument("--parallel", type=int, default=8, help="processes run at once")
    args = ap.parse_args()
    for threads in (1, 2):
        with ThreadPoolExecutor(args.parallel) as pool:
            results = list(pool.map(lambda _: probe(threads, args.calls),
                                    range(args.processes)))
        print(json.dumps({"threads": threads, "processes": args.processes,
                          "calls": args.processes * args.calls,
                          "bad_calls": sum(b for b, _ in results),
                          "worst_rel": max(w for _, w in results)}), flush=True)


if __name__ == "__main__":
    main()

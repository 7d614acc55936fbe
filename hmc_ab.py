#!/usr/bin/env python3
"""Times bench.py's HMC stage on one CUDA card, this checkout beside others.

    python3 hmc_ab.py --other LABEL=path/to/checkout [--other ...]

An other checkout is, e.g., the parent commit unpacked with `git archive`
into a git-ignored directory. Each turn is one child process for one
checkout, in the order others, this, this, others reversed, so that a drift
of the card or the host falls on both sides. A child puts its checkout
first on sys.path and imports that checkout's gpy_tpu_torch and
chip_smoke.py, whose HMC stage it times as chip_smoke's `run_hmc` does:
HMC(m).sample(num_samples=40, num_chains=C) for C = 1, 2, 4, 8, 16, each
after one warm call, synchronized, in samples/s (its first call builds the
checkout's kernels). Prints one JSON line a turn, a summary line (each
checkout's turns by C), the nvidia-smi line; exits non-zero without a
CUDA device or when a child fails.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def child(tree: str) -> int:
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import chip_smoke as s
    from gpy_tpu_torch import mcmc

    X, Y = s.hmc_data()
    hmc = mcmc.HMC(s.hmc_model(X, Y, torch.float32), stepsize=s.HMC_STEP,
                   num_leapfrog=s.HMC_LEAPFROG)
    rates = {}
    for C in s.HMC_CHAINS:
        hmc.sample(num_samples=s.HMC_SAMPLES, num_chains=C, seed=0)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hmc.sample(num_samples=s.HMC_SAMPLES, num_chains=C, seed=3)
        torch.cuda.synchronize()
        rates[str(C)] = s.HMC_SAMPLES * C / (time.perf_counter() - t0)
    print(json.dumps({"samples_per_s": rates}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[], metavar="LABEL=PATH",
                    help="another checkout of the repo")
    ap.add_argument("--child", metavar="PATH", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.child)
    import torch

    if not torch.cuda.is_available():
        print("hmc_ab: torch sees no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as s

    here = os.path.dirname(os.path.abspath(__file__))
    others = [o.split("=", 1) for o in args.other]
    order = others + [("this", here)] * 2 + others[::-1]
    turns = {label: [] for label, _ in order}
    for i, (label, tree) in enumerate(order):
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", tree],
                           capture_output=True, text=True)
        if r.returncode != 0:
            print(r.stdout + r.stderr, file=sys.stderr)
            return r.returncode
        rates = json.loads(r.stdout.strip().splitlines()[-1])["samples_per_s"]
        turns[label].append(rates)
        s.emit({"turn": i, "checkout": label, "samples_per_s": rates})
    s.emit({"summary": "samples/s by checkout, chains and turn", "turns": turns})
    print(s.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

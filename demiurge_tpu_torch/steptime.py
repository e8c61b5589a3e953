"""Time the single-card coupled step of a checkout of the port, on the card.

    python demiurge_tpu_torch/steptime.py [--tree DIR] [--reps 10]

Imports ``demiurge_tpu_torch`` from ``DIR`` (default: the checkout that
holds this file), builds its kernels, makes the coupled CLI's terrain
(fBm, seed 7) at 2048x1024, runs 2 warm-up ``coupled_step``s and then
``--reps`` runs of ``--steps`` steps with ``CoupledConfig()``.  Each run is
timed on the host clock (ending in ``torch.cuda.synchronize()``, as
``chip_smoke.py`` phase 7 times its loop) and with CUDA events.  Prints one
JSON line: the tree, the card, and ms per step of each run with their
median.  Only entry points that every slice of the port has are used, so
two checkouts can be timed alternately in one session on one card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tree", default=str(HERE.parent))
    p.add_argument("--width", type=int, default=2048)
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args(argv)

    tree = pathlib.Path(args.tree).resolve()
    sys.path = [str(tree)] + [q for q in sys.path
                              if pathlib.Path(q or ".").resolve() != HERE]
    import torch

    import demiurge_tpu_torch
    from demiurge_tpu_torch import model
    from demiurge_tpu_torch.api import cli
    from demiurge_tpu_torch.core.grid import Grid
    from demiurge_tpu_torch.kernels import build

    pkg = pathlib.Path(demiurge_tpu_torch.__file__).resolve().parent
    if pkg.parent != tree:
        raise RuntimeError(f"imported {pkg}, not the package in {tree}")
    build.build()
    build.library()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]

    dev = torch.device("cuda")
    grid = Grid(args.width, args.height)
    cfg = model.CoupledConfig()
    s = model.init_coupled(cli._terrain(grid, args.seed, dev), grid)
    for _ in range(2):
        s = model.coupled_step(s, grid, cfg)
    torch.cuda.synchronize()
    host, device = [], []
    for _ in range(args.reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(args.steps):
            s = model.coupled_step(s, grid, cfg)
        end.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3 / args.steps)
        device.append(start.elapsed_time(end) / args.steps)
    if not bool(torch.isfinite(s.height).all()):
        raise RuntimeError("the height is not finite")
    print(json.dumps({
        "tree": str(tree), "card": card,
        "grid": f"{args.width}x{args.height}", "steps_per_run": args.steps,
        "host_ms_per_step": host, "device_ms_per_step": device,
        "host_median": statistics.median(host),
        "device_median": statistics.median(device)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

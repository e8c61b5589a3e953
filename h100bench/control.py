"""The control of a cell's comparison: the plain reference put in the
program's place, computed in bfloat16 (the precision below the float32
that the configurations state), and compared with the float32 reference
as a run compares the program.  Its numbers must come out above their
limits: they are the upper readings the limits are set below.

    python3 h100bench/control.py --workload NAME --seeds N [N ...]

At the cell's own size, on the card.  Prints one JSON line a seed: the
compared numbers, their limits and whether they passed (they must not).
The benchmark's own runs never run it; the tests run ``control`` at a
small size on the CPU.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def control(cell, seed: int, device) -> dict:
    import torch

    from h100bench import compare, harness, terrain as terrain_mod, traffic

    cfg = cell.cfg
    ref = cell.reference
    run_steps = traffic.plan(cell.traffic, cfg).run_steps
    later = harness.later_steps(seed, run_steps, cfg["check"]["later_steps"])
    terrain = terrain_mod.fbm(cfg["width"], cfg["height"], cfg["terrain"],
                              seed, device)
    low = terrain.to(torch.bfloat16)
    kept, state = {}, ref.init(cfg, low)
    for i in range(1, max([1] + later) + 1):
        state = ref.step(cfg, state, low, i)
        if i == 1 or i in later or i + 1 in later:
            kept[i] = state
    # float32 copies (exact) of the control's states, so that the float32
    # reference of each later step starts in float32 from the control's
    kept = {i: {k: x.to(torch.float32) for k, x in s.items()}
            for i, s in kept.items()}
    sync = torch.cuda.synchronize if terrain.is_cuda else (lambda: None)
    pairs = harness.reference_pairs(ref, cfg, terrain, kept, later, sync)
    compared, _ = compare.compare_steps(pairs, cfg["check"])
    return {"workload": cell.workload["name"], "seed": seed,
            "passed": compare.passed(compared), "compared": compared}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from h100bench import harness

    cell = harness.Cell(harness.load_spec(ROOT), args.workload)
    for seed in args.seeds:
        print(json.dumps(control(cell, seed, "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of the benchmark once and print its result line.

    python3 h100bench/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout that holds ``BENCHMARK.json``, this folder and
the program (``demiurge_tpu_torch``).  Needs as many CUDA cards as the cell
asks for: without them it exits 2 and prints no result.  It exits 3, with
no result, if a module of JAX or of the JAX package was loaded.  The last
line of standard output is the result's JSON object; the compared numbers
and their limits are the last lines of standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from h100bench import harness

    cell = harness.Cell(harness.load_spec(ROOT), args.workload)
    import torch

    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              "cuda", T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

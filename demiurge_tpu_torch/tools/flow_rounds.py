"""The banded flow solver's convergence tail: the active bands of each round.

    python -m demiurge_tpu_torch.tools.flow_rounds [W H [band k]] [--device D]

Defaults 2048 1024 64 16, on ``cuda``.  Solves the (A, vis) fixpoint of the
reference tool's terrain (fBm, 6 octaves, seed 7, pre-blur 0.5) by banded
rounds (``kernels.flow_deadends.flow_solve_banded_rounds``, K11d: k
sweeps a round over the bands the last round's 3-bit flags wake, the flags
read by the host every round; on the card one launch a round, each band's
window in a thread-block cluster, or the earlier k launches a round where
no cluster plan fits) and prints the reference tool's three lines: rounds
and the sweeps they launched, the active bands of each round (from the
flags the card wrote), and their total.  The last line is the launches of
both K11d designs, the host reads and the design that ran.  The
reference tool binds its band kernel without the kernel's ``mode``
argument; this one runs what it means, mode "both" with the 3-bit flags
starting at 7.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..core.grid import Grid
from ..kernels import flow_deadends as kd
from . import flow_inputs, terrain


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("size", nargs="*", type=int, metavar="W H [band k]",
                   help="grid width and height, band rows, sweeps a round")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if len(args.size) > 4:
        p.error("at most four numbers: W H band k")
    W, H, band, k = list(args.size) + [2048, 1024, 64, 16][len(args.size):]

    grid = Grid(W, H)
    dev = torch.device(args.device)
    packed, area = flow_inputs(terrain(grid, dev), grid)
    kd.LAUNCHES_BANDED = kd.LAUNCHES_BANDED_SWEEPS = 0
    _, _, stats = kd.flow_solve_banded_rounds(packed, area, grid, band, k)
    print(f"band={band} k={k} nbands={H // band}: rounds={stats['rounds']} "
          f"sweeps<={stats['sweeps']}")
    print("active bands per round:", stats["active"])
    print("total band-runs:", stats["band_runs"])
    print(json.dumps({"kernel_launches": {
        "flow_banded_rounds": kd.LAUNCHES_BANDED,
        "flow_banded_sweeps": kd.LAUNCHES_BANDED_SWEEPS},
        "host_reads": stats["host_reads"],
        "design": stats.get("design", "twin")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

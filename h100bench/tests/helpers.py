"""Small cells for the harness's CPU tests: the committed cells' files at
a tiny grid and short runs."""

from __future__ import annotations

import pathlib

from h100bench import harness

ROOT = pathlib.Path(__file__).resolve().parents[2]

SMALL = {"coupled-8192": dict(width=64, height=32, run_steps=3),
         "ocean-2048": dict(width=64, height=32, run_steps=4)}


def small_cell(workload: str) -> harness.Cell:
    cell = harness.Cell(harness.load_spec(ROOT), workload)
    cell.cfg.update(SMALL[workload])
    cell.cfg["ocean"]["jacobi_iters"] = min(cell.cfg["ocean"]["jacobi_iters"],
                                            100)
    return cell

"""Step metrics and JSONL logging.

Counterpart of ``demiurge_tpu/utils/metrics.py``: per-step physical
diagnostics (mass, divergence norm), throughput accounting
(grid-points/s), and a JSON-lines step logger.  The reference's ``--xprof``
trace flag is not ported; the CLI does not accept it.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Optional

import torch

from ..core.grid import Grid


def mass(height: torch.Tensor, grid: Grid) -> torch.Tensor:
    """Area-weighted land volume (conservation diagnostic)."""
    area = grid.cell_area_rows(height.device)
    return torch.sum(torch.clamp(height, min=0.0) * area)


def divergence_norm(u, v, terrain, grid: Grid, cfg=None) -> torch.Tensor:
    """RMS divergence over the ocean (zero on land)."""
    from ..ops import ocean as _ocean

    cfg = cfg or _ocean.OceanConfig()
    d = _ocean.divergence(u, v, terrain, grid, cfg)
    return torch.sqrt(torch.mean(torch.where(terrain <= 0, d * d, 0.0)))


class StepLogger:
    """JSONL step logger with throughput accounting.  Logging a tensor
    reads it back to the host, which waits for the device."""

    def __init__(self, grid: Grid, path: Optional[str] = None, stream=None):
        self.grid = grid
        self.file = open(path, "a") if path else None
        self.stream = stream if stream is not None else sys.stderr
        self._t_last = time.perf_counter()

    def log(self, step: int, **scalars):
        values = {}
        for k, v in scalars.items():
            try:
                values[k] = float(v)
            except (TypeError, ValueError):
                values[k] = v
        now = time.perf_counter()
        dt = now - self._t_last
        self._t_last = now
        rec = {
            "step": step,
            "wall_s": round(dt, 4),
            "grid_points_per_s": round(
                self.grid.width * self.grid.height / max(dt, 1e-9), 1),
            **values,
        }
        line = json.dumps(rec)
        if self.file:
            self.file.write(line + "\n")
            self.file.flush()
        if self.stream:
            print(line, file=self.stream)
        return rec

    def close(self):
        if self.file:
            self.file.close()

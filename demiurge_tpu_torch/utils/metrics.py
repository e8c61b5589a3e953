"""Step metrics and JSONL logging.

Counterpart of ``demiurge_tpu/utils/metrics.py``: per-step physical
diagnostics (mass, divergence norm, mean temperature), throughput accounting
(grid-points/s), a JSON-lines step logger, and ``maybe_profile``, the
CLI's ``--xprof DIR``: one Chrome trace of a command's steps, the
program's spans (``core.trace``) and the device's events on one clock.
Under a ``mesh``
(``dist.mesh``) the fields are this rank's blocks: each rank sums its own
block and one all_reduce adds the sums, so no field leaves its rank (the
sums' order differs from one device's, an ulp or so).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from typing import Optional

import torch

from ..core.grid import Grid


def _block(grid: Grid, mesh):
    """The grid, or this rank's block of it as a window (its tables)."""
    if mesh is None:
        return grid
    from ..dist.local import block_window

    return block_window(grid, mesh, 0)


def _sum(parts, mesh):
    """The sums of ``parts`` (0-d tensors) over every rank."""
    if mesh is None:
        return parts
    from ..dist.mesh import all_reduce

    return tuple(all_reduce(torch.stack(parts), mesh))


def mass(height: torch.Tensor, grid: Grid, mesh=None) -> torch.Tensor:
    """Area-weighted land volume (conservation diagnostic)."""
    area = _block(grid, mesh).cell_area_rows(height.device)
    return _sum((torch.sum(torch.clamp(height, min=0.0) * area),), mesh)[0]


def divergence_norm(u, v, terrain, grid: Grid, cfg=None,
                    mesh=None) -> torch.Tensor:
    """RMS divergence over the ocean (zero on land)."""
    from ..ops import ocean as _ocean

    cfg = cfg or _ocean.OceanConfig()
    if mesh is None:
        d = _ocean.divergence(u, v, terrain, grid, cfg)
        return torch.sqrt(torch.mean(torch.where(terrain <= 0, d * d, 0.0)))
    from ..dist.local import block_or_gathered

    d = block_or_gathered(_ocean.divergence, grid, mesh, 1, halo=(0, 1, 2),
                          negate=(0, 1))(u, v, terrain, grid, cfg)
    (total,) = _sum((torch.sum(torch.where(terrain <= 0, d * d, 0.0)),),
                    mesh)
    return torch.sqrt(total / (grid.width * grid.height))


def mean_temperature(T: torch.Tensor, grid: Grid, mesh=None) -> torch.Tensor:
    """Area-weighted mean of the temperature field."""
    area = _block(grid, mesh).cell_area_rows(T.device)
    num, den = _sum((torch.sum(T * area),
                     torch.sum(area * torch.ones_like(T))), mesh)
    return num / den


def vmax(u, v, mesh=None) -> torch.Tensor:
    """The largest current speed."""
    top = torch.sqrt(u * u + v * v).max()
    if mesh is None:
        return top
    from ..dist.mesh import all_reduce

    return all_reduce(top, mesh, op="max")


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


@contextlib.contextmanager
def maybe_profile(trace_dir: Optional[str]):
    """A ``torch.profiler`` profile of the block, host and (where this
    build of torch traces one) card, written as one Chrome trace,
    ``trace_dir/trace.json``, when a directory is given (the ``--xprof``
    flag); otherwise nothing."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, \
        supported_activities

    acts = [a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA)
            if a in supported_activities()]
    with profile(activities=acts) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))

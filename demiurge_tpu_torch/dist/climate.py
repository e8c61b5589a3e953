"""The climate step on row groups: up to a group's rows of substeps per
halo exchange.

Counterpart of ``demiurge_tpu/dist/climate.py``.  The stretched corner
taps reach 1/cos(phi) columns, up to ~W/6 near the poles, beyond any fixed
x halo, so the step works on whole rows (``dist.local``'s strips):

- ``all_to_all_single`` over the mesh row into the row-group layout;
- the substeps in chunks of at most r substeps, r the rows of the
  mesh's smallest row group, so that every rank runs the same chunks
  (row groups may differ by a row): per chunk of K substeps one K-deep
  row-halo exchange of T and dt/C (``exchange_rows_halo``, the strip
  ending at the grid's first and last row: ``dist.local.rows_window``),
  then the single-device substeps themselves
  (``kernels.climate.climate_step_plain``) on the strip's window, with
  the insolation table of that chunk's substeps, validity shrinking one
  row a substep from each side that is not the grid's edge, and the
  group's rows kept.  A strip at a pole reflects there as the whole grid
  does, and at an edge that is not a pole clamps as it does;
- ``all_to_all_single`` back.

Every cell sums the same taps in the same order as the single-device
step, so the result is the plain twin's bit for bit.  The substeps run in
plain PyTorch on each rank; the rank-local substeps on the climate kernel
are later work.
"""

from __future__ import annotations

import numpy as np

from ..core.grid import Grid
from .halo import exchange_rows_halo
from .local import local_supported, own_rows, rows_window
from .mesh import Mesh, blocks_to_rows, row_groups, rows_to_blocks


def climate_sharded_supported(grid: Grid, mesh: Mesh) -> bool:
    """The grids of ``dist.local``'s strips: x-periodic, whatever the
    depth of a dispatch."""
    return local_supported(grid, mesh)


def _chunks(substeps: int, rows: int):
    """The substeps of a dispatch as (first substep, substeps) chunks of
    at most ``rows`` substeps each, as few as that allows, of nearly equal
    depth."""
    n = -(-substeps // max(rows, 1))
    out, s0 = [], 0
    for i in range(n):
        steps = substeps // n + (1 if i < substeps % n else 0)
        out.append((s0, steps))
        s0 += steps
    return out


def climate_step_sharded(T, terrain, i0, grid: Grid, mesh: Mesh,
                         substeps: int = 10, albedo: float = 0.30,
                         diffusivity: float = 0.55e6):
    """``ops.temperature.temperature_step`` under a mesh, on blocks.
    Returns (T_new, i0 + substeps)."""
    from ..kernels.climate import _check_grid, climate_step_plain
    from ..ops.temperature import (SUBSTEPS_PER_YEAR, YEAR_SECONDS, _as_index,
                                   heat_capacity, insolation_table)

    _check_grid(grid)
    i0 = _as_index(i0, T.device)
    cinv = blocks_to_rows(YEAR_SECONDS / SUBSTEPS_PER_YEAR
                          / heat_capacity(terrain), mesh)
    Tr = blocks_to_rows(T, mesh)
    rows = int(np.diff(row_groups(grid.height, mesh)).min())
    for s0, steps in _chunks(substeps, rows):
        win = rows_window(grid, mesh, steps)
        asr = insolation_table(win, i0, steps, albedo, first=s0)
        Tr = climate_step_plain(
            exchange_rows_halo(Tr, steps, mesh, grid),
            exchange_rows_halo(cinv, steps, mesh, grid), asr, win,
            diffusivity)[own_rows(win, grid, mesh)].contiguous()
    return rows_to_blocks(Tr, mesh, grid.height), i0 + float(substeps)

"""Thermal erosion (slope-limited talus redistribution).

Counterpart of ``demiurge_tpu/ops/thermal.py`` (the reference's
ThermalErosion filter, src/filter/ThermalErosion.cpp:25-142).  Each step
is 10 substeps of two passes:

- pass 1: where the slope exceeds 30 deg and h > 0, the cell sheds
  ``(h - minh) / count * 0.3``, minh the minimum over the 3x3
  neighbourhood and count 1 + the number of strictly lower neighbours;
- pass 2: each cell gains the shed amount of every strictly higher
  neighbour; cells steeper than 3 deg with h > 0 keep their height.

Pass 2 adds gains but never subtracts the donor's loss, as the reference
does; ``conservative=True`` also takes the shed material off the donors.
"""

from __future__ import annotations

import math

import torch

from ..core.grid import Grid
from ..core.stencils import get_slope
from ..core.topology import NEIGHBORS_FLOW_ORDER, shift

PI = math.pi


def _substep(h, grid: Grid, conservative: bool):
    slope = get_slope(h, grid, 1.0)

    # pass 1: material shed by each cell
    minh = h
    count = torch.ones_like(h)
    for (dx, dy) in NEIGHBORS_FLOW_ORDER:
        h2 = shift(h, dx, dy, grid)
        minh = torch.minimum(minh, h2)
        count = count + (h2 < h).to(h.dtype)
    shed = torch.where((slope > PI / 6) & (h > 0), (h - minh) / count * 0.3,
                       0.0)

    # pass 2: gather shed amounts from strictly higher neighbours
    gain = torch.zeros_like(h)
    for (dx, dy) in NEIGHBORS_FLOW_ORDER:
        h2 = shift(h, dx, dy, grid)
        s2 = shift(shed, dx, dy, grid)
        gain = gain + torch.where(h2 > h, s2, 0.0)

    keep = (slope > PI / 6 / 10) & (h > 0)
    out = torch.where(keep, h, h + gain)
    if conservative:
        nlower = count - 1.0
        out = out - torch.where(shed > 0, shed * nlower, 0.0)
    return out


def thermal_erosion_step(h, grid: Grid, substeps: int = 10,
                         conservative: bool = False):
    """One ThermalErosion::step: ``substeps`` two-pass substeps."""
    for _ in range(substeps):
        h = _substep(h, grid, conservative)
    return h

"""Grayscale morphology (erode/dilate) with the spherical metric.

Counterpart of ``demiurge_tpu/ops/morphological.py`` (the reference's
Morphological filter, src/filter/Morphological.cpp:28-131): the radius is
split into doubling steps (1, 2, 4, ..., remainder, sorted ascending), and
each step takes the min or max over 64 samples on a circle of that radius,
the x offsets stretched by 1/cos(phi), each sample a nearest fetch.

``morphological_gradient`` = dilate((r+1)/2) - erode(r/2), the selection
border.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.fastroll import row_sample_nearest_x_static
from ..core.grid import Grid
from ..core.topology import grid_st, offset_coords, sample_nearest, shift

PI = math.pi
_N_SAMPLES = 64


def radius_list(radius: float) -> list:
    """Doubling-step decomposition (Morphological.cpp:31-43)."""
    r = []
    x = 1
    while radius >= 0:
        if x < radius:
            radius -= x
            r.append(float(x))
            x *= 2
        else:
            r.append(float(radius))
            break
    r.sort()
    return r


def _circle_pass(field, grid: Grid, radius: float, op: str):
    reduce = torch.minimum if op == "min" else torch.maximum
    acc = field

    if grid.wrap_x:
        # NEAREST at (per-row x stretch, constant y): a row shift, then a
        # per-row column roll whose shifts come from the host in float32,
        # as the reference computes them
        H = grid.height
        r_np = np.arange(H, dtype=np.float32)
        t_np = (r_np + np.float32(0.5)) / np.float32(H)
        phi_np = t_np * np.float32(grid.phi1 - grid.phi0) \
            + np.float32(grid.phi0)
        factor_np = np.float32(1.0) / np.cos(np.abs(phi_np))
        for i in range(_N_SAMPLES):
            ang = 2 * PI * i / _N_SAMPLES
            ky = math.floor(0.5 + math.sin(ang) * radius)
            dx = np.float32(math.cos(ang) * radius) * factor_np
            tap = row_sample_nearest_x_static(shift(field, 0, ky, grid), dx)
            acc = reduce(acc, tap)
        return acc

    factor = 1.0 / torch.cos(torch.abs(grid.row_phi(field.device)))
    s, t = grid_st(grid, field.device)
    for i in range(_N_SAMPLES):
        ang = 2 * PI * i / _N_SAMPLES
        dx = math.cos(ang) * radius * factor
        dy = math.sin(ang) * radius
        s2, t2 = offset_coords(s, t, dx, dy, grid)
        acc = reduce(acc, sample_nearest(field, s2.expand(grid.shape),
                                         t2.expand(grid.shape)))
    return acc


def morphology(field, grid: Grid, radius: float, op: str):
    """erode (op='min') / dilate (op='max') by the given pixel radius."""
    if op not in ("min", "max"):
        raise ValueError(f"unknown morphology op {op!r}")
    for r in radius_list(radius):
        field = _circle_pass(field, grid, r, op)
    return field


def erode(field, grid: Grid, radius: float):
    return morphology(field, grid, radius, "min")


def dilate(field, grid: Grid, radius: float):
    return morphology(field, grid, radius, "max")


def morphological_gradient(field, grid: Grid, radius: float):
    """dilate - erode (Morphological.cpp:87-131)."""
    d = dilate(field, grid, (radius + 1) / 2)
    e = erode(field, grid, radius / 2)
    return d - e

"""Shared stencils of the reference's GLSL stdlib.

Counterpart of ``demiurge_tpu/core/stencils.py``: the Sobel gradient, the
spherical 9-point second derivatives, and the slope and aspect angles,
with the reference shaders' tap positions, weights and sign conventions
(including the negated-x Sobel).  Every tap goes through
``core.topology``, so the dateline and pole wrap match ``offset()``
(src/Shader.h:81-98): on an x-periodic grid the Laplacian's stretched
taps are per-row rolls, elsewhere the general nearest sampler.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .fastroll import row_roll_static
from .grid import Grid
from .topology import sample_offset_nearest, shift

PI = math.pi


def row_inv_cos(grid: Grid) -> np.ndarray:
    """1/cos(phi) of each row center, float32 numpy, computed in f32 as
    the reference's GL fetch does (a window's rows of the whole grid's)."""
    H = grid.base.height
    r = np.arange(H, dtype=np.float32)
    t = (r + np.float32(0.5)) / np.float32(H)
    phi = t * np.float32(grid.phi1 - grid.phi0) + np.float32(grid.phi0)
    return (np.float32(1.0) / np.cos(phi))[grid.rows_np()]


def texture_gradient(field: torch.Tensor, grid: Grid, *,
                     pole_wrap: bool = True):
    """Sobel gradient — reference src/Shader.h:281-297.

    Returns (delta_x, delta_y) in field units per physical length.
    delta_x is the *negated* eastward derivative ((west - east)/8dx), as in
    the reference; delta_y is the northward derivative.
    """
    a = shift(field, -1, -1, grid, pole_wrap=pole_wrap)
    b = shift(field, 0, -1, grid, pole_wrap=pole_wrap)
    c = shift(field, 1, -1, grid, pole_wrap=pole_wrap)
    d = shift(field, -1, 0, grid, pole_wrap=pole_wrap)
    f = shift(field, 1, 0, grid, pole_wrap=pole_wrap)
    g = shift(field, -1, 1, grid, pole_wrap=pole_wrap)
    h = shift(field, 0, 1, grid, pole_wrap=pole_wrap)
    i = shift(field, 1, 1, grid, pole_wrap=pole_wrap)

    dx, dy = grid.pixelsize_rows(field.device)
    delta_x = (-(c + 2 * f + i) + (a + 2 * d + g)) / (8 * dx)
    delta_y = ((g + 2 * h + i) - (a + 2 * b + c)) / (8 * dy)
    return delta_x, delta_y


def corner_shifts(grid: Grid):
    """Per-row integer column shifts (kneg, kpos) of the stretched corner
    taps: the NEAREST fetch at -/+ 1/cos(phi) pixels lands on column
    c + floor(0.5 -/+ 1/cos(phi))."""
    ic = row_inv_cos(grid)
    kneg = np.floor(np.float32(0.5) - ic).astype(np.int64)
    kpos = np.floor(np.float32(0.5) + ic).astype(np.int64)
    return kneg, kpos


def texture_laplacian(field: torch.Tensor, grid: Grid, *,
                      pole_wrap: bool = True):
    """Spherical 9-point second derivatives — reference src/Shader.h:299-320.

    The x taps are stretched by 1/cos(phi) pixels and snapped by the
    reference's GL_NEAREST fetch to a per-row integer column shift.
    Returns (delta_x, delta_y), both normalized by 4*dy^2 as the reference
    does (its pixelwidth.y serves both axes).
    """
    if grid.wrap_x:
        kneg, kpos = corner_shifts(grid)

        def tap(k, dy):
            row = shift(field, 0, dy, grid, pole_wrap=pole_wrap)
            return row if k is None else row_roll_static(row, k)
    else:
        inv_cos = 1.0 / torch.cos(grid.row_phi(field.device))
        kneg, kpos = -inv_cos, inv_cos

        def tap(dx, dy):
            if dx is None:
                return shift(field, 0, dy, grid, pole_wrap=pole_wrap)
            return sample_offset_nearest(field, dx, float(dy), grid,
                                         pole_wrap=pole_wrap)

    # reference taps: offset(st, -vec2(sx, sy)) with sx in {+-1/factor, 0}
    a = tap(kneg, -1)
    b = tap(None, -1)
    c = tap(kpos, -1)
    d = tap(kneg, 0)
    e = field
    f = tap(kpos, 0)
    g = tap(kneg, 1)
    h = tap(None, 1)
    i = tap(kpos, 1)

    _, dy = grid.pixelsize_rows(field.device)
    denom = 4 * dy * dy
    delta_x = (a - 2 * b + c + 2 * d - 4 * e + 2 * f + g - 2 * h + i) / denom
    delta_y = (a + 2 * b + c - 2 * d - 4 * e - 2 * f + g + 2 * h + i) / denom
    return torch.nan_to_num(delta_x, nan=0.0), torch.nan_to_num(delta_y,
                                                                nan=0.0)


def get_slope(field: torch.Tensor, grid: Grid, z_factor: float = 1.0, *,
              pole_wrap: bool = True) -> torch.Tensor:
    """Slope angle — reference src/Shader.h:334-342."""
    gx, gy = texture_gradient(field, grid, pole_wrap=pole_wrap)
    return torch.atan(z_factor * torch.sqrt(gx * gx + gy * gy))


def get_aspect(field: torch.Tensor, grid: Grid, *, pole_wrap: bool = True):
    """Aspect angle — reference src/Shader.h:323-331: pi - atan2(gy, -gx)."""
    gx, gy = texture_gradient(field, grid, pole_wrap=pole_wrap)
    return PI - torch.atan2(gy, -gx)

"""Separable spherical Gaussian blur.

Counterpart of ``demiurge_tpu/ops/blur.py``, reproducing the reference
Blur filter (src/filter/BlurMenu.cpp:24-117):

- the radius is halved ("radius vs diameter"), then the variance
  R = (radius/2)^2/2 is split into per-iteration sigmas whose squares sum
  to R (``sigma_list``);
- each iteration runs a 13-tap linearly sampled Gaussian vertically, then
  horizontally, with the horizontal offsets stretched by 1/cos(phi).

On an x-periodic grid the passes take the reference's fast path: the
vertical taps are row lerps through the wrap-aware shift, so they
interpolate through the poles where the GL reference clamps the last
subpixel at the texture seam (the reference package's documented
"seam-quality" deviation, kept here); the horizontal taps are per-row
fractional column fetches, periodic across the dateline.  Any other grid
takes the exact GL-clamp path: every tap a bilinear gather at
``offset()``.  ``blur`` runs every iteration through ``kernels.blur``
(the CUDA kernel for CUDA tensors on an x-periodic grid, its plain twin —
the ``blur13_pass`` sequence — otherwise).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.fastroll import const_sample_bilinear_y, \
    row_sample_bilinear_x_static
from ..core.grid import Grid, rdiv
from ..core.topology import grid_st, offset_coords, sample_bilinear
from ..kernels import blur as kb

# 13-tap Gaussian with the linear-sampling optimization (BlurMenu.cpp:45-60)
_OFFSETS = (1.411764705882353, 3.2941176470588234, 5.176470588235294)
_W0 = 0.1964825501511404
_WEIGHTS = (0.2969069646728344, 0.09447039785044732, 0.010381362401148057)


def sigma_list(radius: float) -> list:
    """Decompose a blur radius into per-iteration radii
    (BlurMenu.cpp:78-94)."""
    radius = radius / 2.0
    R = radius * radius / 2.0
    rlist = []
    i = 1.0
    incrementer = 0.5
    if R < 3:
        k = 1.0 / math.sqrt(55.0 / R) if R > 0 else 0.0
        if k == 0.0:
            return []
        incrementer = k
        i = k
    while R >= i * i:
        R -= i * i
        rlist.append(i)
        i += incrementer
    if R > 0.0:
        rlist.append(math.sqrt(R))
    rlist.sort()
    return rlist


def vertical_taps(step: float):
    """The six vertical taps of one pass as row offsets, in the pass's
    order (offset magnitude ascending, + before -)."""
    return [sign * off * step for off in _OFFSETS for sign in (1.0, -1.0)]


def horizontal_taps(grid: Grid, step: float, stretch_x: bool = True):
    """The six horizontal taps of one pass as per-row fractional column
    offsets (numpy float32 (H,)), in the pass's order (a window's rows of
    the whole grid's taps)."""
    H = grid.base.height
    r = np.arange(H, dtype=np.float32)
    t = (r + np.float32(0.5)) / np.float32(H)
    phi = t * np.float32(grid.phi1 - grid.phi0) + np.float32(grid.phi0)
    pf = np.cos(np.abs(phi))
    rows = grid.rows_np()
    taps = []
    for off in _OFFSETS:
        for sign in (1.0, -1.0):
            ox = np.float32(sign * off * step)
            taps.append((ox / pf if stretch_x else np.full_like(pf, ox))[rows])
    return taps


def blur13_pass(field: torch.Tensor, grid: Grid, direction, *,
                stretch_x: bool = True) -> torch.Tensor:
    """One blur13 pass (BlurMenu.cpp:41-62); ``direction`` = (dx, dy) is
    the pixel step, one of them zero."""
    if not grid.wrap_x:
        return _blur13_pass_gather(field, grid, direction, stretch_x)
    weights = [w for w in _WEIGHTS for _ in (1.0, -1.0)]
    out = field * _W0
    if direction[0] != 0.0:
        for dx, w in zip(horizontal_taps(grid, direction[0], stretch_x),
                         weights):
            out = out + row_sample_bilinear_x_static(field, dx) * w
        return out
    for oy, w in zip(vertical_taps(direction[1]), weights):
        out = out + const_sample_bilinear_y(field, oy, grid) * w
    return out


def _blur13_pass_gather(field: torch.Tensor, grid: Grid, direction,
                        stretch_x: bool) -> torch.Tensor:
    """The pass as the GL reference samples it: each tap a GL_LINEAR +
    GL_CLAMP_TO_EDGE fetch at ``offset(st, +-offset * direction)``, the x
    offset stretched by 1/cos|phi|."""
    phifactor = torch.cos(torch.abs(grid.row_phi(field.device)))  # (H, 1)
    s, t = grid_st(grid, field.device)
    out = field * _W0
    for off_mag, w in zip(_OFFSETS, _WEIGHTS):
        ox = off_mag * direction[0]
        oy = off_mag * direction[1]
        if stretch_x:
            ox = rdiv(ox, phifactor)
        for sign in (1.0, -1.0):
            s2, t2 = offset_coords(s, t, sign * ox, sign * oy, grid)
            out = out + sample_bilinear(field, s2, t2) * w
    return out


def blur(field: torch.Tensor, grid: Grid, radius: float) -> torch.Tensor:
    """Full separable spherical Gaussian blur of the given radius (pixels):
    per ``sigma_list`` iteration a vertical pass, then a horizontal one."""
    rlist = sigma_list(radius)
    if not rlist:
        return field
    return kb.blur(field.contiguous(), grid, rlist)

"""The climate step on blocks: K substeps per one halo exchange.

Counterpart of ``demiurge_tpu/dist/climate.py``.  The stretched corner
taps reach 1/cos(phi) columns, up to ~W/6 near the poles, beyond any fixed
x halo, so the step works on whole rows:

- ``all_to_all_single`` over the mesh row into the row-group layout;
- one K-deep row-halo exchange of T and dt/C (and of the per-row tables,
  ``_pad_table``); the pole cap is a local flip and half-world roll;
- K substeps locally, validity shrinking one ring a substep (the corner
  sum is symmetric in +-dy, so reflected halo rows evolve as exact
  antipodal mirrors);
- ``all_to_all_single`` back.

The arithmetic is ``kernels.climate``'s (the corner-tap Laplacian, dt/C
folded), in plain PyTorch on each rank; the rank-local substeps on the
climate kernel are later work.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.grid import Grid
from ..core.platform import host_to_device
from ..core.stencils import corner_shifts
from ..kernels.climate import KELVIN, OLR_COEF, diff_scale
from .halo import exchange_rows_halo
from .mesh import Mesh, blocks_to_rows, rows_to_blocks


def climate_sharded_supported(grid: Grid, mesh: Mesh, substeps: int) -> bool:
    H, W = grid.shape
    if not (grid.wrap_x and grid.wrap_south and grid.wrap_north
            and W % 2 == 0):
        return False
    if H % mesh.size != 0 or W % mesh.nx != 0:
        return False
    return H // mesh.size >= substeps  # the halo fits in a rank's rows


def _pad_table(tab, k: int, mesh: Mesh):
    """Per-row tables pad like the rows they belong to, except that beyond
    a pole they are flipped without the half-world roll (a row's value does
    not depend on longitude)."""
    return exchange_rows_halo(tab, k, mesh, edge="flip")


def climate_step_sharded(T, terrain, i0, grid: Grid, mesh: Mesh,
                         substeps: int = 10, albedo: float = 0.30,
                         diffusivity: float = 0.55e6):
    """``ops.temperature.temperature_step`` under a mesh, on blocks.
    Returns (T_new, i0 + substeps)."""
    from ..ops.temperature import (SUBSTEPS_PER_YEAR, YEAR_SECONDS, _as_index,
                                   heat_capacity, qday)

    H, W = grid.shape
    K = substeps
    if not climate_sharded_supported(grid, mesh, K):
        raise ValueError(f"sharded climate: grid {grid.shape}, mesh "
                         f"{mesh.shape}, {K} substeps")
    dev = T.device
    i0 = _as_index(i0, dev)
    rows_loc = H // mesh.size
    rows = slice(mesh.rank * rows_loc, (mesh.rank + 1) * rows_loc)

    kneg, kpos = corner_shifts(grid)
    shifts = host_to_device((np.stack([kneg, kpos], axis=1) % W)[rows]
                            .astype(np.int64), dev)
    shifts = _pad_table(shifts, K, mesh)                     # (r+2K, 2)
    phi = _pad_table(grid.row_phi(dev)[rows], K, mesh)       # (r+2K, 1)
    M = (2.0 * math.pi / SUBSTEPS_PER_YEAR) * (
        i0 + torch.arange(K, dtype=torch.float32, device=dev))
    asr = (1.0 - albedo) * qday(phi, M.reshape(1, -1))       # (r+2K, K)

    cinv = YEAR_SECONDS / SUBSTEPS_PER_YEAR / heat_capacity(terrain)
    Tp = exchange_rows_halo(blocks_to_rows(T, mesh), K, mesh, grid)
    cinvp = exchange_rows_halo(blocks_to_rows(cinv, mesh), K, mesh, grid)

    cols = torch.arange(W, device=dev).reshape(1, -1)
    left_idx = torch.remainder(cols + shifts[:, 0:1], W).expand(Tp.shape)
    right_idx = torch.remainder(cols + shifts[:, 1:2], W).expand(Tp.shape)
    D = diff_scale(grid, diffusivity)
    for s in range(K):
        S = torch.roll(Tp, -1, dims=0) + torch.roll(Tp, 1, dims=0)
        left = torch.gather(S, 1, left_idx)
        right = torch.gather(S, 1, right_idx)
        lap = 2.0 * (left + right) - 8.0 * Tp
        Tk = Tp + KELVIN
        T2 = Tk * Tk
        olr = OLR_COEF * (T2 * T2)
        Tp = Tp + (asr[:, s:s + 1] - olr + D * lap) * cinvp
    return rows_to_blocks(Tp[K:-K].contiguous(), mesh), i0 + float(K)

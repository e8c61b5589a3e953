"""Seasonal surface-temperature (climate / energy-balance) model.

Counterpart of ``demiurge_tpu/ops/temperature.py``, reproducing the
reference Temperature filter (src/filter/Temperature.cpp):

- initialization: T = 50 C everywhere;
- per substep: ASR = (1 - albedo) * QDay(phi, M) with albedo 0.30,
  OLR = 210 * (T + 273.15)^4 / 273.4^4 * 0.93, transport
  0.55e6 * (laplacian.x + laplacian.y), heat capacity C = 1.5e7 on land and
  7e7 in the ocean, and T += (ASR - OLR + transport) * 3.154e7/15000 / C;
- M advances 2*pi/15000 per substep (one year = 15000 substeps).

QDay keeps the reference's equation-of-center series as written (its
``2e`` term is a constant by C operator precedence).

``temperature_step`` runs the substeps through ``kernels.climate`` (the
CUDA kernel for CUDA tensors, its plain twin for CPU tensors), which sums
the Laplacian's corner taps directly (the straight taps cancel in
lx + ly).  ``_substep`` is the reference's form, term by term; the tests
hold the two to each other.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.grid import Grid
from ..core.stencils import texture_laplacian
from ..core.trace import span
from ..kernels import climate as kc

PI = math.pi

S0 = 1365.0
ECC = 0.017
GAMMA = 23.44 / 180.0 * PI
OMEGA = 0.0
OMEGA2 = 77.05 / 180.0 * PI
YEAR_SECONDS = 3.154e7
SUBSTEPS_PER_YEAR = 15000


def _S(A):
    return S0 * (1 + 2 * ECC * torch.cos(A - OMEGA))


def _A(M):
    # Temperature.cpp:73-75 — parenthesization reproduced as written
    return M + (2 * ECC - ECC ** 3 / 4 * torch.sin(M)
                + 5.0 / 4 * ECC ** 2 * torch.sin(2 * M)
                + 13.0 / 12 * ECC ** 3 * torch.sin(3 * M))


def _Ls(A):
    return A - OMEGA2


def _delta(Ls):
    return torch.asin(math.sin(GAMMA) * torch.sin(Ls))


def _h0(phi, delta):
    """Sunset hour angle (Temperature.cpp:85-89)."""
    polar = torch.where(torch.sign(phi) == torch.sign(delta), PI, 0.0)
    interior = torch.abs(phi) <= PI / 2 - torch.abs(delta)
    arg = torch.clamp(-torch.tan(phi) * torch.tan(delta), -1.0, 1.0)
    return torch.where(interior, torch.acos(arg), polar)


def qday(phi, M):
    """Daily-mean insolation (Temperature.cpp:91-95); phi and M broadcast."""
    A = _A(M)
    delt = _delta(_Ls(A))
    h = _h0(phi, delt)
    return _S(A) / PI * (h * torch.sin(phi) * torch.sin(delt)
                         + torch.cos(phi) * torch.cos(delt) * torch.sin(h))


def init_temperature(grid: Grid, device) -> torch.Tensor:
    """T = 50 C (Temperature.cpp:27-45)."""
    return torch.full(grid.shape, 50.0, dtype=torch.float32, device=device)


def heat_capacity(terrain: torch.Tensor) -> torch.Tensor:
    """C = 1e7 + (land ? 0.5e7 : 6e7) (Temperature.cpp:131-133)."""
    atmosphere = 1e7
    return atmosphere + torch.where(terrain > 0, atmosphere * 0.5,
                                    4 * 1.5 * atmosphere)


def _substep(T, terrain, M, grid: Grid, albedo: float, diffusivity: float):
    """One substep in the reference's form: both Laplacian components,
    then the update with dt/C applied last."""
    phi = grid.row_phi(T.device).expand(grid.shape)
    ASR = (1 - albedo) * qday(phi, M)
    OLR = 210.0 * (T + 273.15) ** 4 / 273.4 ** 4 * 0.93
    lx, ly = texture_laplacian(T, grid)
    change = ASR - OLR + diffusivity * (lx + ly)
    return T + change * YEAR_SECONDS / SUBSTEPS_PER_YEAR / heat_capacity(
        terrain)


def _as_index(i0, device) -> torch.Tensor:
    """The substep index as a 0-d float32 tensor on ``device``; a Python
    number becomes a fill there (no host-to-device copy)."""
    if isinstance(i0, torch.Tensor):
        return i0.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(np.float32(i0)), dtype=torch.float32,
                      device=device)


def insolation_table(grid: Grid, i0: torch.Tensor, substeps: int,
                     albedo: float, first: int = 0) -> torch.Tensor:
    """(substeps, H) absorbed shortwave (1 - albedo) * QDay(phi_r, M_s) of
    substeps i0 + first, i0 + first + 1, ... — built on i0's device from
    the 0-d index, so a step waits on nothing."""
    k = torch.arange(first, first + substeps, dtype=torch.float32,
                     device=i0.device)
    M = (2.0 * PI / SUBSTEPS_PER_YEAR) * (i0 + k)
    phi = grid.row_phi(i0.device).reshape(1, -1)
    return ((1.0 - albedo) * qday(phi, M.reshape(-1, 1))).contiguous()


def temperature_step(T, terrain, i0, grid: Grid, substeps: int = 10,
                     albedo: float = 0.30, diffusivity: float = 0.55e6,
                     mesh=None):
    """Advance the climate model by ``substeps`` substeps from substep index
    ``i0`` (mean anomaly M = 2 pi i / 15000 — Temperature.cpp:146).
    Returns (T_new, i0 + substeps), the index a 0-d float32 tensor.

    ``mesh``: a ``dist.mesh.Mesh``; T and terrain are then this rank's
    blocks, and the substeps run on this rank's row group, up to its rows
    of substeps per row-halo exchange (``dist.climate``); a grid that is
    not x-periodic (which the single-device step refuses too) on the
    gathered fields (``sharded_call``).  The span ``climate``
    (``core.trace``) holds the call."""
    with span("climate"):
        if mesh is not None:
            from ..dist.climate import (climate_sharded_supported,
                                        climate_step_sharded)
            from ..dist.mesh import sharded_call

            if climate_sharded_supported(grid, mesh):
                return climate_step_sharded(T, terrain, i0, grid, mesh,
                                            substeps=substeps, albedo=albedo,
                                            diffusivity=diffusivity)
            return sharded_call(temperature_step, mesh)(
                T, terrain, i0, grid, substeps, albedo, diffusivity)
        i0 = _as_index(i0, T.device)
        if substeps == 0:
            return T, i0
        asr = insolation_table(grid, i0, substeps, albedo)
        cinv = (YEAR_SECONDS / SUBSTEPS_PER_YEAR / heat_capacity(terrain)
                ).contiguous()
        T = kc.climate_step(T.contiguous(), cinv, asr, grid, diffusivity)
        return T, i0 + float(substeps)


def run_years(T, terrain, grid: Grid, years: float = 1.0, i0=0.0,
              substeps_per_dispatch: int = 250, progress=None):
    """Simulate ``years`` annual cycles in dispatches of
    ``substeps_per_dispatch`` substeps (the reference's outer loop,
    Temperature.cpp:48, never terminates; this one does).  ``progress``:
    optional callable ``(done - 1, total) -> bool``; False stops at the
    next dispatch boundary."""
    n = int(years * SUBSTEPS_PER_YEAR)
    i = i0
    done = 0
    while done < n:
        k = min(substeps_per_dispatch, n - done)
        T, i = temperature_step(T, terrain, i, grid, substeps=k)
        done += k
        if progress is not None and not progress(done - 1, n):
            break
    return T, i

"""Substeps of the climate model's energy balance.

Counterpart of ``demiurge_tpu/pallas_kernels/climate.py``.  One substep s:

    T' = T + (asr[s, r] - olr(T) + D * lap(T)) * cinv
    lap(T) = 2 * (left + right) - 8 * T
    left   = S[r, c + kneg_r],  right = S[r, c + kpos_r],
    S      = T[north] + T[south]
    olr(T) = OLR_COEF * (Tk * Tk) * (Tk * Tk),  Tk = T + 273.15

This is lx + ly of the reference's spherical 9-point Laplacian times 4dy^2
(``core.stencils.texture_laplacian``): in the sum the straight taps
cancel and only the four corner taps, at the per-row NEAREST column
shifts kneg/kpos, remain; D = diffusivity / (4 dy^2) and cinv = dt / C
fold the normalizations.  The north/south rows follow
``core.topology.shift``: beyond a pole the same-latitude row on the other
side, half a world round.

``climate_step`` launches the CUDA kernel (``csrc/climate.cu``) for CUDA
tensors and runs the plain twin ``climate_step_plain`` for CPU tensors.
Both evaluate the sums above in the same order, so on one card they agree
bit for bit.  A launch runs up to ``STEPS_PER_LAUNCH`` substeps on
full-width row bands in shared memory (``kernels/bands.py``); ``launches``
plans a call's.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.grid import Grid
from ..core.platform import check_kernel_inputs, host_to_device, \
    use_cuda_kernels
from ..core.stencils import corner_shifts
from ..core.topology import _pole_col_shift, shift
from . import bands

LAUNCHES = 0

STEPS_PER_LAUNCH = 8   # substeps a launch at most: a band's halo
# a band's row (climate.cu): T in two buffers with margins, cinv, 8 ints;
# 128 floats of slack
LAYOUT = bands.Layout(planes=2, bare=1, ints=8, slack=128)

OLR_COEF = float(np.float32(210.0 * 0.93 / 273.4 ** 4))
KELVIN = 273.15

_TABLES: dict = {}


def _check_grid(grid: Grid) -> None:
    if not grid.wrap_x:
        raise NotImplementedError(
            "the climate step on a grid that is not x-periodic is not "
            "ported yet")


def diff_scale(grid: Grid, diffusivity: float) -> float:
    """diffusivity / (4 dy^2), in float32 as the reference computes it."""
    dy = np.float32(grid.row_spacing())
    return float(np.float32(diffusivity) / (np.float32(4.0) * dy * dy))


def shift_table(grid: Grid, device) -> torch.Tensor:
    """(2, H) int32 corner-tap column shifts (kneg, kpos) mod W, built once
    per grid and device."""
    key = (grid, str(device))
    if key not in _TABLES:
        kneg, kpos = corner_shifts(grid)
        table = np.stack([kneg, kpos]) % grid.width
        _TABLES[key] = host_to_device(table.astype(np.int32), device)
    return _TABLES[key]


def launches(grid: Grid, substeps: int, **plan_kw):
    """The launches of a call of ``substeps`` substeps: (first substep,
    substeps, ``bands.Bands``) each, as few as the halo allows, of nearly
    equal depth.  ``plan_kw`` goes to ``bands.plan``."""
    W, H = grid.width, grid.height
    cap = min(STEPS_PER_LAUNCH,
              bands.halo_max(W, LAYOUT, **plan_kw))
    n = -(-substeps // max(cap, 1))
    out, s0 = [], 0
    for i in range(n):
        steps = substeps // n + (1 if i < substeps % n else 0)
        out.append((s0, steps, bands.plan(W, H, steps, LAYOUT, **plan_kw)))
        s0 += steps
    return out


@functools.lru_cache(maxsize=None)
def card_launches(grid: Grid, substeps: int):
    """``launches`` with the clusters the card runs at once (builds the
    kernels), once per grid and depth."""
    return tuple(launches(grid, substeps, occupancy=functools.partial(
        bands.card_clusters, "demiurge_climate_band_clusters")))


def climate_step_plain(T, cinv, asr, grid: Grid, diffusivity: float):
    """``asr.shape[0]`` substeps in plain PyTorch, in the kernel's order."""
    _check_grid(grid)
    from ..core.fastroll import _gather_rows

    kneg, kpos = shift_table(grid, T.device).to(torch.int64).unsqueeze(-1)
    D = diff_scale(grid, diffusivity)
    for s in range(asr.shape[0]):
        S = shift(T, 0, 1, grid) + shift(T, 0, -1, grid)
        left = _gather_rows(S, kneg)
        right = _gather_rows(S, kpos)
        lap = 2.0 * (left + right) - 8.0 * T
        Tk = T + KELVIN
        T2 = Tk * Tk
        olr = OLR_COEF * (T2 * T2)
        T = T + (asr[s].reshape(-1, 1) - olr + D * lap) * cinv
    return T


def climate_step_cuda(T, cinv, asr, grid: Grid, diffusivity: float):
    """The substeps on the card: ``launches(grid, K)`` band launches on the
    current stream, out of place, no synchronisation."""
    global LAUNCHES
    _check_grid(grid)
    check_kernel_inputs(("T", "cinv"), (T, cinv), shape=grid.shape)
    K = asr.shape[0]
    check_kernel_inputs(("asr",), (asr,), shape=(K, grid.height))
    if K == 0:
        return T.clone()
    from . import build

    shifts = shift_table(grid, T.device)
    plan = card_launches(grid, K)
    H, W = grid.shape
    stream = torch.cuda.current_stream(T.device).cuda_stream
    src = T
    for s0, steps, b in plan:
        dst = torch.empty_like(T)
        err = build.library().demiurge_climate_band(
            src.data_ptr(), cinv.data_ptr(), asr[s0].data_ptr(),
            shifts.data_ptr(), dst.data_ptr(), H, W, int(grid.wrap_south),
            int(grid.wrap_north), _pole_col_shift(grid), steps, b.cluster,
            b.seg, b.th, diff_scale(grid, diffusivity), OLR_COEF, stream)
        build.check(err, "demiurge_climate_band")
        LAUNCHES += 1
        src = dst
    return src


def climate_step(T, cinv, asr, grid: Grid, diffusivity: float):
    """The CUDA kernel for CUDA tensors, the plain twin for CPU tensors."""
    if use_cuda_kernels(T, cinv, asr):
        return climate_step_cuda(T, cinv, asr, grid, diffusivity)
    return climate_step_plain(T, cinv, asr, grid, diffusivity)

"""Landscape evolution: tectonic uplift + stream-power fluvial erosion.

Counterpart of the coupled model's part of ``demiurge_tpu/ops/erosion.py``,
after the reference 'cpufilter' (src/filter/cpufilter.cpp):

- uplift U = max(h0, 0)/50 from the initial heights, and the initial
  h = h/50 on land, unchanged in the ocean (cpufilter.cpp:47-84);
- one erosion pass (cpufilter.cpp:110-199): the steepest slope to the 8
  neighbours over their metric distances, the 30-degree critical-slope
  cap, and stream-power incision factor*4*A*S^m/0.1^m*0.1 against the
  uplift, on land only.

The loop (``landscape_evolution``, BASELINE config 1): per iteration the
full flow filter with lakes (``ops.flow.flow_filter``: K5 and K6 on the
card, the lake solve on the host), then the erosion pass.  The pass is
plain PyTorch: the reference package has no kernel here.
``coupled_tectonic_erosion`` (BASELINE config 2) is the same loop with the
uplift refreshed from the plate tectonics (``ops.tectonics``) every few
iterations.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core.grid import Grid
from ..core.topology import NEIGHBORS_FLOW_ORDER, shift
from .flow import FlowConfig, flow_filter

PI = math.pi


@dataclasses.dataclass(frozen=True)
class ErosionConfig:
    exponent: float = 0.5        # cpufilter.h:20 (flow accumulation exponent)
    slope_exponent: float = 1.0  # cpufilter.h:22
    factor: float = 1.0          # cpufilter.h:21
    lakes: bool = False          # 'dolakes' toggle
    n: int = 50                  # uplift divisor N (cpufilter.cpp:42)
    iterations: int = 150        # N*3 (cpufilter.cpp:93)


def init_uplift(height: torch.Tensor, cfg: ErosionConfig = ErosionConfig()):
    """(U, h_init) — cpufilter.cpp:47-84."""
    U = torch.clamp(height, min=0.0) / cfg.n
    h = torch.where(height <= 0, height, height / cfg.n)
    return U, h


def erosion_pass(h, flow_map, uplift, grid: Grid, factor: float,
                 slope_exponent: float) -> torch.Tensor:
    """One erosion update (cpufilter.cpp:110-199)."""
    dxr, dyr = grid.pixelsize_rows(h.device)

    maxslope = torch.zeros_like(h)
    dist = torch.sqrt(dxr * dxr + dyr * dyr) * torch.ones_like(h)
    for dx, dy in NEIGHBORS_FLOW_ORDER:
        hn = shift(h, dx, dy, grid)
        ndist = torch.sqrt((dxr * dx) ** 2 + (dyr * dy) ** 2) \
            * torch.ones_like(h)
        s = (h - hn) / ndist
        better = s > maxslope
        maxslope = torch.where(better, s, maxslope)
        dist = torch.where(better, ndist, dist)

    SLOPE = math.tan(PI / 2 / 3)  # 30 degrees (cpufilter.cpp:191)
    hdiff = SLOPE * dist - maxslope * dist
    eros = factor * 4.0 * flow_map * torch.pow(maxslope, slope_exponent) \
        / (0.1 ** slope_exponent) * 0.1
    hnew = h + torch.minimum(hdiff, torch.clamp(uplift - eros, min=0.0))
    return torch.where(h <= 0, h, hnew)


def coupled_tectonic_erosion(height, sel, grid: Grid,
                             cfg: ErosionConfig = None, tcfg=None,
                             iterations: int = None, tectonic_every: int = 5,
                             callback=None, progress=None):
    """Config 2's coupling: tectonic uplift forcing live during the
    landscape evolution.  Every ``tectonic_every`` iterations (from the
    first) the plate stack advances one step and its collision uplift
    plus the stream-power base uplift U = max(h, 0)/50 becomes the
    forcing (cpufilter.cpp:42-64); the reference's intent of "coupled
    tectonic uplift + erosion", not its sequential 70-steps-then-erode
    chain.  ``callback`` and ``progress`` as in ``landscape_evolution``.
    Returns the evolved heightfield."""
    from . import tectonics

    if cfg is None:
        cfg = ErosionConfig()
    if tcfg is None:
        tcfg = tectonics.TectonicsConfig()
    if iterations is None:
        iterations = cfg.iterations

    stack = tectonics.init_plate_stack(height, grid)
    uplift0, h = init_uplift(height, cfg)
    uplift = uplift0
    fcfg = FlowConfig(preblur=0.5, exponent=cfg.exponent, lakes=cfg.lakes)
    for i in range(iterations):
        if i % tectonic_every == 0:
            stack, tup = tectonics.tectonic_uplift(stack, grid, tcfg)
            uplift = uplift0 + tup
        flow_map = flow_filter(h, sel, grid, fcfg)
        h = erosion_pass(h, flow_map, uplift, grid, cfg.factor,
                         cfg.slope_exponent)
        if callback is not None:
            callback(i, h)
        if progress is not None and not progress(i, iterations):
            break  # cancelled: return the last completed state
    return h


def landscape_evolution(height, sel, grid: Grid,
                        cfg: ErosionConfig = ErosionConfig(),
                        iterations: int = None, callback=None, progress=None):
    """The whole cpufilter loop (cpufilter.cpp:41-222): flow_filter, then
    erosion_pass, ``iterations`` times (default ``cfg.iterations``).  The
    flow filter has a host stage (the lake graph), so the loop is a Python
    loop.  ``callback(i, h)`` after each iteration; ``progress(i,
    iterations)`` returning false stops the loop (the last completed state
    is returned).  Returns the evolved heightfield."""
    if iterations is None:
        iterations = cfg.iterations
    uplift, h = init_uplift(height, cfg)
    fcfg = FlowConfig(preblur=0.5, exponent=cfg.exponent, lakes=cfg.lakes)
    for i in range(iterations):
        flow_map = flow_filter(h, sel, grid, fcfg)
        h = erosion_pass(h, flow_map, uplift, grid, cfg.factor,
                         cfg.slope_exponent)
        if callback is not None:
            callback(i, h)
        if progress is not None and not progress(i, iterations):
            break  # cancelled: return the last completed state
    return h

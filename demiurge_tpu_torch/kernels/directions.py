"""The D8 direction pass of the flow routing.

Counterpart of ``demiurge_tpu/pallas_kernels/directions.py``.  Per pixel,
on the "coordsMod" grid (x periodic, y clamped — FlowFilter.cpp:253-256):

  1. Sobel gradient (gx, gy) of the blurred height, the reference's signs;
  2. aspect = pi - atan2(gy, -gx), quantized to the octant below or above
     it: the upper one where the tie-break noise q < |aspect - lower|*4/pi;
  3. the aspect's neighbour is taken if it is lower than the pixel (and
     sinks to 5 if that neighbour is ocean or unselected);
  4. otherwise the steepest descent over the 8 neighbours in scan order;
  5. 0 where the pixel is ocean or unselected.

``flow_directions`` launches the CUDA kernel (``csrc/directions.cu``) for
CUDA tensors and runs the plain twin ``flow_directions_plain`` — the
reference's XLA pass, op by op — for CPU tensors.  ``directions_packed``
also returns the packed flow masks that K7/K8 read (``kernels.flow``
``pack_masks`` of the codes and their mouths), from one launch of the
kernel's packed form on the card; its twin is ``directions_packed_plain``.
The tie-break noise and the per-row metric are built once per grid, by the
same torch ops the twin uses, and handed to the kernel as tables.
``LAUNCHES`` counts kernel launches of both forms, ``LAUNCHES_PACKED``
those of the packed form, ``LAUNCHES_STRIP`` those of the codes form on a
row window (``core.grid.Window``: a rank's row group with its halo,
``dist.local``; the tables at the window's global rows, the window's
rows clamped at its edges as the coordsMod grid clamps at the poles).

Knife-edge ties: a pixel whose aspect lies within an ulp of an octant
boundary, or of the tie-break threshold, can resolve to the neighbouring
octant when atan2 or the Sobel sum round differently (another math
library, another compiler).  Both resolutions are valid D8 drainage; the
tests count them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.grid import Grid
from ..core.platform import check_kernel_inputs, use_cuda_kernels
from ..core.stencils import get_aspect
from ..core.topology import NEIGHBORS_FLOW_ORDER, _pole_col_shift, shift

PI = math.pi
LAUNCHES = 0
LAUNCHES_PACKED = 0
LAUNCHES_STRIP = 0

TILE = (16, 128)   # a block's tile, rows x columns: csrc/directions.cu's
                   # build, which refuses any other

_TABLES: dict = {}


def tables(grid: Grid, device):
    """(q (H, W) tie-break noise, dx8 (H,) = 8 * dx of the coordsMod
    grid), both float32 on ``device``, built once per grid (a window's
    at its global rows and columns)."""
    key = (grid, str(device))
    if key not in _TABLES:
        from ..ops.flow import _coords_mod_grid, tie_break_noise

        dx, _ = _coords_mod_grid(grid).pixelsize_rows(device)
        _TABLES[key] = (tie_break_noise(grid, device).contiguous(),
                        (8 * dx).reshape(-1).contiguous())
    return _TABLES[key]


def dy8(grid: Grid) -> float:
    """8 * dy of the coordsMod grid, in float32."""
    from ..ops.flow import _coords_mod_grid

    dy = np.float32(_coords_mod_grid(grid).row_spacing())
    return float(np.float32(8.0) * dy)


def flow_directions_plain(hb, sel, grid: Grid) -> torch.Tensor:
    """The direction pass in plain PyTorch, as the reference's XLA pass
    writes it."""
    from ..ops.flow import _coords_mod_grid

    gmod = _coords_mod_grid(grid)
    a = hb
    interesting = (a > 0.0) & (sel != 0.0)

    aspect = get_aspect(a, gmod)
    lower = torch.floor(aspect / (2 * PI) * 8) / 8 * (2 * PI)
    upper = torch.ceil(aspect / (2 * PI) * 8) / 8 * (2 * PI)
    prob = torch.abs(aspect - lower) / PI * 4
    q, _ = tables(grid, a.device)
    asp = torch.where(q < prob, upper, lower)

    dirx = torch.round(torch.cos(asp)).to(torch.int32)
    diry = -torch.round(torch.sin(asp)).to(torch.int32)
    code = 5 + dirx + 3 * diry  # the keypad code of (dirx, diry)

    # neighbour heights / selection (coordsMod wrap: the poles clamp)
    nh = {d: shift(a, d[0], d[1], gmod) for d in NEIGHBORS_FLOW_ORDER}
    ns = {d: shift(sel, d[0], d[1], gmod) for d in NEIGHBORS_FLOW_ORDER}

    a2 = torch.full_like(a, math.inf)
    s2 = torch.ones_like(a)
    for d in NEIGHBORS_FLOW_ORDER:
        m = (dirx == d[0]) & (diry == d[1])
        a2 = torch.where(m, nh[d], a2)
        s2 = torch.where(m, ns[d], s2)
    aspect_code = torch.where((a2 <= 0.0) | (s2 == 0.0), 5, code)
    take_aspect = a2 < a  # FlowFilter.cpp:176 'if (a2<a) return'

    # steepest-descent fallback scan (FlowFilter.cpp:178-242)
    best_code = torch.full_like(code, 5)
    best_a = a
    best_s = torch.ones_like(a)
    for d in NEIGHBORS_FLOW_ORDER:
        better = nh[d] < best_a
        best_code = torch.where(better, 5 + d[0] + 3 * d[1], best_code)
        best_s = torch.where(better, ns[d], best_s)
        best_a = torch.where(better, nh[d], best_a)
    scan_code = torch.where((best_a <= 0.0) | (best_s == 0.0), 5, best_code)

    code = torch.where(take_aspect, aspect_code, scan_code)
    return torch.where(interesting, code, 0).to(torch.int32)


def flow_directions_cuda(hb, sel, grid: Grid) -> torch.Tensor:
    """The direction pass on the card: one launch on the current stream,
    no synchronisation."""
    global LAUNCHES, LAUNCHES_STRIP
    check_kernel_inputs(("hb", "sel"), (hb, sel), shape=grid.shape)
    if not grid.wrap_x:
        raise NotImplementedError(
            "the direction pass needs an x-periodic grid")
    from . import build

    q, dx8 = tables(grid, hb.device)
    code = torch.empty(grid.shape, dtype=torch.int32, device=hb.device)
    H, W = grid.shape
    stream = torch.cuda.current_stream(hb.device).cuda_stream
    err = build.library().demiurge_flow_directions(
        hb.data_ptr(), sel.data_ptr(), q.data_ptr(), dx8.data_ptr(),
        code.data_ptr(), H, W, dy8(grid), *TILE, stream)
    build.check(err, "demiurge_flow_directions")
    LAUNCHES += 1
    LAUNCHES_STRIP += grid.base is not grid
    return code


def flow_directions(hb, sel, grid: Grid) -> torch.Tensor:
    """The CUDA kernel for CUDA tensors on an x-periodic grid, the plain
    twin otherwise."""
    if use_cuda_kernels(hb, sel, grid=grid):
        return flow_directions_cuda(hb, sel, grid)
    return flow_directions_plain(hb, sel, grid)


def pole_turns(grid: Grid):
    """(south, north) column turn of a neighbour beyond each pole, 0 where
    that edge clamps (``topology.shift``'s pole wrap), and whether the
    incoming masks wrap over the dateline (``ops.flow._incoming_fields``)."""
    H = grid.height
    turn = _pole_col_shift(grid)
    south = turn if grid.wrap_x and grid.wrap_south and H > 1 else 0
    north = turn if grid.wrap_x and grid.wrap_north and H > 1 else 0
    wrap = abs(grid.lam1 - grid.lam0) > 2 * PI - 1e-4
    return south, north, int(wrap)


def directions_packed_plain(hb, sel, grid: Grid):
    """(codes, packed masks) as the plain passes compute them: the
    direction pass, ``incoming_mask``'s mouths and ``pack_masks``."""
    from ..ops.flow import incoming_mask
    from .flow import pack_masks

    code = flow_directions_plain(hb, sel, grid)
    _, mouth, _ = incoming_mask(code, grid)
    return code, pack_masks(code, mouth, grid)


def directions_packed_cuda(hb, sel, grid: Grid):
    """The codes and the packed masks on the card: one launch on the
    current stream, no synchronisation."""
    global LAUNCHES, LAUNCHES_PACKED
    check_kernel_inputs(("hb", "sel"), (hb, sel), shape=grid.shape)
    if not grid.wrap_x:
        raise NotImplementedError(
            "the direction pass needs an x-periodic grid")
    from . import build

    q, dx8 = tables(grid, hb.device)
    code = torch.empty(grid.shape, dtype=torch.int32, device=hb.device)
    packed = torch.empty_like(code)
    H, W = grid.shape
    stream = torch.cuda.current_stream(hb.device).cuda_stream
    err = build.library().demiurge_flow_directions_packed(
        hb.data_ptr(), sel.data_ptr(), q.data_ptr(), dx8.data_ptr(),
        code.data_ptr(), packed.data_ptr(), H, W, dy8(grid),
        *pole_turns(grid), *TILE, stream)
    build.check(err, "demiurge_flow_directions_packed")
    LAUNCHES += 1
    LAUNCHES_PACKED += 1
    return code, packed


def directions_packed(hb, sel, grid: Grid):
    """The packed kernel for CUDA tensors on an x-periodic grid, the
    plain passes otherwise."""
    if use_cuda_kernels(hb, sel, grid=grid):
        return directions_packed_cuda(hb, sel, grid)
    return directions_packed_plain(hb, sel, grid)

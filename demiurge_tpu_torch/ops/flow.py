"""Flow routing and upstream flow accumulation: the device path.

Counterpart of the device part of ``demiurge_tpu/ops/flow.py``, after the
reference FlowFilter (src/filter/FlowFilter.cpp):

  1. pre-blur the heights (radius 0.5, ``ops.blur``);
  2. the "magic numbers" pass: a D8 direction per pixel, the aspect
     quantized to an octant with a value-noise tie break, falling back to
     steepest descent (``flow_directions``, kernel in
     ``kernels.directions``);
  3. the incoming-neighbour bitmask and the river mouths
     (``incoming_mask``); on one card 2 and 3 are one launch of the
     direction kernel's packed form (``kernels.directions``
     ``directions_packed``), which writes the packed masks of step 4;
  4. the upstream area accumulation and the mouth reachability, as the
     fixpoint of an 8-neighbour relaxation (``flow_solve_stencil``; the
     kernels in ``kernels.flow``).

``flow_filter_device`` is the path of the coupled step: endorheic basins
do not drain (their cells keep -1).  Lakes, pointer doubling and the full
``flow_filter`` are not ported yet.

Faithful quirks kept: the direction pass runs on the reference's
"coordsMod" grid (corner coords shrunk by 1e-3, so the poles clamp); the
accumulation drops pole-crossing and out-of-range neighbours as the CPU
traversal does; the cell area uses the latitude of the row's lower edge.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.grid import Grid
from ..core.topology import CODE_DIR, DIR_CODE, NEIGHBORS_FLOW_ORDER, shift
from ..kernels import directions as kd
from ..kernels import flow as kf
from .blur import blur

PI = math.pi

#: scan order of the steepest-descent fallback (FlowFilter.cpp:181-236)
_SCAN_ORDER = NEIGHBORS_FLOW_ORDER


# ---------------------------------------------------------------------------
# value-noise tie break hash (FlowFilter.cpp:114-131)
# ---------------------------------------------------------------------------


def _fract(x):
    return x - torch.floor(x)


def _fma(x, a: float, b: float):
    """float32 x*a + b rounded once, as a fused multiply-add.  The
    reference's compiled hash contracts its first multiply-add into one
    (XLA on the CPU does; rounding it twice changes q at ~40% of the
    pixels).  For the lattice's integer x (< 2^24) the float64 product and
    sum are exact, so one rounding to float32 is the fma."""
    a, b = float(np.float32(a)), float(np.float32(b))
    return (x.to(torch.float64) * a + b).to(torch.float32)


def _hash2(px, py):
    px = 50.0 * _fract(_fma(px, 0.3183099, 0.71))
    py = 50.0 * _fract(_fma(py, 0.3183099, 0.113))
    return -1.0 + 2.0 * _fract(px * py * (px + py))


def tie_break_noise(grid: Grid, device) -> torch.Tensor:
    """q = noise(st*resolution*2)*0.5+0.5 (FlowFilter.cpp:151).  The
    lattice points st*resolution*2 are the integers (2c+1, 2r+1), so the
    value noise reduces to the raw hash there."""
    c = torch.arange(grid.width, dtype=torch.float32, device=device)
    r = torch.arange(grid.height, dtype=torch.float32, device=device)
    px = (2 * c + 1).reshape(1, -1).expand(grid.shape)
    py = (2 * r + 1).reshape(-1, 1).expand(grid.shape)
    return _hash2(px, py) * 0.5 + 0.5


# ---------------------------------------------------------------------------
# direction + incoming mask passes
# ---------------------------------------------------------------------------


def _coords_mod_grid(grid: Grid) -> Grid:
    """The reference's pole-wrap-disabling coords hack
    (FlowFilter.cpp:253-256)."""
    y0, y1, x0, x1 = grid.coords
    return dataclasses.replace(grid, coords=(y0 + 1e-3, y1 - 1e-3, x0, x1))


def flow_directions(height_blurred, sel, grid: Grid) -> torch.Tensor:
    """The direction pass (FlowFilter.cpp:109-259): int32 codes, 0 = not
    interesting (ocean or unselected), 1-9 keypad direction, 5 = sink."""
    return kd.flow_directions(height_blurred.contiguous(), sel.contiguous(),
                              grid)


def incoming_mask(code, grid: Grid):
    """Incoming-neighbour bitmask and flags (FlowFilter.cpp:268-310).

    Returns (mask int32 with bits 1..9, bit 5 = sink; mouth bool;
    interesting bool), sampled with the normal coords (pole wrap on), like
    the reference's second pass."""
    interesting = code > 0
    spec = [  # (offset to the neighbour, the code it must have, bit)
        ((1, 1), 1, 256), ((0, 1), 2, 128), ((-1, 1), 3, 64),
        ((1, 0), 4, 32), ((-1, 0), 6, 8), ((1, -1), 7, 4), ((0, -1), 8, 2),
        ((-1, -1), 9, 1)]
    mask = torch.zeros(grid.shape, dtype=torch.int32, device=code.device)
    mouth = torch.zeros(grid.shape, dtype=torch.bool, device=code.device)
    for (dx, dy), want, bit in spec:
        ncode = shift(code, dx, dy, grid)
        mask = mask + torch.where(ncode == want, bit, 0).to(torch.int32)
        mouth = mouth | (ncode == 0)
    mask = mask + torch.where(code == 5, 16, 0).to(torch.int32)
    return mask, mouth & interesting, interesting


_AREAS: dict = {}  # (grid, device, scale) -> cell_area_lower_edge


def cell_area_lower_edge(grid: Grid, device, scale: float = 1e-5
                         ) -> torch.Tensor:
    """Per-cell area with phi at the row's *lower edge* (FlowFilter.cpp:
    607-613); cos is clamped at 0, so the pole rows get ~0 and not the NaN
    a negative cos would give the reference's powf.  Built once per grid
    and device (``_cell_area_build``); callers must not write to it."""
    key = (grid, str(device), scale)
    if key not in _AREAS:
        _AREAS[key] = _cell_area_build(grid, device, scale)
    return _AREAS[key]


def _cell_area_build(grid: Grid, device, scale: float) -> torch.Tensor:
    H, W = grid.shape
    y = torch.arange(H, dtype=torch.float32, device=device).reshape(-1, 1) / H
    geoy = y * (grid.phi1 - grid.phi0) + grid.phi0
    pwx = grid.circumference * (grid.lam1 - grid.lam0) / (2 * PI) / W
    pwy = grid.circumference * (grid.phi1 - grid.phi0) / (2 * PI) / H
    area = pwy * pwx * torch.clamp(torch.cos(geoy), min=0.0) * scale
    return area.expand(grid.shape).contiguous()


def _row_in_range(H: int, dy: int, device) -> torch.Tensor:
    """(H, 1) mask of the rows whose row r + dy exists (no pole wrap)."""
    rows = torch.arange(H, device=device).reshape(-1, 1)
    if dy > 0:
        return rows < H - dy
    if dy < 0:
        return rows >= -dy
    return torch.ones((H, 1), dtype=torch.bool, device=device)


def _incoming_fields(code, grid: Grid):
    """For each of the 8 offsets d from a cell to an upstream neighbour, a
    bool field "the neighbour at d flows into me", with the CPU traversal's
    range rules (x wraps iff full globe, y edges drop —
    FlowFilter.cpp:39-75)."""
    H, W = grid.shape
    wrap = abs(grid.lam1 - grid.lam0) > 2 * PI - 1e-4
    cols = torch.arange(W, device=code.device).reshape(1, -1)
    fields = []
    for dx, dy in _SCAN_ORDER:
        ncode = shift(code, dx, dy, grid, pole_wrap=False)
        ok = (ncode == DIR_CODE[(-dx, -dy)]) & _row_in_range(H, dy,
                                                             code.device)
        if not wrap and dx > 0:
            ok = ok & (cols < W - dx)
        elif not wrap and dx < 0:
            ok = ok & (cols >= -dx)
        fields.append(((dx, dy), ok))
    return fields


def _outgoing_masks(code, grid: Grid):
    """For each code 1..9 but 5, (offset, "my code points there and the
    target row exists")."""
    H = grid.height
    return [(CODE_DIR[c], (code == c) & _row_in_range(H, CODE_DIR[c][1],
                                                       code.device))
            for c in range(1, 10) if c != 5]


def flow_solve_stencil(code, area2d, mouth, grid: Grid, conn_from=None,
                       conn_to=None, check_every: int = 64,
                       max_iters: int = 1 << 30, want_root: bool = False):
    """Upstream accumulation A and mouth reachability vis, by relaxing

        A   <- area + sum_d incoming_d * shift(A, d)
        vis <- mouth | OR_d (outgoing_d & shift(vis, d))

    to their fixpoint (checked every ``check_every`` sweeps).  Returns
    (A, vis).  The lake connections and the basin roots of the reference's
    full filter are not ported yet and raise."""
    if conn_from is not None or conn_to is not None or want_root:
        raise NotImplementedError(
            "lake connections and basin roots are not ported yet")
    inc = _incoming_fields(code, grid)
    outs = _outgoing_masks(code, grid)

    def sweep(A, vis):
        newA = area2d
        for (dx, dy), ok in inc:
            newA = newA + torch.where(
                ok, shift(A, dx, dy, grid, pole_wrap=False), 0.0)
        newvis = mouth
        for (dx, dy), m in outs:
            newvis = newvis | (m & shift(vis, dx, dy, grid, pole_wrap=False))
        return newA, newvis

    A, vis, it = area2d, mouth, 0
    while it < max_iters:
        prev, prev_v = A, vis
        for _ in range(check_every):
            A, vis = sweep(A, vis)
        it += check_every
        if torch.equal(A, prev) and torch.equal(vis, prev_v):
            break
    return A, vis


def _codes_and_mouths(height, sel, grid: Grid, preblur: float):
    hb = blur(height, grid, preblur)
    code = flow_directions(hb, sel, grid)
    _, mouth, _ = incoming_mask(code, grid)
    return code, mouth


def flow_filter_device(height, sel, grid: Grid, exponent: float = 0.5,
                       preblur: float = 0.5, acc0=None,
                       return_acc: bool = False, mesh=None):
    """Flow accumulation without the host lake-merge stage: cells that
    reach a river mouth get (upstream area)^exponent, the rest -1
    (endorheic basins do not drain).

    ``acc0``: warm start of the area relaxation (the previous step's
    fixpoint; the fixpoint is unique, so only the convergence changes).
    ``return_acc=True`` also returns the raw accumulation, to carry it.

    ``mesh``: the fields are this rank's blocks.  The pre-blur, directions
    and masks run on the gathered fields (``sharded_call``); the fixpoint
    is the two-level sharded solve (``dist.flowdist``) or, where that does
    not apply, the halo-exchange relaxation (``dist.halo``); ``acc0`` is
    not used there, as in the reference."""
    if mesh is not None:
        return _flow_filter_sharded(height, sel, grid, exponent, preblur,
                                    acc0, return_acc, mesh)
    hb = blur(height, grid, preblur)
    _, packed = kd.directions_packed(hb.contiguous(), sel.contiguous(), grid)
    area = cell_area_lower_edge(grid, height.device)
    acc = kf.flow_solve_area(packed, area, grid, a0=acc0)
    vis = kf.vis_solve(packed, grid)
    out = torch.where(vis, torch.pow(acc, exponent), -1.0)
    return (out, acc) if return_acc else out


def _flow_filter_sharded(height, sel, grid: Grid, exponent, preblur, acc0,
                         return_acc, mesh):
    from ..dist.flowdist import (flow_sharded_twolevel_supported,
                                 flow_solve_sharded_twolevel)
    from ..dist.halo import flow_solve_sharded
    from ..dist.mesh import local_part, sharded_call

    if not grid.wrap_x:
        return sharded_call(flow_filter_device, mesh)(
            height, sel, grid, exponent, preblur, acc0, return_acc)
    code, mouth = sharded_call(_codes_and_mouths, mesh)(height, sel, grid,
                                                        preblur)
    area = local_part(cell_area_lower_edge(grid, height.device), grid.shape,
                      mesh)
    if flow_sharded_twolevel_supported(grid, mesh):
        acc, vis = flow_solve_sharded_twolevel(code, area, mouth, grid, mesh)
    else:
        acc, vis = flow_solve_sharded(code, area, mouth, grid, mesh)
    out = torch.where(vis, torch.pow(acc, exponent), -1.0)
    return (out, acc) if return_acc else out

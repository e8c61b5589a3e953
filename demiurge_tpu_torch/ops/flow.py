"""Flow routing, lake solving and upstream flow accumulation.

Counterpart of ``demiurge_tpu/ops/flow.py``, after the reference
FlowFilter (src/filter/FlowFilter.cpp):

  1. pre-blur the heights (radius 0.5, ``ops.blur``);
  2. the "magic numbers" pass: a D8 direction per pixel, the aspect
     quantized to an octant with a value-noise tie break, falling back to
     steepest descent (``flow_directions``, kernel in
     ``kernels.directions``);
  3. the incoming-neighbour bitmask and the river mouths
     (``incoming_mask``); on one card 2 and 3 are one launch of the
     direction kernel's packed form (``kernels.directions``
     ``directions_packed``), which writes the packed masks of step 4;
  4. the lakes, on the host (``flow_filter`` only): basin flood fill,
     lowest passes between basins, their merge into a drainage forest and
     the lake water heights (``solve_lakes_numpy``, and the C++ solver of
     ``native``, ``default_lake_solver``);
  5. the upstream area accumulation and the mouth reachability, as the
     fixpoint of an 8-neighbour relaxation (``flow_solve_stencil``, with
     the lake connections and the basin roots, on K12's tiles in
     ``kernels.lakeflow``; the kernels of the lake-free path in
     ``kernels.flow``).  Pointer doubling
     (``accumulate``, ``resolve_roots``) reaches the same sums on the
     parent pointers.

``flow_filter_device`` is the path of the coupled step: no lakes, so
endorheic basins do not drain (their cells keep -1).  ``flow_filter`` is
the full filter of the erosion loop: connections through the lakes, and
flooded cells zeroed.

Faithful quirks kept: the direction pass runs on the reference's
"coordsMod" grid (corner coords shrunk by 1e-3, so the poles clamp); the
accumulation drops pole-crossing and out-of-range neighbours as the CPU
traversal does; the cell area uses the latitude of the row's lower edge;
the lake merge's seed loop skips passes whose source lake's *pixel index*
has bit 10 set (``Nthbit(c.from,10)``, FlowFilter.cpp:544).
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from typing import NamedTuple

import numpy as np
import torch

from ..core.grid import Grid
from ..core.platform import host_to_device
from ..core.topology import CODE_DIR, DIR_CODE, NEIGHBORS_FLOW_ORDER, shift
from ..core.trace import span
from ..kernels import directions as kd
from ..kernels import flow as kf
from ..kernels import lakeflow as kl
from .blur import blur

PI = math.pi

#: scan order of the steepest-descent fallback (FlowFilter.cpp:181-236)
_SCAN_ORDER = NEIGHBORS_FLOW_ORDER

#: the last ``flow_solve_stencil``'s solve: the twin's sweeps, to its
#: certifying check, or the tiled solves' stats (its docstring)
LAST_SOLVE: dict = {}


@dataclasses.dataclass(frozen=True)
class FlowConfig:
    preblur: float = 0.5          # FlowfilterMenu default / cpufilter value
    exponent: float = 0.5         # FlowfilterMenu 'Exponent'
    lakes: bool = True            # lakeflag
    area_scale: float = 1e-5      # FlowFilter.cpp:613


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
    value noise reduces to the raw hash there (a window's at its global
    rows and columns)."""
    c = grid.col_index(device).to(torch.float32)
    r = grid.row_index(device).to(torch.float32)
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


# ---------------------------------------------------------------------------
# parent pointers + pointer-doubling accumulation
# ---------------------------------------------------------------------------


def _wraps_x(grid: Grid) -> bool:
    """Whether the CPU traversal wraps x (FlowFilter.cpp:39-75): the grid
    spans the full globe."""
    return abs(grid.lam1 - grid.lam0) > 2 * PI - 1e-4


def _parent_from_code(code_np: np.ndarray, grid: Grid) -> np.ndarray:
    """Flattened downstream-parent index per cell; -1 = no parent (sink,
    uninteresting, or target out of range, matching the CPU neighbours()
    clipping, FlowFilter.cpp:39-75: x wraps iff full globe, y clips)."""
    H, W = code_np.shape
    wrap = _wraps_x(grid)
    r, c = np.mgrid[0:H, 0:W]
    parent = np.full((H, W), -1, np.int64)
    for codeval, (dx, dy) in CODE_DIR.items():
        if codeval == 5:
            continue
        m = code_np == codeval
        nc = c + dx
        nr = r + dy
        if wrap:
            nc = (nc + W) % W
            okx = np.ones_like(m)
        else:
            okx = (nc >= 0) & (nc < W)
        oky = (nr >= 0) & (nr < H)
        ok = m & okx & oky
        parent[ok] = (nr[ok] * W + np.clip(nc[ok], 0, W - 1))
    return parent.reshape(-1)


def parent_pointers(code, grid: Grid) -> torch.Tensor:
    """Downstream parent index (-1 none) per flattened cell, int64."""
    H, W = grid.shape
    wrap = _wraps_x(grid)
    r = torch.arange(H, device=code.device).reshape(-1, 1)
    c = torch.arange(W, device=code.device).reshape(1, -1)
    parent = torch.full(grid.shape, -1, dtype=torch.int64, device=code.device)
    for codeval, (dx, dy) in CODE_DIR.items():
        if codeval == 5:
            continue
        nc = c + dx
        nr = r + dy
        if wrap:
            nc = (nc + W) % W
            ok = (nr >= 0) & (nr < H)
        else:
            ok = (nc >= 0) & (nc < W) & (nr >= 0) & (nr < H)
        tgt = nr * W + torch.clamp(nc, 0, W - 1)
        parent = torch.where((code == codeval) & ok, tgt, parent)
    return parent.reshape(-1)


def _doubling_rounds(n: int) -> int:
    return max(1, int(math.ceil(math.log2(max(n, 2)))))


def accumulate(parent, area_flat, nrounds: int) -> torch.Tensor:
    """Exact upstream accumulation by pointer doubling.

    parent: (N,) int64, -1 = root/no parent.  area_flat: (N,) float32.
    Returns acc (N,): acc[p] = area[p] + the area of every cell whose
    downstream path reaches p.  At round k, A[q] sums the cells within
    graph distance 2^k - 1 upstream of q, and ptr[q] is q's 2^k-th
    downstream ancestor where ``alive`` says it exists; each round
    scatters A over ptr (index N is the drop bucket), then squares the
    pointers.  ceil(log2(N)) rounds cover any path."""
    N = parent.shape[0]
    A = area_flat
    has = parent >= 0
    ptr = torch.where(has, parent, 0)
    alive = has
    for _ in range(nrounds):
        contrib = torch.where(alive, A, 0.0)
        tgt = torch.where(alive, ptr, N)
        A = A + torch.zeros(N + 1, dtype=A.dtype, device=A.device
                            ).index_add_(0, tgt, contrib)[:N]
        nxt_alive = alive & alive[ptr]
        ptr = torch.where(nxt_alive, ptr[ptr], ptr)
        alive = nxt_alive
    return A


def resolve_roots(parent, nrounds: int) -> torch.Tensor:
    """Root (terminal downstream) index of every cell by pointer
    doubling."""
    idx = torch.arange(parent.shape[0], dtype=parent.dtype,
                       device=parent.device)
    ptr = torch.where(parent >= 0, parent, idx)
    for _ in range(nrounds):
        ptr = ptr[ptr]
    return ptr


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
    """The (H, W) table; a window's rows of the grid's per-row areas."""
    H, W = grid.base.shape
    y = torch.arange(H, dtype=torch.float32, device=device).reshape(-1, 1) / H
    geoy = y * (grid.phi1 - grid.phi0) + grid.phi0
    pwx = grid.circumference * (grid.lam1 - grid.lam0) / (2 * PI) / W
    pwy = grid.circumference * (grid.phi1 - grid.phi0) / (2 * PI) / H
    area = pwy * pwx * torch.clamp(torch.cos(geoy), min=0.0) * scale
    return grid.cut(area).expand(grid.shape).contiguous()


def _row_in_range(grid: Grid, dy: int, device) -> torch.Tensor:
    """(H, 1) mask of the rows whose row r + dy exists in the whole grid
    (no pole wrap)."""
    rows = grid.row_numbers(device)
    H = grid.base.height
    if dy > 0:
        return rows < H - dy
    if dy < 0:
        return rows >= -dy
    return torch.ones((grid.height, 1), dtype=torch.bool, device=device)


def _incoming_fields(code, grid: Grid):
    """For each of the 8 offsets d from a cell to an upstream neighbour, a
    bool field "the neighbour at d flows into me", with the CPU traversal's
    range rules (x wraps iff full globe, y edges drop —
    FlowFilter.cpp:39-75)."""
    H, W = grid.shape
    wrap = _wraps_x(grid)
    cols = torch.arange(W, device=code.device).reshape(1, -1)
    fields = []
    for dx, dy in _SCAN_ORDER:
        ncode = shift(code, dx, dy, grid, pole_wrap=False)
        ok = (ncode == DIR_CODE[(-dx, -dy)]) & _row_in_range(grid, dy,
                                                             code.device)
        if not wrap and dx > 0:
            ok = ok & (cols < W - dx)
        elif not wrap and dx < 0:
            ok = ok & (cols >= -dx)
        fields.append(((dx, dy), ok))
    return fields


def flow_solve_stencil(code, area2d, mouth, grid: Grid, conn_from=None,
                       conn_to=None, check_every: int = 64,
                       max_iters: int = 1 << 30, want_root: bool = False):
    """Upstream accumulation A, mouth reachability vis and, with
    ``want_root``, the basin root: the fixpoint of

        A    <- area + sum_d incoming_d * shift(A, d)
        vis  <- mouth | OR_d (outgoing_d & shift(vis, d))
        root <- the cell itself where a sink, else its downstream root

    with the lake connections (lake sink ``conn_from`` -> attach pixel
    ``conn_to``, int64 flat indices from the host solver, each side
    unique) after the taps: ``A[conn_to] += A[conn_from]`` and
    ``vis[conn_from] |= vis[conn_to]``.  The masks and the connections are
    packed once (``kernels.lakeflow``) and solved by K12
    (``lakeflow.relax_solve``): on the card the tiled kernels, in rounds
    until one writes none of A, vis and root; on the CPU the plain twin,
    Jacobi sweeps checked every ``check_every`` on A and vis (root
    follows the same flow paths), at most ``max_iters``.  Returns (A,
    vis, root): root an int64 flat index, -1 where the cell reaches no
    sink, None without ``want_root``.  ``LAST_SOLVE`` holds, on the CPU,
    ``"sweeps"`` (the sweeps run, to the certifying check); on the card,
    under ``"A"``, ``"vis"`` and ``"root"``, each tiled solve's rounds,
    launches, host reads and tile visits, in ``kernels.flow.LAST_SOLVE``'s
    words."""
    if conn_from is None:
        conn_from = conn_to = torch.zeros(0, dtype=torch.int64,
                                          device=code.device)
    conn_src, conn_dst = kl.conn_fields(conn_from, conn_to, grid.shape)
    packed = kl.pack_lake_masks(code, mouth, grid, conn_src, conn_dst)
    A, vis, root, stats = kl.relax_solve(
        packed, area2d.contiguous(), conn_src, conn_dst, grid, want_root,
        check_every, max_iters)
    LAST_SOLVE.clear()
    LAST_SOLVE.update(stats)
    return A, vis, None if root is None else root.to(torch.int64)


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
    and masks run on this rank's row group (``dist.local.
    flow_masks_rows``); the fixpoint is the two-level sharded solve
    (``dist.flowdist``) or, where that does not apply, the halo-exchange
    relaxation (``dist.halo``); ``acc0`` is not used there, as in the
    reference.  A grid that is not x-periodic runs the whole filter on
    the gathered fields (``sharded_call``).

    Spans (``core.trace``): ``flow`` around the call and, on one card,
    ``flow.blur``, ``flow.directions``, ``flow.area``, ``flow.vis`` and
    ``flow.map`` around its stages."""
    with span("flow"):
        if mesh is not None:
            return _flow_filter_sharded(height, sel, grid, exponent,
                                        preblur, acc0, return_acc, mesh)
        with span("flow.blur"):
            hb = blur(height, grid, preblur)
        with span("flow.directions"):
            _, packed = kd.directions_packed(hb.contiguous(),
                                             sel.contiguous(), grid)
        with span("flow.area"):
            area = cell_area_lower_edge(grid, height.device)
            acc = kf.flow_solve_area(packed, area, grid, a0=acc0)
        with span("flow.vis"):
            vis = kf.vis_solve(packed, grid)
        with span("flow.map"):
            out = torch.where(vis, torch.pow(acc, exponent), -1.0)
    return (out, acc) if return_acc else out


def _flow_filter_sharded(height, sel, grid: Grid, exponent, preblur, acc0,
                         return_acc, mesh):
    from ..dist import local
    from ..dist.flowdist import (flow_sharded_twolevel_supported,
                                 flow_solve_rows_twolevel)
    from ..dist.halo import flow_solve_sharded_packed
    from ..dist.mesh import rows_to_blocks, sharded_call

    if not local.local_supported(grid, mesh):
        return sharded_call(flow_filter_device, mesh)(
            height, sel, grid, exponent, preblur, acc0, return_acc)
    dev = height.device
    _, _, packed_r = local.flow_masks_rows(height, sel, grid, mesh, preblur)
    if flow_sharded_twolevel_supported(grid, mesh):
        area_r = cell_area_lower_edge(local.rows_window(grid, mesh, 0), dev)
        acc, vis = flow_solve_rows_twolevel(packed_r, area_r, grid, mesh)
        acc = rows_to_blocks(acc, mesh, grid.height)
        vis = rows_to_blocks(vis, mesh, grid.height) > 0.5
    else:
        acc, vis = flow_solve_sharded_packed(
            rows_to_blocks(packed_r, mesh, grid.height),
            cell_area_lower_edge(local.block_window(grid, mesh, 0), dev),
            grid, mesh)
    out = torch.where(vis, torch.pow(acc, exponent), -1.0)
    return (out, acc) if return_acc else out


# ---------------------------------------------------------------------------
# host lake-graph solver (steps 4-6 of the reference), numpy
# ---------------------------------------------------------------------------


class LakeSolution(NamedTuple):
    conn_from: np.ndarray   # (C,) int64 lake sink index
    conn_to: np.ndarray     # (C,) int64 attach pixel index (pass location)
    conn_h: np.ndarray      # (C,) float32 pass height
    lake_wh: np.ndarray     # (N,) float32 water height keyed by sink index
    #                         (NaN where not a sink / not flooded)


_NEIGHBOR_BITS = [  # (bit value, offset) of incoming-mask bits 1..9 but 5
    (1, (-1, -1)),
    (2, (0, -1)),
    (4, (1, -1)),
    (8, (-1, 0)),
    (32, (1, 0)),
    (64, (-1, 1)),
    (128, (0, 1)),
    (256, (1, 1)),
]


def _upstream_neighbors(i, mask, W, H, wrap):
    """CPU neighbours() (FlowFilter.cpp:39-75): the cells flowing into i."""
    out = []
    m = int(mask[i])
    x = i % W
    y = i // W
    for bit, (dx, dy) in _NEIGHBOR_BITS:
        if not (m & bit):
            continue
        nx = x + dx
        if wrap:
            nx = (nx + W) % W
        elif nx < 0 or nx >= W:
            continue
        ny = y + dy
        if ny < 0 or ny >= H:
            continue
        out.append(ny * W + nx)
    return out


def solve_lakes_numpy(mask, mouth, height, parent, grid: Grid
                      ) -> LakeSolution:
    """Steps 4-6 of the reference pipeline on the host, in numpy: basin
    flood fill (assignLakeIds, FlowFilter.cpp:360-398), the lowest pass out
    of each basin to each neighbouring basin (findAllConnections,
    400-531), their merge into a drainage forest from the river mouths
    (solvingConnections, 533-595) and the lake water heights (lakefill,
    651-695).

    mask: (N,) int incoming bitmask; mouth: (N,) bool; height: (N,) the
    unblurred heights; parent: (N,) downstream pointers (unused, as in the
    reference's signature).  ``native.solve_lakes_native`` gives the same
    arrays."""
    H, W = grid.shape
    N = H * W
    wrap = _wraps_x(grid)

    mask = np.asarray(mask).reshape(-1)
    mouth = np.asarray(mouth).reshape(-1)
    height = np.asarray(height).reshape(-1)

    lake_sinks = np.nonzero((mask & 16) != 0)[0]  # mouths included

    # --- basin flood fill
    basin = np.full(N, -1, np.int64)
    for s in lake_sinks:
        stack = [s]
        while stack:
            p = stack.pop()
            basin[p] = s
            stack.extend(_upstream_neighbors(p, mask, W, H, wrap))

    # --- border pixels + lowest passes: a neighbour in another basin
    passes: dict = {}  # sink -> list of (h, from_sink, tolocation)
    offs = [(dx, dy) for _, (dx, dy) in _NEIGHBOR_BITS]
    for s in lake_sinks:
        newpasses: dict = {}
        stack = [s]
        while stack:
            p = stack.pop()
            x, y = p % W, p // W
            minpass = np.inf
            nlake_pix = -1
            for (dx, dy) in offs:
                nx = x + dx
                if wrap:
                    nx = (nx + W) % W
                elif nx < 0 or nx >= W:
                    continue
                ny = y + dy
                if ny < 0 or ny >= H:
                    continue
                n = ny * W + nx
                if basin[n] >= 0 and basin[n] != s:
                    bd = height[n]
                    if bd > 0 and bd < minpass:
                        minpass = bd
                        nlake_pix = n
            if nlake_pix >= 0:
                lid = basin[nlake_pix]
                if not mouth[lid]:  # skip passes into river-mouth basins
                    nheight = max(minpass, height[p])
                    if lid not in newpasses or nheight < newpasses[lid][0]:
                        newpasses[lid] = (nheight, lid, p)
            stack.extend(_upstream_neighbors(p, mask, W, H, wrap))
        passes[s] = sorted(newpasses.values())  # by h (set<pass, comp by h>)

    # --- global merge
    placed = set()
    candidates: list = []  # heap of (h, from, to)
    conns: dict = {}       # tolocation -> (h, from, to)

    def push_next(lake):
        lst = passes.get(lake)
        if lst is None:
            return
        while lst:
            c = lst.pop(0)
            if c[1] in placed:
                continue
            heapq.heappush(candidates, c)
            break

    for s in lake_sinks:
        if not mouth[s]:
            continue
        placed.add(s)
        lst = passes.get(s, [])
        while lst:
            c = lst.pop(0)
            if c[1] in placed:
                continue
            # the reference as written tests bit 10 of the *index* (cpp:544)
            if int(c[1]) & (1 << 9):
                continue
            heapq.heappush(candidates, c)
            break

    while candidates:
        h, frm, to = heapq.heappop(candidates)
        if frm in placed:
            push_next(basin[to])
        else:
            placed.add(frm)
            conns[to] = (h, frm, to)
            push_next(frm)
            push_next(basin[to])

    conn_to = np.array(sorted(conns.keys()), np.int64)
    conn_from = np.array([conns[t][1] for t in conn_to], np.int64)
    conn_h = np.array([conns[t][0] for t in conn_to], np.float32)

    # --- lake water heights: one scalar a basin, down the placed passes
    lake_wh = np.full(N, np.nan, np.float32)
    by_basin: dict = {}  # the passes by the basin their attach pixel is in
    for t in conns:
        by_basin.setdefault(int(basin[t]), []).append(conns[t])
    stack2 = [(int(s), 0.0) for s in lake_sinks if mouth[s]]
    while stack2:
        s, wh = stack2.pop()
        lake_wh[s] = wh
        for (h, frm, to) in by_basin.get(s, []):
            nwh = wh if wh > h else h
            stack2.append((int(frm), float(nwh)))

    return LakeSolution(conn_from, conn_to, conn_h, lake_wh)


def default_lake_solver():
    """The port's C++ solver (``native``, built at its first call).  A
    failed build raises there; the numpy solver runs only when a caller
    passes it."""
    from ..native import solve_lakes_native

    return solve_lakes_native


# ---------------------------------------------------------------------------
# the full filter
# ---------------------------------------------------------------------------


def flow_filter(height, sel, grid: Grid, cfg: FlowConfig = FlowConfig(),
                lake_solver=None) -> torch.Tensor:
    """The full FlowFilter: the flow (discharge) map the reference writes
    over the terrain (FlowFilter.cpp:719-786).

    Cells never reached from a river mouth keep -1 (the reference's lakeID
    initialization); flooded lake cells are 0 (``cfg.lakes``); everything
    else is (upstream area sum)^exponent.  The pre-blur (K5) and the
    direction pass (K6's codes form) run on the tensors' device; mask,
    mouths, the unblurred height and the parent pointers are copied to the
    host once for ``lake_solver`` (default: ``default_lake_solver()``),
    and its connections (and the lakes' water heights) copied back for
    the relaxation.  Spans (``core.trace``): ``flow.lake_copies`` around
    the copies each way, ``flow.lake_solve`` around the host solve."""
    if lake_solver is None:
        lake_solver = default_lake_solver()
    dev = height.device

    hb = blur(height, grid, cfg.preblur)
    code = flow_directions(hb, sel, grid)
    mask, mouth, _ = incoming_mask(code, grid)
    parent = parent_pointers(code, grid)

    with span("flow.lake_copies"):
        host = (mask.cpu().numpy().reshape(-1),
                mouth.cpu().numpy().reshape(-1),
                height.cpu().numpy().reshape(-1), parent.cpu().numpy())
    with span("flow.lake_solve"):
        sol = lake_solver(*host, grid)
    with span("flow.lake_copies"):
        conn_from = host_to_device(sol.conn_from.astype(np.int64), dev)
        conn_to = host_to_device(sol.conn_to.astype(np.int64), dev)
        if cfg.lakes:
            wh = host_to_device(np.nan_to_num(sol.lake_wh, nan=-np.inf),
                                dev)

    area = cell_area_lower_edge(grid, dev, cfg.area_scale)
    acc, vis, root = flow_solve_stencil(code, area, mouth, grid,
                                        conn_from=conn_from, conn_to=conn_to,
                                        want_root=cfg.lakes)
    flow = torch.where(vis, torch.pow(acc, cfg.exponent), -1.0)

    if cfg.lakes:
        cell_wh = torch.where(root >= 0, wh[torch.clamp(root, min=0)],
                              -math.inf)
        flow = torch.where(vis & (height <= cell_wh), 0.0, flow)
    return flow

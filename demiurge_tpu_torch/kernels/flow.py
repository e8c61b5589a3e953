"""The flow fixpoint: upstream area accumulation and mouth reachability.

Counterpart of ``demiurge_tpu/pallas_kernels/flow.py`` (``flow_solve_pallas``
and ``pack_masks``) and ``demiurge_tpu/pallas_kernels/visbits.py``
(``vis_solve_bits``).  ``pack_masks`` folds the direction codes into one
int32 per pixel:

  bits 0..7   incoming: the neighbour at NEIGHBORS_FLOW_ORDER[i] flows here
  bits 8..15  outgoing one-hot: this pixel's code points at that neighbour
  bit  16     river mouth

with the reference's range rules (x periodic over the dateline, rows
beyond the grid dropped, no pole wrap).  On it, two relaxations run to
their fixpoint:

  A   = area + sum_i inc_i * A[neighbour_i]     (in scan order)
  vis = mouth | OR_i (out_i & vis[neighbour_i])

D8 flow strictly descends, so the flow graph is acyclic and each fixpoint
is unique: a cell's A is the float32 sum, in scan order, of its area and
its upstream neighbours' fixpoint values, whatever the start.  So A is the
same bit for bit from any warm start ``a0`` and in any sweep order, and
equals ``ops.flow.flow_solve_stencil``'s.

``flow_solve_area`` / ``vis_solve`` launch the CUDA kernels
(``csrc/flow.cu``) for CUDA tensors and run the plain twins (Jacobi sweeps,
checked every 64) for CPU tensors.  On the card a solve runs in rounds:
one launch is one round over every tile of ``TILE`` (rows, columns), in
which a tile whose halo a neighbour tile wrote in the last round (every
tile, in the first) loads itself into shared memory, relaxes there to its
local fixpoint and writes back what changed; a round in which no tile
wrote certifies the fixpoint (the argument is in the source).
``LAUNCHES_A`` / ``LAUNCHES_VIS`` count kernel launches (one per round);
``LAST_SOLVE`` holds the last CUDA solve's rounds, launches, host reads,
tile visits and the most inner sweeps a visit took.
"""

from __future__ import annotations

import torch

from ..core.grid import Grid
from ..core.platform import check_kernel_inputs, use_cuda_kernels
from ..core.topology import DIR_CODE, NEIGHBORS_FLOW_ORDER, shift

LAUNCHES_A = 0
LAUNCHES_VIS = 0
LAST_SOLVE: dict = {}

FIRST_ROUND = 8     # sweeps in the first round of solve_rounds_cuda
MAX_ROUND = 512     # its rounds double up to this many sweeps

TILE = (16, 128)    # K7/K8's tile, rows x columns: csrc/flow.cu's build
BATCH = 16          # rounds a batch of a tiled solve: one host read each


def pack_masks(code, mouth, grid: Grid) -> torch.Tensor:
    """The 8 incoming masks, 8 outgoing one-hots and the mouth flag in one
    int32 field (bit layout in the module docstring)."""
    from ..ops.flow import _incoming_fields, _row_in_range

    packed = torch.zeros(grid.shape, dtype=torch.int32, device=code.device)
    for i, (_, ok) in enumerate(_incoming_fields(code, grid)):
        packed = packed | torch.where(ok, 1 << i, 0).to(torch.int32)
    for i, (dx, dy) in enumerate(NEIGHBORS_FLOW_ORDER):
        m = (code == DIR_CODE[(dx, dy)]) & _row_in_range(grid, dy,
                                                         code.device)
        packed = packed | torch.where(m, 1 << (8 + i), 0).to(torch.int32)
    return packed | torch.where(mouth, 1 << 16, 0).to(torch.int32)


def _bits(packed, first: int):
    return [((packed >> (first + i)) & 1).bool() for i in range(8)]


def _max_sweeps(grid: Grid) -> int:
    # the longest path of an acyclic graph on H*W cells
    return grid.height * grid.width + 1


def flow_solve_area_plain(packed, area, grid: Grid, a0=None,
                          check_every: int = 64) -> torch.Tensor:
    """Jacobi sweeps of the A relaxation from ``a0`` (default: the area)
    until a check finds no change, in plain PyTorch."""
    inc = _bits(packed, 0)
    A = area if a0 is None else a0
    for _ in range(0, _max_sweeps(grid), check_every):
        prev = A
        for _ in range(check_every):
            newA = area
            for ok, (dx, dy) in zip(inc, NEIGHBORS_FLOW_ORDER):
                newA = newA + torch.where(
                    ok, shift(A, dx, dy, grid, pole_wrap=False), 0.0)
            A = newA
        if torch.equal(A.view(torch.int32), prev.view(torch.int32)):
            return A
    raise RuntimeError("flow A relaxation did not converge: the flow "
                       "graph has a cycle")


def vis_solve_plain(packed, grid: Grid, check_every: int = 64
                    ) -> torch.Tensor:
    """Sweeps of the vis relaxation from the mouths until a check finds no
    change, in plain PyTorch.  Returns bool (H, W)."""
    outs = _bits(packed, 8)
    mouth = ((packed >> 16) & 1).bool()
    vis = mouth
    for _ in range(0, _max_sweeps(grid), check_every):
        prev = vis
        for _ in range(check_every):
            newvis = mouth
            for m, (dx, dy) in zip(outs, NEIGHBORS_FLOW_ORDER):
                newvis = newvis | (m & shift(vis, dx, dy, grid,
                                             pole_wrap=False))
            vis = newvis
        if torch.equal(vis, prev):
            return vis
    raise RuntimeError("vis relaxation did not converge")


def solve_rounds_cuda(entry: str, args, device, max_sweeps: int) -> dict:
    """Rounds of in-place sweeps until a sweep changes nothing.  A round
    launches n sweeps (8, doubling up to 512) through the C entry point
    ``entry(*args(flags_ptr, n))``, each sweep setting its own flag when
    it changed a cell; one host read of the n flags ends the round.  A
    sweep that changed nothing saw the current state everywhere (no cell
    was written while it ran), so it certifies the fixpoint; the sweeps
    after it in its round are no-ops."""
    from . import build

    flags = torch.empty(MAX_ROUND, dtype=torch.int32, device=device)
    fn = getattr(build.library(), entry)
    n, sweeps, reads, launched = FIRST_ROUND, 0, 0, 0
    while sweeps < max_sweeps:
        flags[:n].zero_()
        build.check(fn(*args(flags.data_ptr(), n)), entry)
        launched += n
        changed = flags[:n].tolist()  # the round's one host read
        reads += 1
        if 0 in changed:
            return {"sweeps": sweeps + changed.index(0) + 1,
                    "launched": launched, "host_reads": reads}
        sweeps += n
        n = min(2 * n, MAX_ROUND)
    raise RuntimeError(f"{entry}: no fixpoint after {sweeps} sweeps")


def solve_tiles_cuda(solves, device, shape, max_rounds: int,
                     wakes: bool = False, streams=None) -> list:
    """Tiled solves side by side: batches of ``BATCH`` rounds of every
    solve not yet certified, each ``(entry, args)`` through its C entry
    point ``entry(*args(flags, stats, ty, tx, first, n))``, until a round
    of it writes nothing; one host read of every solve's round flags and
    visit counts ends a batch.  The rounds after a certifying one find
    every tile quiet.  ``wakes``: each solve's flags also hold a wake word
    a tile for each of the two rounds (``kernels.lakeflow``), all 0.
    ``streams``: a CUDA stream a solve (None: the current one), which its
    ``args`` name to the entry point; they start after the current
    stream's work so far, and each batch's read waits for all of them.
    Returns each solve's stats."""
    from . import build

    ty, tx = TILE
    H, W = shape
    nt = -(-H // ty) * -(-W // tx)
    # every edge bit set: round 0 wakes every tile
    flags = torch.full((len(solves), (4 if wakes else 2) * nt), -1,
                       dtype=torch.int32, device=device)
    if wakes:
        flags[:, 2 * nt:] = 0
    stats = torch.zeros((len(solves), 2 + BATCH), dtype=torch.int32,
                        device=device)
    side = [st for st in streams or () if st is not None]
    current = torch.cuda.current_stream(device) if side else None
    for st in side:
        st.wait_stream(current)
    lib = build.library()
    out = [None] * len(solves)
    done, reads = 0, 0
    while done < max_rounds:
        for j, (entry, args) in enumerate(solves):
            if out[j] is None:
                build.check(getattr(lib, entry)(*args(
                    flags[j].data_ptr(), stats[j].data_ptr(), ty, tx, done,
                    BATCH)), entry)
        for st in side:
            current.wait_stream(st)
        rows = stats.tolist()  # the batch's one read
        reads += 1
        for j, (visits, passes, *wrote) in enumerate(rows):
            if out[j] is None and 0 in wrote:
                out[j] = {"rounds": done + wrote.index(0) + 1,
                          "launched": done + BATCH, "host_reads": reads,
                          "tiles_run": visits, "max_inner_sweeps": passes}
        if None not in out:
            return out
        done += BATCH
    raise RuntimeError(f"{[e for e, _ in solves]}: no fixpoint after {done} "
                       f"rounds")


def flow_solve_area_cuda(packed, area, grid: Grid, a0=None) -> torch.Tensor:
    """The A relaxation on the card, in place on a copy of ``a0`` (default:
    the area)."""
    global LAUNCHES_A
    check_kernel_inputs(("packed",), (packed,), shape=grid.shape,
                        dtype=torch.int32)
    start = area if a0 is None else a0
    check_kernel_inputs(("area", "a0"), (area, start), shape=grid.shape)
    if not grid.wrap_x:
        raise NotImplementedError("the flow solve needs an x-periodic grid")
    A = start.clone()
    H, W = grid.shape
    stream = torch.cuda.current_stream(A.device).cuda_stream
    (stats,) = solve_tiles_cuda(
        [("demiurge_flow_area_tiles",
          lambda *batch: (packed.data_ptr(), area.data_ptr(), A.data_ptr(),
                          *batch[:2], H, W, *batch[2:], stream))],
        A.device, grid.shape, _max_sweeps(grid))
    LAUNCHES_A += stats["launched"]
    LAST_SOLVE["A"] = stats
    return A


def vis_solve_cuda(packed, grid: Grid) -> torch.Tensor:
    """The vis relaxation on the card, in place from the mouths."""
    global LAUNCHES_VIS
    check_kernel_inputs(("packed",), (packed,), shape=grid.shape,
                        dtype=torch.int32)
    if not grid.wrap_x:
        raise NotImplementedError("the flow solve needs an x-periodic grid")
    vis = ((packed >> 16) & 1).to(torch.uint8)
    H, W = grid.shape
    stream = torch.cuda.current_stream(vis.device).cuda_stream
    (stats,) = solve_tiles_cuda(
        [("demiurge_flow_vis_tiles",
          lambda *batch: (packed.data_ptr(), vis.data_ptr(), 0, *batch[:2],
                          H, W, *batch[2:], stream))],
        vis.device, grid.shape, _max_sweeps(grid))
    LAUNCHES_VIS += stats["launched"]
    LAST_SOLVE["vis"] = stats
    return vis.bool()


def flow_solve_area(packed, area, grid: Grid, a0=None) -> torch.Tensor:
    """The CUDA kernel for CUDA tensors on an x-periodic grid, the plain
    twin otherwise."""
    start = area if a0 is None else a0
    if use_cuda_kernels(packed, area, start, grid=grid):
        return flow_solve_area_cuda(packed, area, grid, a0)
    return flow_solve_area_plain(packed, area, grid, a0)


def vis_solve(packed, grid: Grid) -> torch.Tensor:
    """The CUDA kernel for CUDA tensors on an x-periodic grid, the plain
    twin otherwise."""
    if use_cuda_kernels(packed, grid=grid):
        return vis_solve_cuda(packed, grid)
    return vis_solve_plain(packed, grid)

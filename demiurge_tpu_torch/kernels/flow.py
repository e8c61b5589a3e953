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
checked every 64) for CPU tensors.  ``LAUNCHES_A`` / ``LAUNCHES_VIS`` count
kernel launches (one per sweep); ``LAST_SOLVE`` holds the last CUDA
solve's sweeps and host reads.
"""

from __future__ import annotations

import torch

from ..core.grid import Grid
from ..core.platform import check_kernel_inputs, use_cuda_kernels
from ..core.topology import DIR_CODE, NEIGHBORS_FLOW_ORDER, shift

LAUNCHES_A = 0
LAUNCHES_VIS = 0
LAST_SOLVE: dict = {}

FIRST_ROUND = 8     # sweeps in the first round of a CUDA solve
MAX_ROUND = 512     # rounds double up to this many sweeps


def pack_masks(code, mouth, grid: Grid) -> torch.Tensor:
    """The 8 incoming masks, 8 outgoing one-hots and the mouth flag in one
    int32 field (bit layout in the module docstring)."""
    from ..ops.flow import _incoming_fields, _row_in_range

    packed = torch.zeros(grid.shape, dtype=torch.int32, device=code.device)
    for i, (_, ok) in enumerate(_incoming_fields(code, grid)):
        packed = packed | torch.where(ok, 1 << i, 0).to(torch.int32)
    for i, (dx, dy) in enumerate(NEIGHBORS_FLOW_ORDER):
        m = (code == DIR_CODE[(dx, dy)]) & _row_in_range(grid.height, dy,
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
    stats = solve_rounds_cuda(
        "demiurge_flow_area_sweeps",
        lambda flags, n: (packed.data_ptr(), area.data_ptr(), A.data_ptr(),
                          flags, H, W, n, stream),
        A.device, _max_sweeps(grid))
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
    stats = solve_rounds_cuda(
        "demiurge_flow_vis_sweeps",
        lambda flags, n: (packed.data_ptr(), vis.data_ptr(), flags, H, W, n,
                          stream),
        vis.device, _max_sweeps(grid))
    LAUNCHES_VIS += stats["launched"]
    LAST_SOLVE["vis"] = stats
    return vis.bool()


def flow_solve_area(packed, area, grid: Grid, a0=None) -> torch.Tensor:
    """The CUDA kernel for CUDA tensors, the plain twin for CPU tensors."""
    start = area if a0 is None else a0
    if use_cuda_kernels(packed, area, start):
        return flow_solve_area_cuda(packed, area, grid, a0)
    return flow_solve_area_plain(packed, area, grid, a0)


def vis_solve(packed, grid: Grid) -> torch.Tensor:
    """The CUDA kernel for CUDA tensors, the plain twin for CPU tensors."""
    if use_cuda_kernels(packed):
        return vis_solve_cuda(packed, grid)
    return vis_solve_plain(packed, grid)

"""K12: the lake-aware flow relaxation, solved to its fixpoint.

Counterpart of the device loop that ``demiurge_tpu/ops/flow.py``
``flow_solve_stencil`` (:342-432) compiles: XLA fuses the 8-neighbour
stencil, and the lake connections' scatter rides in the same loop.  There
is no Pallas kernel behind it.  The fixpoint, per cell:

  A    = area + A[nbr_i] for each incoming bit i in NEIGHBORS_FLOW_ORDER,
         then + A[conn_src] where the cell is a connection's attach pixel
  vis  = mouth | vis[nbr] of the outgoing bit | vis[conn_dst] where the
         cell is a connection's lake sink
  root = the cell's own flat index at a sink, else root[nbr] of the
         outgoing bit, else -1

with nbr = ``core.topology.shift(..., pole_wrap=False)``'s neighbour: the
row clamped to the grid, the column wrapped on an x-periodic grid and
clamped on any other.  The masks come in one int32 a pixel
(``pack_lake_masks``): ``kernels.flow.pack_masks`` (bits 0..7 incoming,
8..15 outgoing, 16 mouth), bit 17 the sink flag, bit 18 "has a connection
source" and bit 19 "has a connection target".  The connections (lake sink
``conn_from`` -> attach pixel ``conn_to``, each side unique: connections
are keyed by attach pixel, and a connection leaves a sink at most once)
become two int32 fields, -1 where a cell has none (``conn_fields``), read
only where bit 18 or 19 is set.  The flow graph with the connections is
acyclic, so the fixpoint is unique.

``relax_solve`` solves it: on the card (``relax_solve_cuda``) on K7/K8's
shared-memory tiles in certified rounds (``csrc/lakeflow.cu``: A, vis and
root as three tiled solves side by side in ``kernels.flow``'s batch loop,
each on its own stream, one host read a batch of ``kernels.flow.BATCH``
rounds; a connection whose ends share a tile is solved within a visit,
one across tiles is read at the visit's start and a write of its far end
wakes the reading tile for the next round; the solve stops at the first
round in which no tile wrote, and raises when none comes within its
round limit); on the CPU by the plain twin (``relax_solve_twin``: Jacobi
sweeps of ``relax_sweep_twin``, checked every 64, A and vis compared).
Both reach the same fixpoint: A bit for bit, vis and root exactly.

``relax_sweep`` runs ``n`` Jacobi sweeps: the earlier kernel, one sweep a
launch (``relax_sweep_cuda``), for CUDA tensors, the twin for CPU
tensors.  The twin is the sweep the port ran before any kernel, in the
same arithmetic and order: ``ops.flow``'s taps with ``torch.where(ok,
shift(A), 0.0)``, then the connection add, which its ``index_add`` made
after the taps.  The kernels skip a tap whose bit is clear, which is
exact: adding +0.0 to a sum of non-negative areas leaves it unchanged.
The one-sweep kernel is on no user path; ``jacobi_solve(relax_sweep_cuda,
...)`` solves with it, as a yardstick for the tiles.

``LAUNCHES`` counts the one-sweep kernel's launches (one a sweep);
``LAUNCHES_AREA_TILES``, ``LAUNCHES_VIS_TILES`` and ``LAUNCHES_ROOT_TILES``
the tiled kernels' (one a round of each solve).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.grid import Grid
from ..core.platform import (check_kernel_inputs, host_to_device,
                             use_cuda_kernels)
from ..core.topology import DIR_CODE, NEIGHBORS_FLOW_ORDER, shift
from . import flow as kf

LAUNCHES = 0              # the one-sweep kernel
LAUNCHES_AREA_TILES = 0   # the tiled solve's three kernels
LAUNCHES_VIS_TILES = 0
LAUNCHES_ROOT_TILES = 0

SINK_BIT = 1 << 17
SRC_BIT = 1 << 18   # conn_src >= 0: the attach pixel of a connection
DST_BIT = 1 << 19   # conn_dst >= 0: the lake sink of a connection


def conn_fields(conn_from, conn_to, shape):
    """(conn_src, conn_dst), int32 fields of ``shape`` on the connections'
    device, -1 where there is no connection: ``conn_src`` at an attach
    pixel is the lake sink it receives from, ``conn_dst`` at a lake sink
    its attach pixel.  One slot a cell is exact because each side is
    unique; raises if either side repeats or leaves the grid."""
    H, W = shape
    n = H * W
    if n >= 2 ** 31:
        raise ValueError(f"{W}x{H}: flat indices past int32")
    src = torch.full((n,), -1, dtype=torch.int32, device=conn_from.device)
    dst = torch.full((n,), -1, dtype=torch.int32, device=conn_from.device)
    if conn_from.shape != conn_to.shape or conn_from.dim() != 1:
        raise ValueError("conn_from and conn_to must be (C,) alike")
    if conn_from.numel():
        for name, side in (("conn_from", conn_from), ("conn_to", conn_to)):
            if torch.unique(side).numel() != side.numel():
                raise ValueError(f"{name} repeats a cell: a connection "
                                 f"needs its own slot")
        lo = min(int(conn_from.min()), int(conn_to.min()))
        hi = max(int(conn_from.max()), int(conn_to.max()))
        if lo < 0 or hi >= n:
            raise ValueError(f"connection index out of the {W}x{H} grid")
        src[conn_to.long()] = conn_from.to(torch.int32)
        dst[conn_from.long()] = conn_to.to(torch.int32)
    return src.reshape(H, W), dst.reshape(H, W)


def pack_lake_masks(code, mouth, grid: Grid, conn_src, conn_dst):
    """``kernels.flow.pack_masks`` with bit 17 set at the sinks (code 5),
    bit 18 where ``conn_src`` holds a connection and bit 19 where
    ``conn_dst`` does.  The 8 neighbours are 8 views of one padded copy
    of the codes (``shift(pole_wrap=False)``'s: x wrapped on an x-periodic
    grid and clamped on any other, rows clamped), and the range rules
    (``ops.flow._incoming_fields``'s and ``pack_masks``') come as (8, H, 1)
    and (8, 1, W) tables, so the masks take some 30 torch ops instead of
    ``pack_masks``' 150: the relaxation packs them once a solve."""
    from ..ops.flow import _wraps_x

    H, W = grid.shape
    dev = code.device
    if grid.wrap_x:
        cols = torch.cat([code[:, -1:], code, code[:, :1]], 1)
    else:
        cols = torch.cat([code[:, :1], code, code[:, -1:]], 1)
    padded = torch.cat([cols[:1], cols, cols[-1:]], 0)
    nbr = torch.stack([padded[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
                       for dx, dy in NEIGHBORS_FLOW_ORDER])
    # per neighbour: dx, dy, the code that flows from it here, the code
    # that flows from here to it
    table = host_to_device(np.array(
        [(dx, dy, DIR_CODE[(-dx, -dy)], DIR_CODE[(dx, dy)])
         for dx, dy in NEIGHBORS_FLOW_ORDER], np.int32), dev).reshape(
             8, 4, 1, 1)
    dx, dy, toward, away = table.unbind(1)
    # _row_in_range: the row r + dy exists in the whole grid
    r = grid.row_numbers(dev).reshape(1, H, 1)
    rows = torch.where(dy > 0, r < grid.base.height - dy,
                       torch.where(dy < 0, r >= -dy, True))
    c = torch.arange(W, device=dev).reshape(1, 1, W)
    in_cols = True if _wraps_x(grid) else (c < W - dx) & (c >= -dx)
    bit = (1 << torch.arange(8, dtype=torch.int32, device=dev)).reshape(
        8, 1, 1)
    inc = torch.where((nbr == toward) & rows & in_cols, bit, 0).sum(0)
    out = torch.where((code == away) & rows, bit << 8, 0).sum(0)
    flags = (torch.where(mouth, 1 << 16, 0)
             | torch.where(code == 5, SINK_BIT, 0)
             | torch.where(conn_src >= 0, SRC_BIT, 0)
             | torch.where(conn_dst >= 0, DST_BIT, 0))
    return (inc | out | flags).to(torch.int32)


def root_start(packed) -> torch.Tensor:
    """A sweep's root before the downstream read: each sink's own flat
    index, -1 elsewhere (int32)."""
    H, W = packed.shape
    idx = torch.arange(H * W, dtype=torch.int32,
                       device=packed.device).reshape(H, W)
    return torch.where((packed & SINK_BIT) != 0, idx, -1)


def relax_sweep_twin(packed, area, conn_src, conn_dst, A, vis, root,
                     grid: Grid, n: int = 1):
    """``n`` sweeps in plain PyTorch (root may be None: not carried); the
    masks are unpacked once for the ``n``."""
    H, W = grid.shape
    inc = [((packed >> i) & 1).bool() for i in range(8)]
    outs = [((packed >> (8 + i)) & 1).bool() for i in range(8)]
    mouth = ((packed >> 16) & 1).bool()
    root0 = None if root is None else root_start(packed)
    src_ok = (packed & SRC_BIT) != 0
    dst_ok = (packed & DST_BIT) != 0
    src = conn_src.clamp(min=0).long().reshape(-1)
    dst = conn_dst.clamp(min=0).long().reshape(-1)
    for _ in range(n):
        newA = area
        for ok, (dx, dy) in zip(inc, NEIGHBORS_FLOW_ORDER):
            newA = newA + torch.where(
                ok, shift(A, dx, dy, grid, pole_wrap=False), 0.0)
        # vis and root flow downstream -> upstream: take the value of the
        # cell the code points to
        newvis = mouth
        newroot = root0
        for m, (dx, dy) in zip(outs, NEIGHBORS_FLOW_ORDER):
            newvis = newvis | (m & shift(vis, dx, dy, grid,
                                         pole_wrap=False))
            if root is not None:
                newroot = torch.where(
                    m, shift(root, dx, dy, grid, pole_wrap=False), newroot)
        # the connections after the taps
        newA = torch.where(src_ok, newA + A.reshape(-1)[src].reshape(H, W),
                           newA)
        newvis = newvis | (dst_ok & vis.reshape(-1)[dst].reshape(H, W))
        A, vis, root = newA, newvis, newroot
    return A, vis, root


def relax_sweep_cuda(packed, area, conn_src, conn_dst, A, vis, root,
                     grid: Grid, n: int = 1):
    """``n`` sweeps on the card, one launch each, into fresh ping-pong
    buffers (the inputs are not written).  root int32 or None."""
    global LAUNCHES
    from . import build

    shape = grid.shape
    check_kernel_inputs(("packed", "conn_src", "conn_dst"),
                        (packed, conn_src, conn_dst), shape=shape,
                        dtype=torch.int32)
    check_kernel_inputs(("area", "A"), (area, A), shape=shape)
    check_kernel_inputs(("vis",), (vis,), shape=shape, dtype=torch.bool)
    if root is not None:
        check_kernel_inputs(("root",), (root,), shape=shape,
                            dtype=torch.int32)
    if n < 1:
        raise ValueError(f"n = {n}: at least one sweep")
    H, W = shape
    bufs = [(torch.empty_like(A), torch.empty_like(vis),
             None if root is None else torch.empty_like(root))
            for _ in range(2)]

    def ptrs(t3):
        return [0 if t is None else t.data_ptr() for t in t3]

    stream = torch.cuda.current_stream(A.device).cuda_stream
    err = build.library().demiurge_lake_relax(
        packed.data_ptr(), area.data_ptr(), conn_src.data_ptr(),
        conn_dst.data_ptr(), *ptrs((A, vis, root)), *ptrs(bufs[0]),
        *ptrs(bufs[1]), H, W, int(grid.wrap_x), n, stream)
    build.check(err, "demiurge_lake_relax")
    LAUNCHES += n
    # sweep 0 writes the first set, then the two alternate
    return bufs[0] if n % 2 else bufs[1]


def relax_sweep(packed, area, conn_src, conn_dst, A, vis, root,
                grid: Grid, n: int = 1):
    """``n`` sweeps: the one-sweep kernel for CUDA tensors, the plain twin
    for CPU tensors.  Returns (A, vis, root)."""
    carried = () if root is None else (root,)
    if use_cuda_kernels(packed, area, conn_src, conn_dst, A, vis, *carried):
        return relax_sweep_cuda(packed, area, conn_src, conn_dst, A, vis,
                                root, grid, n)
    return relax_sweep_twin(packed, area, conn_src, conn_dst, A, vis, root,
                            grid, n)


def jacobi_solve(sweep, packed, area, conn_src, conn_dst, grid: Grid,
                 want_root: bool = False, check_every: int = 64,
                 max_iters: int = 1 << 30):
    """The fixpoint by Jacobi sweeps from the area, the mouths and
    ``root_start`` (root only with ``want_root``): ``check_every`` sweeps
    a call of ``sweep`` (``relax_sweep``'s signature) until a check finds
    A and vis unchanged, or ``max_iters`` sweeps have run.  Root follows
    the same flow paths.  Returns (A, vis, root or None, {"sweeps": n})."""
    A, vis = area, ((packed >> 16) & 1).bool()
    root = root_start(packed) if want_root else None
    it = 0
    while it < max_iters:
        prev, prev_v = A, vis
        A, vis, root = sweep(packed, area, conn_src, conn_dst, A, vis, root,
                             grid, check_every)
        it += check_every
        if torch.equal(A, prev) and torch.equal(vis, prev_v):
            break
    return A, vis, root, {"sweeps": it}


def relax_solve_twin(packed, area, conn_src, conn_dst, grid: Grid,
                     want_root: bool = False, check_every: int = 64,
                     max_iters: int = 1 << 30):
    """The plain twin's solve: ``jacobi_solve`` of ``relax_sweep_twin``."""
    return jacobi_solve(relax_sweep_twin, packed, area, conn_src, conn_dst,
                        grid, want_root, check_every, max_iters)


TILE_ENTRIES = {"A": "demiurge_lake_area_tiles",
                "vis": "demiurge_lake_vis_tiles",
                "root": "demiurge_lake_root_tiles"}


def tile_solves(packed, area, conn_src, conn_dst, grid: Grid,
                parts=("A", "vis", "root")):
    """The tiled solves of ``parts`` on the card, side by side: A from the
    area, vis (uint8) from the mouths, root (int32) from ``root_start``,
    each in place on its own buffer.  Returns ({part: field}, {part:
    ``kernels.flow.solve_tiles_cuda``'s stats})."""
    global LAUNCHES_AREA_TILES, LAUNCHES_VIS_TILES, LAUNCHES_ROOT_TILES
    shape = grid.shape
    check_kernel_inputs(("packed", "conn_src", "conn_dst"),
                        (packed, conn_src, conn_dst), shape=shape,
                        dtype=torch.int32)
    check_kernel_inputs(("area",), (area,), shape=shape)
    if not parts or set(parts) - set(TILE_ENTRIES):
        raise ValueError(f"parts {parts}: some of {tuple(TILE_ENTRIES)}")
    H, W = shape
    wrap = int(grid.wrap_x)
    start = {"A": area.clone,
             "vis": lambda: ((packed >> 16) & 1).to(torch.uint8),
             "root": lambda: root_start(packed)}
    fields = {k: start[k]() for k in parts}
    ins = {"A": (packed, area, conn_src, conn_dst), "vis": (
        packed, conn_src, conn_dst), "root": (packed,)}
    # the first solve on the current stream, each other one on its own:
    # a round is one tile's visit long where few tiles wake, so the
    # solves' rounds overlap on the card
    streams = [None] + [torch.cuda.Stream(packed.device) for _ in parts[1:]]

    def args(part, st):
        ptrs = [t.data_ptr() for t in (*ins[part], fields[part])]
        handle = (st or torch.cuda.current_stream(packed.device)).cuda_stream
        return lambda *batch: (*ptrs, wrap, *batch[:2], H, W, *batch[2:],
                               handle)

    stats = kf.solve_tiles_cuda(
        [(TILE_ENTRIES[k], args(k, st)) for k, st in zip(parts, streams)],
        packed.device, shape, kf._max_sweeps(grid), wakes=True,
        streams=streams)
    stats = dict(zip(parts, stats))
    LAUNCHES_AREA_TILES += stats.get("A", {}).get("launched", 0)
    LAUNCHES_VIS_TILES += stats.get("vis", {}).get("launched", 0)
    LAUNCHES_ROOT_TILES += stats.get("root", {}).get("launched", 0)
    return fields, stats


def relax_solve_cuda(packed, area, conn_src, conn_dst, grid: Grid,
                     want_root: bool = False):
    """The fixpoint on the card by the tiled kernels.  Returns (A, vis
    bool, root int32 or None, {"A": stats, "vis": stats[, "root":
    stats]})."""
    parts = ("A", "vis", "root") if want_root else ("A", "vis")
    fields, stats = tile_solves(packed, area, conn_src, conn_dst, grid,
                                parts)
    return (fields["A"], fields["vis"].bool(), fields.get("root"), stats)


def relax_solve(packed, area, conn_src, conn_dst, grid: Grid,
                want_root: bool = False, check_every: int = 64,
                max_iters: int = 1 << 30):
    """The fixpoint: the tiled kernels for CUDA tensors (on any grid; the
    twin's ``check_every`` and ``max_iters`` do not apply), the plain twin
    for CPU tensors.  Returns (A, vis, root or None, stats): the tiled
    solves' stats by field on the card, {"sweeps": n} on the CPU."""
    if use_cuda_kernels(packed, area, conn_src, conn_dst):
        return relax_solve_cuda(packed, area, conn_src, conn_dst, grid,
                                want_root)
    return relax_solve_twin(packed, area, conn_src, conn_dst, grid,
                            want_root, check_every, max_iters)

"""K12: the lake-aware flow relaxation, one Jacobi sweep a launch.

Counterpart of the sweep that ``demiurge_tpu/ops/flow.py``
``flow_solve_stencil`` (:342-432) compiles into one device loop: XLA fuses
the 8-neighbour stencil, and the lake connections' scatter rides in the same
loop.  There is no Pallas kernel behind it.  One sweep computes, per cell,
from the previous sweep's A, vis and root:

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
become two int32 fields, -1 where a cell has none (``conn_fields``); a
sweep reads them only where bit 18 or 19 is set.

``relax_sweep`` launches ``n`` sweeps of the CUDA kernel
(``csrc/lakeflow.cu``) over ping-pong buffers for CUDA tensors and runs
``n`` sweeps of the plain twin ``relax_sweep_twin`` for CPU tensors.  The
twin is the sweep the port ran before the kernel, in the same arithmetic
and order: ``ops.flow``'s taps with ``torch.where(ok, shift(A), 0.0)``,
then the connection add, which its ``index_add`` made after the taps.  The
kernel skips a tap whose bit is clear, which is exact: adding +0.0 to a
sum of non-negative areas leaves it unchanged.  So the two agree bit for
bit.  ``LAUNCHES`` counts kernel launches (one a sweep); the fixpoint loop
is ``ops.flow.flow_solve_stencil``'s.
"""

from __future__ import annotations

import torch

from ..core.grid import Grid
from ..core.platform import check_kernel_inputs, use_cuda_kernels
from ..core.topology import NEIGHBORS_FLOW_ORDER, shift
from . import flow as kf

LAUNCHES = 0

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
    ``conn_dst`` does."""
    flags = (torch.where(code == 5, SINK_BIT, 0)
             | torch.where(conn_src >= 0, SRC_BIT, 0)
             | torch.where(conn_dst >= 0, DST_BIT, 0))
    return kf.pack_masks(code, mouth, grid) | flags.to(torch.int32)


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
    """``n`` sweeps: the CUDA kernel for CUDA tensors, the plain twin for
    CPU tensors.  Returns (A, vis, root)."""
    carried = () if root is None else (root,)
    if use_cuda_kernels(packed, area, conn_src, conn_dst, A, vis, *carried):
        return relax_sweep_cuda(packed, area, conn_src, conn_dst, A, vis,
                                root, grid, n)
    return relax_sweep_twin(packed, area, conn_src, conn_dst, A, vis, root,
                            grid, n)

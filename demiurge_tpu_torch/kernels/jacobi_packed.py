"""Jacobi sweeps from one obstacle-bit field and a per-row metric table.

Counterpart of ``attic/jacobi_packed.py``: the ocean's pressure and
viscosity sweeps (``kernels.jacobi``, K2/K3) with the five or six
per-pixel coefficient planes folded into

- ``pack_ob``: one int32 a pixel, bit 0/1/2/3 = the N/S/E/W neighbour is
  land (the sweep takes the centre instead), bit 4 = land; a clamped
  (non-pole) edge sets the bit of the missing neighbour;
- ``row_table``: (H, 3) float32 of (cx, cy, c0) a row;

and a sweep ``f' = cx*(fE + fW) + cy*(fN + fS) + (b or c0*f)``, zero on
land when ``sea_mask`` is set, the neighbour across a pole negated for
velocities (``negate``).  The reference pads both tables with k pole-halo
rows; the port keeps them unpadded (H rows): the twin indexes the pole
neighbour directly, the kernel reads it in K2's unfolded frame
(``utils.interop.packed_jacobi_from_reference`` cuts the reference's
padded tables down).

``resident_call_packed`` launches the CUDA kernel
(``csrc/jacobi_packed.cu``) for CUDA tensors and runs the plain twin for
CPU tensors; both round every operation alike, so on one card they agree
bit for bit.  A launch runs ``SWEEPS_PER_LAUNCH`` sweeps (k) on
shared-memory tiles of ``TILES[number of fields]`` output cells, each with
a halo of k cells (K2's temporal blocking, ``kernels.jacobi``); a solve of
``iters`` sweeps is ``launches(iters)`` launches, the last one running the
remainder.  ``LAUNCHES`` counts them.  ``resident_call_packed_sweeps_cuda``
is the earlier design, one launch a sweep, kept as the yardstick the smoke
times beside it (``LAUNCHES_SWEEPS``, 0 on every other path).
"""

from __future__ import annotations

import torch

from ..core.grid import Grid
from ..core.platform import check_kernel_inputs, use_cuda_kernels
from ..core.topology import _pole_col_shift, shift
from .jacobi import _pole_rows, _topology_args

LAUNCHES = 0
LAUNCHES_SWEEPS = 0

# csrc/jacobi_packed.cu's build (PERF.md has the shapes raced); its entry
# point refuses any other
SWEEPS_PER_LAUNCH = 8          # k: sweeps a launch, the halo's depth
TILES = {1: (32, 128), 2: (32, 64)}  # output cells of a block by fields


def launches(iters: int) -> int:
    """Kernel launches of a solve of ``iters`` sweeps: ceil(iters / k)."""
    return -(-iters // SWEEPS_PER_LAUNCH)


def pack_ob(terrain: torch.Tensor, grid: Grid, sea_bit: bool
            ) -> torch.Tensor:
    """(H, W) int32 obstacle bits of ``terrain`` (land where > 0)."""
    bits = [(shift(terrain, dx, dy, grid) > 0).to(torch.int32) << n
            for n, (dx, dy) in enumerate(((0, 1), (0, -1), (1, 0), (-1, 0)))]
    ob = bits[0] | bits[1] | bits[2] | bits[3]
    if sea_bit:
        ob = ob | torch.where(terrain > 0, 16, 0).to(torch.int32)
    if not (grid.wrap_south and grid.wrap_x):
        ob[0] |= 2   # clamp: row 0 has no southern neighbour
    if not (grid.wrap_north and grid.wrap_x):
        ob[-1] |= 1
    return ob.contiguous()


def row_table(grid: Grid, mode: str, device="cpu") -> torch.Tensor:
    """(H, 3) float32 (cx, cy, c0) a row, for mode "pressure" or
    "viscosity" (the reference's ``_row_table`` without its pads)."""
    dxr, dyr = grid.pixelsize_rows(device)
    return row_coefficients(dxr, dyr, mode)


def row_coefficients(dxr, dyr, mode: str) -> torch.Tensor:
    """``row_table`` from the pixel sizes: dx (H, 1) and dy (0-d)."""
    H = dxr.shape[0]
    if mode == "pressure":
        pw2x = (dxr / 420.0) ** 2
        pw2y = (dyr / 420.0) ** 2
        beta = 2 * (1 / pw2x + 1 / pw2y)
        cx = 1.0 / pw2x / beta
        cy = (1.0 / pw2y / beta).expand(H, 1)
        c0 = torch.zeros((H, 1), dtype=torch.float32, device=dxr.device)
    elif mode == "viscosity":
        # a true division: torch computes scalar / tensor as a reciprocal
        # times the scalar, which rounds twice
        c420 = torch.full((), 420.0, dtype=torch.float32, device=dxr.device)
        wx = (c420 / dxr) ** 2
        wy = (c420 / dyr) ** 2 * torch.ones_like(wx)
        beta = 2 * (wx + wy) * (1 + 1 / (2 * (wx + wy)))
        cx = wx / beta
        cy = wy / beta
        c0 = 1.0 / beta
    else:
        raise ValueError(f"mode must be 'pressure' or 'viscosity', got "
                         f"{mode!r}")
    return torch.cat([cx, cy, c0], dim=1).contiguous()


def _check(ob, rowtab, b, fields, grid: Grid, iters: int) -> None:
    if not 1 <= len(fields) <= 2:
        raise ValueError(f"one or two fields, got {len(fields)}")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    H, W = grid.shape
    for name, t, shape in [("ob", ob, (H, W)), ("rowtab", rowtab, (H, 3))] \
            + ([("b", b, (H, W))] if b is not None else []) \
            + [(f"fields[{i}]", f, (H, W)) for i, f in enumerate(fields)]:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")


def resident_call_packed_plain(ob, rowtab, b, fields, grid: Grid,
                               iters: int, sea_mask: bool, negate: bool):
    """``iters`` sweeps of every field, in plain PyTorch."""
    _check(ob, rowtab, b, fields, grid, iters)
    cx, cy, c0 = rowtab[:, 0:1], rowtab[:, 1:2], rowtab[:, 2:3]
    blocked = [(ob & (1 << n)) != 0 for n in range(4)]
    land = (ob & 16) != 0
    north, south = _pole_rows(grid, ob.device)
    out = []
    for f in fields:
        for _ in range(iters):
            fN = shift(f, 0, 1, grid)
            fS = shift(f, 0, -1, grid)
            if negate:
                fN = torch.where(north, -fN, fN)
                fS = torch.where(south, -fS, fS)
            pN, pS, pE, pW = (torch.where(m, f, nb) for m, nb in zip(
                blocked, (fN, fS, shift(f, 1, 0, grid),
                          shift(f, -1, 0, grid))))
            new = cx * (pE + pW) + cy * (pN + pS)
            new = new + b if b is not None else new + c0 * f
            f = torch.where(land, 0.0, new) if sea_mask else new
        out.append(f)
    return out


def _cuda_args(ob, rowtab, b, fields, grid: Grid, iters: int):
    """Checks for the card, then (output buffers, pointer arguments), or
    None when there is no sweep to run."""
    _check(ob, rowtab, b, fields, grid, iters)
    check_kernel_inputs(("ob",), (ob,), dtype=torch.int32)
    floats = [rowtab] + ([b] if b is not None else []) + fields
    check_kernel_inputs([f"input {i}" for i in range(len(floats))], floats)
    if ob.device != rowtab.device:
        raise ValueError(f"ob on {ob.device}, rowtab on {rowtab.device}")
    if iters == 0:
        return None
    bufs = [torch.empty_like(f) for f in fields for _ in range(2)]
    pp = [t.data_ptr() for t in bufs] + [None, None] * (2 - len(fields))
    H, W = grid.shape
    wrap_x, wrap_s, wrap_n, _ = _topology_args(grid)
    args = (ob.data_ptr(), rowtab.data_ptr(),
            None if b is None else b.data_ptr(), fields[0].data_ptr(),
            fields[1].data_ptr() if len(fields) == 2 else None, *pp, H, W,
            wrap_x, wrap_s, wrap_n, _pole_col_shift(grid))
    return bufs, args


def resident_call_packed_cuda(ob, rowtab, b, fields, grid: Grid, iters: int,
                              sea_mask: bool, negate: bool):
    """``iters`` sweeps on the card: ``launches(iters)`` launches of k
    sweeps on shared-memory tiles, on the current stream, no
    synchronisation."""
    global LAUNCHES
    fields = list(fields)
    call = _cuda_args(ob, rowtab, b, fields, grid, iters)
    if call is None:
        return [f.clone() for f in fields]
    from . import build

    bufs, args = call
    err = build.library().demiurge_jacobi_packed(
        *args, int(sea_mask), int(negate), *TILES[len(fields)],
        SWEEPS_PER_LAUNCH, iters,
        torch.cuda.current_stream(ob.device).cuda_stream)
    build.check(err, "demiurge_jacobi_packed")
    n = launches(iters)
    LAUNCHES += n
    last = (n - 1) % 2
    return [bufs[2 * i + last] for i in range(len(fields))]


def resident_call_packed_sweeps_cuda(ob, rowtab, b, fields, grid: Grid,
                                     iters: int, sea_mask: bool,
                                     negate: bool):
    """The earlier design on the card, the yardstick: one launch a sweep
    on the current stream, no synchronisation."""
    global LAUNCHES_SWEEPS
    fields = list(fields)
    call = _cuda_args(ob, rowtab, b, fields, grid, iters)
    if call is None:
        return [f.clone() for f in fields]
    from . import build

    bufs, args = call
    err = build.library().demiurge_jacobi_packed_sweeps(
        *args, int(sea_mask), int(negate), iters,
        torch.cuda.current_stream(ob.device).cuda_stream)
    build.check(err, "demiurge_jacobi_packed_sweeps")
    LAUNCHES_SWEEPS += iters
    last = (iters - 1) % 2
    return [bufs[2 * i + last] for i in range(len(fields))]


def resident_call_packed(ob, rowtab, b, fields, grid: Grid, iters: int,
                         sea_mask: bool, negate: bool):
    """The CUDA kernel for CUDA tensors, the plain twin for CPU tensors.
    Returns the list of swept fields."""
    tensors = [ob, rowtab] + ([b] if b is not None else []) + list(fields)
    if use_cuda_kernels(*tensors):
        return resident_call_packed_cuda(ob, rowtab, b, fields, grid, iters,
                                         sea_mask, negate)
    return resident_call_packed_plain(ob, rowtab, b, fields, grid, iters,
                                      sea_mask, negate)

"""Stencil stages on this rank's block or row group: no full field on
any rank.

Counterpart of GSPMD's partitioning of the stencil stages
(``demiurge_tpu/dist/mesh.py`` ``sharded_jit``, ``P('y', 'x')``), which
the reference gets from XLA and the port writes out.  One mechanism:

1. pad each input once by the stage's reach: a block by
   ``dist.halo.exchange_halo``, a row group (``dist.mesh.blocks_to_rows``)
   by ``dist.halo.exchange_rows_halo``;
2. run the single-device op itself on the padded piece, with a
   ``core.grid.Window`` in place of the grid: its per-row and per-column
   tables are the grid's, cut at the piece's global rows and columns, its
   per-pixel tables are built from those coordinates, and its shifts read
   the halo as it is (the pole's reflection and sign flips are in the
   halo rows: ``negate`` flips velocity halos);
3. crop the reach off every output.

No op's arithmetic is written twice, and each op keeps its own edge
rules: what the padding puts beyond a pole is what the op's single-device
shift would read there.  A stage of reach k leaves the k outer rings of
the padded piece stale, which the crop drops; an input read only at its
own pixel is padded with zeros, without communication.

``block_call`` is the block form (the ocean's departure points,
divergence, projection and coefficient builds, the erosion pass, the
packed flow masks of the halo fallback): one pass each, so the halo rows
beyond a pole (the cap, negated for velocities) read as the
single-device shift reads there.  ``flow_masks_rows`` is the row-group
form of the flow's masks: the pre-blur's horizontal taps reach 1/cos(phi)
columns, nearly a whole row near the poles (``ops.blur``), so the rows
must be whole; its blur makes five passes, so a strip at a pole ends at
the pole and reflects there itself (halo rows beyond a pole would evolve
as mirrors only up to the order of the blur's sums).

``local_supported`` says where this applies: a grid that is x-periodic
and reaches both poles, split evenly.  Elsewhere a stage runs on the
gathered fields (``dist.mesh.sharded_call``): ``block_or_gathered``
picks one or the other.
"""

from __future__ import annotations

import torch

from ..core.grid import Grid, Window
from .halo import exchange_halo, exchange_rows_halo
from .mesh import (Mesh, _map_outputs, block_shape, blocks_to_rows,
                   sharded_call)


def local_supported(grid: Grid, mesh: Mesh) -> bool:
    """Whether the local stages apply: an x-periodic grid with both poles
    (the halo carries them), split evenly by the mesh, the antipodal cap
    on one shard (nx even or 1)."""
    H, W = grid.shape
    return (grid.wrap_x and grid.wrap_south and grid.wrap_north
            and H % mesh.ny == 0 and W % mesh.nx == 0
            and (mesh.nx == 1 or mesh.nx % 2 == 0))


def block_window(grid: Grid, mesh: Mesh, k: int) -> Window:
    """This rank's block with a k-ring halo, as a window of ``grid``."""
    h, w = block_shape(grid.shape, mesh)
    return Window(w + 2 * k, h + 2 * k, grid.coords, grid.circumference,
                  full=(grid.width, grid.height), row0=mesh.yi * h - k,
                  col0=mesh.xi * w - k)


def rows_window(grid: Grid, mesh: Mesh, k: int) -> Window:
    """This rank's row group (``blocks_to_rows``) with k halo rows on
    each side that is not a pole: a row group at a pole starts (ends) at
    the pole's row, where the window reflects as the grid does."""
    r = grid.height // mesh.size
    lo = max(mesh.rank * r - k, 0)
    hi = min((mesh.rank + 1) * r + k, grid.height)
    return Window(grid.width, hi - lo, grid.coords, grid.circumference,
                  full=(grid.width, grid.height), row0=lo, col0=0)


def _zero_pad(t: torch.Tensor, k: int) -> torch.Tensor:
    if t.is_floating_point():
        return torch.nn.functional.pad(t, (k, k, k, k))
    out = t.new_zeros((t.shape[0] + 2 * k, t.shape[1] + 2 * k))
    out[k:-k, k:-k] = t
    return out


def _crop(t, win: Window, k: int):
    if not isinstance(t, torch.Tensor) or k == 0 or t.dim() < 2:
        return t
    if t.shape[-2] == win.height:
        t = t[..., k:-k, :]
    if t.shape[-1] == win.width:
        t = t[..., k:-k]
    return t.contiguous()


def block_call(fn, mesh: Mesh, k: int, halo=(), negate=()):
    """Run the single-device op ``fn`` on this rank's blocks.  Each 2-D
    tensor argument at a position in ``halo`` is padded with its k-ring
    halo (negated beyond a pole at the positions in ``negate``: velocity
    components), every other 2-D tensor argument with zeros (an input
    read only at its own pixel); the ``Grid`` argument becomes the padded
    block's window; each output is cropped back to the block."""

    def call(*args):
        grid = next(a for a in args if isinstance(a, Grid))
        win = block_window(grid, mesh, k)

        def pad(i, a):
            if a is grid:
                return win
            if not (isinstance(a, torch.Tensor) and a.dim() == 2) or k == 0:
                return a
            if i in halo:
                return exchange_halo(a, k, grid, mesh,
                                     negate_pole=i in negate)
            return _zero_pad(a, k)

        out = fn(*[pad(i, a) for i, a in enumerate(args)])
        return _map_outputs(out, lambda t: _crop(t, win, k))

    return call


def block_or_gathered(fn, grid: Grid, mesh: Mesh, k: int, halo=(),
                      negate=()):
    """``block_call`` where the local stages apply (``local_supported``),
    else ``dist.mesh.sharded_call``: the op on the gathered fields."""
    if local_supported(grid, mesh):
        return block_call(fn, mesh, k, halo, negate)
    return sharded_call(fn, mesh)


def flow_rows_reach(preblur: float) -> int:
    """The row halo of ``flow_masks_rows``: the pre-blur's vertical
    reaches, one row for the codes' Sobel and steepest-descent taps, one
    for the mouths and the masks' neighbour codes."""
    from ..kernels.blur import reach
    from ..ops.blur import sigma_list

    return sum(reach(r) for r in sigma_list(preblur)) + 2


def flow_rows_supported(grid: Grid, mesh: Mesh, preblur: float) -> bool:
    """Whether ``flow_masks_rows`` applies: the local grids, whole row
    groups, each at least as deep as the halo."""
    return (local_supported(grid, mesh) and grid.height % mesh.size == 0
            and grid.height // mesh.size >= flow_rows_reach(preblur))


def flow_masks_rows(height, sel, grid: Grid, mesh: Mesh, preblur: float):
    """The flow's pre-blur, D8 codes, mouths and packed masks on this
    rank's row group, from its blocks of ``height`` and ``sel``: one
    ``blocks_to_rows`` of each, one row-halo exchange of each as deep as
    the stages' vertical reaches together (``flow_rows_reach``), then the
    single-device ops on the strip (the blur on K5 and the codes on K6's
    codes form on the card), validity shrinking by each stage's reach.
    A strip at a pole starts (ends) at the pole's row and reflects there
    as the whole grid does (``rows_window``): the blur's five passes, the
    codes' clamp (the coordsMod grid) and the mouths' reflection are each
    the single-device op's own.  Returns (code, mouth, packed masks), each
    (r, W) in the row-group layout (``kernels.flow.pack_masks``)."""
    from ..kernels.flow import pack_masks
    from ..ops.blur import blur
    from ..ops.flow import flow_directions, incoming_mask

    k = flow_rows_reach(preblur)
    win = rows_window(grid, mesh, k)
    r = grid.height // mesh.size
    s0 = win.row0 - (mesh.rank * r - k)  # the halo rows beyond a pole

    def strip(x):
        x = exchange_rows_halo(blocks_to_rows(x, mesh), k, mesh, grid,
                               "zero")
        return x[s0:s0 + win.height]

    code = flow_directions(blur(strip(height), win, preblur), strip(sel),
                           win)
    _, mouth, _ = incoming_mask(code, win)
    packed = pack_masks(code, mouth, win)
    own = slice(k - s0, k - s0 + r)
    return tuple(x[own].contiguous() for x in (code, mouth, packed))

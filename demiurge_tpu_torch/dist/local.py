"""Stencil stages on this rank's block or row group: no full field on
any rank.

Counterpart of GSPMD's partitioning of the stencil stages
(``demiurge_tpu/dist/mesh.py`` ``sharded_jit``, ``P('y', 'x')``), which
the reference gets from XLA and the port writes out.  One mechanism:

1. pad each input once by the stage's reach: a block by
   ``dist.halo.exchange_halo``, a row group (``dist.mesh.blocks_to_rows``)
   by ``dist.halo.exchange_rows_halo``, from as many ranks away as the
   reach needs; at a grid edge that is not a pole (a grid whose latitudes
   stop short of it) the piece ends, with no halo beyond;
2. run the single-device op itself on the padded piece, with a
   ``core.grid.Window`` in place of the grid: its per-row and per-column
   tables are the grid's, cut at the piece's global rows and columns, its
   per-pixel tables are built from those coordinates, and its shifts read
   the halo as it is (the pole's reflection and sign flips are in the
   halo rows: ``negate`` flips velocity halos) and, where the piece ends
   at the grid's own edge, apply the grid's own rule there (the pole's
   reflection for a whole-width strip, the clamp of ``core.topology.
   shift`` at an edge that is not a pole);
3. crop the reach off every output (asymmetrically where a side ends at
   such an edge).

No op's arithmetic is written twice, and each op keeps its own edge
rules: what the padding puts beyond a pole is what the op's single-device
shift would read there.  A stage of reach k leaves the k outer rings of
the padded piece stale, which the crop drops; an input read only at its
own pixel is padded with zeros, without communication.

``block_call`` is the block form (the ocean's departure points,
divergence, projection and coefficient builds, the erosion pass, the
packed flow masks of the halo fallback): one pass each, so the halo rows
beyond a pole (the cap, negated for velocities) read as the
single-device shift reads there.  ``pad_block`` and ``crop_block`` are
its two halves, for the rounds of ``dist.halo.diffusion_quirks_sharded``.
``flow_masks_rows`` is the row-group form of the flow's masks: the
pre-blur's horizontal taps reach 1/cos(phi) columns, nearly a whole row
near the poles (``ops.blur``), so the rows must be whole; its blur makes
five passes, so a strip at a pole ends at the pole and reflects there
itself (halo rows beyond a pole would evolve as mirrors only up to the
order of the blur's sums).  ``dist.climate`` runs the climate on the same
strips (``rows_window``).

``local_supported`` says where this applies: an x-periodic grid.  A
grid that does not wrap in x (regional) runs its stages on the gathered
fields (``dist.mesh.sharded_call``; ``block_or_gathered`` picks one or
the other): the halo exchange always wraps its columns (``dist.halo.
_source``), a ``Window``'s shifts roll them, and the reference's halo
solvers take x-periodic grids only.
"""

from __future__ import annotations

import torch

from ..core.grid import Grid, Window
from .halo import exchange_halo, exchange_rows_halo
from .mesh import (Mesh, _map_outputs, block_shape, blocks_to_rows,
                   row_group, sharded_call)


def local_supported(grid: Grid, mesh: Mesh) -> bool:
    """Whether the local stages apply: an x-periodic grid (the mesh must
    split it evenly, and where it reaches a pole put the antipodal cap on
    one x shard, nx even or 1: ``dist.mesh.block_shape`` and ``dist.halo.
    post_halo`` refuse anything else)."""
    return grid.wrap_x


def block_reach(grid: Grid, mesh: Mesh, k: int):
    """The halo rows south and north of this rank's block: k, but none
    beyond a grid edge that is not a pole."""
    south = k if mesh.yi > 0 or grid.wrap_south else 0
    north = k if mesh.yi < mesh.ny - 1 or grid.wrap_north else 0
    return south, north


def block_window(grid: Grid, mesh: Mesh, k: int) -> Window:
    """This rank's block with a k-ring halo, as a window of ``grid``
    (no rows beyond a grid edge that is not a pole: ``block_reach``)."""
    h, w = block_shape(grid.shape, mesh)
    south, north = block_reach(grid, mesh, k)
    return Window(w + 2 * k, h + south + north, grid.coords,
                  grid.circumference, full=(grid.width, grid.height),
                  row0=mesh.yi * h - south, col0=mesh.xi * w - k)


def rows_window(grid: Grid, mesh: Mesh, k: int) -> Window:
    """This rank's row group (``blocks_to_rows``) with k halo rows on
    each side, ending at the grid's first and last row: a row group at a
    pole starts (ends) at the pole's row, where the window reflects as
    the grid does, and at an edge that is not a pole the window clamps as
    the grid does.  The rows of ``exchange_rows_halo``."""
    lo, hi = row_group(grid.height, mesh)
    lo, hi = max(lo - k, 0), min(hi + k, grid.height)
    return Window(grid.width, hi - lo, grid.coords, grid.circumference,
                  full=(grid.width, grid.height), row0=lo, col0=0)


def own_rows(win: Window, grid: Grid, mesh: Mesh) -> slice:
    """The rows of a ``rows_window`` that are this rank's group."""
    lo, hi = row_group(grid.height, mesh)
    return slice(lo - win.row0, hi - win.row0)


def _zero_pad(t: torch.Tensor, k: int) -> torch.Tensor:
    if t.is_floating_point():
        return torch.nn.functional.pad(t, (k, k, k, k))
    out = t.new_zeros((t.shape[0] + 2 * k, t.shape[1] + 2 * k))
    out[k:-k, k:-k] = t
    return out


def pad_block(block, k: int, grid: Grid, mesh: Mesh, halo: bool = True,
              negate: bool = False) -> torch.Tensor:
    """This rank's block padded to ``block_window(grid, mesh, k)``: with
    its k-ring halo (``exchange_halo``, negated beyond a pole where
    ``negate``), or with zeros where ``halo`` is false (an input read
    only at its own pixel)."""
    if k == 0:
        return block
    padded = exchange_halo(block, k, grid, mesh, negate_pole=negate) \
        if halo else _zero_pad(block, k)
    south, north = block_reach(grid, mesh, k)
    return padded[k - south:padded.shape[0] - k + north]


def crop_block(t, grid: Grid, mesh: Mesh, k: int):
    """The inverse of ``pad_block`` for an output of the padded piece (a
    tensor spanning ``block_window``'s rows or columns); anything else as
    it is."""
    if not isinstance(t, torch.Tensor) or k == 0 or t.dim() < 2:
        return t
    win = block_window(grid, mesh, k)
    h, w = block_shape(grid.shape, mesh)
    south, _ = block_reach(grid, mesh, k)
    if t.shape[-2] == win.height:
        t = t[..., south:south + h, :]
    if t.shape[-1] == win.width:
        t = t[..., k:k + w]
    return t.contiguous()


def block_call(fn, mesh: Mesh, k: int, halo=(), negate=()):
    """Run the single-device op ``fn`` on this rank's blocks.  Each 2-D
    tensor argument at a position in ``halo`` is padded with its k-ring
    halo (negated beyond a pole at the positions in ``negate``: velocity
    components), every other 2-D tensor argument with zeros (an input
    read only at its own pixel) (``pad_block``); the ``Grid`` argument
    becomes the padded block's window; each output is cropped back to
    the block (``crop_block``)."""

    def call(*args):
        grid = next(a for a in args if isinstance(a, Grid))
        win = block_window(grid, mesh, k)

        def pad(i, a):
            if a is grid:
                return win
            if not (isinstance(a, torch.Tensor) and a.dim() == 2):
                return a
            return pad_block(a, k, grid, mesh, i in halo, i in negate)

        out = fn(*[pad(i, a) for i, a in enumerate(args)])
        return _map_outputs(out, lambda t: crop_block(t, grid, mesh, k))

    return call


def block_or_gathered(fn, grid: Grid, mesh: Mesh, k: int, halo=(),
                      negate=()):
    """``block_call`` where the local stages apply (``local_supported``:
    an x-periodic grid), else ``dist.mesh.sharded_call``: the op on the
    gathered fields (a regional grid, module docstring)."""
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


def flow_masks_rows(height, sel, grid: Grid, mesh: Mesh, preblur: float):
    """The flow's pre-blur, D8 codes, mouths and packed masks on this
    rank's row group, from its blocks of ``height`` and ``sel``: one
    ``blocks_to_rows`` of each, one row-halo exchange of each as deep as
    the stages' vertical reaches together (``flow_rows_reach``, from
    several ranks away where a group has fewer rows), then the
    single-device ops on the strip (the blur on K5 and the codes on K6's
    codes form on the card), validity shrinking by each stage's reach.
    The strip ends at the grid's first and last row (``rows_window``): at
    a pole the blur's five passes, the codes' clamp (the coordsMod grid)
    and the mouths' reflection are each the single-device op's own, and
    at an edge that is not a pole, the clamp.  Returns (code, mouth,
    packed masks), each (r, W) in the row-group layout
    (``kernels.flow.pack_masks``)."""
    from ..kernels.flow import pack_masks
    from ..ops.blur import blur
    from ..ops.flow import flow_directions, incoming_mask

    k = flow_rows_reach(preblur)
    win = rows_window(grid, mesh, k)

    def strip(x):
        return exchange_rows_halo(blocks_to_rows(x, mesh), k, mesh, grid)

    code = flow_directions(blur(strip(height), win, preblur), strip(sel),
                           win)
    _, mouth, _ = incoming_mask(code, win)
    packed = pack_masks(code, mouth, win)
    own = own_rows(win, grid, mesh)
    return tuple(x[own].contiguous() for x in (code, mouth, packed))

"""Neighbor topology of the spherical lat-lon grid.

Counterpart of ``demiurge_tpu/core/topology.py`` for integer offsets:
``shift(field, dx, dy, grid)`` is the wrap every stencil relies on — the
dateline is a ring in x, the row beyond a pole is the same-latitude row on
the other side of the pole rolled W/2 columns, and everything else clamps
to the edge (GL_CLAMP_TO_EDGE); ``pole_wrap=False`` clamps at the poles too
(the flow pass's "coordsMod" grid).  Also the D8 direction tables of the
flow routing.  The fractional-coordinate samplers are not ported yet.
"""

from __future__ import annotations

import torch

from .grid import Grid


def shift(field: torch.Tensor, dx: int, dy: int, grid: Grid, *,
          pole_wrap: bool = True) -> torch.Tensor:
    """Neighbor value at integer pixel offset (dx, dy) for every pixel:
    ``out[..., r, c] = field[..., wrap(r + dy), wrap(c + dx)]``.

    dy=+1 is the row to the north; dx=+1 is east.
    """
    touches_pole = grid.wrap_south or grid.wrap_north
    if touches_pole and pole_wrap and not grid.wrap_x and dy != 0:
        # the reference reflects through the general nearest sampler here;
        # no ported configuration reaches it yet
        raise NotImplementedError(
            "pole reflection on a grid that is not x-periodic")

    out = field
    if dx != 0:
        if grid.wrap_x:
            out = torch.roll(out, -dx, dims=-1)
        else:
            out = _clamped_shift(out, dx, dim=-1)

    if dy == 0:
        return out
    if grid.wrap_x and pole_wrap and touches_pole:
        return _pole_wrapped_row_shift(out, dy, grid)
    return _clamped_shift(out, dy, dim=-2)


def _clamped_shift(field: torch.Tensor, d: int, dim: int) -> torch.Tensor:
    """Shift by d pixels along ``dim`` with clamp-to-edge."""
    n = field.shape[dim]
    d = max(-n + 1, min(n - 1, d))
    if d == 0:
        return field
    if d > 0:
        body = field.narrow(dim, d, n - d)
        edge = field.narrow(dim, n - 1, 1)
        return torch.cat([body] + [edge] * d, dim=dim)
    body = field.narrow(dim, 0, n + d)
    edge = field.narrow(dim, 0, 1)
    return torch.cat([edge] * (-d) + [body], dim=dim)


def _pole_wrapped_row_shift(field: torch.Tensor, dy: int,
                            grid: Grid) -> torch.Tensor:
    """Row shift with pole reflection: a target row r' = r + dy outside
    [0, H) reflects to -r'-1 (south) or 2H-1-r' (north), with the columns
    rotated by the pole shift."""
    H = field.shape[-2]
    cols = _pole_col_shift(grid)
    if dy < 0 and grid.wrap_south and -dy < H:
        k = -dy
        head = torch.roll(torch.flip(field[..., :k, :], dims=[-2]), -cols,
                          dims=-1)
        return torch.cat([head, field[..., :H - k, :]], dim=-2)
    if dy > 0 and grid.wrap_north and dy < H:
        k = dy
        tail = torch.roll(torch.flip(field[..., H - k:, :], dims=[-2]), -cols,
                          dims=-1)
        return torch.cat([field[..., k:, :], tail], dim=-2)
    return _clamped_shift(field, dy, dim=-2)


def _pole_col_shift(grid: Grid) -> int:
    """Column shift of the pole reflection: half the world, W/2 pixels
    (rounded to the nearest integer for odd W, as the reference does)."""
    return int(round(grid.width / 2))


#: The 8 neighbor offsets in the reference's scan order for steepest-descent
#: style loops (FlowFilter.cpp:181-236).
NEIGHBORS_FLOW_ORDER = ((1, 1), (0, 1), (-1, 1), (1, 0), (-1, 0), (1, -1),
                        (0, -1), (-1, -1))

#: Keypad code of each direction offset (FlowFilter.cpp:159-166); code 5 is
#: the sink (no offset).
DIR_CODE = {(1, 1): 9, (0, 1): 8, (-1, 1): 7, (1, 0): 6, (0, 0): 5,
            (-1, 0): 4, (1, -1): 3, (0, -1): 2, (-1, -1): 1}

#: code -> offset (inverse of DIR_CODE)
CODE_DIR = {v: k for k, v in DIR_CODE.items()}

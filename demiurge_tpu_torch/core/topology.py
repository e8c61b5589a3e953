"""Neighbor topology of the spherical lat-lon grid.

Counterpart of ``demiurge_tpu/core/topology.py``:

- ``shift(field, dx, dy, grid)``, the integer-offset wrap every stencil
  relies on: the dateline is a ring in x, the row beyond a pole is the
  same-latitude row on the other side of the pole rolled W/2 columns, and
  everything else clamps to the edge (GL_CLAMP_TO_EDGE);
  ``pole_wrap=False`` clamps at the poles too (the flow pass's "coordsMod"
  grid).  On a grid that touches a pole but is not x-periodic the
  reflection goes through the general nearest sampler, as in the
  reference;
- the gather samplers for fractional coordinates: ``offset_coords`` (the
  GLSL ``offset()``, src/Shader.h:81-98), ``sample_nearest`` and
  ``sample_bilinear`` (GL_NEAREST / GL_LINEAR with GL_CLAMP_TO_EDGE,
  src/Texture.cpp:19-36) and the ``sample_offset_*`` forms that fetch
  every pixel at an offset;
- the D8 direction tables of the flow routing and ``neighborhood``.
"""

from __future__ import annotations

import math

import torch

from .grid import Grid

PI = math.pi


def shift(field: torch.Tensor, dx: int, dy: int, grid: Grid, *,
          pole_wrap: bool = True) -> torch.Tensor:
    """Neighbor value at integer pixel offset (dx, dy) for every pixel:
    ``out[..., r, c] = field[..., wrap(r + dy), wrap(c + dx)]``.

    dy=+1 is the row to the north; dx=+1 is east.
    """
    touches_pole = grid.wrap_south or grid.wrap_north
    if touches_pole and pole_wrap and not grid.wrap_x and dy != 0:
        # the reflection goes through the spheric mod formula and may
        # clamp: the general sampler, as in the reference
        return sample_offset_nearest(field, float(dx), float(dy), grid,
                                     pole_wrap=pole_wrap)

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


# ---------------------------------------------------------------------------
# General coordinate wrap + samplers (gather path)
# ---------------------------------------------------------------------------


def offset_coords(s, t, ds_pix, dt_pix, grid: Grid, *,
                  pole_wrap: bool = True):
    """The GLSL ``offset()`` (src/Shader.h:81-98) on tex coords: shift
    (s, t) by (ds_pix, dt_pix) pixels (numbers or tensors, may be
    fractional) and wrap.  x is mod-wrapped before and after the pole
    reflection, and the reflection goes through spheric coordinates, as
    in the reference."""
    W, H = grid.width, grid.height
    s = s + ds_pix / W
    t = t + dt_pix / H

    if grid.wrap_x:
        s = torch.remainder(s + 1.0, 1.0)

    if pole_wrap and grid.wrap_south:
        cross = t < 0
        s = torch.where(cross, _antipodal_s(s, grid), s)
        t = torch.where(cross, -t, t)
    if pole_wrap and grid.wrap_north:
        cross = t > 1
        s = torch.where(cross, _antipodal_s(s, grid), s)
        t = torch.where(cross, 2.0 - t, t)

    if grid.wrap_x:
        s = torch.remainder(s + 1.0, 1.0)
    return s, t


def _antipodal_s(s, grid: Grid):
    """s of the longitude half a world round, through the reference's
    lambda -> mod(lambda + 2pi, 2pi) - pi."""
    lam = s * (grid.lam1 - grid.lam0) + grid.lam0
    lam = torch.remainder(lam + 2 * PI, 2 * PI) - PI
    return (lam - grid.lam0) / (grid.lam1 - grid.lam0)


def _texel(x: torch.Tensor, n: int) -> torch.Tensor:
    """Integer texel index of a floored coordinate, clamped to [0, n)."""
    return torch.clamp(torch.clamp(x, -1.0, float(n)).to(torch.int64), 0,
                       n - 1)


def sample_nearest(field: torch.Tensor, s, t) -> torch.Tensor:
    """GL_NEAREST + GL_CLAMP_TO_EDGE fetch of ``field[..., H, W]`` at tex
    coords (s, t) (broadcast against each other)."""
    H, W = field.shape[-2], field.shape[-1]
    c = _texel(torch.floor(s * W), W)
    r = _texel(torch.floor(t * H), H)
    return field[..., r, c]


def sample_bilinear(field: torch.Tensor, s, t) -> torch.Tensor:
    """GL_LINEAR + GL_CLAMP_TO_EDGE fetch at tex coords (s, t): pixel
    centers at ((c+0.5)/W, (r+0.5)/H), taps beyond an edge clamp to the
    edge texel (across the dateline seam too: callers wanting a seamless
    x pre-wrap through ``offset_coords``, as the reference shaders do)."""
    H, W = field.shape[-2], field.shape[-1]
    x = s * W - 0.5
    y = t * H - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    c0, c1 = _texel(x0, W), _texel(x0 + 1, W)
    r0, r1 = _texel(y0, H), _texel(y0 + 1, H)
    v00 = field[..., r0, c0]
    v01 = field[..., r0, c1]
    v10 = field[..., r1, c0]
    v11 = field[..., r1, c1]
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    return top * (1 - fy) + bot * fy


def grid_st(grid: Grid, device):
    """Pixel-center tex coords of the whole grid: (s (1, W), t (H, 1))."""
    s = (torch.arange(grid.width, dtype=torch.float32, device=device)
         + 0.5) / grid.width
    t = (torch.arange(grid.height, dtype=torch.float32, device=device)
         + 0.5) / grid.height
    return s.reshape(1, -1), t.reshape(-1, 1)


def _offset_st(field, dx, dy, grid: Grid, pole_wrap: bool):
    s, t = grid_st(grid, field.device)
    s2, t2 = offset_coords(s, t, dx, dy, grid, pole_wrap=pole_wrap)
    return s2.expand(grid.shape), t2.expand(grid.shape)


def sample_offset_nearest(field: torch.Tensor, dx, dy, grid: Grid, *,
                          pole_wrap: bool = True) -> torch.Tensor:
    """GL_NEAREST fetch at ``offset(st, (dx, dy))`` for every pixel; dx
    and dy may be fractional and per-row tensors ((H, 1)), as in the
    1/cos(phi)-stretched stencils.  For integer offsets ``shift`` does
    the same without a gather."""
    return sample_nearest(field, *_offset_st(field, dx, dy, grid, pole_wrap))


def sample_offset_bilinear(field: torch.Tensor, dx, dy, grid: Grid, *,
                           pole_wrap: bool = True) -> torch.Tensor:
    """GL_LINEAR fetch at ``offset(st, (dx, dy))`` for every pixel."""
    return sample_bilinear(field,
                           *_offset_st(field, dx, dy, grid, pole_wrap))


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


def neighborhood(field: torch.Tensor, grid: Grid, *, pole_wrap: bool = True
                 ) -> dict:
    """{(dx, dy): shifted field} over the 3x3 neighborhood (without the
    center), in ``NEIGHBORS_FLOW_ORDER``."""
    return {(dx, dy): shift(field, dx, dy, grid, pole_wrap=pole_wrap)
            for (dx, dy) in NEIGHBORS_FLOW_ORDER}

"""Selection tools.

Counterpart of ``demiurge_tpu/select/selection.py``.  The selection is an
(H, W) float field in [0, 1] that every filter samples (the reference's
'sel' texture); candidates combine into it through
``ops.blend.selection_mode``.

- all / inverse            (AllSelect.cpp:8-25, InverseSelection.cpp:9-36)
- by height range          (HeightSelection.cpp:39-66)
- spherical-triangle lasso (FreeSelection.cpp:40-188): each mouse-move
  triangle (first, prev, cur) toggles the parity of the pixels inside it;
  a final 4-neighbour vote despeckles
- grow / shrink / border   (morphology on the selection)
- blur                     (BlurSelection.cpp:9-22)

The lasso's plane normals are Python float math, as in the reference; the
pixel points are computed on the device, so a pixel within an ulp of a
triangle's edge may take the other side there.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from ..core.grid import Grid
from ..core.topology import shift
from ..ops.blend import selection_mode
from ..ops.blur import blur
from ..ops.morphological import dilate, erode, morphological_gradient


def select_all(grid: Grid, device):
    """AllSelect: sel = 1."""
    return torch.ones(grid.shape, dtype=torch.float32, device=device)


def select_none(grid: Grid, device):
    return torch.zeros(grid.shape, dtype=torch.float32, device=device)


def invert(sel):
    """InverseSelection: 1 - sel."""
    return 1.0 - sel


def by_height(height, lower: float, upper: float):
    """HeightSelectFilter: 1 where lower <= h <= upper."""
    return torch.where((height >= lower) & (height <= upper), 1.0, 0.0)


def apply_selection(sel, candidate, mode: str = "replace"):
    """Combine a candidate mask into the selection (selection_mode)."""
    return selection_mode(sel, candidate, mode)


# ---------------------------------------------------------------------------
# lasso (FreeSelection)
# ---------------------------------------------------------------------------


def _to_cartesian(grid: Grid, st):
    lam = st[0] * (grid.lam1 - grid.lam0) + grid.lam0
    phi = st[1] * (grid.phi1 - grid.phi0) + grid.phi0
    return (math.cos(phi) * math.cos(lam), math.cos(phi) * math.sin(lam),
            math.sin(phi))


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def lasso_triangle(parity, grid: Grid, first, prev, cur):
    """Toggle the parity inside the spherical triangle (first, prev, cur)
    (FreeSelection.cpp:74-133).  Points are (s, t) tex coords; ``parity``
    is the accumulating 0/1 field."""
    A = _to_cartesian(grid, cur)
    B = _to_cartesian(grid, prev)
    C = _to_cartesian(grid, first)
    a = _cross(A, B)
    b = _cross(B, C)
    c = _cross(C, A)
    avg = tuple(A[i] + B[i] + C[i] for i in range(3))
    s = math.copysign(1.0, sum(a[i] * avg[i] for i in range(3)))

    lam, phi = grid.lam_phi(parity.device)
    Px = torch.cos(phi) * torch.cos(lam)
    Py = torch.cos(phi) * torch.sin(lam)
    Pz = torch.sin(phi) * torch.ones_like(lam)

    def halfplane(n):
        return s * (n[0] * Px + n[1] * Py + n[2] * Pz) > 0

    inside = (halfplane(a) & halfplane(b) & halfplane(c)).expand(grid.shape)
    return torch.where(inside, 1.0 - parity, parity)


def lasso_finalize(parity, sel, grid: Grid, mode: str = "replace"):
    """Despeckle by a 4-neighbour vote, then combine
    (FreeSelection.cpp:146-180)."""
    a = (shift(parity, 1, 0, grid) + shift(parity, -1, 0, grid)
         + shift(parity, 0, 1, grid) + shift(parity, 0, -1, grid))
    val = torch.where(a == 0, 0.0, parity)
    val = torch.where(a == 4, 1.0, val)
    return apply_selection(sel, val, mode)


def lasso(sel, grid: Grid, path: Sequence[Tuple[float, float]],
          mode: str = "replace"):
    """A whole lasso stroke: triangles fanned from path[0] over
    consecutive pairs."""
    parity = torch.zeros(grid.shape, dtype=torch.float32, device=sel.device)
    if len(path) >= 3:
        first = path[0]
        for prev, cur in zip(path[1:-1], path[2:]):
            if cur == prev or cur == first or prev == first:
                continue
            parity = lasso_triangle(parity, grid, first, prev, cur)
    return lasso_finalize(parity, sel, grid, mode)


# ---------------------------------------------------------------------------
# morphology-based tools
# ---------------------------------------------------------------------------


def grow(sel, grid: Grid, radius: float):
    """GrowShrinkSelection (grow): dilate the selection."""
    return dilate(sel, grid, radius)


def shrink(sel, grid: Grid, radius: float):
    """GrowShrinkSelection (shrink): erode the selection."""
    return erode(sel, grid, radius)


def border(sel, grid: Grid, radius: float):
    """BorderSelection: the morphological gradient of the selection."""
    return morphological_gradient(sel, grid, radius)


def blur_selection(sel, grid: Grid, radius: float):
    """BlurSelection: the Gaussian blur of the selection."""
    return blur(sel, grid, radius)

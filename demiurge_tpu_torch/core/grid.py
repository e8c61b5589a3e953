"""Lat-lon grid specification for the spherical heightfield.

Counterpart of ``demiurge_tpu/core/grid.py``: a static (hashable) grid spec.
Fields are ``(H, W)`` float32 tensors with row 0 = southernmost row and
column 0 at the west edge; pixel centers sit at ((c+0.5)/W, (r+0.5)/H) in
tex coords.  The grid itself holds no tensors: each method that returns one
takes the ``device`` to build it on.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

PI = math.pi


@dataclasses.dataclass(frozen=True)
class Grid:
    """coords = (phi0, phi1, lam0, lam1): south lat, north lat, west lon,
    east lon (radians); circumference in km."""

    width: int
    height: int
    coords: Tuple[float, float, float, float] = (-PI / 2, PI / 2, -PI, PI)
    circumference: float = 42000.0

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.height, self.width)

    @property
    def phi0(self) -> float:
        return self.coords[0]

    @property
    def phi1(self) -> float:
        return self.coords[1]

    @property
    def lam0(self) -> float:
        return self.coords[2]

    @property
    def lam1(self) -> float:
        return self.coords[3]

    @property
    def wrap_x(self) -> bool:
        """Dateline-periodic in x."""
        return self.lam0 < -PI + 1e-4 and self.lam1 > PI - 1e-3

    @property
    def wrap_south(self) -> bool:
        """South pole included -> rows below row 0 reflect."""
        return self.phi0 < -PI / 2 + 1e-4

    @property
    def wrap_north(self) -> bool:
        """North pole included -> rows above row H-1 reflect."""
        return self.phi1 > PI / 2 - 1e-4

    def spheric_to_tex(self, lam, phi):
        s = (lam - self.lam0) / (self.lam1 - self.lam0)
        t = (phi - self.phi0) / (self.phi1 - self.phi0)
        return s, t

    def row_t(self, device) -> torch.Tensor:
        """t coordinate of each row center, shape (H, 1)."""
        r = torch.arange(self.height, dtype=torch.float32, device=device)
        return ((r + 0.5) / self.height).reshape(-1, 1)

    def col_s(self, device) -> torch.Tensor:
        """s coordinate of each column center, shape (1, W)."""
        c = torch.arange(self.width, dtype=torch.float32, device=device)
        return ((c + 0.5) / self.width).reshape(1, -1)

    def row_phi(self, device) -> torch.Tensor:
        """Latitude of each row center, shape (H, 1) float32."""
        return self.row_t(device) * (self.phi1 - self.phi0) + self.phi0

    def col_lam(self, device) -> torch.Tensor:
        """Longitude of each column center, shape (1, W) float32."""
        return self.col_s(device) * (self.lam1 - self.lam0) + self.lam0

    def lam_phi(self, device):
        """Broadcastable (lambda (1,W), phi (H,1)) pair of pixel centers."""
        return self.col_lam(device), self.row_phi(device)

    def row_spacing(self) -> float:
        """dy, the constant pixel height in circumference units, rounded to
        float32 as the reference computes it."""
        scale = self.circumference / (2 * PI)
        return float(np.float32((self.phi1 - self.phi0) * scale
                                / self.height))

    def pixelsize_rows(self, device):
        """Physical pixel size (dx (H,1), dy 0-d) in circumference units."""
        phi = self.row_phi(device)
        scale = self.circumference / (2 * PI)
        dx = (self.lam1 - self.lam0) * torch.cos(phi) * scale / self.width
        # a fill, not a copy from the host: no stream synchronisation
        dy = torch.full((), self.row_spacing(), dtype=torch.float32,
                        device=device)
        return dx, dy

    def cell_area_rows(self, device) -> torch.Tensor:
        """Per-row pixel area dx*dy, shape (H, 1)."""
        dx, dy = self.pixelsize_rows(device)
        return dx * dy

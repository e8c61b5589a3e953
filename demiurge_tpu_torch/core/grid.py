"""Lat-lon grid specification for the spherical heightfield.

Counterpart of ``demiurge_tpu/core/grid.py``: a static (hashable) grid spec.
Fields are ``(H, W)`` float32 tensors with row 0 = southernmost row and
column 0 at the west edge; pixel centers sit at ((c+0.5)/W, (r+0.5)/H) in
tex coords.  The grid itself holds no tensors: each method that returns one
takes the ``device`` to build it on.  The vector helpers at the end work
on tuples of tensors (or of anything torch's elementwise ops take).
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

    @property
    def radius(self) -> float:
        return self.circumference / (2 * PI)

    def tex_to_spheric(self, s, t):
        """(s, t) in [0,1]^2 -> (lambda, phi) radians."""
        lam = s * (self.lam1 - self.lam0) + self.lam0
        phi = t * (self.phi1 - self.phi0) + self.phi0
        return lam, phi

    def spheric_to_tex(self, lam, phi):
        s = (lam - self.lam0) / (self.lam1 - self.lam0)
        t = (phi - self.phi0) / (self.phi1 - self.phi0)
        return s, t

    @property
    def base(self) -> "Grid":
        """The whole grid this grid's tables are cut from: itself (a
        ``Window``'s is the grid it is a window of)."""
        return self

    def rows_np(self) -> np.ndarray:
        """The grid row each row reads its tables from, int64 (H,)."""
        return np.arange(self.height)

    def row_numbers(self, device) -> torch.Tensor:
        """Each row's number in the whole grid, int64 (H, 1) (a
        ``Window``'s rows past a pole count on below 0 and from H)."""
        return torch.arange(self.height, device=device).reshape(-1, 1)

    def row_index(self, device) -> torch.Tensor:
        """The grid row each row reads its tables from, int64 (H,)."""
        return torch.arange(self.height, device=device)

    def col_index(self, device) -> torch.Tensor:
        """The grid column of each column, int64 (W,)."""
        return torch.arange(self.width, device=device)

    def cut(self, t: torch.Tensor) -> torch.Tensor:
        """A table of the whole grid, as this grid reads it: itself (a
        ``Window`` cuts its rows and columns)."""
        return t

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

    def geodistance_tex(self, p1, p2) -> torch.Tensor:
        """Haversine distance between two tex-coord points (pairs of
        tensors; one of them may be a pair of Python numbers, taken as
        float32 where a function of it is), in x-pixel units (the GLSL
        ``geodistance``, which scales by size.x/(lam1-lam0))."""
        l1, f1 = self.tex_to_spheric(p1[0], p1[1])
        l2, f2 = self.tex_to_spheric(p2[0], p2[1])
        dev = (f1 if isinstance(f1, torch.Tensor) else f2).device

        def cos(f):
            if not isinstance(f, torch.Tensor):
                f = torch.full((), f, dtype=torch.float32, device=dev)
            return torch.cos(f)

        inner = (torch.sin(torch.abs(f2 - f1) / 2) ** 2
                 + cos(f1) * cos(f2)
                 * torch.sin((l1 - l2) / 2) ** 2)
        delta_sigma = 2 * torch.asin(torch.sqrt(inner))
        return delta_sigma / (self.lam1 - self.lam0) * self.width


_WINDOW_INDEX: dict = {}  # (window, axis, device) -> index tensor


@dataclasses.dataclass(frozen=True)
class Window(Grid):
    """A rectangle of a global grid, reaching past its poles where it
    must: a rank's block or row group with its halo (``dist.local``).

    ``width`` and ``height`` are the window's own, the shape of its
    fields; ``full`` is the grid's (W, H).  The window's row i and column
    j are the grid's row ``row0 + i`` and column ``(col0 + j) mod W``; a
    row past a pole is the row the pole reflects it to (row -1 is row 0,
    row H is row H - 1, and so on), as far as the tables go: a per-row or
    per-column table of a window is the grid's own table cut at those
    rows and columns (``cut``), so it holds the same bits, and the
    per-pixel tables built from the indices (``row_index``,
    ``col_index``) read the global coordinates.  ``shift`` rolls the
    window's columns; at its first and last rows it reflects over a pole
    where the window spans the whole width from that pole's row, as the
    grid does (a row group's window), and clamps anywhere else: at the
    grid's own edge where that is not a pole, as the grid does, and where
    its halo rows stand beyond a pole or inside the grid, where a stencil
    of reach k then leaves the k rings inside the edge stale and the
    caller crops them.  For any x-periodic grid.

    ``width`` and ``height`` are not the globe's: every ``Grid`` method
    that reads them is overridden here, to read ``full`` or the cut
    tables, or to raise where a window has no answer (``geodistance_tex``
    scales by the globe's width: ask ``base``)."""

    full: Tuple[int, int] = (0, 0)
    row0: int = 0
    col0: int = 0

    @property
    def base(self) -> Grid:
        """The whole grid, with the window's coords (a coordsMod window's
        base is the coordsMod grid)."""
        return Grid(self.full[0], self.full[1], self.coords,
                    self.circumference)

    @property
    def _whole_rows(self) -> bool:
        return self.col0 == 0 and self.width == self.full[0]

    @property
    def wrap_south(self) -> bool:
        return (self.row0 == 0 and self._whole_rows
                and self.base.wrap_south)

    @property
    def wrap_north(self) -> bool:
        return (self.row0 + self.height == self.full[1] and self._whole_rows
                and self.base.wrap_north)

    def row_numbers(self, device) -> torch.Tensor:
        return torch.arange(self.row0, self.row0 + self.height,
                            device=device).reshape(-1, 1)

    def rows_np(self) -> np.ndarray:
        """The grid row each window row reads (poles reflected), int64."""
        H = self.full[1]
        g = np.arange(self.row0, self.row0 + self.height)
        g = np.where(g < 0, -1 - g, g)
        return np.where(g >= H, 2 * H - 1 - g, g)

    def cols_np(self) -> np.ndarray:
        return (self.col0 + np.arange(self.width)) % self.full[0]

    def _index(self, axis: str, device) -> torch.Tensor:
        key = (self, axis, str(device))
        if key not in _WINDOW_INDEX:
            idx = self.rows_np() if axis == "rows" else self.cols_np()
            _WINDOW_INDEX[key] = torch.from_numpy(idx).to(device)
        return _WINDOW_INDEX[key]

    def row_index(self, device) -> torch.Tensor:
        return self._index("rows", device)

    def col_index(self, device) -> torch.Tensor:
        return self._index("cols", device)

    def cut(self, t: torch.Tensor) -> torch.Tensor:
        """The window's part of a table of the whole grid: rows where
        ``t`` spans the grid's H rows (dim -2, or dim 0 of a 1-D table),
        columns where it spans the W columns (dim -1)."""
        W, H = self.full
        if t.dim() == 1:
            return t.index_select(0, self.row_index(t.device))
        if t.shape[-2] == H:
            t = t.index_select(t.dim() - 2, self.row_index(t.device))
        if t.shape[-1] == W:
            t = t.index_select(t.dim() - 1, self.col_index(t.device))
        return t

    def row_t(self, device) -> torch.Tensor:
        return self.cut(self.base.row_t(device))

    def col_s(self, device) -> torch.Tensor:
        return self.cut(self.base.col_s(device))

    def row_spacing(self) -> float:
        return self.base.row_spacing()

    def pixelsize_rows(self, device):
        dx, dy = self.base.pixelsize_rows(device)
        return self.cut(dx), dy

    def geodistance_tex(self, p1, p2) -> torch.Tensor:
        raise NotImplementedError(
            "a window has no globe-wide texture scale: use its base grid")


def rdiv(num: float, t: torch.Tensor) -> torch.Tensor:
    """float32 ``num / t`` rounded once, as the reference divides (torch's
    ``number / tensor`` is a reciprocal and a product)."""
    return torch.full_like(t, num) / t


def spheric_to_cartesian(lam, phi):
    """(lambda, phi) -> unit vector (x, y, z) (src/Shader.h:61-63)."""
    return (torch.cos(phi) * torch.cos(lam), torch.cos(phi) * torch.sin(lam),
            torch.sin(phi))


def cartesian_to_spheric(x, y, z):
    """Unit vector -> (lambda, phi) (src/Shader.h:65-67)."""
    return torch.atan2(y, x), torch.asin(torch.clamp(z, -1.0, 1.0))


def rotation_matrix(theta, u):
    """Axis-angle rotation matrix (src/Shader.h:33-41) as nested row
    tuples, so that ``apply_rotation(R, v)`` is the GLSL
    ``rotation_matrix(theta, u) * v``.  ``theta`` a tensor or a number
    (taken as float32); ``u`` three components."""
    ux, uy, uz = u
    theta = torch.as_tensor(theta, dtype=torch.float32)
    c = torch.cos(theta)
    s = torch.sin(theta)
    omc = 1.0 - c
    return (
        (c + ux * ux * omc, ux * uy * omc - uz * s, ux * uz * omc + uy * s),
        (uy * ux * omc + uz * s, c + uy * uy * omc, uy * uz * omc - ux * s),
        (uz * ux * omc - uy * s, uz * uy * omc + ux * s, c + uz * uz * omc),
    )


def apply_rotation(R, v):
    """R @ v for the nested-tuple layout of ``rotation_matrix``."""
    vx, vy, vz = v
    return (R[0][0] * vx + R[0][1] * vy + R[0][2] * vz,
            R[1][0] * vx + R[1][1] * vy + R[1][2] * vz,
            R[2][0] * vx + R[2][1] * vy + R[2][2] * vz)


def normalize3(v, eps: float = 0.0):
    vx, vy, vz = v
    n = torch.sqrt(vx * vx + vy * vy + vz * vz + eps)
    return (vx / n, vy / n, vz / n)


def cross3(a, b):
    ax, ay, az = a
    bx, by, bz = b
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def tangent_basis(lam, phi):
    """East and north unit tangent vectors at (lambda, phi), the
    reference's ``cartesian_to_v`` basis (src/Shader.h:101-117)."""
    east = (-torch.sin(lam), torch.cos(lam),
            torch.zeros_like(lam) * torch.ones_like(phi))
    north = (-torch.sin(phi) * torch.cos(lam),
             -torch.sin(phi) * torch.sin(lam),
             torch.cos(phi) * torch.ones_like(lam))
    return east, north


def v_to_cartesian(vx, vy, lam, phi):
    """Tangent (east, north) components -> 3D vector
    (OceanCurrents.cpp:251-258)."""
    east, north = tangent_basis(lam, phi)
    return (vx * east[0] + vy * north[0], vx * east[1] + vy * north[1],
            vx * east[2] + vy * north[2])


def cartesian_to_v(v, lam, phi, subtract_radial: bool = False):
    """3D vector -> tangent (east, north) components; with
    ``subtract_radial`` the radial component is projected out first, as
    src/Shader.h:104-116 does."""
    if subtract_radial:
        r = spheric_to_cartesian(lam, phi)
        v = tuple(vi - dot3(v, r) / dot3(r, r) * ri for vi, ri in zip(v, r))
    east, north = tangent_basis(lam, phi)
    return dot3(v, east), dot3(v, north)

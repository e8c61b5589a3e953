"""Interactive spherical brush painting.

Counterpart of ``demiurge_tpu/ops/brush.py`` (the reference's BrushWindow,
src/menus/BrushWindow.cpp):

- ``brush_profile``: the 512x512 integrated brush profile LUT, in numpy:
  row d holds the running line integral of the radial falloff (cos^2
  beyond the hardness radius) across a chord at normalized distance d
  from the stroke line (set_hardness, BrushWindow.cpp:232-272), with the
  reference's initial-value quirk ``current + i*step`` on the row index;
- ``stroke_rotation``: the rotation that puts a segment on the equator
  (BrushWindow.cpp:185-211), in float64 numpy;
- ``segment_accumulate``: one segment's LUT line-integral difference
  added into the stroke accumulator on the device (brush_calc,
  BrushWindow.cpp:116-155); the clamped bilinear LUT fetch is one gather
  of its four taps;
- ``composite``: terrain = backup + value * min(accum, limit)
  (BrushWindow.cpp:214-230).

A stroke is ``BrushStroke``: init (backup terrain, zero accumulator), one
``segment`` per mouse move, ``finish`` (the diff against the backup, for
the undo history).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.grid import Grid
from ..core.platform import host_to_device

PI = math.pi

BRUSH_TEX_SIZE = 512


def brush_profile(hardness: float, n: int = BRUSH_TEX_SIZE) -> np.ndarray:
    """Integrated brush profile LUT (set_hardness, BrushWindow.cpp:232-272).

    Returns (n, n) float32: row i = chord at distance d = i/(n-1), column
    j = running trapezoidal integral of the falloff along the chord.
    """
    def brush_val(r):
        phi = r  # R = 1
        c = PI * phi / (2 * (1 - hardness)) + PI / 2 * (1 - 1 / (1 - hardness))
        return np.where(phi <= hardness, 1.0, np.cos(c) ** 2)

    i = np.arange(n, dtype=np.float64).reshape(-1, 1)
    j = np.arange(n, dtype=np.float64).reshape(1, -1)
    d = i / (n - 1)
    width = np.sqrt(np.maximum(1 - d * d, 0.0))
    step = 2 * width / (n - 1)

    # reference quirk: the initial 'current_val' uses current + i*step with
    # the *row* index i (BrushWindow.cpp:261)
    init_r = np.sqrt(d * d + (-width + i * step) ** 2)
    init_val = brush_val(init_r)

    current = -width + (j + 1) * step  # after the j-th 'current += step'
    r = np.sqrt(d * d + current ** 2)
    vals = brush_val(r)
    prev_vals = np.concatenate([init_val, vals[:, :-1]], axis=1)
    contrib = (prev_vals + vals) / 2 * step
    return np.cumsum(contrib, axis=1).astype(np.float32)


def _rotz(a):
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float64)


def _roty(a):
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)


def _rotx(a):
    c, s = math.cos(a), math.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float64)


def stroke_rotation(grid: Grid, pos, prev) -> np.ndarray:
    """Rotation (float32 (3, 3)) that puts the segment prev -> pos on the
    equator through lon 0 (BrushWindow.cpp:185-211)."""
    v = grid.coords
    dtheta = pos[0] * (v[3] - v[2]) + v[2]
    R = _rotz(-dtheta)
    dphi = pos[1] * (v[1] - v[0]) + v[0]
    R = _roty(dphi) @ R

    phi = prev[1] * (v[1] - v[0]) + v[0]
    theta = prev[0] * (v[3] - v[2]) + v[2]
    p = np.array([
        math.sin(PI / 2 - phi) * math.cos(theta),
        math.sin(PI / 2 - phi) * math.sin(theta),
        math.cos(PI / 2 - phi),
    ])
    pr = R @ p
    dtheta2 = -math.atan2(pr[2], pr[1])
    return (_rotx(dtheta2) @ R).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class BrushParams:
    size: float = 30.0       # pixels (brush_size)
    value: float = 1.0
    flow: float = 1.0
    hardness: float = 0.5
    limit: float = float("inf")


def _sample_lut_bilinear(lut, x, y):
    """Bilinear LUT fetch with clamp (GL texture semantics): the four taps
    of every pixel as one gather on the flattened LUT."""
    n = lut.shape[0]
    xi = torch.clamp(x * n - 0.5, 0.0, n - 1.0)
    yi = torch.clamp(y * n - 0.5, 0.0, n - 1.0)
    x0 = torch.floor(xi).to(torch.int64)
    y0 = torch.floor(yi).to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=n - 1)
    y1 = torch.clamp(y0 + 1, max=n - 1)
    fx = xi - x0
    fy = yi - y0
    idx = torch.stack([y0 * n + x0, y0 * n + x1, y1 * n + x0, y1 * n + x1])
    v00, v01, v10, v11 = lut.reshape(-1)[idx]
    return ((v00 * (1 - fx) + v01 * fx) * (1 - fy)
            + (v10 * (1 - fx) + v11 * fx) * fy)


def _matvec_fma(R, m):
    """R @ m for a 3x3 float32 R, each row a chain of fused multiply-adds
    in column order, as XLA's dot rounds it (exact products in float64,
    one rounding to float32 a step)."""
    R64, m64 = R.double(), m.double()
    acc = (R64[:, 0] * m64[0]).float()
    for j in (1, 2):
        acc = (R64[:, j] * m64[j] + acc.double()).float()
    return acc


def segment_accumulate(accum, sel, lut, rotation, mouse_prev, grid: Grid,
                       size, flow):
    """Add one segment's line-integral contribution to the accumulator
    (brush_calc + brush_shader, BrushWindow.cpp:116-178).  ``lut``,
    ``rotation`` and ``mouse_prev`` are float32 tensors on ``accum``'s
    device; ``size`` and ``flow`` numbers (taken as float32, as the
    reference's traced scalars are)."""
    dev = accum.device
    size = torch.tensor(size, dtype=torch.float32, device=dev)
    flow = torch.tensor(flow, dtype=torch.float32, device=dev)
    lam, phi = grid.lam_phi(dev)
    px = torch.cos(phi) * torch.cos(lam)
    py = torch.cos(phi) * torch.sin(lam)
    pz = torch.sin(phi) * torch.ones_like(lam)
    R = rotation
    rx = R[0, 0] * px + R[0, 1] * py + R[0, 2] * pz
    ry = R[1, 0] * px + R[1, 1] * py + R[1, 2] * pz
    rz = R[2, 0] * px + R[2, 1] * py + R[2, 2] * pz
    p_x = torch.atan2(ry, rx).expand(grid.shape)
    p_y = torch.asin(torch.clamp(rz, -1.0, 1.0)).expand(grid.shape)

    mlam = mouse_prev[0] * (grid.lam1 - grid.lam0) + grid.lam0
    mphi = mouse_prev[1] * (grid.phi1 - grid.phi0) + grid.phi0
    m = torch.stack([torch.cos(mphi) * torch.cos(mlam),
                     torch.cos(mphi) * torch.sin(mlam), torch.sin(mphi)])
    m = _matvec_fma(R, m)
    m_x = torch.atan2(m[1], m[0])

    factor = grid.width / (grid.lam1 - grid.lam0)
    d = torch.abs(p_y) * factor
    inside = d < size
    width = torch.sqrt(torch.clamp(size * size - d * d, min=1e-12))

    rightstart = torch.maximum(-width, torch.minimum(p_x, width))
    leftend = torch.minimum(m_x + width,
                            torch.maximum(p_x, m_x - width)) - m_x

    stop = rightstart * factor
    start = leftend * factor
    vstop_x = stop / width / 2 + 0.5
    vstart_x = start / width / 2 + 0.5
    vy = d / size

    contrib = (_sample_lut_bilinear(lut, vstop_x, vy)
               - _sample_lut_bilinear(lut, vstart_x, vy))
    contrib = torch.where(inside, contrib, 0.0)
    return accum + flow * sel * contrib


def composite(backup, accum, value, limit):
    """terrain = backup + value * min(accum, limit)
    (BrushWindow.cpp:214-230)."""
    return backup + value * torch.clamp(accum, max=limit)


class BrushStroke:
    """A stroke: init -> segment(...) -> finish()."""

    def __init__(self, height, sel, grid: Grid, params: BrushParams):
        self.grid = grid
        self.params = params
        self.backup = height
        self.sel = sel
        self.accum = torch.zeros_like(height)
        self.lut = host_to_device(brush_profile(params.hardness),
                                  height.device)
        self.height = height

    def segment(self, pos, prev):
        dev = self.accum.device
        R = host_to_device(stroke_rotation(self.grid, pos, prev), dev)
        mouse = host_to_device(np.asarray(prev, np.float32), dev)
        self.accum = segment_accumulate(
            self.accum, self.sel, self.lut, R, mouse, self.grid,
            self.params.size, self.params.flow)
        self.height = composite(self.backup, self.accum, self.params.value,
                                self.params.limit)
        return self.height

    def finish(self):
        """(height, diff against the backup) for the undo history."""
        return self.height, self.backup - self.height

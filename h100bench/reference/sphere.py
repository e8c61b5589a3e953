"""The global lat-lon grid of the plain references, in plain PyTorch.

Fields are (H, W) tensors, row 0 the southernmost, column 0 at the
dateline; pixel centres at ((c + 0.5) / W, (r + 0.5) / H) in texture
coordinates.  The grid spans the whole globe (longitude -pi..pi, latitude
-pi/2..pi/2, circumference 42000 km), so x is periodic and a row beyond a
pole is the row of the same latitude half a world round.  Every table is
built in float32 and cast to the field's dtype by the caller, so the same
code runs in a lower precision for the control.

This file and the others of ``reference/`` import nothing of the program:
they are the benchmark's yardstick.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PI = math.pi
PHI0, PHI1, LAM0, LAM1 = -PI / 2, PI / 2, -PI, PI
CIRCUMFERENCE = 42000.0
SCALE = CIRCUMFERENCE / (2 * PI)   # km per radian

#: the 8 neighbour offsets (dx, dy) in the flow's scan order, and the keypad
#: code of each direction (5 = sink)
SCAN = ((1, 1), (0, 1), (-1, 1), (1, 0), (-1, 0), (1, -1), (0, -1), (-1, -1))
CODE = {(1, 1): 9, (0, 1): 8, (-1, 1): 7, (1, 0): 6, (0, 0): 5, (-1, 0): 4,
        (1, -1): 3, (0, -1): 2, (-1, -1): 1}
OFFSET = {c: d for d, c in CODE.items()}


def row_t(H: int, device) -> torch.Tensor:
    r = torch.arange(H, dtype=torch.float32, device=device)
    return ((r + 0.5) / H).reshape(-1, 1)


def row_phi(H: int, device, phi0: float = PHI0, phi1: float = PHI1
            ) -> torch.Tensor:
    """Latitude of each row centre, (H, 1) float32."""
    return row_t(H, device) * (phi1 - phi0) + phi0


def col_lam(W: int, device) -> torch.Tensor:
    c = torch.arange(W, dtype=torch.float32, device=device)
    return ((c + 0.5) / W).reshape(1, -1) * (LAM1 - LAM0) + LAM0


def row_spacing(H: int, phi0: float = PHI0, phi1: float = PHI1) -> float:
    """dy in km, rounded to float32."""
    return float(np.float32((phi1 - phi0) * SCALE / H))


def pixel_size(H: int, W: int, device, phi0: float = PHI0,
               phi1: float = PHI1):
    """(dx (H, 1), dy 0-d): the physical pixel size in km."""
    phi = row_phi(H, device, phi0, phi1)
    dx = (LAM1 - LAM0) * torch.cos(phi) * SCALE / W
    dy = torch.full((), row_spacing(H, phi0, phi1), dtype=torch.float32,
                    device=device)
    return dx, dy


def shift(f: torch.Tensor, dx: int, dy: int, poles: bool = True
          ) -> torch.Tensor:
    """out[..., r, c] = f[..., r + dy, (c + dx) mod W]: x periodic; a row
    beyond a pole reflects to the other side, half a world round
    (``poles``), or clamps to the edge row (``poles=False``)."""
    out = torch.roll(f, -dx, dims=-1) if dx else f
    if dy == 0:
        return out
    H, W = out.shape[-2], out.shape[-1]
    k = abs(dy)
    if poles:
        turn = int(round(W / 2))
        if dy < 0:
            head = torch.roll(torch.flip(out[..., :k, :], dims=[-2]), -turn,
                              dims=-1)
            return torch.cat([head, out[..., :H - k, :]], dim=-2)
        tail = torch.roll(torch.flip(out[..., H - k:, :], dims=[-2]), -turn,
                          dims=-1)
        return torch.cat([out[..., k:, :], tail], dim=-2)
    if dy < 0:
        return torch.cat([out[..., :1, :]] * k + [out[..., :H - k, :]],
                         dim=-2)
    return torch.cat([out[..., k:, :]] + [out[..., H - 1:, :]] * k, dim=-2)


def roll_rows(f: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    """f[..., r, (c + k_r) mod W] for per-row integer shifts (numpy (H,))."""
    W = f.shape[-1]
    k = torch.from_numpy(np.asarray(k, np.int64).reshape(-1, 1) % W).to(
        f.device)
    idx = torch.remainder(torch.arange(W, device=f.device).reshape(1, -1)
                          + k, W)
    return torch.gather(f, -1, idx.expand(f.shape))


def inv_cos_rows(H: int) -> np.ndarray:
    """1/cos(phi) of each row centre, in float32 numpy."""
    t = (np.arange(H, dtype=np.float32) + np.float32(0.5)) / np.float32(H)
    phi = t * np.float32(PHI1 - PHI0) + np.float32(PHI0)
    return np.float32(1.0) / np.cos(phi)

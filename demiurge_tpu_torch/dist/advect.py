"""The semi-Lagrangian tap sampler on blocks: one halo exchange for the
whole tap loop.

Counterpart of ``demiurge_tpu/dist/advect.py``.  The (2k)-wide halo, k =
max(Rx, Ry), is exchanged once and the hat-weighted taps become slices of
the padded block.  Semantics of the single-radius sampler
(``kernels.advect`` with ``global_meta(Rx)``): x taps periodic over the
dateline, y taps clamped at the grid edge (GL_CLAMP_TO_EDGE), dx and dy
clipped to the radii, the taps summed in the same order.  One global
radius, not the polar hybrid of the single-card tiered sampler: a
displacement beyond Rx columns (near the poles) is clamped here.  Plain
PyTorch on each rank; the rank-local tap sum on the sampler kernel is
later work.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.grid import Grid
from .halo import exchange_halo
from .mesh import Mesh


def _exchange_clamped(block, k: int, grid: Grid, mesh: Mesh):
    """(h+2k, w+2k) halo pad: x ring-periodic, y clamped at the grid's
    first and last rows (not the pole wrap)."""
    y0, y1, x0, x1 = grid.coords
    flat = dataclasses.replace(grid, coords=(y0 + 1e-3, y1 - 1e-3, x0, x1))
    padded = exchange_halo(block, k, flat, mesh)
    h2 = padded.shape[0]
    if mesh.yi == 0:
        padded = torch.cat([padded[k:k + 1].expand(k, -1), padded[k:]])
    if mesh.yi == mesh.ny - 1:
        padded = torch.cat([padded[:h2 - k],
                            padded[h2 - k - 1:h2 - k].expand(k, -1)])
    return padded


def advect_sample_sharded(u, v, s2, t2, grid: Grid, mesh: Mesh,
                          Rx: int = 8, Ry: int = 2):
    """Bilinear fetch of this rank's (u, v) blocks at backtraced tex
    coords (s2, t2) by the tap sum: one halo exchange, then local taps."""
    H, W = grid.shape
    k = max(Rx, Ry)
    h, w = u.shape
    c = mesh.xi * w + torch.arange(w, dtype=torch.float32,
                                   device=u.device).reshape(1, -1)
    r = mesh.yi * h + torch.arange(h, dtype=torch.float32,
                                   device=u.device).reshape(-1, 1)
    dx = torch.clamp(s2 * W - 0.5 - c, -Rx, Rx)
    dy = torch.clamp(t2 * H - 0.5 - r, -Ry, Ry)

    uv = torch.stack([_exchange_clamped(u, k, grid, mesh),
                      _exchange_clamped(v, k, grid, mesh)])
    out = torch.zeros((2, h, w), dtype=torch.float32, device=u.device)
    for ky in range(-Ry, Ry + 1):
        wy = torch.clamp(1.0 - torch.abs(dy - ky), min=0.0)
        for kx in range(-Rx, Rx + 1):
            wgt = wy * torch.clamp(1.0 - torch.abs(dx - kx), min=0.0)
            out = out + wgt * uv[:, k + ky:k + ky + h, k + kx:k + kx + w]
    return out[0], out[1]

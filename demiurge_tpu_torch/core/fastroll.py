"""Per-row column rolls and the two samplers built on them.

Counterpart of the parts of ``demiurge_tpu/core/fastroll.py`` that the
ported fast paths use.  On an x-periodic grid a fetch at a per-row column
offset is ``field[r, (c + k_r) mod W]`` with a per-row integer shift k_r
that depends only on the grid.  The reference splits that roll into
power-of-two stages because a gather is slow on a TPU; here it is one
gather with a per-row index, which computes the same values.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .platform import host_to_device


def row_roll_static(field: torch.Tensor, k_np) -> torch.Tensor:
    """out[..., r, c] = field[..., r, (c + k_r) mod W] for per-row integer
    shifts ``k_np`` (numpy, (H,), any sign)."""
    H, W = field.shape[-2], field.shape[-1]
    k = np.asarray(k_np).reshape(-1).astype(np.int64) % W
    if k.shape[0] != H:
        raise ValueError(f"{k.shape[0]} shifts for {H} rows")
    kt = host_to_device(k, field.device).reshape(-1, 1)
    idx = torch.remainder(torch.arange(W, device=field.device).reshape(1, -1)
                          + kt, W)
    return torch.gather(field, -1, idx.expand(field.shape))


def row_sample_bilinear_x_static(field: torch.Tensor, dx_np) -> torch.Tensor:
    """GL_LINEAR fetch at per-row fractional x offsets ``dx_np`` (numpy
    (H,) float32), periodic in x: the integer part is a row roll, the
    fraction a lerp of that column and the next."""
    dx_np = np.asarray(dx_np, np.float32).reshape(-1)
    k = np.floor(dx_np).astype(np.int64)
    f = host_to_device((dx_np - k).astype(np.float32).reshape(-1, 1),
                       field.device)
    r0 = row_roll_static(field, k)
    r1 = torch.roll(r0, -1, dims=-1)
    return r0 * (1.0 - f) + r1 * f


def const_sample_bilinear_y(field: torch.Tensor, dy: float, grid
                            ) -> torch.Tensor:
    """GL_LINEAR fetch at a constant fractional row offset ``dy``: a lerp
    of the two bracketing rows, each fetched by the wrap-aware shift (so
    through the poles on a global grid)."""
    from .topology import shift

    k = math.floor(dy)
    f = dy - k
    r0 = shift(field, 0, k, grid)
    if f == 0.0:
        return r0
    r1 = shift(field, 0, k + 1, grid)
    return r0 * (1.0 - f) + r1 * f

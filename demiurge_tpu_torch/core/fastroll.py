"""Per-row column rolls and the samplers built on them (periodic x).

Counterpart of ``demiurge_tpu/core/fastroll.py``.  On an x-periodic grid
a fetch at a per-row column offset is ``field[r, (c + k_r) mod W]`` with a
per-row integer shift k_r.  The reference splits that roll into
power-of-two stages because a gather is slow on a TPU; here it is one
gather with a per-row index, which computes the same values.  The
``_static`` forms take their shifts from the host (numpy: they depend only
on the grid), the others from a tensor.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .platform import host_to_device


def _gather_rows(field: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """field[..., r, (c + k_r) mod W] for int64 shifts k (H, 1) in [0, W)."""
    W = field.shape[-1]
    idx = torch.remainder(torch.arange(W, device=field.device).reshape(1, -1)
                          + k, W)
    return torch.gather(field, -1, idx.expand(field.shape))


def row_roll(field: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """out[..., r, c] = field[..., r, (c + k_r) mod W] for per-row integer
    shifts ``k`` (a tensor (H,) or (H, 1), any sign)."""
    H, W = field.shape[-2], field.shape[-1]
    k = torch.remainder(k.reshape(-1, 1).to(torch.int64), W)
    if k.shape[0] != H:
        raise ValueError(f"{k.shape[0]} shifts for {H} rows")
    return _gather_rows(field, k)


def row_roll_static(field: torch.Tensor, k_np) -> torch.Tensor:
    """``row_roll`` by shifts given on the host (numpy (H,), any sign)."""
    H, W = field.shape[-2], field.shape[-1]
    k = np.asarray(k_np).reshape(-1).astype(np.int64) % W
    if k.shape[0] != H:
        raise ValueError(f"{k.shape[0]} shifts for {H} rows")
    return _gather_rows(field, host_to_device(k, field.device).reshape(-1, 1))


def row_sample_nearest_x_static(field: torch.Tensor, dx_np) -> torch.Tensor:
    """GL_NEAREST fetch at per-row fractional x offsets ``dx_np`` (numpy
    (H,)): column (c + floor(0.5 + dx_r)) mod W, in float32."""
    k = np.floor(np.float32(0.5) + np.asarray(dx_np, np.float32))
    return row_roll_static(field, k.astype(np.int64))


def row_sample_nearest_x(field: torch.Tensor, dx: torch.Tensor
                         ) -> torch.Tensor:
    """GL_NEAREST fetch at per-row fractional x offsets ``dx`` (a float32
    tensor (H,) or (H, 1)): column (c + floor(0.5 + dx_r)) mod W."""
    k = torch.floor(0.5 + dx.to(torch.float32)).to(torch.int32)
    return row_roll(field, k)


def row_sample_bilinear_x(field: torch.Tensor, dx: torch.Tensor
                          ) -> torch.Tensor:
    """GL_LINEAR fetch at per-row fractional x offsets ``dx`` (a float32
    tensor (H,) or (H, 1)): the lerp of columns floor and floor + 1,
    periodic across the dateline (where the GL reference clamps the last
    subpixel at the seam: the reference package's documented deviation)."""
    dx = dx.to(torch.float32).reshape(-1, 1)
    k = torch.floor(dx)
    f = dx - k
    r0 = row_roll(field, k.to(torch.int32))
    r1 = torch.roll(r0, -1, dims=-1)
    return r0 * (1.0 - f) + r1 * f


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

"""Iterations of the separable spherical blur.

Counterpart of ``demiurge_tpu/pallas_kernels/blur.py``.  For every radius
of ``ops.blur.sigma_list`` the blur runs two 13-tap passes of
``ops.blur.blur13_pass``:

- vertical: out = W0*f + sum_t w_t * (v0_t * f[row r+k_t] + v1_t * f[row
  r+k_t+1]) over the six row offsets o_t = +-offset*r, k_t = floor(o_t),
  v1_t = o_t - k_t, v0_t = 1 - v1_t; rows beyond a pole reflect to the
  other side, half a world round (``core.topology.shift``);
- horizontal: the same with per-row fractional column offsets
  +-offset*r/cos|phi|, each a column shift k_{t,r} (mod W) and a lerp
  weight pair, periodic in x.

The taps' shifts and weights depend only on the grid and the radius; they
are built once (``tables``) in float32 exactly as the plain twin derives
them, and stay on the device.  ``blur`` launches the CUDA kernel
(``csrc/blur.cu``, two launches per iteration) for CUDA tensors and runs
the plain twin ``blur_plain`` — the ``blur13_pass`` sequence — for CPU
tensors; both sum the taps in the same order.  ``LAUNCHES`` counts kernel
launches.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.grid import Grid
from ..core.platform import check_kernel_inputs, host_to_device, \
    use_cuda_kernels
from ..core.topology import _pole_col_shift

LAUNCHES = 0
TAPS = 6  # taps of one pass besides the center: 3 offsets x 2 signs

_TABLES: dict = {}


def blur_plain(field: torch.Tensor, grid: Grid, rlist) -> torch.Tensor:
    """Every iteration's vertical then horizontal pass, in plain PyTorch."""
    from ..ops.blur import blur13_pass

    for r in rlist:
        field = blur13_pass(field, grid, (0.0, r))
        field = blur13_pass(field, grid, (r, 0.0))
    return field


def tables(grid: Grid, rlist, device):
    """Per-grid, per-radius tap tables on ``device``:
    vk (n, 6) int32 row offsets; vw (n, 6, 2) float32 (v0, v1);
    hk (n, 6, H) int32 column shifts mod W; hw (n, 6, 2, H) float32;
    weights (4,) float32 (W0 and the three tap weights)."""
    key = (grid, tuple(rlist), str(device))
    if key in _TABLES:
        return _TABLES[key]
    from ..ops.blur import _W0, _WEIGHTS, horizontal_taps, vertical_taps

    n, H = len(rlist), grid.height
    vk = np.zeros((n, TAPS), np.int32)
    vw = np.zeros((n, TAPS, 2), np.float32)
    hk = np.zeros((n, TAPS, H), np.int32)
    hw = np.zeros((n, TAPS, 2, H), np.float32)
    for i, r in enumerate(rlist):
        for t, oy in enumerate(vertical_taps(r)):
            k = math.floor(oy)
            f = oy - k
            vk[i, t] = k
            vw[i, t] = (np.float32(1.0 - f), np.float32(f))
        for t, dx in enumerate(horizontal_taps(grid, r)):
            k = np.floor(dx).astype(np.int64)
            f = (dx - k).astype(np.float32)
            hk[i, t] = k % grid.width
            hw[i, t] = (np.float32(1.0) - f, f)
    weights = np.array([_W0, *_WEIGHTS], np.float32)
    out = tuple(host_to_device(a, device) for a in (vk, vw, hk, hw, weights))
    _TABLES[key] = out
    return out


def blur_cuda(field: torch.Tensor, grid: Grid, rlist) -> torch.Tensor:
    """Every iteration on the card: a vertical and a horizontal launch each,
    ping-pong buffers, on the current stream, no synchronisation."""
    global LAUNCHES
    check_kernel_inputs(("field",), (field,), shape=grid.shape)
    if not grid.wrap_x:
        raise NotImplementedError("the blur needs an x-periodic grid")
    n = len(rlist)
    if n == 0:
        return field.clone()
    from . import build

    vk, vw, hk, hw, weights = tables(grid, rlist, field.device)
    ping, pong = torch.empty_like(field), torch.empty_like(field)
    H, W = grid.shape
    stream = torch.cuda.current_stream(field.device).cuda_stream
    err = build.library().demiurge_blur(
        field.data_ptr(), vk.data_ptr(), vw.data_ptr(), hk.data_ptr(),
        hw.data_ptr(), weights.data_ptr(), ping.data_ptr(), pong.data_ptr(),
        H, W, int(grid.wrap_south), int(grid.wrap_north),
        _pole_col_shift(grid), n, stream)
    build.check(err, "demiurge_blur")
    LAUNCHES += 2 * n
    return pong  # the last (horizontal) pass of every iteration lands there


def blur(field: torch.Tensor, grid: Grid, rlist) -> torch.Tensor:
    """The CUDA kernel for CUDA tensors, the plain twin for CPU tensors."""
    if use_cuda_kernels(field):
        return blur_cuda(field, grid, rlist)
    return blur_plain(field, grid, rlist)

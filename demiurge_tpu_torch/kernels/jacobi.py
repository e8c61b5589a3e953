"""Jacobi sweeps of the ocean's pressure and viscosity solves.

Counterpart of ``demiurge_tpu/pallas_kernels/jacobi.py``.  Both solves are
one 5-point sweep with the obstacle masks and the metric folded into
per-pixel coefficients:

    f' = cN*fN + cS*fS + cE*fE + cW*fW + cC*f (+ b)

where fN..fW are ``core.topology.shift`` neighbours (the velocity's pole
neighbour changes sign).  ``pressure_solve`` / ``diffusion_solve`` launch
the CUDA kernel (``csrc/jacobi.cu``) when handed CUDA tensors and run the
plain PyTorch twin (``*_plain``) when handed CPU tensors.  The kernel and
its twin evaluate the same sum in the same order, so on one card they give
the same numbers.

``PRESSURE_LAUNCHES`` and ``DIFFUSION_LAUNCHES`` count kernel launches (one
per sweep); the twins do not count.
"""

from __future__ import annotations

import torch

from ..core.grid import Grid
from ..core.platform import check_kernel_inputs, use_cuda_kernels
from ..core.topology import _pole_col_shift, shift

PRESSURE_LAUNCHES = 0
DIFFUSION_LAUNCHES = 0


# ---------------------------------------------------------------------------
# coefficients
# ---------------------------------------------------------------------------


def _obstacles(terrain: torch.Tensor, grid: Grid):
    """Land flags of the N, S, E, W neighbours as float32."""
    return [(shift(terrain, dx, dy, grid) > 0).to(torch.float32)
            for dx, dy in ((0, 1), (0, -1), (1, 0), (-1, 0))]


def coefficients(divw: torch.Tensor, terrain: torch.Tensor, grid: Grid):
    """Pressure sweep coefficients (cN, cS, cE, cW, cC, b): Neumann walls
    move the masked weight onto the center, b = -div/beta, zero on land,
    and a clamped (non-pole) edge folds its neighbour weight into cC."""
    dxr, dyr = grid.pixelsize_rows(terrain.device)
    pw2x = ((dxr / 420.0) ** 2).expand(grid.shape)
    pw2y = ((dyr / 420.0) ** 2 * torch.ones_like(dxr)).expand(grid.shape)
    beta = 2 * (1 / pw2x + 1 / pw2y)

    oN, oS, oE, oW = _obstacles(terrain, grid)
    sea = (terrain <= 0).to(torch.float32)

    cx = 1.0 / pw2x / beta
    cy = 1.0 / pw2y / beta
    cN = (1 - oN) * cy * sea
    cS = (1 - oS) * cy * sea
    cE = (1 - oE) * cx * sea
    cW = (1 - oW) * cx * sea
    cC = (oN * cy + oS * cy + oE * cx + oW * cx) * sea
    b = -divw / beta * sea

    if not (grid.wrap_south and grid.wrap_x):
        cC[0, :] += cS[0, :]
        cS[0, :] = 0.0
    if not (grid.wrap_north and grid.wrap_x):
        cC[-1, :] += cN[-1, :]
        cN[-1, :] = 0.0
    return cN, cS, cE, cW, cC, b


def diffusion_coefficients(terrain: torch.Tensor, grid: Grid):
    """Viscosity sweep coefficients (cN, cS, cE, cW, cC): obstacle-masked
    neighbour weights redirected onto the center."""
    dxr, dyr = grid.pixelsize_rows(terrain.device)
    wx = ((420.0 / dxr) ** 2).expand(grid.shape)
    wy = ((420.0 / dyr) ** 2 * torch.ones_like(dxr)).expand(grid.shape)
    beta = 2 * (wx + wy) * (1 + 1 / (2 * (wx + wy)))

    oN, oS, oE, oW = _obstacles(terrain, grid)
    cN = (1 - oN) * wy / beta
    cS = (1 - oS) * wy / beta
    cE = (1 - oE) * wx / beta
    cW = (1 - oW) * wx / beta
    cC = (1 + (oN + oS) * wy + (oE + oW) * wx) / beta
    return cN, cS, cE, cW, cC


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------


def _pole_rows(grid: Grid, device):
    """(H,1) masks of the rows whose N / S neighbour crossed a pole."""
    H = grid.height
    north = torch.zeros((H, 1), dtype=torch.bool, device=device)
    south = torch.zeros((H, 1), dtype=torch.bool, device=device)
    if grid.wrap_x and grid.wrap_north:
        north[H - 1] = True
    if grid.wrap_x and grid.wrap_south:
        south[0] = True
    return north, south


def _sweeps_plain(coeffs, b, f, grid: Grid, iters: int, pole_sign: float):
    cN, cS, cE, cW, cC = coeffs
    north, south = _pole_rows(grid, f.device)
    for _ in range(iters):
        fN = shift(f, 0, 1, grid)
        fS = shift(f, 0, -1, grid)
        if pole_sign < 0:
            fN = torch.where(north, -fN, fN)
            fS = torch.where(south, -fS, fS)
        out = (cN * fN + cS * fS + cE * shift(f, 1, 0, grid)
               + cW * shift(f, -1, 0, grid) + cC * f)
        f = out + b if b is not None else out
    return f


def pressure_solve_plain(cN, cS, cE, cW, cC, b, p0, grid: Grid,
                         iters: int) -> torch.Tensor:
    """``iters`` pressure sweeps from ``p0``, in plain PyTorch."""
    return _sweeps_plain((cN, cS, cE, cW, cC), b, p0, grid, iters, 1.0)


def diffusion_solve_plain(cN, cS, cE, cW, cC, u, v, grid: Grid, iters: int):
    """``iters`` viscosity sweeps on (u, v) together, in plain PyTorch."""
    uv = _sweeps_plain((cN, cS, cE, cW, cC), None, torch.stack([u, v]),
                       grid, iters, -1.0)
    return uv[0], uv[1]


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


def _topology_args(grid: Grid):
    if (grid.wrap_south or grid.wrap_north) and not grid.wrap_x:
        raise NotImplementedError(
            "pole reflection on a grid that is not x-periodic")
    return (int(grid.wrap_x), int(grid.wrap_south and grid.wrap_x),
            int(grid.wrap_north and grid.wrap_x), _pole_col_shift(grid))


def pressure_solve_cuda(cN, cS, cE, cW, cC, b, p0, grid: Grid,
                        iters: int) -> torch.Tensor:
    """``iters`` pressure sweeps from ``p0`` on the card: one launch per
    sweep on the current stream, no synchronisation."""
    global PRESSURE_LAUNCHES
    tensors = (cN, cS, cE, cW, cC, b, p0)
    check_kernel_inputs(("cN", "cS", "cE", "cW", "cC", "b", "p0"), tensors,
                        shape=grid.shape)
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    if iters == 0:
        return p0.clone()
    from . import build

    ping, pong = torch.empty_like(p0), torch.empty_like(p0)
    H, W = grid.shape
    stream = torch.cuda.current_stream(p0.device).cuda_stream
    err = build.library().demiurge_jacobi_pressure(
        *(t.data_ptr() for t in tensors), ping.data_ptr(), pong.data_ptr(),
        H, W, *_topology_args(grid), iters, stream)
    build.check(err, "demiurge_jacobi_pressure")
    PRESSURE_LAUNCHES += iters
    return ping if (iters - 1) % 2 == 0 else pong


def diffusion_solve_cuda(cN, cS, cE, cW, cC, u, v, grid: Grid, iters: int):
    """``iters`` viscosity sweeps on (u, v) on the card: one launch per
    sweep on the current stream, no synchronisation."""
    global DIFFUSION_LAUNCHES
    tensors = (cN, cS, cE, cW, cC, u, v)
    check_kernel_inputs(("cN", "cS", "cE", "cW", "cC", "u", "v"), tensors,
                        shape=grid.shape)
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    if iters == 0:
        return u.clone(), v.clone()
    from . import build

    bufs = [torch.empty_like(u) for _ in range(4)]  # u ping/pong, v ping/pong
    H, W = grid.shape
    stream = torch.cuda.current_stream(u.device).cuda_stream
    err = build.library().demiurge_jacobi_diffusion(
        *(t.data_ptr() for t in tensors), *(t.data_ptr() for t in bufs),
        H, W, *_topology_args(grid), iters, stream)
    build.check(err, "demiurge_jacobi_diffusion")
    DIFFUSION_LAUNCHES += iters
    last = (iters - 1) % 2
    return bufs[last], bufs[2 + last]


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def pressure_solve(cN, cS, cE, cW, cC, b, p0, grid: Grid,
                   iters: int) -> torch.Tensor:
    """The CUDA kernel for CUDA tensors, the plain twin for CPU tensors."""
    if use_cuda_kernels(cN, cS, cE, cW, cC, b, p0):
        return pressure_solve_cuda(cN, cS, cE, cW, cC, b, p0, grid, iters)
    return pressure_solve_plain(cN, cS, cE, cW, cC, b, p0, grid, iters)


def diffusion_solve(cN, cS, cE, cW, cC, u, v, grid: Grid, iters: int):
    """The CUDA kernel for CUDA tensors, the plain twin for CPU tensors."""
    if use_cuda_kernels(cN, cS, cE, cW, cC, u, v):
        return diffusion_solve_cuda(cN, cS, cE, cW, cC, u, v, grid, iters)
    return diffusion_solve_plain(cN, cS, cE, cW, cC, u, v, grid, iters)

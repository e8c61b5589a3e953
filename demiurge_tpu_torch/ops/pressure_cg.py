"""Preconditioned conjugate-gradient pressure solve (performance mode).

Counterpart of ``demiurge_tpu/ops/pressure_cg.py``.  The reference's
pressure is 5000 plain Jacobi sweeps, which resolve ~sqrt(n) pixels; this
solver converges across a basin of any size.  The operator restricted to
water cells is symmetric positive semi-definite (couplings to land are
dropped symmetrically, land rows are identity), so CG applies, with:

- a small diagonal screen ``eps`` that makes the per-basin Neumann system
  definite (``_system``);
- a per-row spectral preconditioner: the rFFT inverse of the obstacle-free
  x tridiagonal, which absorbs the 1/cos^2(phi) anisotropy near the poles
  exactly (``_row_spectral_precond``; ``torch.fft``, cuFFT on the card);
- a restart from the true residual every ``restart`` iterations (float32
  loses conjugacy after a few dozen).

The loop is Python: its stopping test reads ||r||^2 on the host each
iteration, so the iteration count is the reference's.  Select it with
``OceanConfig(pressure_method="cg")``.
"""

from __future__ import annotations

import math

import torch

from ..core.grid import Grid, rdiv
from ..core.topology import shift

LAST_SOLVE: dict = {}  # {"iterations": n} of the last pressure_solve_cg


def _vdot(a, b):
    return torch.sum(a * b)


def _pw2(grid: Grid, device):
    dxr, dyr = grid.pixelsize_rows(device)
    return (dxr / 420.0) ** 2, (dyr / 420.0) ** 2


def _system(divw, terrain, grid: Grid, eps: float = 0.0):
    """(A, rhs, diag, land): A is SPD on water and the identity on land;
    ``eps`` adds eps*beta to the water diagonal (the screened system)."""
    pw2x, pw2y = _pw2(grid, divw.device)
    beta = 2 * (1 / pw2x + 1 / pw2y)

    oN = shift(terrain, 0, 1, grid) > 0
    oS = shift(terrain, 0, -1, grid) > 0
    oE = shift(terrain, 1, 0, grid) > 0
    oW = shift(terrain, -1, 0, grid) > 0
    oC = terrain > 0

    def A(p):
        p = torch.where(oC, 0.0, p)  # land holds 0; couplings to it vanish
        pN = torch.where(oN, p, shift(p, 0, 1, grid))
        pS = torch.where(oS, p, shift(p, 0, -1, grid))
        pE = torch.where(oE, p, shift(p, 1, 0, grid))
        pW = torch.where(oW, p, shift(p, -1, 0, grid))
        S = (pW + pE) / pw2x + (pS + pN) / pw2y
        return torch.where(oC, p, (1.0 + eps) * beta * p - S)

    rhs = torch.where(oC, 0.0, -divw)
    diag = torch.where(oC, 1.0, ((1.0 + eps) * beta).expand(divw.shape))
    return A, rhs, diag, oC


def _row_spectral_precond(divw, grid: Grid, eps: float = 0.0):
    """M^-1 for the obstacle-free operator restricted to x: per row a
    periodic constant-coefficient tridiagonal (diag beta, off -1/pw2x),
    diagonalized by the rFFT."""
    W = divw.shape[1]
    pw2x, pw2y = _pw2(grid, divw.device)
    beta = 2 * (1 / pw2x + 1 / pw2y)
    k = torch.arange(W // 2 + 1, dtype=torch.float32,
                     device=divw.device).reshape(1, -1)
    eig = ((1.0 + eps) * beta
           - rdiv(2.0, pw2x)
           * torch.cos(2.0 * math.pi * k / W))   # (H, W/2+1)

    def Minv(r):
        return torch.fft.irfft(torch.fft.rfft(r, dim=1) / eig, n=W, dim=1
                               ).to(r.dtype)

    return Minv


def pressure_solve_cg(divw, terrain, grid: Grid, iters: int = 200,
                      rtol: float = 1e-4, restart: int = 32,
                      eps: float = 1e-3, p0=None):
    """Preconditioned CG to ||r|| <= rtol*||rhs|| (or ``iters`` applies)
    on the eps-screened system.  ``LAST_SOLVE["iterations"]`` holds the
    count of the last call."""
    A, rhs, _, oC = _system(divw, terrain, grid, eps=eps)
    Minv = _row_spectral_precond(divw, grid, eps=eps)
    p = torch.zeros_like(divw) if p0 is None else torch.where(oC, 0.0, p0)
    bound2 = rtol * rtol * _vdot(rhs, rhs)

    def fresh(p):
        r = rhs - A(p)
        z = Minv(r)
        return r, z, z, _vdot(r, z)

    r, d, z, rz = fresh(p)
    it = 0
    while it < iters and bool(_vdot(r, r) > bound2):
        Ad = A(d)
        dAd = _vdot(d, Ad)
        alpha = rz / torch.where(dAd > 0, dAd, 1.0)
        alpha = torch.where(dAd > 0, alpha, 0.0)  # f32 breakdown guard
        p = p + alpha * d
        if it % restart == restart - 1:
            # periodic restart: the true residual, the search direction
            # reset (f32 conjugacy drift)
            r, d, z, rz = fresh(p)
        else:
            r = r - alpha * Ad
            z = Minv(r)
            rz2 = _vdot(r, z)
            d = z + (rz2 / torch.where(rz > 0, rz, 1.0)) * d
            rz = rz2
        it += 1
    LAST_SOLVE["iterations"] = it
    return p


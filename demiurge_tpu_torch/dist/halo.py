"""Explicit halo exchange over the ('y', 'x') mesh, and the solvers that
amortize it.

Counterpart of ``demiurge_tpu/dist/halo.py``.  The deep iterative solvers
(pressure Jacobi, viscosity, the flow fixpoint's fallback) exchange a
k-wide halo once, then run k sweeps on the padded block (validity shrinks
one ring a sweep), and repeat: k times less communication than one
exchange a sweep.  Static inputs (the 5-point coefficients, the packed
flow masks) are padded once, before the rounds.

Topology, as ``core.topology.shift``:

- E/W: the dateline ring along 'x';
- N/S: bands along 'y';
- polar caps: the rows beyond a pole are the same block's rows flipped, at
  the antipodal longitude, which with an even ``nx`` is the x shard nx/2
  away (one more exchange along 'x', on the pole bands only).  Crossing a
  pole reverses the walk (the N/S coefficients swap in reflected halo
  rows) and tangent vectors (velocity halos negate).

``ppermute`` is ``dist.mesh.permute`` (paired isend/irecv) and ``pmax``
``dist.mesh.any_rank`` (all_reduce MAX).  The sweeps are plain PyTorch on
each rank; the rank-local sweeps on the Jacobi kernels are later work.
"""

from __future__ import annotations

import torch

from ..core.grid import Grid
from ..core.topology import NEIGHBORS_FLOW_ORDER, _pole_col_shift
from .mesh import Mesh, any_rank, permute, sharded_call


def _ring(x, mesh: Mesh, axis: str, s: int):
    """Along the mesh axis ('x' or 'y') as a ring: send ``x`` to the rank
    s steps on, receive from the rank s steps back."""
    if axis == "x":
        n, i = mesh.nx, mesh.xi
        rank = lambda j: mesh.rank_of(mesh.yi, j % n)  # noqa: E731
    else:
        n, i = mesh.ny, mesh.yi
        rank = lambda j: mesh.rank_of(j % n, mesh.xi)  # noqa: E731
    return permute(x, rank(i + s), rank(i - s), mesh)


def _band_from_prev(x, mesh: Mesh):
    """Along 'y', not a ring: rank yi gets ``x`` of yi - 1 (zeros at 0)."""
    up = mesh.rank_of(mesh.yi + 1, mesh.xi) if mesh.yi < mesh.ny - 1 else None
    down = mesh.rank_of(mesh.yi - 1, mesh.xi) if mesh.yi > 0 else None
    return permute(x, up, down, mesh)


def _band_from_next(x, mesh: Mesh):
    """Along 'y': rank yi gets ``x`` of yi + 1 (zeros at ny - 1)."""
    up = mesh.rank_of(mesh.yi + 1, mesh.xi) if mesh.yi < mesh.ny - 1 else None
    down = mesh.rank_of(mesh.yi - 1, mesh.xi) if mesh.yi > 0 else None
    return permute(x, down, up, mesh)


def exchange_halo(block, k: int, grid: Grid, mesh: Mesh,
                  negate_pole: bool = False) -> torch.Tensor:
    """Pad this rank's (h, w) block with k-wide halos from its mesh
    neighbours: (h+2k, w+2k), whose stencils up to k rings deep match the
    single-device wrap topology.  ``negate_pole`` flips the sign of the
    pole-cap halo rows (velocity components reverse across a pole)."""
    if not grid.wrap_x:
        raise NotImplementedError("halo exchange needs an x-periodic grid")
    poles = grid.wrap_south or grid.wrap_north
    if poles and mesh.nx > 1 and mesh.nx % 2:
        raise ValueError("the polar cap needs an even number of x shards")

    # E/W ring (dateline periodic)
    if mesh.nx > 1:
        west = _ring(block[:, -k:], mesh, "x", 1)
        east = _ring(block[:, :k], mesh, "x", -1)
    else:
        west, east = block[:, -k:], block[:, :k]
    padded = torch.cat([west, block, east], dim=1)

    # N/S bands
    south = _band_from_prev(padded[-k:], mesh)
    north = _band_from_next(padded[:k], mesh)

    # polar caps: flipped head/tail rows from the antipodal x shard
    def cap(rows):
        if mesh.nx > 1:
            rows = _ring(torch.flip(rows, dims=[0]), mesh, "x", mesh.nx // 2)
        else:  # the antipode is in this block: roll the unpadded rows
            rows = torch.roll(torch.flip(rows[:, k:-k], dims=[0]),
                              -_pole_col_shift(grid), dims=1)
            rows = torch.cat([rows[:, -k:], rows, rows[:, :k]], dim=1)
        return -rows if negate_pole else rows

    if grid.wrap_south and mesh.yi == 0:
        south = cap(padded[:k])
    if grid.wrap_north and mesh.yi == mesh.ny - 1:
        north = cap(padded[-k:])
    return torch.cat([south, padded, north], dim=0)


def exchange_rows_halo(block, k: int, mesh: Mesh, grid: Grid = None,
                       edge: str = "reflect") -> torch.Tensor:
    """k-row halo exchange in the row-group layout (``dist.mesh.
    blocks_to_rows``): rank g holds full-width rows [g*r, (g+1)*r), so its
    south halo is the last k rows of rank g-1 and its north halo the first
    k rows of rank g+1.  ``edge`` fills the halo beyond the grid's first
    and last row: 'reflect' (the pole wrap: flipped rows half a world
    round, local here since rows are whole), 'flip' (flipped rows, for
    per-row tables that do not depend on longitude), 'clamp' (the edge row
    repeated) or 'zero'.  Returns (r + 2k, W)."""
    g, last = mesh.rank, mesh.size - 1
    south = permute(block[-k:], g + 1 if g < last else None,
                    g - 1 if g > 0 else None, mesh)
    north = permute(block[:k], g - 1 if g > 0 else None,
                    g + 1 if g < last else None, mesh)

    def edge_rows(rows, at):
        if edge == "reflect":
            return torch.roll(torch.flip(rows, dims=[0]),
                              -(block.shape[1] // 2), dims=1)
        if edge == "flip":
            return torch.flip(rows, dims=[0])
        if edge == "clamp":
            return block[at:at + 1].expand(rows.shape)
        if edge == "zero":
            return torch.zeros_like(rows)
        raise ValueError(f"unknown edge {edge!r}")

    if g == 0:
        south = edge_rows(block[:k], 0)
    if g == last:
        north = edge_rows(block[-k:], block.shape[0] - 1)
    return torch.cat([south, block, north], dim=0)


def _swap_pole_rows(a, b, k: int, grid: Grid, mesh: Mesh):
    """In pole-reflected halo rows 'padded north' is 'sphere south': swap
    an (N, S) coefficient pair there (a, b already halo-padded)."""
    rows = torch.arange(a.shape[0], device=a.device).reshape(-1, 1)
    sw = torch.zeros_like(rows, dtype=torch.bool)
    if grid.wrap_south and mesh.yi == 0:
        sw = sw | (rows < k)
    if grid.wrap_north and mesh.yi == mesh.ny - 1:
        sw = sw | (rows >= a.shape[0] - k)
    return torch.where(sw, b, a), torch.where(sw, a, b)


def _sweep5(p, cN, cS, cE, cW, cC, b):
    """One folded 5-point sweep on a padded block: plain shifts (the
    outermost ring reads wrapped garbage and goes stale)."""
    pN = torch.roll(p, -1, dims=0)
    pS = torch.roll(p, 1, dims=0)
    pE = torch.roll(p, -1, dims=1)
    pW = torch.roll(p, 1, dims=1)
    return cN * pN + cS * pS + cE * pE + cW * pW + cC * p + b


def _ksweeps(p_b, k: int, coeffs, exchange, n_sw=None):
    """k sweeps of this rank's block after one k-wide halo refresh, on the
    padded block; its centre is the result.  ``n_sw``: only the first
    ``n_sw`` sweeps run.  (The reference splits the block into a centre
    and a frame so that XLA can overlap the exchange with the centre's
    sweeps; eager PyTorch finishes the exchange first, so the split would
    only add launches.)"""
    pp = exchange(p_b)
    for _ in range(k if n_sw is None else min(n_sw, k)):
        pp = _sweep5(pp, *coeffs)
    return pp[k:-k, k:-k]


def _padded_coefficients(coeffs, k: int, grid: Grid, mesh: Mesh):
    cN, cS, cE, cW, cC = (exchange_halo(c, k, grid, mesh)
                          for c in coeffs[:5])
    cN, cS = _swap_pole_rows(cN, cS, k, grid, mesh)
    return cN, cS, cE, cW, cC


def pressure_solve_sharded(divw, terrain, grid: Grid, mesh: Mesh,
                           iters: int = 5000, k: int = 8) -> torch.Tensor:
    """The pressure Poisson solve on blocks: k sweeps per k-wide halo
    exchange of p (the coefficients are folded and padded once), from
    zero.  ceil(iters / k) rounds of k sweeps, as the reference runs."""
    from ..kernels.jacobi import coefficients

    coeffs = sharded_call(coefficients, mesh)(divw, terrain, grid)
    padded = _padded_coefficients(coeffs, k, grid, mesh) \
        + (exchange_halo(coeffs[5], k, grid, mesh),)
    p = torch.zeros_like(divw)
    for _ in range((iters + k - 1) // k):
        p = _ksweeps(p, k, padded, lambda q: exchange_halo(q, k, grid, mesh))
    return p


def diffusion_solve_sharded(u, v, terrain, grid: Grid, mesh: Mesh,
                            iters: int = 50, k: int = 10):
    """The implicit-viscosity solve on blocks: k sweeps per halo exchange
    of each of (u, v), velocity pole halos negated; the last round runs
    the remainder of ``iters``."""
    from ..kernels.jacobi import diffusion_coefficients

    coeffs = sharded_call(diffusion_coefficients, mesh)(terrain, grid)
    padded = _padded_coefficients(coeffs, k, grid, mesh)
    padded = padded + (torch.zeros_like(padded[0]),)
    n_rounds = (iters + k - 1) // k
    quotas = [k] * (n_rounds - 1) + [iters - (n_rounds - 1) * k]

    def exch(q):
        return exchange_halo(q, k, grid, mesh, negate_pole=True)

    for n_sw in quotas:
        u = _ksweeps(u, k, padded, exch, n_sw=n_sw)
        v = _ksweeps(v, k, padded, exch, n_sw=n_sw)
    return u, v


def flow_solve_sharded(code, area2d, mouth, grid: Grid, mesh: Mesh,
                       k: int = 16, max_iters: int = 1 << 20):
    """The flow fixpoint on blocks, the fallback where the two-level solve
    does not apply: k sweeps of the joint (A, vis) relaxation per k-wide
    halo exchange, the packed masks padded once, until a round changes
    nothing on any rank.  Same fixpoint as ``ops.flow.flow_solve_stencil``
    (the cross-pole bits are masked off, so the pole-cap halo rows are
    never read).  Returns (A, vis bool)."""
    from ..kernels.flow import pack_masks

    packed_b = sharded_call(pack_masks, mesh)(code, mouth, grid)
    packed = exchange_halo(packed_b, k, grid, mesh)
    area = exchange_halo(area2d, k, grid, mesh)
    inc = [(packed & (1 << i)) != 0 for i in range(8)]
    outs = [(packed & (1 << (8 + i))) != 0 for i in range(8)]
    mouth_p = torch.where((packed & (1 << 16)) != 0, 1.0, 0.0)

    def sweep(A, vis):
        newA, newvis = area, mouth_p
        for i, (dx, dy) in enumerate(NEIGHBORS_FLOW_ORDER):
            Ad = torch.roll(A, (-dy, -dx), dims=(0, 1))
            vd = torch.roll(vis, (-dy, -dx), dims=(0, 1))
            newA = newA + torch.where(inc[i], Ad, 0.0)
            newvis = torch.maximum(newvis, torch.where(outs[i], vd, 0.0))
        return newA, newvis

    A, vis = area2d, torch.where(mouth, 1.0, 0.0)
    for _ in range(0, max_iters, k):
        Ap = exchange_halo(A, k, grid, mesh)
        vp = exchange_halo(vis, k, grid, mesh)
        for _ in range(k):
            Ap, vp = sweep(Ap, vp)
        A2, v2 = Ap[k:-k, k:-k], vp[k:-k, k:-k]
        changed = not (torch.equal(A2, A) and torch.equal(v2, vis))
        A, vis = A2.contiguous(), v2.contiguous()
        if not any_rank(changed, mesh):
            break
    return A, vis > 0.5

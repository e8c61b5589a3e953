"""Explicit halo exchange over the ('y', 'x') mesh, and the solvers that
amortize it.

Counterpart of ``demiurge_tpu/dist/halo.py``.  The deep iterative solvers
(pressure Jacobi, viscosity, the flow fixpoint's fallback) exchange a
k-wide halo once, then run k sweeps on the padded block (validity shrinks
one ring a sweep), and repeat: k times less communication than one
exchange a sweep.  Static inputs (the 5-point coefficients, the packed
flow masks) are padded once, before the rounds; the coefficients are
built on the blocks (``dist.local``).  Beyond a grid edge that is not a
pole these rounds read a zero halo, as the reference's halo solvers do
(where the single-device sweep clamps).  The ``exact_quirks`` viscosity
(``diffusion_quirks_sharded``) runs the reference's own sweep in the
same rounds, on ``dist.local``'s padded blocks, which end at such an
edge and clamp there as the single-device sweep does.

Topology, as ``core.topology.shift``:

- E/W: the dateline ring along 'x';
- N/S: bands along 'y';
- polar caps: the rows beyond a pole are the same block's rows flipped, at
  the antipodal longitude, which with an even ``nx`` is the x shard nx/2
  away (one more exchange along 'x', on the pole bands only).  Crossing a
  pole reverses the walk (the N/S coefficients swap in reflected halo
  rows) and tangent vectors (velocity halos negate).

A halo exchange is one round of paired isend/irecv: the four edges, the
four corners and the cap rows, each straight from the rank that holds it
(``post_halo``), then one wait for all of them (``PendingHalo.finish``).
In the row-group layout (``exchange_rows_halo``) each halo row comes
straight from the rank that holds it, however many groups deep.
With ``OVERLAP`` on, the solvers sweep the centre of the block, which
needs no halo, between the two (``_overlapped_ksweeps``, the reference's
split); ``LAST_OVERLAP`` records whether they did.  ``pmax`` is
``dist.mesh.any_rank`` (all_reduce MAX).  The sweeps are plain PyTorch
on each rank; the rank-local sweeps on the Jacobi kernels are later
work.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from ..core.grid import Grid
from ..core.topology import NEIGHBORS_FLOW_ORDER, _pole_col_shift
from .mesh import TRAFFIC, Mesh, _nbytes, _wire, any_rank, row_groups

#: whether the solvers split each halo round that waits on another rank
#: into the block's centre, swept while the exchange is in flight, and
#: its frame (the reference's order).  Off: the split costs four more
#: strips of sweeps a round, and no run has yet shown the overlap paying
#: for them (PERF.md; ``tools/scaling_bench.py --overlap`` turns it on)
OVERLAP = False

#: the last solve's halo rounds: rounds run, rounds split into a centre
#: and a frame, and split rounds whose centre sweeps were issued while
#: their exchange was in flight (posted, not yet waited for)
LAST_OVERLAP: dict = {"rounds": 0, "split": 0, "in_flight": 0}

_REGIONS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
            if (dy, dx) != (0, 0)]


def _source(Y: int, X: int, dy: int, dx: int, h: int, w: int, k: int,
            grid: Grid, mesh: Mesh):
    """Where halo region (dy, dx) of rank (Y, X)'s padded block comes
    from: (rank, block rows, block columns, across a pole), or None where
    it is zeros (beyond an edge that does not wrap).  Rows beyond a pole
    are the pole band's rows flipped, half a world round."""
    W = grid.width
    cols = {-1: X * w - k + np.arange(k), 0: X * w + np.arange(w),
            1: X * w + w + np.arange(k)}[dx] % W
    Yp, pole = Y + dy, False
    if 0 <= Yp < mesh.ny:
        rows = {-1: np.arange(h - k, h), 0: np.arange(h),
                1: np.arange(k)}[dy]
    elif (grid.wrap_south if dy < 0 else grid.wrap_north):
        Yp, pole = (0, True) if dy < 0 else (mesh.ny - 1, True)
        rows = (np.arange(k - 1, -1, -1) if dy < 0
                else np.arange(h - 1, h - k - 1, -1))
        cols = (cols + _pole_col_shift(grid)) % W
    else:
        return None
    xs = cols // w
    if not (xs == xs[0]).all():
        raise ValueError("the polar cap needs an even number of x shards")
    return mesh.rank_of(Yp, int(xs[0])), rows, cols - xs[0] * w, pole


def _runs(idx: np.ndarray):
    """An index list as runs of consecutive indices: [(start, stop)]."""
    cut = np.flatnonzero(np.diff(idx) != 1) + 1
    return tuple((int(r[0]), int(r[-1]) + 1) for r in np.split(idx, cut))


def _cut(rows: np.ndarray, cols: np.ndarray):
    """Block rows and columns as slices: (first row, row after the last,
    flipped, column runs).  The rows are one run, ascending or (beyond a
    pole) descending; the columns one run or (a cap on one x shard, half
    a world round) two."""
    flip = bool(rows[0] > rows[-1])
    r0, r1 = (int(rows[-1]), int(rows[0]) + 1) if flip else \
        (int(rows[0]), int(rows[-1]) + 1)
    return r0, r1, flip, _runs(cols)


def _spans(h: int, w: int, k: int, dy: int, dx: int):
    """Region (dy, dx)'s rows and columns in the padded block."""
    return ({-1: slice(0, k), 0: slice(k, k + h), 1: slice(k + h, None)}[dy],
            {-1: slice(0, k), 0: slice(k, k + w), 1: slice(k + w, None)}[dx])


class _Plan:
    """Rank (yi, xi)'s exchange of the k-wide halo of its (h, w) block:
    ``own`` the regions it copies from its own block, (padded rows,
    padded columns, ``_cut``, across a pole); ``remote`` the regions to
    receive, (region, rank); ``zero`` the regions beyond an edge that
    does not wrap; ``send`` the pieces of its block it sends, in the
    order each receiver posts its receives: (dst rank, ``_cut``, across a
    pole)."""

    def __init__(self, h, w, k, grid, ny, nx, yi, xi):
        mesh = Mesh(ny, nx, yi, xi, torch.device("cpu"), None)
        me = mesh.rank
        self.own, self.remote, self.zero = [], [], []
        for region in _REGIONS:
            src = _source(yi, xi, *region, h, w, k, grid, mesh)
            rs, cs = _spans(h, w, k, *region)
            if src is None:
                self.zero.append((rs, cs))
            elif src[0] == me:
                self.own.append((rs, cs, _cut(src[1], src[2]), src[3]))
            else:
                self.remote.append(((rs, cs), src[0]))
        self.send = []
        for q in range(ny * nx):
            if q == me:
                continue
            Y, X = divmod(q, nx)
            for region in _REGIONS:
                src = _source(Y, X, *region, h, w, k, grid, mesh)
                if src is not None and src[0] == me:
                    self.send.append((q, _cut(src[1], src[2]), src[3]))


@functools.lru_cache(maxsize=64)
def _plan(h: int, w: int, k: int, grid: Grid, ny: int, nx: int, yi: int,
          xi: int) -> _Plan:
    return _Plan(h, w, k, grid, ny, nx, yi, xi)


def _put(out, block, cut, negate: bool):
    """Copy the piece of ``block`` at ``cut`` into ``out``, a region of
    the padded block: its rows (flipped beyond a pole), then one slice
    copy a column run, negated where ``negate``."""
    r0, r1, flip, runs = cut
    rows = block[r0:r1]
    if flip:
        rows = torch.flip(rows, dims=[0])
    c = 0
    for a, b in runs:
        part = rows[:, a:b]
        dst = out[:, c:c + b - a]
        if negate:
            torch.neg(part, out=dst)
        else:
            dst.copy_(part)
        c += b - a


class PendingHalo:
    """A posted halo exchange: the padded block with this rank's own
    pieces in place, the receive buffers and the requests in flight.
    ``remote`` is whether any piece comes from another rank; ``finish``
    waits for every request and returns the padded block."""

    def __init__(self, padded, dtype, recvs, requests, sends):
        self.padded, self.dtype = padded, dtype
        self.recvs, self.requests = recvs, requests
        self._sends = sends  # kept alive until the wait
        self.remote = bool(requests)
        self.waited = False

    def finish(self) -> torch.Tensor:
        for req in self.requests:
            req.wait()
        self.waited = True
        self._sends = None
        out = self.padded
        for (rs, cs), buf in self.recvs:
            out[rs, cs] = buf
        return out.to(self.dtype)


def post_halo(block, k: int, grid: Grid, mesh: Mesh,
              negate_pole: bool = False) -> PendingHalo:
    """Post the k-wide halo exchange of this rank's (h, w) block: every
    isend and irecv of the round at once (edges, corners, the cap rows),
    and the pieces this rank holds itself copied into place (slice
    copies).  ``negate_pole`` flips the sign of the pole-cap halo rows
    (velocity components reverse across a pole)."""
    if not grid.wrap_x:
        raise NotImplementedError("halo exchange needs an x-periodic grid")
    poles = grid.wrap_south or grid.wrap_north
    if poles and mesh.nx > 1 and mesh.nx % 2:
        raise ValueError("the polar cap needs an even number of x shards")
    h, w = block.shape
    plan = _plan(h, w, k, grid, mesh.ny, mesh.nx, mesh.yi, mesh.xi)
    wire = _wire(block)
    ops, sends = [], []
    for q, (r0, r1, flip, runs), pole in plan.send:
        piece = wire.new_empty((r1 - r0, sum(b - a for a, b in runs)))
        _put(piece, wire, (r0, r1, flip, runs), pole and negate_pole)
        sends.append(piece)
        ops.append(dist.P2POp(dist.isend, piece, q))
    padded = wire.new_empty((h + 2 * k, w + 2 * k))
    padded[k:k + h, k:k + w] = wire
    for rs, cs, cut, pole in plan.own:
        _put(padded[rs, cs], wire, cut, pole and negate_pole)
    for rs, cs in plan.zero:
        padded[rs, cs] = 0
    recvs = []
    for (rs, cs), src in plan.remote:
        buf = torch.empty((padded[rs, cs].shape), dtype=wire.dtype,
                          device=block.device)
        TRAFFIC["permute"] += _nbytes(buf)
        recvs.append(((rs, cs), buf))
        ops.append(dist.P2POp(dist.irecv, buf, src))
    requests = dist.batch_isend_irecv(ops) if ops else []
    return PendingHalo(padded, block.dtype, recvs, requests, sends)


def exchange_halo(block, k: int, grid: Grid, mesh: Mesh,
                  negate_pole: bool = False) -> torch.Tensor:
    """Pad this rank's (h, w) block with k-wide halos from its mesh
    neighbours: (h+2k, w+2k), whose stencils up to k rings deep match the
    single-device wrap topology.  ``negate_pole`` flips the sign of the
    pole-cap halo rows (velocity components reverse across a pole)."""
    return post_halo(block, k, grid, mesh, negate_pole).finish()


@functools.lru_cache(maxsize=64)
def _rows_plan(H: int, k: int, ny: int, nx: int):
    """Every rank's strip in the row-group layout: for each of its rows,
    (row within the group that holds it, rank holding it).  The strip is
    rows [lo - k, hi + k) of the rank's group [lo, hi) (``dist.mesh.
    row_groups``), ending at the grid's first and last row."""
    starts = np.asarray(row_groups(H, Mesh(ny, nx, 0, 0, None, None)))
    plans = []
    for g in range(ny * nx):
        src = np.arange(max(starts[g] - k, 0), min(starts[g + 1] + k, H))
        owner = np.searchsorted(starts, src, side="right") - 1
        plans.append((src - starts[owner], owner))
    return plans


def exchange_rows_halo(rows, k: int, mesh: Mesh, grid: Grid) -> torch.Tensor:
    """k-row halo exchange in the row-group layout (``dist.mesh.
    blocks_to_rows``): rank g holds full-width rows [lo, hi) (``dist.
    mesh.row_group``), and its strip is rows [lo - k, hi + k), each row
    straight from the rank that holds it (ranks g-1, g-2, ... where k is
    deeper than a group), one round of paired isend/irecv.  The strip
    ends at the grid's first and last row: the rows of ``dist.local.
    rows_window``, whose shifts apply the grid's own rule there."""
    W = rows.shape[1]
    plans = _rows_plan(grid.height, k, mesh.ny, mesh.nx)
    me = mesh.rank
    src, owner = plans[me]
    if k == 0 or mesh.size == 1:
        return rows                      # the strip is this rank's rows
    wire = _wire(rows)
    out = wire.new_empty((len(src), W))
    ops = []
    # the strip's rows are consecutive, so each rank's share of them is
    # one run of consecutive rows of its group
    for q in range(mesh.size):
        at = np.flatnonzero(owner == q)
        if q == me:
            if len(at):
                out[at[0]:at[-1] + 1] = wire[src[at[0]]:src[at[-1]] + 1]
            continue
        q_src, q_owner = plans[q]
        send = q_src[q_owner == me]
        if len(send):
            ops.append(dist.P2POp(dist.isend, wire[send[0]:send[-1] + 1], q))
        if len(at):
            buf = out[at[0]:at[-1] + 1]
            TRAFFIC["permute"] += _nbytes(buf)
            ops.append(dist.P2POp(dist.irecv, buf, q))
    for req in (dist.batch_isend_irecv(ops) if ops else []):
        req.wait()
    return out.to(rows.dtype)


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
    ``n_sw`` sweeps run.  The monolithic order, which
    ``_overlapped_ksweeps`` equals bit for bit."""
    pp = exchange(p_b)
    for _ in range(k if n_sw is None else min(n_sw, k)):
        pp = _sweep5(pp, *coeffs)
    return pp[k:-k, k:-k]


def _overlapped_ksweeps(p_b, k: int, coeffs, post, n_sw=None,
                        split=None):
    """``_ksweeps`` with the exchange overlapped (the reference's
    ``_overlapped_ksweeps``): post the exchange, sweep the centre of the
    block (out rows and columns [2k, h-2k)), which reads only this rank's
    own cells, wait, then sweep the four frame strips from the padded
    block.  Every cell sees the same stencil inputs as in the monolithic
    order, so the result is the same bit for bit.  ``post`` posts the
    exchange (``post_halo``).  The monolithic order where the block is too
    small to split (h or w < 4k), and with ``split=None`` unless
    ``OVERLAP`` is on and a piece comes from another rank (on a 1x1 mesh
    nothing is in flight); ``split=True`` or ``False`` decides alone."""
    h, w = p_b.shape
    n = k if n_sw is None else min(n_sw, k)

    def run(block, csl):
        for _ in range(n):
            block = _sweep5(block, *csl)
        return block

    def crop(r0, r1, c0, c1):
        return tuple(c[r0:r1, c0:c1] for c in coeffs)

    pending = post(p_b)
    LAST_OVERLAP["rounds"] += 1
    if split is None:
        split = OVERLAP and pending.remote
    if h < 4 * k or w < 4 * k or not split:
        return run(pending.finish(), coeffs)[k:-k, k:-k]

    # centre: block rows/cols [k, h-k) = padded [2k, h); after k sweeps
    # its valid part is out rows/cols [2k, h-2k)
    centre = run(p_b[k:h - k, k:w - k], crop(2 * k, h, 2 * k, w))
    LAST_OVERLAP["split"] += 1
    LAST_OVERLAP["in_flight"] += int(not pending.waited)
    centre = centre[k:-k, k:-k]
    pp = pending.finish()

    # the frame strips from the padded block, each cropped to its core
    S = run(pp[0:4 * k, :], crop(0, 4 * k, 0, w + 2 * k))[k:3 * k, k:-k]
    N = run(pp[h - 2 * k:h + 2 * k, :],
            crop(h - 2 * k, h + 2 * k, 0, w + 2 * k))[k:3 * k, k:-k]
    Wst = run(pp[2 * k:h, 0:4 * k], crop(2 * k, h, 0, 4 * k))[k:-k, k:3 * k]
    E = run(pp[2 * k:h, w - 2 * k:w + 2 * k],
            crop(2 * k, h, w - 2 * k, w + 2 * k))[k:-k, k:3 * k]
    mid = torch.cat([Wst, centre, E], dim=1)
    return torch.cat([S, mid, N], dim=0)


def _padded_coefficients(coeffs, k: int, grid: Grid, mesh: Mesh):
    cN, cS, cE, cW, cC = (exchange_halo(c, k, grid, mesh)
                          for c in coeffs[:5])
    cN, cS = _swap_pole_rows(cN, cS, k, grid, mesh)
    return cN, cS, cE, cW, cC


def _quotas(iters: int, k: int):
    """``iters`` sweeps as rounds of k, the last one the remainder."""
    full, rest = divmod(iters, k)
    return [k] * full + ([rest] if rest else [])


def pressure_solve_sharded(divw, terrain, grid: Grid, mesh: Mesh,
                           iters: int = 5000, k: int = 8,
                           p0=None) -> torch.Tensor:
    """The pressure Poisson solve on blocks: k sweeps per k-wide halo
    exchange of p (``_overlapped_ksweeps``; the coefficients are built on
    the blocks with a 1-ring halo, ``dist.local``, then folded and padded
    once).  From zero, ceil(iters / k) rounds of k sweeps, as the
    reference's halo solver runs; from this rank's block of ``p0``, a
    warm start, exactly ``iters`` sweeps (the last round the remainder),
    as the reference runs its single-device solve there."""
    from ..kernels.jacobi import coefficients
    from .local import block_or_gathered

    LAST_OVERLAP.update(rounds=0, split=0, in_flight=0)
    coeffs = block_or_gathered(coefficients, grid, mesh, 1, halo=(1,))(
        divw, terrain, grid)
    padded = _padded_coefficients(coeffs, k, grid, mesh) \
        + (exchange_halo(coeffs[5], k, grid, mesh),)
    if p0 is None:
        p, quotas = torch.zeros_like(divw), [k] * -(-iters // k)
    else:
        p, quotas = p0, _quotas(iters, k)
    for n_sw in quotas:
        p = _overlapped_ksweeps(p, k, padded,
                                lambda q: post_halo(q, k, grid, mesh),
                                n_sw=n_sw)
    return p


def diffusion_solve_sharded(u, v, terrain, grid: Grid, mesh: Mesh,
                            iters: int = 50, k: int = 10):
    """The implicit-viscosity solve on blocks: k sweeps per halo exchange
    of each of (u, v) (``_overlapped_ksweeps``), velocity pole halos
    negated; the last round runs the remainder of ``iters``.  The
    coefficients as in ``pressure_solve_sharded``."""
    from ..kernels.jacobi import diffusion_coefficients
    from .local import block_or_gathered

    LAST_OVERLAP.update(rounds=0, split=0, in_flight=0)
    coeffs = block_or_gathered(diffusion_coefficients, grid, mesh, 1,
                               halo=(0,))(terrain, grid)
    padded = _padded_coefficients(coeffs, k, grid, mesh)
    padded = padded + (torch.zeros_like(padded[0]),)

    def post(q):
        return post_halo(q, k, grid, mesh, negate_pole=True)

    for n_sw in _quotas(iters, k):
        u = _overlapped_ksweeps(u, k, padded, post, n_sw=n_sw)
        v = _overlapped_ksweeps(v, k, padded, post, n_sw=n_sw)
    return u, v


def diffusion_quirks_sharded(u, v, terrain, grid: Grid, mesh: Mesh,
                             iters: int = 50, k: int = 10):
    """The ``exact_quirks`` viscosity (the reference's sweep as written,
    ``ops.ocean._quirks_sweep``) on blocks: the terrain padded once with
    a k-ring halo and the sweep's tables built on the padded block's
    window (``dist.local``), then rounds of k sweeps of the padded (u, v),
    one k-wide halo exchange of each a round, velocity pole halos
    negated, the last round the remainder of ``iters``.  The window of a
    block with a halo beyond a pole does not reach the pole itself, so
    ``_neighbor_vec`` flips nothing there: the exchange's negation is the
    single-device flip.  The sweep is symmetric in +-dy (two-term sums,
    negation exact), so the halo rows beyond a pole evolve as the exact
    negated mirror of the rows they reflect, and every cell of the block
    equals the single-device sweep bit for bit; at a grid edge that is
    not a pole the block ends and its window clamps, as the grid does."""
    from ..ops.ocean import _quirks_sweep, _quirks_tables
    from .local import block_window, crop_block, pad_block

    win = block_window(grid, mesh, k)
    tables = _quirks_tables(pad_block(terrain, k, grid, mesh), win)
    for n_sw in _quotas(iters, k):
        up = pad_block(u, k, grid, mesh, negate=True)
        vp = pad_block(v, k, grid, mesh, negate=True)
        for _ in range(n_sw):
            up, vp = _quirks_sweep(up, vp, tables, win)
        u, v = crop_block(up, grid, mesh, k), crop_block(vp, grid, mesh, k)
    return u, v


def flow_solve_sharded(code, area2d, mouth, grid: Grid, mesh: Mesh,
                       k: int = 16, max_iters: int = 1 << 20):
    """The flow fixpoint on blocks, the fallback where the two-level solve
    does not apply: the packed masks built on the blocks (``pack_masks``
    with a 1-ring halo of the codes, ``dist.local``), then
    ``flow_solve_sharded_packed``.
    Returns (A, vis bool)."""
    from ..kernels.flow import pack_masks
    from .local import block_or_gathered

    packed_b = block_or_gathered(pack_masks, grid, mesh, 1, halo=(0,))(
        code, mouth, grid)
    return flow_solve_sharded_packed(packed_b, area2d, grid, mesh, k,
                                     max_iters)


def flow_solve_sharded_packed(packed_b, area2d, grid: Grid, mesh: Mesh,
                              k: int = 16, max_iters: int = 1 << 20):
    """k sweeps of the joint (A, vis) relaxation per k-wide halo exchange,
    the packed masks padded once, until a round changes nothing on any
    rank.  Same fixpoint as ``ops.flow.flow_solve_stencil`` (the
    cross-pole bits are masked off, so the pole-cap halo rows are never
    read).  Returns (A, vis bool)."""
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

    A = area2d
    vis = torch.where((packed_b & (1 << 16)) != 0, 1.0, 0.0)
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

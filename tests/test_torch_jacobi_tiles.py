"""The schedule of the tiled Jacobi kernels K2 and K3 (csrc/jacobi.cu), in numpy.

The CUDA kernels cannot run here, so their schedule is transliterated in
float32 and held to the plain twins (``pressure_solve_plain``,
``diffusion_solve_plain``) bit for bit: it is what checks the topology
argument in csrc/jacobi.cu.  A launch runs ``s <= k`` sweeps (k =
``SWEEPS_PER_LAUNCH``; the last launch of a solve runs the remainder) on
every tile: a tile of TH x TW output cells loads an extended region of
(TH + 2k) x (TW + 2k) cells, the field(s) and every coefficient plane, and
sweeps it s times between two buffers, sweep t computing every column of
the rows inset by k - s + t (one row less each sweep; cells that are no
longer right are computed and never read); it writes back its TH x TW
cells.  Each buffer has one spare float before and after it, which the
edge columns' wrapped and pole steps may read.

Inside the extended region a row stands for a row of the grid read in an
unfolded frame: rows past a pole are the rows on the far side of it (row
H + j is row H-1-j at column c + pole_shift, and so on, pole after pole),
their field times pole_sign (-1 for velocity) and cN/cS swapped.  An
extended cell's neighbour is the cell beside it, except across a clamped
edge (it is the cell itself) and on the way back across a pole, where odd
W puts it one column over (2 * pole_shift = W +- 1).  Rows and columns
past a clamped edge, which the kernel fills with arbitrary cells of the
grid, are NaN here, and so are the spare floats and the second buffer
before its first sweep: a valid cell that read any would poison the
result.  The wrong rules
(no column fix at odd W, no cN/cS swap) must disagree with the twins.
"""

import math

import numpy as np
import pytest
import torch

from demiurge_tpu_torch.core.grid import Grid
from demiurge_tpu_torch.kernels import jacobi as kj

torch.set_num_threads(2)

PI = math.pi
GLOBAL = (-PI / 2, PI / 2, -PI, PI)
REGIONAL = (-1.0, 0.9, -2.5, 1.0)
BAND = (-1.0, 0.9, -PI, PI)          # x-periodic, clamped in y
SOUTH_CAP = (-PI / 2, 0.5, -PI, PI)  # the south pole only

K = kj.SWEEPS_PER_LAUNCH

# (W, H, coords): the sizes the kernels must hold at, beside the 256x128
# grids: the golden size, a width below TW + 2k, an odd width, H < 2k, a
# width the halo wraps onto more than twice, one pole only
GRIDS = {
    "256x128-global": (256, 128, GLOBAL),
    "256x128-regional": (256, 128, REGIONAL),
    "256x128-band": (256, 128, BAND),
    "128x64": (128, 64, GLOBAL),
    "96x48": (96, 48, GLOBAL),
    "255x128": (255, 128, GLOBAL),
    "64x12": (64, 12, GLOBAL),
    "33x6": (33, 6, GLOBAL),
    "40x24-south-cap": (40, 24, SOUTH_CAP),
}
ITERS = (0, 1, K - 1, K, K + 1, 41)


def _fdiv(a, b):
    return a // b  # numpy and Python floor: as the kernel's floordiv


def _row_table(e, H, W, wrap_s, wrap_n, s, EW, sign, odd_fix=True):
    """Per extended row (unfolded grid row e): grid row g, column offset,
    sign, cN/cS swapped, steps to the north and south neighbours (in
    extended cells; 0 = the cell itself), and whether the row lies past a
    clamped edge (junk)."""
    delta = 2 * s - W if odd_fix else 0
    m = _fdiv(e, H)
    q = e - m * H
    n = np.abs(m)                      # pole crossings from the grid
    odd = n % 2 == 1
    g = np.where(odd, H - 1 - q, q)
    off = (n * s) % W
    sgn = np.where(odd, np.float32(sign), np.float32(1.0))

    def wraps(mp):                     # the pole at unfolded row mp*H
        return np.where(mp % 2 == 1, bool(wrap_n), bool(wrap_s))

    up = _fdiv(e + 1, H)               # boundary above e when q == H-1
    nstep = np.where(q == H - 1,
                     np.where(wraps(up), EW + np.where(up <= 0, delta, 0), 0),
                     EW)
    sstep = np.where(q == 0,
                     np.where(wraps(m), -EW + np.where(m >= 1, delta, 0), 0),
                     -EW)
    # junk: a pole that does not wrap lies between the grid and row e
    junk = np.zeros(e.shape, bool)
    for i, ee in enumerate(e):
        mm = _fdiv(int(ee), H)
        crossed = range(1, mm + 1) if mm > 0 else range(0, mm, -1)
        junk[i] = any(not (wrap_n if b % 2 else wrap_s) for b in crossed)
    return g, off, sgn, odd, nstep, sstep, junk


def tile_schedule(coeffs, b, fields, grid, iters, tile, k, sign,
                  odd_fix=True, swap=True):
    """The kernels' launches in numpy: (result fields, launches)."""
    f32 = np.float32
    H, W = grid.shape
    wrap_x, wrap_s, wrap_n, s = kj._topology_args(grid)
    TH, TW = tile
    EH, EW = TH + 2 * k, TW + 2 * k
    cN, cS, cE, cW, cC = (np.asarray(c, f32).reshape(-1) for c in coeffs)
    bb = None if b is None else np.asarray(b, f32).reshape(-1)
    src = [np.asarray(f, f32).reshape(-1) for f in fields]
    launches = -(-iters // k)
    for j in range(launches):
        sweeps = min(k, iters - j * k)
        dst = [np.full(H * W, np.nan, f32) for _ in src]
        for r0 in range(0, H, TH):
            for c0 in range(0, W, TW):
                _visit(cN, cS, cE, cW, cC, bb, src, dst, H, W, wrap_x,
                       wrap_s, wrap_n, s, r0, c0, TH, TW, k, EH, EW, sweeps,
                       sign, odd_fix, swap)
        src = dst
    return [f.reshape(H, W) for f in src], launches


def _visit(cN, cS, cE, cW, cC, bb, src, dst, H, W, wrap_x, wrap_s, wrap_n, s,
           r0, c0, TH, TW, k, EH, EW, sweeps, sign, odd_fix, swap):
    f32 = np.float32
    e = r0 - k + np.arange(EH)
    g, off, sgn, odd, nstep, sstep, junk = _row_table(
        e, H, W, wrap_s, wrap_n, s, EW, sign, odd_fix)
    x = c0 - k + np.arange(EW)
    if wrap_x:
        col = (x[None, :] + off[:, None]) % W
        junk_col = np.zeros(EW, bool)
    else:
        col = np.broadcast_to(np.clip(x, 0, W - 1), (EH, EW))
        junk_col = (x < 0) | (x >= W)
    gi = (g[:, None] * W + col).reshape(-1)
    sw = np.repeat(odd & swap, EW)
    bad = (junk[:, None] | junk_col[None, :]).reshape(-1)

    def load(plane, scale=None):
        out = plane[gi].copy()
        if scale is not None:
            out = out * np.repeat(scale, EW)
        out[bad] = np.nan
        return out

    tN = np.where(sw, load(cS), load(cN))
    tS = np.where(sw, load(cN), load(cS))
    tE, tW, tC = load(cE), load(cW), load(cC)
    tB = None if bb is None else load(bb, sgn)
    # a buffer: one spare float, EH x EW cells, one spare float
    spare = np.full(1, np.nan, f32)
    buf = [[np.concatenate([spare, load(f, sgn), spare]),
            np.full(EH * EW + 2, np.nan, f32)] for f in src]
    estep = np.where(wrap_x | (x < W - 1), 1, 0)
    wstep = np.where(wrap_x | (x > 0), -1, 0)
    for t in range(1, sweeps + 1):
        lo = k - sweeps + t
        ly = np.arange(lo, EH - lo)[:, None]
        lx = np.arange(EW)[None, :]
        i = (ly * EW + lx).reshape(-1)
        iN = (ly * EW + lx + nstep[ly]).reshape(-1)
        iS = (ly * EW + lx + sstep[ly]).reshape(-1)
        iE = (ly * EW + lx + estep[lx]).reshape(-1)
        iW = (ly * EW + lx + wstep[lx]).reshape(-1)
        assert iN.max() <= EH * EW and iS.min() >= -1
        for fb in buf:
            a, z = fb[(t - 1) % 2], fb[t % 2]
            acc = tN[i] * a[iN + 1] + tS[i] * a[iS + 1]
            acc = acc + tE[i] * a[iE + 1]
            acc = acc + tW[i] * a[iW + 1]
            acc = acc + tC[i] * a[i + 1]
            if tB is not None:
                acc = acc + tB[i]
            z[i + 1] = acc.astype(f32)
    ry = np.arange(TH)[:, None]
    rx = np.arange(TW)[None, :]
    keep = ((r0 + ry < H) & (c0 + rx < W))
    out = ((r0 + ry) * W + c0 + rx)[keep]
    loc = ((ry + k) * EW + rx + k)[keep]
    for fb, d in zip(buf, dst):
        d[out] = fb[sweeps % 2][loc + 1]


def _case(W, H, coords, seed=0):
    """A smooth land mask with real coastlines, its pressure right-hand
    side and random (u, v), as float32 CPU tensors."""
    from demiurge_tpu_torch.ops import ocean

    rng = np.random.default_rng(seed)
    h = rng.standard_normal((H, W)).astype(np.float32)
    for _ in range(3):
        h = (h + np.roll(h, 1, 0) + np.roll(h, -1, 0)
             + np.roll(h, 1, 1) + np.roll(h, -1, 1)) / 5
    u, v = (rng.standard_normal((2, H, W)) * 0.1).astype(np.float32)
    grid = Grid(W, H, coords)
    h, u, v = (torch.from_numpy(a) for a in (h, u, v))
    div = ocean.divergence(u, v, h, grid, ocean.OceanConfig())
    return grid, h, u, v, div


def _equal(got, want):
    return np.array_equal(np.asarray(got), want.numpy())


@pytest.mark.parametrize("name", list(GRIDS))
def test_pressure_tiles_equal_plain_twin(name):
    grid, h, _, _, div = _case(*GRIDS[name])
    coeffs = kj.coefficients(div, h, grid)
    p0 = torch.from_numpy(np.random.default_rng(1).standard_normal(
        grid.shape).astype(np.float32))
    for iters in ITERS:
        (got,), n = tile_schedule(coeffs[:5], coeffs[5], [p0], grid, iters,
                                  kj.PRESSURE_TILE, K, 1.0)
        want = kj.pressure_solve_plain(*coeffs, p0, grid, iters)
        assert n == kj.launches(iters) == -(-iters // K)
        assert _equal(got, want), (name, iters)


@pytest.mark.parametrize("name", list(GRIDS))
def test_diffusion_tiles_equal_plain_twin(name):
    grid, h, u, v, _ = _case(*GRIDS[name])
    coeffs = kj.diffusion_coefficients(h, grid)
    for iters in ITERS:
        (gu, gv), n = tile_schedule(coeffs, None, [u, v], grid, iters,
                                    kj.DIFFUSION_TILE, K, -1.0)
        wu, wv = kj.diffusion_solve_plain(*coeffs, u, v, grid, iters)
        assert n == kj.launches(iters)
        assert _equal(gu, wu) and _equal(gv, wv), (name, iters)


@pytest.mark.parametrize("tile,k,names", [
    ((4, 8), 3, ("33x6", "40x24-south-cap", "96x48")),
    ((8, 32), 5, ("255x128", "256x128-regional")),
    ((2, 4), 6, ("33x6", "40x24-south-cap"))],
    ids=["4x8-k3", "8x32-k5", "2x4-k6"])
def test_small_tiles_equal_plain_twin(tile, k, names):
    """Other shapes of the same schedule: many tiles, halos deeper than the
    tile, several pole crossings inside one tile's rows."""
    for name in names:
        grid, h, u, v, div = _case(*GRIDS[name])
        dco = kj.diffusion_coefficients(h, grid)
        (gu, gv), _ = tile_schedule(dco, None, [u, v], grid, 2 * k + 1, tile,
                                    k, -1.0)
        wu, wv = kj.diffusion_solve_plain(*dco, u, v, grid, 2 * k + 1)
        assert _equal(gu, wu) and _equal(gv, wv), name
        co = kj.coefficients(div, h, grid)
        (gp,), _ = tile_schedule(co[:5], co[5], [u], grid, 2 * k + 1, tile,
                                 k, 1.0)
        assert _equal(gp, kj.pressure_solve_plain(*co, u, grid, 2 * k + 1))


@pytest.mark.parametrize("rule", ["no-odd-column-fix", "no-swap"])
def test_wrong_pole_rules_disagree(rule):
    """Without the column fix at odd W, or without the cN/cS swap past a
    pole, the schedule leaves the twins: the tests above have teeth."""
    grid, h, u, v, _ = _case(*GRIDS["255x128"])
    coeffs = kj.diffusion_coefficients(h, grid)
    (gu, gv), _ = tile_schedule(
        coeffs, None, [u, v], grid, K + 1, kj.DIFFUSION_TILE, K, -1.0,
        odd_fix=rule != "no-odd-column-fix", swap=rule != "no-swap")
    wu, wv = kj.diffusion_solve_plain(*coeffs, u, v, grid, K + 1)
    assert np.isfinite(gu).all() and np.isfinite(gv).all()
    assert not (_equal(gu, wu) and _equal(gv, wv))

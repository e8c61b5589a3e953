"""The schedule of the tiled packed Jacobi kernel K11e (csrc/jacobi_packed.cu), in numpy.

The CUDA kernel cannot run here, so its schedule is transliterated in
float32 and held bit for bit to the plain twin
(``resident_call_packed_plain``): it is what checks that K2's temporal
blocking (tests/test_torch_jacobi_tiles.py, whose row table this file
reuses) carries over to one bit word a cell and a per-row table.  A launch
runs ``s <= k`` sweeps (the last launch of a solve the remainder) on every
tile of TH x TW output cells: the tile loads an extended region of (TH +
2k) x (TW + 2k) cells, the field(s) and b times pole_sign^n, each cell's
bit word with bits 0 and 1 (N and S solid) swapped on the rows past an
odd number of poles, and each row's (cx, cy, c0) of the grid row it stands
for; it sweeps the region between two buffers as K2 does,

    f' = cx*(pE + pW) + cy*(pN + pS) + (b or c0*f),

a blocked neighbour replaced by the centre, zero on land with the sea
mask, and writes back its own cells.  Rows and columns past a clamped
edge, the spare floats and the second buffer before its first sweep are
NaN, their bits 0: a valid cell that read any would poison the result.
Without the bit swap, or without the pole sign, the schedule must leave
the twin.
"""

import numpy as np
import pytest
import torch

from demiurge_tpu_torch.kernels import jacobi as kj
from demiurge_tpu_torch.kernels import jacobi_packed as kp
from test_torch_jacobi_tiles import BAND, GLOBAL, REGIONAL, _case, _row_table

torch.set_num_threads(2)

K = kp.SWEEPS_PER_LAUNCH

# (W, H, coords): a ragged globe (no tile divides it), an odd width, H <
# 2k (rows across both poles), a width below a tile and its halo, a
# regional grid and a band clamped in y
GRIDS = {
    "200x100-ragged": (200, 100, GLOBAL),
    "255x128-odd": (255, 128, GLOBAL),
    "64x12": (64, 12, GLOBAL),
    "33x6": (33, 6, GLOBAL),
    "96x48": (96, 48, GLOBAL),
    "256x128-regional": (256, 128, REGIONAL),
    "256x128-band": (256, 128, BAND),
}
ITERS = (0, 1, K - 1, K, K + 1, 41)   # every remainder case


def _swap_ns(o):
    return (o & ~3) | ((o & 1) << 1) | ((o >> 1) & 1)


def tile_schedule(ob, tab, b, fields, grid, iters, tile, k, sign, sea_mask,
                  swap=True, signed=True):
    """The kernel's launches in numpy: (result fields, launches).  ``swap``
    False: the bits past a pole keep their grid meaning; ``signed`` False:
    the rows past a pole are not multiplied by pole_sign."""
    f32 = np.float32
    H, W = grid.shape
    wrap_x, wrap_s, wrap_n, s = kj._topology_args(grid)
    ob = np.asarray(ob).reshape(-1)
    tab = np.asarray(tab, f32)
    bb = None if b is None else np.asarray(b, f32).reshape(-1)
    src = [np.asarray(f, f32).reshape(-1) for f in fields]
    launches = -(-iters // k)
    for j in range(launches):
        sweeps = min(k, iters - j * k)
        dst = [np.full(H * W, np.nan, f32) for _ in src]
        for r0 in range(0, H, tile[0]):
            for c0 in range(0, W, tile[1]):
                _visit(ob, tab, bb, src, dst, grid, wrap_x, wrap_s, wrap_n,
                       s, r0, c0, tile, k, sweeps, sign, sea_mask, swap,
                       signed)
        src = dst
    return [f.reshape(H, W) for f in src], launches


def _visit(ob, tab, bb, src, dst, grid, wrap_x, wrap_s, wrap_n, s, r0, c0,
           tile, k, sweeps, sign, sea_mask, swap, signed):
    f32 = np.float32
    H, W = grid.shape
    TH, TW = tile
    EH, EW = TH + 2 * k, TW + 2 * k
    e = r0 - k + np.arange(EH)
    g, off, sgn, odd, nstep, sstep, junk = _row_table(
        e, H, W, wrap_s, wrap_n, s, EW, sign)
    if not signed:
        sgn = np.ones_like(sgn)
    x = c0 - k + np.arange(EW)
    if wrap_x:
        col = (x[None, :] + off[:, None]) % W
        junk_col = np.zeros(EW, bool)
    else:
        col = np.broadcast_to(np.clip(x, 0, W - 1), (EH, EW))
        junk_col = (x < 0) | (x >= W)
    gi = (g[:, None] * W + col).reshape(-1)
    bad = (junk[:, None] | junk_col[None, :]).reshape(-1)

    def load(plane, scale=None):
        out = plane[gi].copy()
        if scale is not None:
            out = out * np.repeat(scale, EW)
        out[bad] = np.nan
        return out

    o = ob[gi].copy()
    if swap:
        o = np.where(np.repeat(odd, EW), _swap_ns(o), o)
    o[bad] = 0
    cx, cy, cc = (np.where(bad, np.nan, np.repeat(tab[g, n], EW)).astype(f32)
                  for n in range(3))
    tB = None if bb is None else load(bb, sgn)
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
        oi = o[i]
        for fb in buf:
            a, z = fb[(t - 1) % 2], fb[t % 2]
            p = a[i + 1]
            pN = np.where(oi & 1, p, a[iN + 1])
            pS = np.where(oi & 2, p, a[iS + 1])
            pE = np.where(oi & 4, p, a[iE + 1])
            pW = np.where(oi & 8, p, a[iW + 1])
            acc = cx[i] * (pE + pW) + cy[i] * (pN + pS)
            acc = acc + (tB[i] if tB is not None else cc[i] * p)
            if sea_mask:
                acc = np.where(oi & 16, f32(0), acc)
            z[i + 1] = acc.astype(f32)
    ry = np.arange(TH)[:, None]
    rx = np.arange(TW)[None, :]
    keep = (r0 + ry < H) & (c0 + rx < W)
    out = ((r0 + ry) * W + c0 + rx)[keep]
    loc = ((ry + k) * EW + rx + k)[keep]
    for fb, d in zip(buf, dst):
        d[out] = fb[sweeps % 2][loc + 1]


def _pressure(name):
    grid, h, _, _, div = _case(*GRIDS[name])
    b = kj.coefficients(div, h, grid)[5]
    p0 = torch.from_numpy(np.random.default_rng(1).standard_normal(
        grid.shape).astype(np.float32))
    return grid, kp.pack_ob(h, grid, True), kp.row_table(grid, "pressure"), \
        b, [p0]


def _viscosity(name):
    grid, h, u, v, _ = _case(*GRIDS[name])
    return grid, kp.pack_ob(h, grid, False), \
        kp.row_table(grid, "viscosity"), None, [u, v]


def _equal(got, want):
    return all(np.array_equal(g, w.numpy()) for g, w in zip(got, want))


@pytest.mark.parametrize("name", list(GRIDS))
def test_pressure_tiles_equal_plain_twin(name):
    grid, ob, tab, b, fields = _pressure(name)
    assert ((ob.numpy() & 16) != 0).any() and ((ob.numpy() & 3) != 0).any()
    for iters in ITERS:
        got, n = tile_schedule(ob, tab, b, fields, grid, iters,
                               kp.TILES[1], K, 1.0, True)
        want = kp.resident_call_packed_plain(ob, tab, b, fields, grid, iters,
                                             True, False)
        assert n == kp.launches(iters) == -(-iters // K)
        assert _equal(got, want), (name, iters)


@pytest.mark.parametrize("name", list(GRIDS))
def test_viscosity_tiles_equal_plain_twin(name):
    grid, ob, tab, b, fields = _viscosity(name)
    for iters in ITERS:
        got, n = tile_schedule(ob, tab, b, fields, grid, iters,
                               kp.TILES[2], K, -1.0, False)
        want = kp.resident_call_packed_plain(ob, tab, b, fields, grid, iters,
                                             False, True)
        assert n == kp.launches(iters)
        assert _equal(got, want), (name, iters)


@pytest.mark.parametrize("tile,k,names", [
    ((4, 8), 3, ("33x6", "96x48", "256x128-regional")),
    ((2, 4), 6, ("33x6", "64x12"))], ids=["4x8-k3", "2x4-k6"])
def test_small_tiles_equal_plain_twin(tile, k, names):
    """Other shapes of the same schedule: many tiles, halos deeper than
    the tile, several pole crossings inside one tile's rows."""
    for name in names:
        for make, sign, sea, neg in ((_pressure, 1.0, True, False),
                                     (_viscosity, -1.0, False, True)):
            grid, ob, tab, b, fields = make(name)
            got, _ = tile_schedule(ob, tab, b, fields, grid, 2 * k + 1,
                                   tile, k, sign, sea)
            want = kp.resident_call_packed_plain(ob, tab, b, fields, grid,
                                                 2 * k + 1, sea, neg)
            assert _equal(got, want), (name, make.__name__)


@pytest.mark.parametrize("rule", ["no-bit-swap", "no-pole-sign"])
def test_wrong_pole_rules_disagree(rule):
    """Without the N/S bit swap past an odd crossing, or without the pole
    sign, the schedule leaves the twin: the tests above have teeth."""
    grid, ob, tab, b, fields = _viscosity("255x128-odd")
    got, _ = tile_schedule(ob, tab, b, fields, grid, K + 1, kp.TILES[2], K,
                           -1.0, False, swap=rule != "no-bit-swap",
                           signed=rule != "no-pole-sign")
    want = kp.resident_call_packed_plain(ob, tab, b, fields, grid, K + 1,
                                         False, True)
    assert all(np.isfinite(g).all() for g in got)
    assert not _equal(got, want)

"""The schedule of the band kernel K5 (csrc/blur.cu), in numpy.

The CUDA kernel cannot run here, so its schedule is transliterated in
float32 and held to the plain twin (``blur_plain``) bit for bit.  A call
is ``kernels.blur.launches``: a "band" launch runs a group of iterations
whose vertical reaches sum to the band's halo, on bands of ``th`` output
rows with that halo a side, whole rows across a cluster of blocks of
``seg`` columns (csrc/bands.cuh); a "passes" launch pair runs one
iteration that alone outgrows a band, a pass a launch.  Extended row j of
the band at r0 stands for the unfolded grid row e = r0 - halo + j (past a
pole the rows on its far side), a copy of that physical row in the grid's
own column order: its vertical taps read the rows ``row_source`` finds in
the band, its horizontal taps its own row at its own shifts.  An
iteration's vertical pass computes the rows still right, [lo, eh - lo)
after the reaches so far sum to lo, and the horizontal pass the same rows,
each dealt out in items as K1's (``item_cells``); every other cell is NaN
here, and so are the rows past a pole that does not
wrap: a right cell that read one would poison the result.

Two wrong rules must leave the twin: a halo one row short, and reads
capped at the block's own columns plus an x halo of 8 (a 2-D tile with a
fixed x halo: the polar rows' horizontal taps reach far beyond).
"""

import math

import numpy as np
import pytest
import torch

from demiurge_tpu_torch.core.grid import Grid
from demiurge_tpu_torch.core.topology import _pole_col_shift
from demiurge_tpu_torch.kernels import bands
from demiurge_tpu_torch.kernels import blur as kb
from demiurge_tpu_torch.ops.blur import sigma_list

from test_torch_climate_tiles import item_cells, junk_rows, row_source, \
    unfold

torch.set_num_threads(2)

PI = math.pi
GLOBAL = (-PI / 2, PI / 2, -PI, PI)
BAND = (-1.0, 0.9, -PI, PI)          # x-periodic, clamped in y
SOUTH_CAP = (-PI / 2, 0.5, -PI, PI)  # the south pole only

# (W, H, coords, plan overrides), as in test_torch_climate_tiles.py
GRIDS = {
    "256x128": (256, 128, GLOBAL, dict(segment=64, smem=30000)),
    "ragged-250x100": (250, 100, GLOBAL, dict(segment=48, smem=30000)),
    "one-tile-column-128x64": (128, 64, GLOBAL, {}),
    "H<2k-64x10": (64, 10, GLOBAL, dict(segment=16, smem=40000)),
    "odd-255x128": (255, 128, GLOBAL, dict(segment=64, smem=30000)),
    "odd-33x6": (33, 6, GLOBAL, dict(segment=8, smem=40000)),
    "band-96x48": (96, 48, BAND, dict(segment=32, smem=40000)),
    "south-cap-40x24": (40, 24, SOUTH_CAP, dict(segment=16, smem=40000)),
}
# the pre-blur's radius; taps several rows away; more than 5 iterations,
# some of which outgrow the smaller bands (two one-pass launches)
RADII = (0.5, 3.0, 12.0)


def band_schedule(field, grid, rlist, plan_kw, halo_short=0, x_halo=None):
    """The kernel's launches in numpy: (result, kernel launches)."""
    f32 = np.float32
    H, W = grid.shape
    ws, wn, s = grid.wrap_south, grid.wrap_north, _pole_col_shift(grid)
    vk, vw, hk, hw, wt = (np.asarray(t) for t in kb.tables(grid, rlist,
                                                             "cpu"))
    plan = kb.launches(grid, rlist, **plan_kw)
    src = np.asarray(field, f32)
    c = np.arange(W)[None, :]
    for kind, i0, m, b in plan:
        its = range(i0, i0 + m)
        if kind == "passes":
            assert m == 1 and kb.reach(rlist[i0]) > bands.halo_max(
                W, kb.LAYOUT, **plan_kw)
            src = _passes(src, grid, vk[i0], vw[i0], hk[i0], hw[i0], wt)
            continue
        assert b.halo == sum(kb.reach(rlist[i]) for i in its)
        assert (b.cluster - 1) * b.seg < W <= b.cluster * b.seg
        assert b.smem(kb.LAYOUT) <= plan_kw.get("smem", bands.SMEM_BYTES)
        halo = b.halo - halo_short
        eh = b.th + 2 * halo
        own = c // b.seg
        dst = np.full((H, W), np.nan, f32)
        for r0 in range(0, H, b.th):
            e = r0 - halo + np.arange(eh)
            q, d = unfold(e, H)
            a = src[q].copy()
            a[junk_rows(e, H, ws, wn)] = np.nan

            def rd(buf, rows, x):
                v = buf[rows[:, None], x % W]
                if x_halo is not None:
                    xx = x - (x - c + W // 2) // W * W   # nearest to c
                    v = np.where((xx >= own * b.seg - x_halo)
                                 & (xx < own * b.seg + b.seg + x_halo),
                                 v, np.nan)
                return v

            lo = 0
            for i in its:
                lo += kb.reach(rlist[i])
                j = np.arange(lo, eh - lo)
                jj, qq, dd = j, q[j], d[j]
                z = np.full_like(a, np.nan)
                acc = a[jj] * wt[0]
                for t in range(kb.TAPS):
                    k, (v0, v1) = int(vk[i, t]), vw[i, t]
                    st, off = row_source(qq, dd, k, H, ws, wn, s)
                    tap = rd(a, jj + st, c + off[:, None]) * v0
                    if v1 != 0:
                        st, off = row_source(qq, dd, k + 1, H, ws, wn, s)
                        tap = tap + rd(a, jj + st, c + off[:, None]) * v1
                    acc = acc + tap * wt[1 + t // 2]
                z[jj] = acc
                done = item_cells(lo, eh - lo, eh, W, b)
                z = np.where(done, z, np.nan)
                y = np.full_like(a, np.nan)
                acc = z[jj] * wt[0]
                for t in range(kb.TAPS):
                    x0 = c + hk[i, t][qq][:, None]
                    tap = rd(z, jj, x0) * hw[i, t, 0][qq][:, None] \
                        + rd(z, jj, x0 + 1) * hw[i, t, 1][qq][:, None]
                    acc = acc + tap * wt[1 + t // 2]
                y[jj] = acc
                a = np.where(done, y, np.nan)
            rows = np.arange(b.th)
            keep = r0 + rows < H
            dst[(r0 + rows)[keep]] = a[(halo + rows)[keep]]
        src = dst
    return src, kb.launch_count(plan)


def _passes(f, grid, vk, vw, hk, hw, wt):
    """One iteration as blur.cu's one-pass kernels compute it: each row
    read where fetch_row resolves it."""
    H, W = grid.shape
    ws, wn, s = grid.wrap_south, grid.wrap_north, _pole_col_shift(grid)
    r = np.arange(H)[:, None]
    c = np.arange(W)[None, :]

    def fetch(k):
        rr = r + k
        north = (rr >= H) & bool(wn and k < H)
        south = (rr < 0) & bool(ws and -k < H)
        row = np.where(north, 2 * H - 1 - rr, np.where(south, -rr - 1,
                                                       np.clip(rr, 0, H - 1)))
        return f[row, (c + np.where(north | south, s, 0)) % W]

    acc = f * wt[0]
    for t in range(kb.TAPS):
        k, (v0, v1) = int(vk[t]), vw[t]
        tap = fetch(k) * v0
        if v1 != 0:
            tap = tap + fetch(k + 1) * v1
        acc = acc + tap * wt[1 + t // 2]
    g = acc
    acc = g * wt[0]
    for t in range(kb.TAPS):
        x0 = (c + hk[t][:, None]) % W
        tap = g[r, x0] * hw[t, 0][:, None] + g[r, (x0 + 1) % W] \
            * hw[t, 1][:, None]
        acc = acc + tap * wt[1 + t // 2]
    return acc


def _field(W, H, coords, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((H, W)).astype(np.float32)
    for _ in range(3):
        h = (h + np.roll(h, 1, 0) + np.roll(h, -1, 0)
             + np.roll(h, 1, 1) + np.roll(h, -1, 1)) / 5
    return Grid(W, H, coords), torch.from_numpy((h - 0.05) * 20)


@pytest.mark.parametrize("name", list(GRIDS))
def test_blur_bands_equal_plain_twin(name):
    W, H, coords, plan_kw = GRIDS[name]
    grid, h = _field(W, H, coords)
    for radius in RADII:
        rlist = sigma_list(radius)
        got, _ = band_schedule(h, grid, rlist, plan_kw)
        want = kb.blur_plain(h, grid, rlist)
        assert np.array_equal(got, want.numpy()), (name, radius)


def test_lone_iterations_run_as_two_passes():
    """Radius 12 on the 256x128 plan: its widest iterations outgrow the
    band and run as the one-pass kernels, the others as band launches."""
    W, H, coords, plan_kw = GRIDS["256x128"]
    kinds = {kind for kind, *_ in kb.launches(Grid(W, H, coords),
                                               sigma_list(12.0), **plan_kw)}
    assert kinds == {"band", "passes"}


@pytest.mark.parametrize("rule", ["halo-one-row-short", "x-halo-of-8"])
def test_wrong_band_rules_disagree(rule):
    """A halo one row short, or a block that sees only its own columns and
    8 more a side, leaves the twin: the tests above have teeth."""
    W, H, coords, plan_kw = GRIDS["256x128"]
    grid, h = _field(W, H, coords)
    rlist = sigma_list(0.5)
    got, _ = band_schedule(h, grid, rlist, plan_kw,
                           halo_short=int(rule == "halo-one-row-short"),
                           x_halo=8 if rule == "x-halo-of-8" else None)
    assert not np.array_equal(got, kb.blur_plain(h, grid, rlist).numpy())


@pytest.mark.parametrize("shape", [(2048, 1024), (8192, 4096)])
def test_blur_launch_counts(shape):
    """The card's plans: the pre-blur (radius 0.5, 5 iterations) in one
    launch (was 10); every band fits a block."""
    grid = Grid(*shape)
    plan = kb.launches(grid, sigma_list(0.5))
    assert kb.launch_count(plan) == 1
    for kind, _, _, b in plan:
        assert kind == "band" and b.halo == 5
        assert b.smem(kb.LAYOUT) <= bands.SMEM_BYTES

"""The schedule of the band kernel K1 (csrc/climate.cu), in numpy.

The CUDA kernel cannot run here, so its schedule is transliterated in
float32 and held to the plain twin (``climate_step_plain``) bit for bit.
A call is ``kernels.climate.launches``: each launch runs ``steps``
substeps on bands of ``th`` output rows with ``steps`` halo rows a side,
whole rows, held across a cluster of blocks of ``seg`` columns each
(csrc/bands.cuh).  Extended row j of the band at r0 stands for the
unfolded grid row e = r0 - steps + j: past a pole the rows on its far side
(row H + i is row H-1-i, row 2H + i is row i, ...), each a copy of that
physical row in the grid's own column order, updated with that row's
corner shifts, insolation and cinv, reading its physical north and south
where ``row_source`` finds them in the band.  Substep t computes the rows
[t, eh - t), dealt out to the blocks' warps in items of 32 * CELLS columns
of a row (``item_cells``), and leaves the others as they were; here those
are NaN, and so are the rows past a pole that does not wrap (the kernel
fills them with arbitrary rows): a right cell that read one would poison
the result.

Two wrong rules must leave the twin: a halo one row short, and reads
capped at the block's own columns plus an x halo of 8 (what a 2-D tile
with a fixed x halo sees: the polar rows' corner taps reach far beyond).
"""

import math

import numpy as np
import pytest
import torch

from demiurge_tpu_torch.core.grid import Grid
from demiurge_tpu_torch.core.stencils import corner_shifts
from demiurge_tpu_torch.core.topology import _pole_col_shift
from demiurge_tpu_torch.kernels import bands
from demiurge_tpu_torch.kernels import climate as kc
from demiurge_tpu_torch.ops import temperature

torch.set_num_threads(2)

PI = math.pi
GLOBAL = (-PI / 2, PI / 2, -PI, PI)
BAND = (-1.0, 0.9, -PI, PI)          # x-periodic, clamped in y
SOUTH_CAP = (-PI / 2, 0.5, -PI, PI)  # the south pole only

# (W, H, coords, plan overrides): the sizes the schedule must hold at.
# Small segments and shared memory give these grids the clusters and bands
# the card's widths get (kernels/bands.py picks 8 blocks of 256 columns
# and 16 bands at 2048x1024).
GRIDS = {
    "256x128": (256, 128, GLOBAL, dict(segment=64, smem=40000)),
    "ragged-250x100": (250, 100, GLOBAL, dict(segment=48, smem=30000)),
    "one-tile-column-128x64": (128, 64, GLOBAL, {}),
    "H<2k-64x10": (64, 10, GLOBAL, dict(segment=16, smem=32000)),
    "odd-255x128": (255, 128, GLOBAL, dict(segment=64, smem=40000)),
    "odd-33x6": (33, 6, GLOBAL, dict(segment=8, smem=32000)),
    "band-96x48": (96, 48, BAND, dict(segment=32, smem=38000)),
    "south-cap-40x24": (40, 24, SOUTH_CAP, dict(segment=16, smem=35000)),
}
SUBSTEPS = (1, 5, 8, 10, 17)


def _fdiv(a, b):
    return a // b  # numpy and Python floor: as the kernel's floordiv


def unfold(e, H):
    """bands.cuh unfold: physical row and orientation of unfolded row e."""
    m = _fdiv(e, H)
    q = e - m * H
    odd = m % 2 == 1
    return np.where(odd, H - 1 - q, q), np.where(odd, -1, 1)


def row_source(q, d, k, H, wrap_s, wrap_n, s):
    """bands.cuh row_source: (extended-row step, column offset) of the row
    physical row q reads at row offset k."""
    rr = q + k
    step = np.where(
        rr >= H, np.where(wrap_n and k < H, d * k, d * (H - 1 - q)),
        np.where(rr < 0, np.where(wrap_s and -k < H, d * k, -d * q), d * k))
    off = np.where((rr >= H) & bool(wrap_n and k < H)
                   | (rr < 0) & bool(wrap_s and -k < H), s, 0)
    return step, off


CELLS = 4  # climate.cu and blur.cu kCells: cells a lane takes at once


def divide(a, b):
    """bands.cuh divide(a, reciprocal(b)): one multiply by ceil(2^32 / b)
    (kept 0, and a returned, at b = 1)."""
    inv = 0 if b == 1 else -(-(1 << 32) // b) % (1 << 32)
    return (a * inv) >> 32 if inv else a


def item_cells(lo, hi, eh, W, b):
    """The cells a pass over rows [lo, hi) computes, as the kernels deal
    them out: every block of the cluster takes items of 32 * CELLS columns
    of one row, item i to row lo + i / groups."""
    done = np.zeros((eh, W), bool)
    for rank in range(b.cluster):
        c0 = rank * b.seg
        ncols = min(b.seg, W - c0)
        groups = -(-ncols // (32 * CELLS))
        it = np.arange((hi - lo) * groups)
        jr = np.array([divide(int(i), groups) for i in it], int)
        l0 = (it - jr * groups) * 32 * CELLS
        lc = l0[:, None] + np.arange(32 * CELLS)[None, :]
        ok = lc < ncols
        done[np.broadcast_to((lo + jr)[:, None], lc.shape)[ok],
             c0 + lc[ok]] = True
    return done


def junk_rows(e, H, wrap_s, wrap_n):
    """Unfolded rows past a pole that does not wrap."""
    out = np.zeros(e.shape, bool)
    for i, ee in enumerate(e):
        m = _fdiv(int(ee), H)
        crossed = range(1, m + 1) if m > 0 else range(0, m, -1)
        out[i] = any(not (wrap_n if b % 2 else wrap_s) for b in crossed)
    return out


def band_schedule(T, cinv, asr, grid, diffusivity, plan_kw, halo_short=0,
                  x_halo=None):
    """The kernel's launches in numpy: (result, launches)."""
    f32 = np.float32
    H, W = grid.shape
    ws, wn, s = grid.wrap_south, grid.wrap_north, _pole_col_shift(grid)
    kneg, kpos = (np.asarray(k) % W for k in corner_shifts(grid))
    D, olr_c = f32(kc.diff_scale(grid, diffusivity)), f32(kc.OLR_COEF)
    src = np.asarray(T, f32)
    cv = np.asarray(cinv, f32)
    tab = np.asarray(asr, f32)
    plan = kc.launches(grid, tab.shape[0], **plan_kw)
    for s0, steps, b in plan:
        assert b.halo == steps and b.cluster * b.seg >= W
        assert (b.cluster - 1) * b.seg < W
        assert b.smem(kc.LAYOUT) <= plan_kw.get("smem", bands.SMEM_BYTES)
        halo = steps - halo_short
        eh = b.th + 2 * halo
        dst = np.full((H, W), np.nan, f32)
        for r0 in range(0, H, b.th):
            e = r0 - halo + np.arange(eh)
            q, d = unfold(e, H)
            ns, no = row_source(q, d, 1, H, ws, wn, s)
            ss, so = row_source(q, d, -1, H, ws, wn, s)
            jn = np.clip(np.arange(eh) + ns, 0, eh - 1)
            js = np.clip(np.arange(eh) + ss, 0, eh - 1)
            a = src[q].copy()
            a[junk_rows(e, H, ws, wn)] = np.nan
            tc = cv[q]
            c = np.arange(W)[None, :]
            own = c // b.seg  # a block's columns, and x_halo more a side
            for t in range(1, steps + 1):
                j = np.arange(t, eh - t)
                qq = q[j][:, None]

                def rd(rows, cols):
                    x = cols % W
                    v = a[rows[:, None], x]
                    if x_halo is not None:
                        lo, hi = own * b.seg - x_halo, own * b.seg + b.seg \
                            + x_halo
                        xx = np.where(x - c > W // 2, x - W,
                                      np.where(c - x > W // 2, x + W, x))
                        v = np.where((xx >= lo) & (xx < hi), v, np.nan)
                    return v

                cl = c + kneg[qq]
                cr = c + kpos[qq]
                left = rd(jn[j], cl + no[j][:, None]) \
                    + rd(js[j], cl + so[j][:, None])
                right = rd(jn[j], cr + no[j][:, None]) \
                    + rd(js[j], cr + so[j][:, None])
                tv = a[j]
                lap = f32(2) * (left + right) - f32(8) * tv
                tk = tv + f32(kc.KELVIN)
                t2 = tk * tk
                olr = olr_c * (t2 * t2)
                change = (tab[s0 + t - 1][q[j]][:, None] - olr) + D * lap
                z = np.full_like(a, np.nan)
                z[j] = tv + change * tc[j]
                a = np.where(item_cells(t, eh - t, eh, W, b), z, np.nan)
            rows = np.arange(b.th)
            keep = r0 + rows < H
            dst[(r0 + rows)[keep]] = a[(halo + rows)[keep]]
        src = dst
    return src, len(plan)


def _case(W, H, coords, substeps, seed=0):
    """T near 50 C with land and ocean, cinv of that terrain, and the
    insolation table of ``substeps`` substeps from index 3."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((H, W)).astype(np.float32)
    for _ in range(3):
        h = (h + np.roll(h, 1, 0) + np.roll(h, -1, 0)
             + np.roll(h, 1, 1) + np.roll(h, -1, 1)) / 5
    grid = Grid(W, H, coords)
    h = torch.from_numpy((h - 0.05) * 20)
    T = temperature.init_temperature(grid, "cpu") + h
    asr = temperature.insolation_table(
        grid, torch.full((), 3.0), substeps, 0.30)
    cinv = (temperature.YEAR_SECONDS / temperature.SUBSTEPS_PER_YEAR
            / temperature.heat_capacity(h)).contiguous()
    return grid, T, cinv, asr


@pytest.mark.parametrize("name", list(GRIDS))
def test_climate_bands_equal_plain_twin(name):
    W, H, coords, plan_kw = GRIDS[name]
    for substeps in SUBSTEPS:
        grid, T, cinv, asr = _case(W, H, coords, substeps)
        got, n = band_schedule(T, cinv, asr, grid, 0.55e6, plan_kw)
        want = kc.climate_step_plain(T, cinv, asr, grid, 0.55e6)
        cap = min(kc.STEPS_PER_LAUNCH,
                  bands.halo_max(W, kc.LAYOUT, **plan_kw))
        assert n == -(-substeps // cap)
        assert np.array_equal(got, want.numpy()), (name, substeps)


def test_climate_bands_hold_nans_where_the_twin_does():
    """Past the stability bound (land's cinv 400 times the model's) the
    land blows up within 10 substeps; the schedule puts its infs and NaNs
    where the twin does."""
    W, H, coords, plan_kw = GRIDS["256x128"]
    grid, T, cinv, asr = _case(W, H, coords, 10)
    cinv = torch.where(cinv > cinv.min(), cinv * 400.0, cinv)
    got, _ = band_schedule(T, cinv, asr, grid, 0.55e6, plan_kw)
    want = kc.climate_step_plain(T, cinv, asr, grid, 0.55e6).numpy()
    assert not np.isfinite(want).all() and np.isfinite(want).any()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    assert np.array_equal(got[fin], want[fin])


@pytest.mark.parametrize("rule", ["halo-one-row-short", "x-halo-of-8"])
def test_wrong_band_rules_disagree(rule):
    """A halo one row short, or a block that sees only its own columns and
    8 more a side, leaves the twin: the tests above have teeth."""
    W, H, coords, plan_kw = GRIDS["256x128"]
    grid, T, cinv, asr = _case(W, H, coords, 10)
    got, _ = band_schedule(
        T, cinv, asr, grid, 0.55e6, plan_kw,
        halo_short=int(rule == "halo-one-row-short"),
        x_halo=8 if rule == "x-halo-of-8" else None)
    want = kc.climate_step_plain(T, cinv, asr, grid, 0.55e6)
    assert not np.array_equal(got, want.numpy())


@pytest.mark.parametrize("shape,substeps,most", [
    ((2048, 1024), 10, 2), ((4096, 2048), 250, 32), ((8192, 4096), 10, 2)],
    ids=["coupled-step", "climate-dispatch", "8192x4096"])
def test_climate_launch_counts(shape, substeps, most):
    """The card's plans: at most 2 launches a coupled step's 10 substeps,
    32 a climate dispatch's 250 at 4096x2048; every band fits a block."""
    grid = Grid(*shape)
    plan = kc.launches(grid, substeps)
    assert len(plan) <= most
    assert sum(steps for _, steps, _ in plan) == substeps
    for _, steps, b in plan:
        assert b.smem(kc.LAYOUT) <= bands.SMEM_BYTES
        assert b.cluster * b.seg >= shape[0] and b.halo == steps

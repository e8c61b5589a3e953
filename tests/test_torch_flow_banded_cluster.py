"""K11d's cluster windows (csrc/flow_deadends.cu banded_cluster_kernel) as
a numpy schedule, held to the plain twin's fixpoint.

The CUDA kernel cannot run here.  This file runs its schedule in numpy
instead: each woken band's segments as clusters in a random order, each
loading its window from the current fields (the band's rows and k rows
each side, the segment's columns and k each side, across the dateline; the
whole row where one segment spans it); the window cut into C slices, each
a copy with one margin column a side; up to k in-place sweeps, each
slice's rows in its own random order (a row's cells side by side, as a
warp's threads), the margins read as they stood when the sweep began (a
push that lands only at the cluster barrier); the outermost row and column
read, never computed;
an exit after a sweep that changed nothing in the window; only the band's
own cells that changed written back, with the 3-bit flags from them.  It
must reach the twin's fixpoint bit for bit (A in float32 scan order, vis
exactly), and three mutations must stop short: a window that does not wrap
at the dateline, a band woken by its own bit 0 alone, and an outer ring
recomputed with absent neighbours read as 0.  ``plan_banded`` is checked at
the sizes the card runs.
"""

import numpy as np
import pytest
import torch

from demiurge_tpu_torch.core.grid import Grid
from demiurge_tpu_torch.kernels import flow as kf
from demiurge_tpu_torch.kernels import flow_deadends as kd
from demiurge_tpu_torch.tools import serpentine

torch.set_num_threads(2)

SCAN = ((1, 1), (0, 1), (-1, 1), (1, 0), (-1, 0), (1, -1), (0, -1),
        (-1, -1))


def _window(state, b, s, band, k, plan, rng, wrap=True, ring=False):
    """One cluster's visit of segment s of band b; returns its 3 flag
    bits."""
    A, vis, inc, out, area = state
    H, W = A.shape
    r0 = b * band
    whole = plan.segments == 1
    c0 = s * plan.seg
    segw = W if whole else min(plan.seg, W - c0)
    WH, WW = band + 2 * k, (W if whole else segw + 2 * k)
    gr = r0 - k + np.arange(WH)
    rows_in = (gr >= 0) & (gr < H)
    if whole:
        gx = np.arange(W)
        cols_in = np.ones(W, bool)
    else:
        x = c0 - k + np.arange(WW)
        gx = x % W
        cols_in = np.ones(WW, bool) if wrap else (x >= 0) & (x < W)
    take = rows_in[:, None] & cols_in[None, :]
    grc = np.ix_(np.where(rows_in, gr, 0), gx)

    def load(f, dtype):
        return np.where(take, f[grc], 0).astype(dtype)

    # the window, with a zero row above and below and a zero column past
    # its end: what is absent reads there (only the ring mutation and the
    # unwrapped dateline read it)
    S = WW + 1
    wA = np.zeros((WH + 2, S), np.float32)
    wV = np.zeros((WH + 2, S), np.uint8)
    wA[1:-1, :WW], wV[1:-1, :WW] = load(A, np.float32), load(vis, np.uint8)
    wInc, wOut = load(inc, np.int64), load(out, np.int64)
    wArea = load(area, np.float32)
    chA = np.zeros((WH, WW), bool)
    chV = np.zeros((WH, WW), bool)
    # the rows and columns a window computes
    lo, hi = max(1, k - r0), min(WH - 1, H - r0 + k)
    if ring:
        lo, hi = max(0, k - r0), min(WH, H - r0 + k)
    xs = np.arange(WW)
    cols = xs if whole or ring else xs[1:-1]
    # each column's neighbour columns (the zero column where absent), and
    # whether a read crosses to another slice: a margin, read as it stood
    # when the sweep began
    sw, _ = plan.slices(WW)
    dx = np.array([d[0] for d in SCAN])[:, None]
    dy = np.array([d[1] for d in SCAN])[:, None]
    src = cols[None, :] + dx
    if whole and wrap:
        src %= WW
    src = np.where((src >= 0) & (src < WW), src, WW)
    cross = (src < WW) & (src // sw != cols[None, :] // sw)
    slice_of = cols // sw
    bit = np.arange(8)[:, None]
    rows = np.arange(lo, hi)
    for _ in range(k):
        snapA, snapV = wA.ravel().copy(), wV.ravel().copy()
        fA, fV = wA.ravel(), wV.ravel()
        # each slice's rows in its own random order, in place
        order = rng.permuted(np.tile(rows, (kd.CLUSTER, 1)), axis=1)
        changed = False
        for q in range(len(rows)):
            R = order[slice_of, q]
            idx = (R[None, :] + 1 + dy) * S + src
            ctr = (R + 1) * S + cols
            nbA = np.where(cross, snapA[idx], fA[idx])
            m = (wInc[R, cols][None, :] >> bit) & 1
            acc = wArea[R, cols]
            for d in range(8):  # scan order, float32
                acc = acc + np.where(m[d] != 0, nbA[d], np.float32(0))
            newA = acc != fA[ctr]
            fA[ctr] = acc
            o = (wOut[R, cols][None, :] >> bit) & 1
            hit = (o * np.where(cross, snapV[idx], fV[idx])).any(axis=0)
            newV = (fV[ctr] == 0) & hit
            fV[ctr] |= newV.astype(np.uint8)
            chA[R, cols] |= newA
            chV[R, cols] |= newV
            changed |= bool(newA.any() or newV.any())
        if not changed:
            break
    wA, wV = wA[:, :WW], wV[:, :WW]
    # write back the band's own cells that changed; flags from them
    ic = slice(None) if whole else slice(k, k + segw)
    ch = chA[k:k + band, ic] | chV[k:k + band, ic]
    rows = slice(r0, r0 + band)
    cols_g = gx[ic]
    A[rows, cols_g] = np.where(chA[k:k + band, ic], wA[1 + k:1 + k + band, ic],
                               A[rows, cols_g])
    vis[rows, cols_g] |= chV[k:k + band, ic].astype(np.uint8)
    rows_ch = ch.any(axis=1)
    rl = np.arange(band)
    return (int(rows_ch.any()) | (int((rows_ch & (rl < k)).any()) << 1)
            | (int((rows_ch & (rl >= band - k)).any()) << 2))


def cluster_rounds(packed, area, band, k, plan, seed, wrap=True,
                   own_bit=False, ring=False, max_rounds=1000):
    """The kernel's rounds in numpy: (A, vis, rounds), rounds None where
    ``max_rounds`` passed with bands still awake."""
    p = packed.numpy().astype(np.int64)
    state = (area.numpy().astype(np.float32).copy(),
             ((p >> 16) & 1).astype(np.uint8), p & 0xff, (p >> 8) & 0xff,
             area.numpy().astype(np.float32))
    H = p.shape[0]
    nb = H // band
    rng = np.random.default_rng(seed)
    flags, rounds = [7] * nb, 0
    while True:
        act = ([b for b in range(nb) if flags[b] & 1] if own_bit
               else kd.active_bands(flags))
        if not act or rounds == max_rounds:
            return state[0], state[1], rounds if not act else None
        work = [(b, s) for b in act for s in range(plan.segments)]
        new = [0] * nb
        for i in rng.permutation(len(work)):
            b, s = work[i]
            new[b] |= _window(state, b, s, band, k, plan, rng, wrap, ring)
        flags, rounds = new, rounds + 1


def _terrain_case(W, H, seed=3):
    """(grid, packed, area) of a smooth random terrain through the port's
    direction pass."""
    from demiurge_tpu_torch.ops import flow as tf

    grid = Grid(W, H)
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((H, W)).astype(np.float32)
    for _ in range(4):
        h = (h + np.roll(h, 1, 0) + np.roll(h, -1, 0) + np.roll(h, 1, 1)
             + np.roll(h, -1, 1)) / 5
    code = tf.flow_directions(torch.from_numpy((h + 0.1) * 10),
                              torch.ones(H, W), grid)
    _, mouth, _ = tf.incoming_mask(code, grid)
    return grid, kf.pack_masks(code, mouth, grid), \
        tf.cell_area_lower_edge(grid, "cpu")


# name: (W, H, band, k, a block's shared bytes or None, inputs); the
# serpentine runs (x0, columns, rows): down and up columns, so it crosses
# every band edge, and east a column at a turn, across slice seams and the
# dateline.  A few shared bytes a block cut the "segments" case's bands.
CASES = {
    "ragged globe": (94, 48, 8, 3, None, "terrain"),
    "band edges": (64, 40, 8, 2, None, (5, 6, 30)),
    "slice seams": (64, 24, 8, 2, None, (1, 60, 3)),
    "dateline": (64, 32, 8, 2, None, (58, 8, 24)),
    "segments": (130, 24, 8, 2, 648, (124, 12, 18)),
}


def _case(name, monkeypatch):
    W, H, band, k, smem, src = CASES[name]
    if src == "terrain":
        grid, packed, area = _terrain_case(W, H)
    else:
        grid = Grid(W, H)
        packed, area = serpentine(grid, "cpu", *src)
    if smem is not None:
        monkeypatch.setattr(kd, "SMEM_BYTES", smem)
    plan = kd.plan_banded(H, W, band, k)
    A, vis, _ = kd.flow_solve_banded_rounds_plain(packed, area, grid, band,
                                                  k)
    return packed, area, band, k, plan, A.numpy(), vis.numpy()


@pytest.mark.parametrize("name", list(CASES))
def test_cluster_schedule_reaches_the_twin_fixpoint(name, monkeypatch):
    packed, area, band, k, plan, want_A, want_vis = _case(name, monkeypatch)
    if name == "segments":  # three segments, the last narrower
        assert (plan.segments, plan.seg) == (3, 44)
    else:
        assert plan.segments == 1
    if name == "ragged globe":  # the last block's slice is narrower
        assert plan.slices(94) == (6, 4)
    seed = list(CASES).index(name)  # an order of its own for each case
    A, vis, rounds = cluster_rounds(packed, area, band, k, plan, seed)
    np.testing.assert_array_equal(A, want_A)
    np.testing.assert_array_equal(vis.astype(bool), want_vis)
    assert rounds is not None and rounds >= 2


@pytest.mark.parametrize("name,mutation", [
    ("dateline", "no wrap"), ("segments", "no wrap"),
    ("band edges", "own bit 0"), ("band edges", "ring")])
def test_cluster_schedule_mutations_stop_short(name, mutation, monkeypatch):
    packed, area, band, k, plan, want_A, want_vis = _case(name, monkeypatch)
    A, vis, rounds = cluster_rounds(packed, area, band, k, plan, 0,
                                    wrap=mutation != "no wrap",
                                    own_bit=mutation == "own bit 0",
                                    ring=mutation == "ring", max_rounds=60)
    # the ring mutation never settles: its recomputed ring keeps pulling
    # the cells beside it down
    assert rounds is None or not (np.array_equal(A, want_A) and
                                  np.array_equal(vis.astype(bool), want_vis))


def test_plan_banded_at_the_card_sizes():
    """The fewest segments whose windows fit a block's 227 KB in clusters
    of 16: one at 2048x1024, two at 4096, three (the last ragged) at
    8192x4096, four with band 128; and a (band, k) that nothing takes."""
    P = kd.BandedPlan
    assert kd.CLUSTER == 16
    assert kd.plan_banded(1024, 2048, 64, 16) == P(1, 2048)
    assert kd.plan_banded(1024, 2048, 64, 4) == P(1, 2048)
    assert kd.plan_banded(256, 4096, 64, 16) == P(2, 2048)
    big = kd.plan_banded(4096, 8192, 64, 16)
    assert big == P(3, 2731) and big.windows(8192, 16) == [2763, 2762]
    assert kd.plan_banded(1024, 2048, 128, 16) == P(1, 2048)
    assert kd.plan_banded(1024, 8192, 128, 16) == P(4, 2048)
    for H, W, band, k in ((1024, 2048, 64, 16), (4096, 8192, 64, 16),
                          (1024, 8192, 128, 16)):
        plan = kd.plan_banded(H, W, band, k)
        sws = [plan.slices(ww) for ww in plan.windows(W, k)]
        assert all(kd.banded_smem(band + 2 * k, sw) <= kd.SMEM_BYTES
                   and last >= 1 for sw, last in sws)
        if plan.segments > 1:  # one segment fewer would not fit
            fewer = kd.BandedPlan(plan.segments - 1,
                                  -(-W // (plan.segments - 1)))
            sw, _ = fewer.slices(fewer.windows(W, k)[0])
            assert kd.banded_smem(band + 2 * k, sw) > kd.SMEM_BYTES
    assert kd.plan_banded(1024, 2048, 1024, 512) is None
    assert kd.plan_banded(256, 1024, 256, 256) is None
    with pytest.raises(ValueError, match="k must be"):
        kd.plan_banded(1024, 2048, 64, 65)


def test_flow_tune_races_k_for_the_banded_rounds():
    """``flow_tune --kernel banded`` races k 4, 8, 16, the constant first;
    it asks for the card."""
    from demiurge_tpu_torch.tools import flow_tune

    runs = flow_tune.variants("banded")
    assert runs[0][1] == {"k": kd.BANDED_K}
    assert sorted(kw["k"] for _, kw in runs) == [4, 8, 16]
    with pytest.raises(SystemExit):
        flow_tune.main(["64", "32", "--kernel", "banded", "--device",
                        "cpu"])

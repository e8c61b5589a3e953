"""K12, the lake-aware flow relaxation (``kernels.lakeflow``), on the CPU.

The kernel (``csrc/lakeflow.cu``) runs only on the card; here its plain
twin and a numpy transliteration of its per-cell arithmetic are held to
what the port ran before it and to the reference.  Tolerances: none.

- the twin against the sweep ``ops.flow.flow_solve_stencil`` ran before
  K12 (copied below): A, vis and root bit for bit after 1, 7 and 64
  sweeps on the lake cases of tests/test_torch_flow_lakes.py (48x24, its
  seeds, the port's numpy lake solver), with connections and roots;
- the transliteration (one thread a cell in blocks of 256 columns, the
  taps skipped where their bit is clear, the connection add last, float32
  adds) against the twin: bit for bit from random states, on a 300x12
  grid no block divides, across the dateline and in both polar rows, with
  a cell that has taps and a connection source, and with 0 connections;
  and on a regional 300x12 grid (no dateline, no poles), where a cell on
  the rim that points off the grid reads its clamped neighbour, as the
  twin's ``shift`` does;
- ``conn_fields`` raises on a repeated source or target;
- the whole ``flow_solve_stencil`` against the reference's with its
  connections: A bit for bit, vis and root exactly, on the globe and on
  a regional grid.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demiurge_tpu.core.grid import Grid as JGrid
from demiurge_tpu.ops import flow as jf
from demiurge_tpu_torch.core.grid import Grid as TGrid
from demiurge_tpu_torch.core.topology import (CODE_DIR, NEIGHBORS_FLOW_ORDER,
                                              shift)
from demiurge_tpu_torch.kernels import flow as kf
from demiurge_tpu_torch.kernels import lakeflow as kl
from demiurge_tpu_torch.ops import flow as tf
from demiurge_tpu_torch.utils import interop
from test_torch_flow_lakes import SEEDS, _fbm_height

torch.set_num_threads(2)

BLOCK = 256   # csrc/lakeflow.cu kThreads: the columns of a block


def _closure_sweeps(code, area2d, mouth, grid, conn_from, conn_to, n,
                    want_root=True):
    """``n`` sweeps of the closure ``ops.flow.flow_solve_stencil`` ran
    before K12, verbatim, from (area, mouth, the sinks' indices)."""
    H, W = grid.shape
    inc = tf._incoming_fields(code, grid)
    outs = [(CODE_DIR[c], (code == c) & tf._row_in_range(
        grid, CODE_DIR[c][1], code.device)) for c in range(1, 10) if c != 5]
    has_conns = conn_from is not None and conn_from.numel() > 0
    root0 = None
    if want_root:
        idx = torch.arange(H * W, device=code.device).reshape(H, W)
        root0 = torch.where(code == 5, idx, -1)

    def sweep(A, vis, root):
        newA = area2d
        for (dx, dy), ok in inc:
            newA = newA + torch.where(
                ok, shift(A, dx, dy, grid, pole_wrap=False), 0.0)
        newvis = mouth
        newroot = root0
        for (dx, dy), m in outs:
            newvis = newvis | (m & shift(vis, dx, dy, grid, pole_wrap=False))
            if want_root:
                newroot = torch.where(
                    m, shift(root, dx, dy, grid, pole_wrap=False), newroot)
        if has_conns:
            newA = newA.reshape(-1).index_add(
                0, conn_to, A.reshape(-1)[conn_from]).reshape(H, W)
            fv = newvis.reshape(-1).clone()
            fv[conn_from] = fv[conn_from] | vis.reshape(-1)[conn_to]
            newvis = fv.reshape(H, W)
        return newA, newvis, newroot

    A, vis, root = area2d, mouth, root0
    for _ in range(n):
        A, vis, root = sweep(A, vis, root)
    return A, vis, root


@pytest.fixture(scope="module")
def lake_cases():
    """Per seed at 48x24 (tests/test_torch_flow_lakes.py's terrains): the
    port's codes, mouths and its numpy lake solution's connections."""
    tg = TGrid(48, 24)
    cases = {}
    for seed in SEEDS:
        h = torch.from_numpy(_fbm_height(48, 24, seed))
        code = tf.flow_directions(tf.blur(h, tg, 0.5), torch.ones(tg.shape),
                                  tg)
        mask, mouth, _ = tf.incoming_mask(code, tg)
        sol = tf.solve_lakes_numpy(mask.numpy().reshape(-1),
                                   mouth.numpy().reshape(-1),
                                   h.numpy().reshape(-1), None, tg)
        assert sol.conn_from.size > 0
        cases[seed] = (code, mouth, torch.from_numpy(sol.conn_from),
                       torch.from_numpy(sol.conn_to))
    return tg, cases


def _bits_equal(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert torch.equal(got, want)


def test_lake_masks_keep_the_scan_order():
    """Bits 0..7 are ``_incoming_fields`` in its order, 8..15 the one-hot
    outgoing offsets in NEIGHBORS_FLOW_ORDER, 16 the mouth, 17 the sink,
    18 a connection source and 19 a connection target."""
    tg = TGrid(48, 24)
    code = torch.from_numpy(np.random.default_rng(2).integers(
        0, 10, tg.shape).astype(np.int32))
    _, mouth, _ = tf.incoming_mask(code, tg)
    src, dst = kl.conn_fields(torch.tensor([13, 700]),
                              torch.tensor([40, 1000]), tg.shape)
    packed = kl.pack_lake_masks(code, mouth, tg, src, dst)
    fields = tf._incoming_fields(code, tg)
    assert [d for d, _ in fields] == list(NEIGHBORS_FLOW_ORDER)
    for i, (_, ok) in enumerate(fields):
        assert torch.equal(((packed >> i) & 1).bool(), ok)
    outs = (packed >> 8) & 0xFF
    assert int((outs & (outs - 1)).abs().max()) == 0   # one-hot
    for i, (dx, dy) in enumerate(NEIGHBORS_FLOW_ORDER):
        want = (code == 5 + dx + 3 * dy) & tf._row_in_range(tg, dy, "cpu")
        assert torch.equal(((packed >> (8 + i)) & 1).bool(), want)
    assert torch.equal(((packed >> 16) & 1).bool(), mouth)
    assert torch.equal(((packed >> 17) & 1).bool(), code == 5)
    assert torch.equal(((packed >> 18) & 1).bool(), src >= 0)
    assert torch.equal(((packed >> 19) & 1).bool(), dst >= 0)
    assert int((src >= 0).sum()) == int((dst >= 0).sum()) == 2
    assert int(packed.max()) < 1 << 20
    assert torch.equal(kl.root_start(packed), torch.where(
        code == 5, torch.arange(48 * 24, dtype=torch.int32).reshape(
            tg.shape), -1))


@pytest.mark.parametrize("sweeps", [1, 7, 64])
@pytest.mark.parametrize("seed", SEEDS)
def test_twin_equals_the_closure_it_replaced(lake_cases, seed, sweeps):
    tg, cases = lake_cases
    code, mouth, cfrom, cto = cases[seed]
    area = tf.cell_area_lower_edge(tg, "cpu")
    want = _closure_sweeps(code, area, mouth, tg, cfrom, cto, sweeps)
    src, dst = kl.conn_fields(cfrom, cto, tg.shape)
    packed = kl.pack_lake_masks(code, mouth, tg, src, dst)
    root0 = kl.root_start(packed)
    launches = kl.LAUNCHES
    got = kl.relax_sweep(packed, area, src, dst, area, mouth, root0, tg,
                         sweeps)
    assert kl.LAUNCHES == launches
    for g, w in zip(got[:2], want[:2]):
        _bits_equal(g, w)
    assert torch.equal(got[2].to(torch.int64), want[2])
    # and without the roots
    A, vis, root = kl.relax_sweep_twin(packed, area, src, dst, area, mouth,
                                       None, tg, sweeps)
    assert root is None
    _bits_equal(A, want[0])
    _bits_equal(vis, want[1])


def _k12_numpy(packed, area, conn_src, conn_dst, A, vis, root, H, W,
               wrap_x):
    """csrc/lakeflow.cu's lake_relax_sweep, one thread at a time: block
    (bx, y), thread t owns x = bx * BLOCK + t, and a thread past W
    returns."""
    dxs = [d[0] for d in NEIGHBORS_FLOW_ORDER]
    dys = [d[1] for d in NEIGHBORS_FLOW_ORDER]
    A_out = np.empty_like(A)
    vis_out = np.empty_like(vis)
    root_out = None if root is None else np.empty_like(root)

    def nbr(y, x, k):
        ny = min(max(y + dys[k], 0), H - 1)
        nx = x + dxs[k]
        if wrap_x:
            nx = nx + W if nx < 0 else (nx - W if nx >= W else nx)
        else:
            nx = min(max(nx, 0), W - 1)
        return ny * W + nx

    for y in range(H):
        for bx in range(-(-W // BLOCK)):
            for t in range(BLOCK):
                x = bx * BLOCK + t
                if x >= W:
                    continue
                p = y * W + x
                bits = int(packed[p])
                a = area[p]
                for k in range(8):
                    if bits & (1 << k):
                        a = np.float32(a + A[nbr(y, x, k)])
                if bits & kl.SRC_BIT:
                    a = np.float32(a + A[conn_src[p]])
                A_out[p] = a
                v = (bits >> 16) & 1
                r = p if bits & kl.SINK_BIT else -1
                out = (bits >> 8) & 0xFF
                if out:
                    n = nbr(y, x, (out & -out).bit_length() - 1)
                    v |= int(vis[n])
                    if root is not None:
                        r = int(root[n])
                if bits & kl.DST_BIT:
                    v |= int(vis[conn_dst[p]])
                vis_out[p] = v
                if root is not None:
                    root_out[p] = r
    return A_out, vis_out, root_out


REGIONAL = (-0.4, 0.3, -1.0, 0.5)   # coords: no pole, no dateline


def _random_case(W, H, n_conn, seed, regional=False):
    """Random codes on a global (or regional) grid, a random state, and
    ``n_conn`` connections from distinct sinks to distinct attach pixels,
    one of them an attach pixel with incoming taps."""
    rng = np.random.default_rng(seed)
    tg = TGrid(W, H, REGIONAL) if regional else TGrid(W, H)
    code = torch.from_numpy(rng.integers(0, 10, (H, W)).astype(np.int32))
    _, mouth, _ = tf.incoming_mask(code, tg)
    area = tf.cell_area_lower_edge(tg, "cpu")
    N = W * H
    sinks = np.flatnonzero(code.numpy().reshape(-1) == 5)
    tapped = np.flatnonzero(kf.pack_masks(code, mouth, tg).numpy().reshape(
        -1) & 0xFF)
    cfrom = rng.choice(sinks, n_conn, replace=False)
    cto = rng.choice(np.setdiff1d(tapped, cfrom), n_conn, replace=False)
    src, dst = kl.conn_fields(torch.from_numpy(cfrom), torch.from_numpy(cto),
                              tg.shape)
    packed = kl.pack_lake_masks(code, mouth, tg, src, dst)
    A = rng.uniform(0, 4, (H, W)).astype(np.float32)
    A[rng.random((H, W)) < 0.1] = 0.0
    vis = rng.random((H, W)) < 0.5
    root = rng.integers(-1, N, (H, W)).astype(np.int32)
    return tg, packed, area, (src, dst), (
        torch.from_numpy(A), torch.from_numpy(vis), torch.from_numpy(root))


@pytest.mark.parametrize("regional", [False, True],
                         ids=["globe", "regional"])
@pytest.mark.parametrize("n_conn", [0, 40], ids=["no-connections",
                                                  "40-connections"])
@pytest.mark.parametrize("with_root", [True, False], ids=["root", "no-root"])
def test_transliteration_equals_twin(n_conn, with_root, regional):
    W, H = 300, 12
    tg, packed, area, (src, dst), (A, vis, root) = _random_case(
        W, H, n_conn, seed=11 + n_conn, regional=regional)
    assert tg.wrap_x != regional
    if not with_root:
        root = None
    p = packed.numpy()
    west = sum(1 << i for i, (dx, _) in enumerate(NEIGHBORS_FLOW_ORDER)
               if dx < 0)
    east = sum(1 << i for i, (dx, _) in enumerate(NEIGHBORS_FLOW_ORDER)
               if dx > 0)
    if regional:
        # what the case covers: cells on the west and east rims that
        # point off the grid (their neighbour clamps), and no tap across
        assert ((p[:, 0] >> 8) & west).any() and ((p[:, -1] >> 8) &
                                                  east).any()
        assert not (p[:, 0] & west).any() and not (p[:, -1] & east).any()
    else:
        # taps over the dateline both ways, both polar rows
        assert (p[:, 0] & west).any() and (p[:, -1] & east).any()
        assert (p[0] & 0xFF).any() and (p[-1] & 0xFF).any()
        assert ((p[0] >> 8) & 0xFF).any() and ((p[-1] >> 8) & 0xFF).any()
    # a connection source on a cell with taps
    if n_conn:
        assert (((p & kl.SRC_BIT) != 0) & ((p & 0xFF) != 0)).any()
    assert int(((p & kl.SRC_BIT) != 0).sum()) == n_conn
    state = (A, vis, root)
    for _ in range(3):
        flat = [None if t is None else t.numpy().reshape(-1) for t in state]
        want = kl.relax_sweep_twin(packed, area, src, dst, *state, tg)
        got = _k12_numpy(p.reshape(-1), area.numpy().reshape(-1),
                         src.numpy().reshape(-1), dst.numpy().reshape(-1),
                         *flat, H, W, tg.wrap_x)
        np.testing.assert_array_equal(
            got[0].view(np.int32), want[0].numpy().reshape(-1).view(np.int32))
        np.testing.assert_array_equal(got[1], want[1].numpy().reshape(-1))
        if with_root:
            np.testing.assert_array_equal(got[2],
                                          want[2].numpy().reshape(-1))
        else:
            assert want[2] is None and got[2] is None
        state = want


@pytest.mark.parametrize("side", ["source", "target"])
def test_conn_fields_raise_on_a_repeated_side(side):
    cfrom = torch.tensor([5, 9, 17], dtype=torch.int64)
    cto = torch.tensor([30, 31, 32], dtype=torch.int64)
    src, dst = kl.conn_fields(cfrom, cto, (8, 16))
    assert src.dtype == dst.dtype == torch.int32
    assert src.reshape(-1)[30] == 5 and dst.reshape(-1)[17] == 32
    assert int((src >= 0).sum()) == int((dst >= 0).sum()) == 3
    if side == "source":
        cfrom = torch.tensor([5, 9, 5], dtype=torch.int64)
    else:
        cto = torch.tensor([30, 30, 32], dtype=torch.int64)
    with pytest.raises(ValueError, match="repeats"):
        kl.conn_fields(cfrom, cto, (8, 16))
    with pytest.raises(ValueError, match="out of"):
        kl.conn_fields(torch.tensor([5]), torch.tensor([128]), (8, 16))


def test_cuda_wrapper_raises_on_cpu_tensors():
    tg = TGrid(64, 32)
    z = torch.zeros(tg.shape)
    i = torch.zeros(tg.shape, dtype=torch.int32)
    launches = kl.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        kl.relax_sweep_cuda(i, z, i, i, z, z > 0, i, tg)
    assert kl.LAUNCHES == launches


@pytest.mark.parametrize("regional", [False, True],
                         ids=["globe", "regional"])
@pytest.mark.parametrize("seed", SEEDS)
def test_solve_matches_reference_with_connections(seed, regional):
    """The reference's codes, mouths and numpy lake solution through both
    ``flow_solve_stencil``s: A bit for bit, vis and root exactly; the
    port counts its sweeps, checked every 64, and launches nothing on
    the CPU."""
    coords = (REGIONAL,) if regional else ()
    jg, tg = JGrid(48, 24, *coords), TGrid(48, 24, *coords)
    h = _fbm_height(48, 24, seed)
    jcode = jf.flow_directions(jf.blur(jnp.asarray(h), jg, 0.5),
                               jnp.ones(jg.shape), jg)
    jmask, jmouth, _ = jf.incoming_mask(jcode, jg)
    jsol = jf.solve_lakes_numpy(np.asarray(jmask).reshape(-1),
                                np.asarray(jmouth).reshape(-1),
                                h.reshape(-1), None, jg)
    sol = interop.lake_solution_from_numpy(jsol)
    area = np.array(jf.cell_area_lower_edge(jg))
    jA, jvis, jroot = jf.flow_solve_stencil(
        jcode, jnp.asarray(area), jmouth, jg,
        conn_from=jnp.asarray(sol.conn_from, jnp.int32),
        conn_to=jnp.asarray(sol.conn_to, jnp.int32), want_root=True)
    launches = kl.LAUNCHES
    A, vis, root = tf.flow_solve_stencil(
        torch.from_numpy(np.array(jcode)), torch.from_numpy(area),
        torch.from_numpy(np.array(jmouth)), tg,
        conn_from=torch.from_numpy(sol.conn_from),
        conn_to=torch.from_numpy(sol.conn_to), want_root=True)
    assert kl.LAUNCHES == launches   # the twin, on the CPU
    np.testing.assert_array_equal(A.numpy().view(np.int32),
                                  np.asarray(jA).view(np.int32))
    np.testing.assert_array_equal(vis.numpy(), np.asarray(jvis))
    assert root.dtype == torch.int64
    np.testing.assert_array_equal(root.numpy(), np.asarray(jroot))
    assert tf.LAST_SOLVE["sweeps"] % 64 == 0 and sol.conn_from.size > 0
    assert bool(vis.any()) and int((root >= 0).sum()) > 0

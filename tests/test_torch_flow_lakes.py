"""The port's full flow filter, with lakes, against the reference.

The same terrain (the reference's fBm, 4 octaves, or a hand-built crater
island) goes through the JAX package on the CPU (its XLA passes and its
numpy lake solver) and through the port on the CPU (the kernels' plain
twins, the port's numpy lake solver and its own C++ one).  Tolerances, and
why:

- parent pointers and roots: exact (the same integer arithmetic); the
  pointer-doubling accumulation: exact on a chain, within 1e-6 (an ulp)
  of the reference on a random forest, where a round's scatter-add sums
  the contributions to one target in an order neither library specifies,
  and within 1e-5 of a brute-force float64 sum (the reference's own
  bound, tests/test_flow.py).
- the direction codes: equal (0 ties on every input here; a tie would
  change the lake solution downstream, so it is counted, not tolerated).
- the lake solution (connections, pass heights, water heights): equal
  array for array, port against reference and native against numpy.
- the lake-aware relaxation on the same inputs: A bit for bit (the
  reference's order: area, the 8 taps in scan order, then the connection
  add), vis and the basin roots exactly.
- the whole flow map: its -1 (unreached) and 0 (flooded) cells equal, the
  rest within 1e-6 of max: the cell area's cos differs by an ulp in one
  row at 48x24 (two libraries), and A**exponent is two libraries' pow.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demiurge_tpu.core.grid import Grid as JGrid
from demiurge_tpu.ops import flow as jf
from demiurge_tpu.ops.noise import NoiseParams, fbm
from demiurge_tpu_torch.core.grid import Grid as TGrid
from demiurge_tpu_torch.native import build as nbuild
from demiurge_tpu_torch.native import lakes as nlakes
from demiurge_tpu_torch.ops import flow as tf
from demiurge_tpu_torch.utils import interop

torch.set_num_threads(2)

CPU = torch.device("cpu")
SEEDS = [3, 5, 7]


def _random_forest(N, seed):
    """parent[i] < i or -1: an acyclic forest."""
    rng = np.random.default_rng(seed)
    parent = np.full(N, -1, np.int64)
    for i in range(1, N):
        if rng.random() < 0.8:
            parent[i] = rng.integers(0, i)
    return parent, rng.random(N).astype(np.float32)


def _brute_force_accumulate(parent, area):
    acc = np.array(area, np.float64)
    for _ in range(len(parent)):
        new = np.array(area, np.float64)
        for i, p in enumerate(parent):
            if p >= 0:
                new[p] += acc[i]
        if np.allclose(new, acc):
            break
        acc = new
    return acc


@pytest.mark.parametrize("coords", [None, (-1.0, 1.0, -2.0, 2.0)],
                         ids=["global", "regional"])
def test_parent_pointers_match_reference(coords):
    kw = {} if coords is None else {"coords": coords}
    jg, tg = JGrid(48, 24, **kw), TGrid(48, 24, **kw)
    code = np.random.default_rng(1).integers(0, 10, (24, 48)).astype(
        np.int32)
    want = np.asarray(jf.parent_pointers(jnp.asarray(code), jg))
    got = tf.parent_pointers(torch.from_numpy(code), tg)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tf._parent_from_code(code, tg), want)
    assert (want == -1).any() and (want >= 0).any()


def test_accumulate_random_forest_matches_reference():
    parent, area = _random_forest(300, 0)
    want = np.asarray(jf.accumulate(jnp.asarray(parent, jnp.int32),
                                    jnp.asarray(area), 10))
    got = tf.accumulate(torch.from_numpy(parent), torch.from_numpy(area), 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got.numpy(),
                               _brute_force_accumulate(parent, area),
                               rtol=1e-5)


def test_accumulate_long_chain():
    """A path longer than 2^rounds would break a lazy doubling;
    ceil(log2(N)) rounds cover it exactly."""
    N = 1000
    parent = np.arange(-1, N - 1, dtype=np.int64)  # i -> i-1
    rounds = tf._doubling_rounds(N)
    assert rounds == jf._doubling_rounds(N)
    got = tf.accumulate(torch.from_numpy(parent), torch.ones(N), rounds)
    np.testing.assert_array_equal(got.numpy(),
                                  np.arange(N, 0, -1, dtype=np.float32))


@pytest.mark.parametrize("case", ["chain", "forest"])
def test_resolve_roots_match_reference(case):
    if case == "chain":
        parent = np.arange(-1, 256, dtype=np.int64)
    else:
        parent, _ = _random_forest(300, 2)
    rounds = tf._doubling_rounds(parent.size)
    want = np.asarray(jf.resolve_roots(jnp.asarray(parent, jnp.int32),
                                       rounds))
    got = tf.resolve_roots(torch.from_numpy(parent), rounds).numpy()
    np.testing.assert_array_equal(got, want)
    assert (parent[got] == -1).all()
    if case == "chain":
        assert (got == 0).all()


def _fbm_height(W, H, seed):
    return np.array(fbm(JGrid(W, H), NoiseParams(
        octaves=4, scale=2.0, min=-2.0, max=3.0, seed=seed)))


@pytest.fixture(scope="module")
def lake_cases():
    """Per seed at 48x24: the reference's codes, masks and lake solution,
    and the port's, each from its own blur and direction pass."""
    jg, tg = JGrid(48, 24), TGrid(48, 24)
    cases = {}
    for seed in SEEDS:
        h = _fbm_height(48, 24, seed)
        jcode = jf.flow_directions(jf.blur(jnp.asarray(h), jg, 0.5),
                                   jnp.ones(jg.shape), jg)
        jmask, jmouth, _ = jf.incoming_mask(jcode, jg)
        jparent = np.asarray(jf.parent_pointers(jcode, jg))
        jsol = jf.solve_lakes_numpy(np.asarray(jmask).reshape(-1),
                                    np.asarray(jmouth).reshape(-1),
                                    h.reshape(-1), jparent, jg)
        tcode = tf.flow_directions(tf.blur(torch.from_numpy(h), tg, 0.5),
                                   torch.ones(tg.shape), tg)
        tmask, tmouth, _ = tf.incoming_mask(tcode, tg)
        cases[seed] = {"h": h, "jcode": np.array(jcode),
                       "jmouth": np.array(jmouth), "jsol": jsol,
                       "tcode": tcode, "tmask": tmask, "tmouth": tmouth,
                       "tparent": tf.parent_pointers(tcode, tg)}
    return jg, tg, cases


def _assert_same_solution(a, b):
    for name, x, y in zip(a._fields, a, b):
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("seed", SEEDS)
def test_solve_lakes_port_native_and_reference(lake_cases, seed):
    """Codes first (a tie would change the lake solution), then the port's
    numpy solver against the reference's and the native one against the
    port's numpy: the arrays equal."""
    _, tg, cases = lake_cases
    c = cases[seed]
    np.testing.assert_array_equal(c["tcode"].numpy(), c["jcode"])
    args = (c["tmask"].numpy().reshape(-1), c["tmouth"].numpy().reshape(-1),
            c["h"].reshape(-1), c["tparent"].numpy(), tg)
    port = tf.solve_lakes_numpy(*args)
    _assert_same_solution(port, c["jsol"])
    calls = nlakes.CALLS
    _assert_same_solution(nlakes.solve_lakes_native(*args), port)
    assert nlakes.CALLS == calls + 1
    assert port.conn_from.size > 0 and np.isfinite(port.lake_wh).any()
    assert np.unique(port.conn_from).size == port.conn_from.size
    assert np.unique(port.conn_to).size == port.conn_to.size


@pytest.mark.parametrize("seed", SEEDS)
def test_flow_solve_stencil_with_lakes(lake_cases, seed):
    """The reference's relaxation with its connections and want_root, and
    the port's on the same inputs: A bit for bit, vis and root exactly."""
    jg, tg, cases = lake_cases
    c = cases[seed]
    area = np.array(jf.cell_area_lower_edge(jg))
    sol = interop.lake_solution_from_numpy(c["jsol"])
    jA, jvis, jroot = jf.flow_solve_stencil(
        jnp.asarray(c["jcode"]), jnp.asarray(area), jnp.asarray(c["jmouth"]),
        jg, conn_from=jnp.asarray(sol.conn_from, jnp.int32),
        conn_to=jnp.asarray(sol.conn_to, jnp.int32), want_root=True)
    A, vis, root = tf.flow_solve_stencil(
        torch.from_numpy(c["jcode"]), torch.from_numpy(area),
        torch.from_numpy(c["jmouth"]), tg,
        conn_from=torch.from_numpy(sol.conn_from),
        conn_to=torch.from_numpy(sol.conn_to), want_root=True)
    np.testing.assert_array_equal(A.numpy(), np.asarray(jA))
    np.testing.assert_array_equal(vis.numpy(), np.asarray(jvis))
    assert root.dtype == torch.int64
    np.testing.assert_array_equal(root.numpy(), np.asarray(jroot))
    assert tf.LAST_SOLVE["sweeps"] % 64 == 0
    # the connections reach cells the lake-free relaxation leaves dry
    A0, vis0, root0 = tf.flow_solve_stencil(
        torch.from_numpy(c["jcode"]), torch.from_numpy(area),
        torch.from_numpy(c["jmouth"]), tg)
    assert root0 is None
    assert int(vis.sum()) > int(vis0.sum())


def _flow_map_close(got, want):
    np.testing.assert_array_equal(got == -1.0, want == -1.0)
    np.testing.assert_array_equal(got == 0.0, want == 0.0)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("lakes", [True, False])
@pytest.mark.parametrize("seed", SEEDS)
def test_flow_filter_matches_reference(seed, lakes):
    """The whole filter, each side with its own blur, directions and numpy
    lake solver; the codes are equal on these inputs."""
    h = _fbm_height(48, 24, seed)
    jcfg = jf.FlowConfig(exponent=1.0, lakes=lakes)
    want = np.asarray(jf.flow_filter(jnp.asarray(h), jnp.ones((24, 48)),
                                     JGrid(48, 24), jcfg,
                                     lake_solver=jf.solve_lakes_numpy))
    tcfg = tf.FlowConfig(**dataclasses.asdict(jcfg))
    got = tf.flow_filter(torch.from_numpy(h), torch.ones(24, 48),
                         TGrid(48, 24), tcfg,
                         lake_solver=tf.solve_lakes_numpy).numpy()
    _flow_map_close(got, want)
    assert (want > 0).sum() > 50
    # flooded cells (0) only with lakes; the south pole row's cells have
    # no area, so they carry 0 either way
    assert bool((want[1:] == 0).any()) == lakes


def test_crater_lake_on_the_global_grid():
    """A dome island on a global 64x32 grid with a rimmed crater whose
    lowest rim cell is a saddle to the east: the crater's sinks connect
    over the saddle, its floor is flooded (0) and the flank beyond the
    saddle carries the crater's area downhill.  Against the reference (codes equal, flow map
    as above)."""
    H, W = 32, 64
    r, c = np.mgrid[0:H, 0:W]
    h = np.full((H, W), -1.0, np.float32)
    dome = (6.0 - 0.1 * (np.abs(r - 15.5) + np.abs(c - 31.5))).astype(
        np.float32)
    h[8:24, 8:56] = dome[8:24, 8:56]
    h[11, 19:37] = h[20, 19:37] = 4.5     # the rim
    h[12:20, 19] = h[12:20, 36] = 4.5
    h[12:20, 20:36] = 2.0                 # the crater floor
    h[15, 36] = 3.0                       # the saddle
    jg, tg = JGrid(W, H), TGrid(W, H)
    jcode = np.asarray(jf.flow_directions(jnp.asarray(h), jnp.ones((H, W)),
                                          jg))
    tcode = tf.flow_directions(torch.from_numpy(h), torch.ones(H, W), tg)
    np.testing.assert_array_equal(tcode.numpy(), jcode)
    cfg = tf.FlowConfig(preblur=0.0, exponent=1.0, lakes=True)
    got = tf.flow_filter(torch.from_numpy(h), torch.ones(H, W), tg,
                         cfg).numpy()
    want = np.asarray(jf.flow_filter(
        jnp.asarray(h), jnp.ones((H, W)), jg,
        jf.FlowConfig(**dataclasses.asdict(cfg)),
        lake_solver=jf.solve_lakes_numpy))
    _flow_map_close(got, want)
    assert (got[12:20, 20:36] == 0.0).all()
    area = tf.cell_area_lower_edge(tg, CPU, cfg.area_scale).numpy()
    assert got[8:24, 37:56].max() > area[12:20, 20:36].sum()
    assert (got[h <= 0] == -1.0).all()


def test_default_lake_solver_is_native_and_builds_in_the_package():
    """The default solver is the port's own C++ build (in
    demiurge_tpu_torch/_build, named by the source's hash), not the numpy
    one and nothing of the reference package."""
    assert tf.default_lake_solver() is nlakes.solve_lakes_native
    path, _ = nbuild.build()
    assert path.parent == nbuild.BUILD_DIR
    assert nbuild.BUILD_DIR.parent.name == "demiurge_tpu_torch"
    assert path.name == f"libdemiurge_native_{nbuild._digest()}.so"
    assert path.is_file()


def test_failed_native_build_raises(tmp_path, monkeypatch):
    """No compiler, or a source that does not compile: the build raises,
    and nothing falls back to the numpy solver."""
    monkeypatch.setattr(nbuild, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(nbuild.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        nbuild.build()
    monkeypatch.undo()
    bad = tmp_path / "lake_solver.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(nbuild, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(nbuild, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        nbuild.build()
    assert not list((tmp_path / "_build").glob("*.so"))

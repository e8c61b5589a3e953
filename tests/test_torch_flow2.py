"""The two-level flow solve (kernels/flow2.py) against the reference.

The same numpy-made terrain goes through the port on the CPU (the K10
kernels' plain twins) and through the JAX package on the CPU (its XLA
twins, and the Pallas kernels in interpret mode).  Tolerances, and why:

- mask_local, the coarse rows and graph, the pointer doubling on these
  inputs: exact (integer work, and the chain sums add in the reference's
  order on the CPU);
- the band-local fixpoints (K10a A and exit ids, K10b vis with a nonzero
  seed): exact; each fixpoint is unique;
- flow_solve_twolevel against flow_solve_stencil: rtol 1e-5, atol 1e-7,
  the reference's own bound (the chain sums reassociate f32 additions).

The CUDA kernels cannot run here; a numpy transliteration of their
schedule (in-place sweeps, rows in random orders, until a sweep writes
nothing) is held to the twins instead.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demiurge_tpu.core.grid import Grid as JGrid
from demiurge_tpu.ops import flow as jf
from demiurge_tpu.pallas_kernels import flow2 as j2
from demiurge_tpu.pallas_kernels.flow import pack_masks as jpack
from demiurge_tpu_torch.core.grid import Grid as TGrid
from demiurge_tpu_torch.kernels import flow as kf
from demiurge_tpu_torch.kernels import flow2 as k2
from demiurge_tpu_torch.ops import blur as tb
from demiurge_tpu_torch.ops import flow as tf

torch.set_num_threads(2)

CPU = torch.device("cpu")
SCAN = ((1, 1), (0, 1), (-1, 1), (1, 0), (-1, 0), (1, -1), (0, -1),
        (-1, -1))


def _height(W, H, seed):
    """A smooth terrain, about 60% land."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((H, W)).astype(np.float32)
    for _ in range(6):
        h = (h + np.roll(h, 1, 0) + np.roll(h, -1, 0) + np.roll(h, 1, 1)
             + np.roll(h, -1, 1)) / 5
    return ((h + 0.1) * 10).astype(np.float32)


def _flow_case(W, H, seed=0):
    """(grids, codes, mouths, area, packed) of the port, and the same as
    JAX arrays."""
    tg = TGrid(W, H)
    hb = tb.blur(torch.from_numpy(_height(W, H, seed)), tg, 0.5)
    code = tf.flow_directions(hb, torch.ones_like(hb), tg)
    _, mouth, _ = tf.incoming_mask(code, tg)
    area = tf.cell_area_lower_edge(tg, CPU)
    packed = kf.pack_masks(code, mouth, tg)
    j = {"code": jnp.asarray(code.numpy()), "mouth": jnp.asarray(
        mouth.numpy()), "area": jnp.asarray(area.numpy())}
    return JGrid(W, H), tg, code, mouth, area, packed, j


@pytest.fixture(scope="module")
def case():
    return _flow_case(128, 64)


def test_index_sets_follow_the_port_order():
    """The reference indexes its _SCAN_ORDER by position; the port derives
    the same sets from NEIGHBORS_FLOW_ORDER."""
    assert k2._DY_POS == j2._DY_POS and k2._DY_NEG == j2._DY_NEG
    assert k2._DX_POS == (0, 3, 5) and k2._DX_NEG == (2, 4, 7)


@pytest.mark.parametrize("band", [8, 16, 32])
def test_mask_local_matches_reference(case, band):
    _, _, _, _, _, packed, _ = case
    got = k2.mask_local(packed, band).numpy()
    want = np.asarray(j2.mask_local(jnp.asarray(packed.numpy()), band))
    np.testing.assert_array_equal(got, want)
    assert (got != packed.numpy()).any()


def _ref_local(packed, area, band, a0=None, with_exit=True):
    ploc = j2.mask_local(jnp.asarray(packed.numpy()), band)
    a = jnp.asarray(area.numpy())
    a0 = a if a0 is None else jnp.asarray(a0.numpy())
    return ploc, j2.flow_local_solve_xla(ploc, a, a0, band,
                                         with_exit=with_exit)


@pytest.mark.parametrize("band", [16, 32])
def test_local_solve_twin_matches_xla_and_interpret(case, band):
    """K10a's twin: A and the exit ids bit for bit against the XLA twin
    and the Pallas kernel (interpret mode), from a cold and a warm
    start."""
    _, _, _, _, area, packed, _ = case
    ploc_t = k2.mask_local(packed, band)
    A, E = k2.flow_local_solve(ploc_t, area, area, band)
    ploc, (jA, jE) = _ref_local(packed, area, band)
    np.testing.assert_array_equal(A.numpy(), np.asarray(jA))
    np.testing.assert_array_equal(E.numpy(), np.asarray(jE).astype(np.int32))
    assert (E.numpy() >= 0).any() and A.numpy().max() > 10 * area.max()
    pA, pE = j2.flow_local_solve(ploc, jnp.asarray(area.numpy()),
                                 jnp.asarray(area.numpy()), band,
                                 interpret=True)
    np.testing.assert_array_equal(A.numpy(), np.asarray(pA))
    np.testing.assert_array_equal(E.numpy(), np.asarray(pE).astype(np.int32))

    warm = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 2, area.shape).astype(np.float32))
    A2, E2 = k2.flow_local_solve(ploc_t, area, warm, band, with_exit=False)
    _, (jA2, _) = _ref_local(packed, area, band, warm, with_exit=False)
    assert E2 is None
    np.testing.assert_array_equal(A2.numpy(), np.asarray(jA2))
    np.testing.assert_array_equal(A2.numpy(), A.numpy())


def _seed(shape, band):
    """Resolved-reachability seeds on the bands' boundary rows, as the
    reference's seeded test scatters them."""
    seed = np.zeros(shape, np.float32)
    seed[band - 1, ::7] = 1.0
    seed[band, 3::11] = 1.0
    seed[2 * band - 1, 5::13] = 1.0
    return seed


@pytest.mark.parametrize("seeded", [False, True], ids=["zero", "seed"])
def test_local_vis_twin_matches_xla_and_interpret(case, seeded):
    """K10b's twin exactly, with an all-zero and a nonzero seed."""
    _, _, _, _, _, packed, _ = case
    band = 16
    seed = _seed(packed.shape, band) if seeded else \
        np.zeros(packed.shape, np.float32)
    got = k2.flow_local_vis(k2.mask_local(packed, band),
                            torch.from_numpy(seed), band).numpy()
    ploc = j2.mask_local(jnp.asarray(packed.numpy()), band)
    want = np.asarray(j2.flow_local_vis_xla(ploc, jnp.asarray(seed), band))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(j2.flow_local_vis(
        ploc, jnp.asarray(seed), band, interpret=True)))
    assert got.dtype == np.float32 and 0 < got.mean() < 1


def test_coarse_graph_matches_reference(case):
    _, _, _, _, area, packed, _ = case
    band = 16
    ploc, (jA, jE) = _ref_local(packed, area, band)
    A, E = k2.flow_local_solve(k2.mask_local(packed, band), area, area, band)
    for x, jx in ((packed, jnp.asarray(packed.numpy())), (A, jA)):
        np.testing.assert_array_equal(k2.coarse_rows(x, band).numpy(),
                                      np.asarray(j2.coarse_rows(jx, band)))
    got = k2.coarse_graph(packed, A, E, band)
    want = j2.coarse_graph(jnp.asarray(packed.numpy()), jA, jE, band)
    for name, g, w in zip(("succ", "m0", "tflat_c", "tflat_g", "srcflat_g",
                           "cross"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert got[5].any() and (got[0] >= 0).any()

    X = k2._accumulate_adaptive(got[0], got[1])
    np.testing.assert_array_equal(
        X.numpy(), np.asarray(j2._accumulate_adaptive(want[0], want[1])))
    vloc = k2.flow_local_vis(k2.mask_local(packed, band),
                             torch.zeros_like(area), band)
    n0 = torch.where(got[5], k2.coarse_rows(vloc, band).reshape(-1)[got[2]],
                     0.0)
    jn0 = jnp.asarray(n0.numpy())
    np.testing.assert_array_equal(
        k2._or_chain_adaptive(got[0], n0).numpy(),
        np.asarray(j2._or_chain_adaptive(want[0], jn0)))


def test_pointer_doubling_matches_reference_on_long_chains():
    """A random forest of long chains (merging trees, depth up to 300):
    the sums and the suffix-OR exactly as the reference computes them."""
    rng = np.random.default_rng(3)
    N = 2000
    order = rng.permutation(N)
    parent = np.full(N, -1, np.int64)
    for i in range(1, N):          # each node points to a later node
        if rng.uniform() < 0.97:
            parent[order[i - 1]] = order[min(N - 1, i + rng.integers(0, 3))]
    parent[order[-1]] = -1
    parent[parent == np.arange(N)] = -1
    m0 = rng.uniform(0, 1, N).astype(np.float32)
    n0 = (rng.uniform(size=N) < 0.01).astype(np.float32)
    tp = torch.from_numpy(parent)
    np.testing.assert_array_equal(
        k2._accumulate_adaptive(tp, torch.from_numpy(m0)).numpy(),
        np.asarray(j2._accumulate_adaptive(jnp.asarray(parent, jnp.int32),
                                           jnp.asarray(m0))))
    np.testing.assert_array_equal(
        k2._or_chain_adaptive(tp, torch.from_numpy(n0)).numpy(),
        np.asarray(j2._or_chain_adaptive(jnp.asarray(parent, jnp.int32),
                                         jnp.asarray(n0))))


@pytest.mark.parametrize("band", [16, 32, 64])
def test_twolevel_matches_stencil(case, band):
    """The reference's bound (tests/test_dist.py test_twolevel_singlechip_
    matches_stencil): A within rtol 1e-5, atol 1e-7 of the stencil's."""
    jg, tg, code, mouth, area, _, j = case
    A0, _, _ = jf.flow_solve_stencil(j["code"], j["area"], j["mouth"], jg)
    A1 = k2.flow_solve_twolevel(code, area, mouth, tg, band=band)
    np.testing.assert_allclose(A1.numpy(), np.asarray(A0), rtol=1e-5,
                               atol=1e-7)
    assert k2.flow_twolevel_supported(tg, band) and k2.pick_band(64) == 64


def test_twolevel_at_256x128_matches_reference_twolevel():
    """Against the reference's own two-level solve (interpret mode) at the
    next size: the same chain sums, so the same bits."""
    jg, tg, code, mouth, area, _, j = _flow_case(256, 128, seed=2)
    want = j2.flow_solve_twolevel(j["code"], j["area"], j["mouth"], jg,
                                  band=32, interpret=True)
    got = k2.flow_solve_twolevel(code, area, mouth, tg, band=32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _kernel_schedule(packed, area, a0, band, seedm, order_seed):
    """The K10a and K10b kernels' schedule, transliterated: in-place
    sweeps, each row a block, rows in a random order each sweep, until a
    sweep writes nothing (csrc/flow.cu flow_local_sweep_kernel and
    flow_local_vis_sweep_kernel)."""
    p = packed.numpy()
    H, W = p.shape
    A, area = a0.numpy().copy(), area.numpy()
    E = np.full((H, W), -1, np.int64)
    vis = seedm.copy()
    cols = np.arange(W)
    rng = np.random.default_rng(order_seed)
    neg, pos = sum(1 << i for i in (5, 6, 7)), sum(1 << i for i in (0, 1, 2))
    for _ in range(H * W):
        wrote = False
        for r in rng.permutation(H):
            acc = area[r].copy()
            for i, (dx, dy) in enumerate(SCAN):
                on = (p[r] >> i) & 1 == 1
                nb = A[min(max(r + dy, 0), H - 1), (cols + dx) % W]
                acc = np.where(on, acc + nb, acc).astype(np.float32)
            out = (p[r] >> 8) & 0xff
            rl = r % band
            cross = ((rl == 0) & ((out & neg) != 0)) \
                | ((rl == band - 1) & ((out & pos) != 0))
            e = np.full(W, -1, np.int64)
            v = vis[r].copy()
            for i, (dx, dy) in enumerate(SCAN):
                on = (out >> i) & 1 == 1
                rr = min(max(r + dy, 0), H - 1)
                e = np.where(on, E[rr, (cols + dx) % W], e)
                v = np.where(on & ~cross, v | vis[rr, (cols + dx) % W], v)
            e = np.where(cross, np.where(rl == 0, cols, W + cols), e)
            if (acc.view(np.int32) != A[r].view(np.int32)).any() \
                    or (e != E[r]).any() or (v != vis[r]).any():
                wrote = True
                A[r], E[r], vis[r] = acc, e, v
        if not wrote:
            return A, E, vis
    raise AssertionError("no fixpoint")


@pytest.mark.parametrize("order_seed", [0, 1])
def test_kernel_schedule_reaches_the_twins_fixpoints(order_seed):
    """Any row order with in-place reads certifies the twins' A, exit ids
    and vis, bit for bit (the argument in csrc/flow.cu)."""
    _, tg, code, mouth, area, packed, _ = _flow_case(64, 32, seed=5)
    band = 8
    ploc = k2.mask_local(packed, band)
    seed = _seed(packed.shape, band)
    seedm = (((packed.numpy() >> 16) & 1) | (seed != 0)).astype(np.uint8)
    A, E, vis = _kernel_schedule(ploc, area, torch.zeros(tg.shape), band,
                                 seedm, order_seed)
    wA, wE = k2.flow_local_solve_plain(ploc, area, torch.zeros(tg.shape),
                                       band)
    wvis = k2.flow_local_vis_plain(ploc, torch.from_numpy(seed), band)
    np.testing.assert_array_equal(A, wA.numpy())
    np.testing.assert_array_equal(E, wE.numpy())
    np.testing.assert_array_equal(vis, wvis.numpy().astype(np.uint8))


def test_k10_wrappers_raise_on_cpu_tensors():
    z = torch.zeros(32, 64)
    p = torch.zeros(32, 64, dtype=torch.int32)
    counts = (k2.LAUNCHES_LOCAL, k2.LAUNCHES_LOCAL_VIS)
    with pytest.raises(ValueError, match="CUDA"):
        k2.flow_local_solve_cuda(p, z, z, 8)
    with pytest.raises(ValueError, match="CUDA"):
        k2.flow_local_vis_cuda(p, z, 8)
    assert (k2.LAUNCHES_LOCAL, k2.LAUNCHES_LOCAL_VIS) == counts

"""The port's device flow path against the reference.

The same numpy-made terrain goes through the JAX package on the CPU (its
XLA passes, and the Pallas flow kernels in interpret mode) and through the
port on the CPU (the kernels' plain twins).  Tolerances, and why:

- the tie-break noise: exact, against the reference's *compiled* hash.
  XLA on the CPU contracts its first multiply-add (px * 0.3183099 + 0.71)
  into a fused one, and the hash amplifies that rounding into another q at
  ~40% of the pixels, so the port computes that step as an fma too.  Run
  op by op, the reference's own hash differs from its compiled one.
- the Sobel gradient: exact; the aspect: an ulp (atan2 of two libraries).
- the direction codes: equal but for knife-edge ties, pixels whose aspect
  lies within 1e-5 of an octant boundary or of the tie-break threshold;
  at most one per 10^4 pixels (none occur on these inputs).
- incoming masks, mouths, packed masks, cell areas: exact.
- the flow fixpoint: A bit for bit and vis exactly, cold and warm (the
  fixpoint is unique; see kernels/flow.py).
- the flow map: A**0.5 of two libraries' pow, 1e-6 of max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demiurge_tpu.core import stencils as jst
from demiurge_tpu.core.grid import Grid as JGrid
from demiurge_tpu.ops import flow as jf
from demiurge_tpu.pallas_kernels.flow import flow_solve_pallas
from demiurge_tpu.pallas_kernels.flow import pack_masks as jpack
from demiurge_tpu.pallas_kernels.visbits import vis_solve_bits
from demiurge_tpu_torch.core import stencils as tst
from demiurge_tpu_torch.core.grid import Grid as TGrid
from demiurge_tpu_torch.kernels import flow as kf
from demiurge_tpu_torch.ops import blur as tb
from demiurge_tpu_torch.ops import flow as tf

torch.set_num_threads(2)

CPU = torch.device("cpu")
SCAN = ((1, 1), (0, 1), (-1, 1), (1, 0), (-1, 0), (1, -1), (0, -1),
        (-1, -1))


def _height(W, H, seed=0):
    """A smooth terrain, about 60% land."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((H, W)).astype(np.float32)
    for _ in range(6):
        h = (h + np.roll(h, 1, 0) + np.roll(h, -1, 0) + np.roll(h, 1, 1)
             + np.roll(h, -1, 1)) / 5
    return ((h + 0.1) * 10).astype(np.float32)


def _case(W, H, seed=0):
    """(grid pair, blurred height, sel, codes) through the port."""
    h = _height(W, H, seed)
    tg = TGrid(W, H)
    hb = tb.blur(torch.from_numpy(h), tg, 0.5)
    sel = torch.ones_like(hb)
    code = tf.flow_directions(hb, sel, tg)
    return JGrid(W, H), tg, h, hb, sel, code


@pytest.fixture(scope="module")
def case():
    return _case(128, 64)


@pytest.mark.parametrize("shape", [(128, 64), (256, 128)])
def test_tie_break_noise_matches_compiled_reference(shape):
    jg, tg = JGrid(*shape), TGrid(*shape)
    compiled = np.asarray(jax.jit(jf.tie_break_noise, static_argnums=0)(jg))
    np.testing.assert_array_equal(tf.tie_break_noise(tg, CPU).numpy(),
                                  compiled)
    eager = np.asarray(jf.tie_break_noise(jg))
    assert (eager != compiled).mean() > 0.3


def test_gradient_and_aspect_match_reference(case):
    jg, tg, _, hb, _, _ = case
    jgm, tgm = jf._coords_mod_grid(jg), tf._coords_mod_grid(tg)
    a = jnp.asarray(hb.numpy())
    jx, jy = jst.texture_gradient(a, jgm)
    tx, ty = tst.texture_gradient(hb, tgm)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_allclose(tst.get_aspect(hb, tgm).numpy(),
                               np.asarray(jst.get_aspect(a, jgm)),
                               rtol=0, atol=5e-7)


def _ties(hb, grid, differ):
    """Of the pixels in ``differ``, those on a knife edge: the aspect within
    1e-5 of an octant boundary, or q within 1e-5 of the tie threshold."""
    aspect = tst.get_aspect(hb, tf._coords_mod_grid(grid)).numpy()
    octant = aspect / (2 * np.pi) * 8
    prob = np.abs(aspect - np.floor(octant) / 8 * 2 * np.pi) / np.pi * 4
    q = tf.tie_break_noise(grid, CPU).numpy()
    edge = (np.abs(octant - np.round(octant)) < 1e-5) | \
        (np.abs(q - prob) < 1e-5)
    return differ & edge


@pytest.mark.parametrize("shape", [(128, 64), (256, 128)])
def test_flow_directions_match_xla(shape):
    jg, tg, _, hb, sel, code = _case(*shape, seed=1)
    sel[:, :8] = 0.0
    code = tf.flow_directions(hb, sel, tg).numpy()
    want = np.asarray(jf.flow_directions(jnp.asarray(hb.numpy()),
                                         jnp.asarray(sel.numpy()), jg))
    differ = code != want
    assert code.dtype == np.int32 and set(np.unique(code)) <= set(range(10))
    assert (code == 0).any() and (code == 5).any()
    assert differ.sum() <= code.size // 10000
    np.testing.assert_array_equal(_ties(hb, tg, differ), differ)


def test_incoming_mask_and_pack_masks_exact(case):
    jg, tg, _, _, _, code = case
    jcode = jnp.asarray(code.numpy())
    jm, jmouth, jint = jf.incoming_mask(jcode, jg)
    tm, tmouth, tint = tf.incoming_mask(code, tg)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tmouth.numpy(), np.asarray(jmouth))
    np.testing.assert_array_equal(tint.numpy(), np.asarray(jint))
    assert tmouth.any()
    np.testing.assert_array_equal(kf.pack_masks(code, tmouth, tg).numpy(),
                                  np.asarray(jpack(jcode, jmouth, jg)))
    np.testing.assert_array_equal(tf.cell_area_lower_edge(tg, CPU).numpy(),
                                  np.asarray(jf.cell_area_lower_edge(jg)))


def test_flow_solve_exact_cold_and_warm(case):
    jg, tg, _, _, _, code = case
    _, mouth, _ = tf.incoming_mask(code, tg)
    area = tf.cell_area_lower_edge(tg, CPU)
    jA, jvis, _ = jf.flow_solve_stencil(jnp.asarray(code.numpy()),
                                        jnp.asarray(area.numpy()),
                                        jnp.asarray(mouth.numpy()), jg)
    jA, jvis = np.asarray(jA), np.asarray(jvis)
    A, vis, root = tf.flow_solve_stencil(code, area, mouth, tg)
    assert root is None
    np.testing.assert_array_equal(A.numpy(), jA)
    np.testing.assert_array_equal(vis.numpy(), jvis)
    assert jA.max() > 20 * area.numpy().max() and jvis.any()

    packed = kf.pack_masks(code, mouth, tg)
    warm = torch.from_numpy(np.random.default_rng(5).uniform(
        -1, 3, tg.shape).astype(np.float32))
    for a0 in (None, torch.zeros(tg.shape), warm):
        got = kf.flow_solve_area_plain(packed, area, tg, a0)
        np.testing.assert_array_equal(got.numpy(), jA)
    np.testing.assert_array_equal(kf.vis_solve_plain(packed, tg).numpy(),
                                  jvis)
    # the basin roots (tests/test_torch_flow_lakes.py adds the lakes)
    _, _, jroot = jf.flow_solve_stencil(jnp.asarray(code.numpy()),
                                        jnp.asarray(area.numpy()),
                                        jnp.asarray(mouth.numpy()), jg,
                                        want_root=True)
    A, vis, root = tf.flow_solve_stencil(code, area, mouth, tg,
                                         want_root=True)
    np.testing.assert_array_equal(A.numpy(), jA)
    np.testing.assert_array_equal(root.numpy(), np.asarray(jroot))


def _in_place_sweeps(packed, area, a0, order_seed):
    """The one-sweep-a-launch schedule of the band-local kernels (K10,
    csrc/flow.cu), transliterated: sweeps in place, the rows (as blocks)
    in a random order each sweep, until a sweep changes nothing."""
    p = packed.numpy()
    A = a0.numpy().copy()
    area = area.numpy()
    H, W = A.shape
    rng = np.random.default_rng(order_seed)
    cols = np.arange(W)
    for _ in range(H * W):
        changed = False
        for r in rng.permutation(H):
            acc = area[r].copy()
            for i, (dx, dy) in enumerate(SCAN):
                on = (p[r] >> i) & 1 == 1
                if on.any():
                    nb = A[min(max(r + dy, 0), H - 1), (cols + dx) % W]
                    acc = np.where(on, acc + nb, acc).astype(np.float32)
            if (acc.view(np.int32) != A[r].view(np.int32)).any():
                changed = True
                A[r] = acc
        if not changed:
            return A
    raise AssertionError("no fixpoint")


@pytest.mark.parametrize("order_seed", [0, 1])
def test_in_place_schedule_reaches_the_same_fixpoint(order_seed):
    """Any block order with in-place reads certifies the same A, bit for
    bit (the argument in csrc/flow.cu's K10 section; the tiled K7's
    schedule is tests/test_torch_flow_tiles.py's)."""
    _, tg, _, _, _, code = _case(64, 32, seed=2)
    _, mouth, _ = tf.incoming_mask(code, tg)
    area = tf.cell_area_lower_edge(tg, CPU)
    packed = kf.pack_masks(code, mouth, tg)
    want = kf.flow_solve_area_plain(packed, area, tg).numpy()
    got = _in_place_sweeps(packed, area, torch.zeros(tg.shape), order_seed)
    np.testing.assert_array_equal(got, want)


def test_flow_filter_device_matches_reference():
    """The port's whole device path against the reference's passes (each
    jitted, as in its compiled step) on the same pre-blurred height, so on
    the same codes.  The blur is held to the reference in
    test_torch_blur.py (compiling the reference's whole path costs the CPU
    half a minute)."""
    jg, tg, h, hb, sel, _ = _case(64, 32, seed=3)
    code = jf.flow_directions(jnp.asarray(hb.numpy()),
                              jnp.asarray(sel.numpy()), jg)
    _, mouth, _ = jf.incoming_mask(code, jg)
    jacc, jvis, _ = jf.flow_solve_stencil(code, jf.cell_area_lower_edge(jg),
                                          mouth, jg)
    want = np.asarray(jnp.where(jvis, jnp.power(jacc, 0.5), -1.0))
    got, acc = tf.flow_filter_device(torch.from_numpy(h), sel, tg,
                                     acc0=torch.zeros(tg.shape),
                                     return_acc=True)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    np.testing.assert_array_equal(got.numpy() == -1.0, want == -1.0)
    assert (want > 0).any()
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_flow_kernels_match_pallas_interpret():
    """The TPU kernels themselves (interpret mode): flow_solve_pallas's A
    (mode "A", warm-started) bit for bit, vis_solve_bits exactly."""
    jg, tg, _, _, _, code = _case(256, 128, seed=4)
    _, mouth, _ = tf.incoming_mask(code, tg)
    area = tf.cell_area_lower_edge(tg, CPU)
    packed = kf.pack_masks(code, mouth, tg)
    jcode, jmouth = jnp.asarray(code.numpy()), jnp.asarray(mouth.numpy())
    a0 = np.full(tg.shape, 0.5, np.float32)
    jA, _ = flow_solve_pallas(jcode, jnp.asarray(area.numpy()), jmouth, jg,
                              k=8, band=64, mode="A", a0=jnp.asarray(a0),
                              interpret=True)
    jvis = vis_solve_bits(jcode, jmouth, jg, interpret=True)
    np.testing.assert_array_equal(
        kf.flow_solve_area(packed, area, tg, torch.from_numpy(a0)).numpy(),
        np.asarray(jA))
    np.testing.assert_array_equal(kf.vis_solve(packed, tg).numpy(),
                                  np.asarray(jvis))

"""The packed Jacobi (kernels/jacobi_packed.py, K11e) against the reference.

The same numpy-made terrain and fields go through the reference's
``attic/jacobi_packed.py`` on the CPU (its Pallas kernel in interpret mode,
on its padded tables) and the port's plain twin (on the unpadded tables
that ``utils.interop.packed_jacobi_from_reference`` cuts from the
reference's).  Tolerances, and why:

- ``pack_ob``: exact (integer bits) against the reference's interior rows;
- ``row_table``: within 1 ulp from the reference's pixel sizes, and within
  a few ulps from the port's own (its cos of the row latitude differs from
  XLA's by an ulp at some rows, and the table's divisions carry that on);
- the sweeps: within 1e-5 of the field's max.  The reference refreshes its
  pole halos every k sweeps and sweeps the halo rows as mirror images, the
  port indexes the pole neighbour directly; the two are the same
  recurrence, but XLA may fuse the reference's multiply-adds.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attic import jacobi_packed as jp
from demiurge_tpu.core.grid import Grid as JGrid
from demiurge_tpu.pallas_kernels.jacobi import _pad_rows
from demiurge_tpu_torch.core.grid import Grid as TGrid
from demiurge_tpu_torch.kernels import jacobi as kj
from demiurge_tpu_torch.kernels import jacobi_packed as kp
from demiurge_tpu_torch.utils import interop

torch.set_num_threads(2)

PI = math.pi
GLOBAL = (-PI / 2, PI / 2, -PI, PI)
REGIONAL = (-1.0, 0.9, -2.5, 1.0)


def _case(coords, W=256, H=128, seed=0):
    """Grids, a terrain with coastlines, and (u, v) of 0.1 scale."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((H, W)).astype(np.float32)
    for _ in range(3):
        h = (h + np.roll(h, 1, 0) + np.roll(h, -1, 0) + np.roll(h, 1, 1)
             + np.roll(h, -1, 1)) / 5
    h = ((h - 0.05) * 20).astype(np.float32)
    u, v = (rng.standard_normal((2, H, W)) * 0.1).astype(np.float32)
    return JGrid(W, H, coords), TGrid(W, H, coords), h, u, v


@pytest.mark.parametrize("sea_bit", [True, False])
@pytest.mark.parametrize("coords", [GLOBAL, REGIONAL],
                         ids=["global", "regional"])
def test_pack_ob_matches_reference_interior(coords, sea_bit):
    jg, tg, h, _, _ = _case(coords)
    k = 8
    want = np.asarray(jp._pack_ob(jnp.asarray(h), jg, k, sea_bit))
    tab = np.asarray(jp._row_table(jg, k, "pressure"))
    ob, _ = interop.packed_jacobi_from_reference(want, tab, k)
    got = kp.pack_ob(torch.from_numpy(h), tg, sea_bit)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ob)
    assert ((ob & 15) != 0).any() and (((ob & 16) != 0).any() == sea_bit)


@pytest.mark.parametrize("mode", ["pressure", "viscosity"])
@pytest.mark.parametrize("coords", [GLOBAL, REGIONAL],
                         ids=["global", "regional"])
def test_row_table_matches_reference_within_an_ulp(coords, mode):
    """From the reference's pixel sizes the table is within an ulp; from
    the port's own (its cos differs from XLA's by an ulp at some rows) the
    difference grows through the table's five operations to a few."""
    jg, tg, h, _, _ = _case(coords)
    k = 4
    ob = np.asarray(jp._pack_ob(jnp.asarray(h), jg, k, True))
    _, want = interop.packed_jacobi_from_reference(
        ob, np.asarray(jp._row_table(jg, k, mode)), k)
    dxr, dyr = jg.pixelsize_rows()
    same_dx = kp.row_coefficients(torch.from_numpy(np.array(dxr)),
                                  torch.tensor(np.float32(dyr)), mode)
    np.testing.assert_array_max_ulp(same_dx.numpy(), want, maxulp=1)
    got = kp.row_table(tg, mode).numpy()
    assert got.shape == (128, 3) and got.dtype == np.float32
    np.testing.assert_array_max_ulp(got, want, maxulp=4)


def test_interop_cuts_the_pads():
    ob = np.arange(10 * 4, dtype=np.int32).reshape(10, 4)
    tab = np.arange(10 * 8, dtype=np.float32).reshape(10, 8)
    o, t = interop.packed_jacobi_from_reference(ob, tab, 2)
    np.testing.assert_array_equal(o, ob[2:8])
    np.testing.assert_array_equal(t, tab[2:8, :3])
    assert o.flags.c_contiguous and t.flags.c_contiguous


def _reference_inputs(jg, h, k, mode, sea_bit):
    ob = jp._pack_ob(jnp.asarray(h), jg, k, sea_bit)
    tab = jp._row_table(jg, k, mode)
    ob_t, tab_t = interop.packed_jacobi_from_reference(
        np.asarray(ob), np.asarray(tab), k)
    return ob, tab, torch.from_numpy(ob_t), torch.from_numpy(tab_t)


def test_pressure_twin_matches_pallas_interpret():
    """k 20, 40 sweeps, from p = 0 with a sea-masked b."""
    jg, tg, h, _, _ = _case(GLOBAL)
    k, iters = 20, 40
    rng = np.random.default_rng(1)
    b = (rng.standard_normal(h.shape) * (h <= 0)).astype(np.float32)
    ob, tab, ob_t, tab_t = _reference_inputs(jg, h, k, "pressure", True)
    p0 = np.zeros_like(b)
    (want,) = jp._resident_call_packed(
        ob, tab, _pad_rows(jnp.asarray(b), k, jg),
        [_pad_rows(jnp.asarray(p0), k, jg)], jg, k, iters, sea_mask=True,
        negate=False, interpret=True)
    (got,) = kp.resident_call_packed(ob_t, tab_t, torch.from_numpy(b),
                                     [torch.from_numpy(p0)], tg, iters,
                                     sea_mask=True, negate=False)
    want = np.asarray(want)
    scale = np.abs(want).max()
    assert scale > 0 and (got.numpy()[h > 0] == 0).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * scale)


def test_viscosity_twin_matches_pallas_interpret():
    """k 12, 24 sweeps on (u, v) together, the sign flipping at the
    poles."""
    jg, tg, h, u, v = _case(GLOBAL, seed=2)
    k, iters = 12, 24
    ob, tab, ob_t, tab_t = _reference_inputs(jg, h, k, "viscosity", False)
    want = jp._resident_call_packed(
        ob, tab, None,
        [_pad_rows(jnp.asarray(f), k, jg, negate=True) for f in (u, v)],
        jg, k, iters, sea_mask=False, negate=True, interpret=True)
    got = kp.resident_call_packed(ob_t, tab_t, None,
                                  [torch.from_numpy(u), torch.from_numpy(v)],
                                  tg, iters, sea_mask=False, negate=True)
    scale = max(np.abs(np.asarray(w)).max() for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5 * scale)


@pytest.mark.parametrize("coords", [GLOBAL, REGIONAL],
                         ids=["global", "regional"])
def test_twin_agrees_with_the_coefficient_plane_sweeps(coords):
    """The same solves as K2/K3's twins (per-pixel coefficients), within
    the bounds chip_smoke.py holds the kernels to (1e-4 of max|p|, 2e-5 of
    max|u|)."""
    from demiurge_tpu_torch.ops import ocean

    _, tg, h, u, v = _case(coords, seed=3)
    h, u, v = (torch.from_numpy(a) for a in (h, u, v))
    div = ocean.divergence(u, v, h, tg, ocean.OceanConfig())
    co = kj.coefficients(div, h, tg)
    p0 = torch.zeros_like(div)
    (got,) = kp.resident_call_packed(kp.pack_ob(h, tg, True),
                                     kp.row_table(tg, "pressure"), co[5],
                                     [p0], tg, 60, True, False)
    want = kj.pressure_solve(*co, p0, tg, 60)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    dco = kj.diffusion_coefficients(h, tg)
    gu, gv = kp.resident_call_packed(kp.pack_ob(h, tg, False),
                                     kp.row_table(tg, "viscosity"), None,
                                     [u, v], tg, 30, False, True)
    wu, wv = kj.diffusion_solve(*dco, u, v, tg, 30)
    scale = float(wu.abs().max())
    for g, w in ((gu, wu), (gv, wv)):
        assert float((g - w).abs().max()) <= 2e-5 * scale


def test_wrapper_checks(monkeypatch):
    _, tg, h, u, _ = _case(GLOBAL)
    ht = torch.from_numpy(h)
    ob, tab = kp.pack_ob(ht, tg, True), kp.row_table(tg, "pressure")
    before = kp.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        kp.resident_call_packed_cuda(ob, tab, None, [ht], tg, 2, True, False)
    with pytest.raises(ValueError, match="fields"):
        kp.resident_call_packed(ob, tab, None, [ht] * 3, tg, 2, True, False)
    with pytest.raises(ValueError, match="shape"):
        kp.resident_call_packed(ob, tab[:5], None, [ht], tg, 2, True, False)
    with pytest.raises(ValueError, match="mode"):
        kp.row_table(tg, "salinity")
    assert kp.LAUNCHES == before
    (same,) = kp.resident_call_packed(ob, tab, None, [ht], tg, 0, True,
                                      False)
    assert torch.equal(same, ht)

"""The port's climate (stencils, insolation, substeps) against the reference.

The same numpy-made fields go through the JAX package on the CPU (its XLA
path, and the Pallas climate kernel in interpret mode) and through the port
on the CPU, where ``temperature_step`` runs the kernel's plain twin.
Tolerances, and why:

- ``texture_laplacian``: the same taps in the same order; 1e-6 of max
  (an ulp of the 4dy^2 normalisation).
- ``qday``: float32 trig of two libraries (XLA's and torch's) an ulp or two
  apart; 2e-6 of the insolation's max.
- the substeps: the port's kernel sums the four corner taps (the straight
  taps cancel in lx + ly) and folds dt/C into one factor, where the XLA
  path sums both Laplacian components and divides by C last; the
  reference holds its own two forms to rtol 2e-5, atol 2e-4
  (tests/test_pallas.py), and so does this file.
- ``run_years``: 300 substeps of that difference; same bound.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demiurge_tpu.core import stencils as jst
from demiurge_tpu.core.grid import Grid as JGrid
from demiurge_tpu.ops import temperature as jt
from demiurge_tpu.pallas_kernels.climate import climate_step_pallas
from demiurge_tpu_torch.core import stencils as tst
from demiurge_tpu_torch.core.grid import Grid as TGrid
from demiurge_tpu_torch.ops import temperature as tt

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _fields(W, H, seed=0):
    """A smooth terrain with land and ocean, and a non-uniform T."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((H, W)).astype(np.float32)
    for _ in range(4):
        h = (h + np.roll(h, 1, 0) + np.roll(h, -1, 0) + np.roll(h, 1, 1)
             + np.roll(h, -1, 1)) / 5
    h = (h * 20).astype(np.float32)
    T = (50.0 + 10 * rng.standard_normal((H, W))).astype(np.float32)
    return h, T


def _close(got, want, rtol=2e-5, atol=2e-4):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


def test_texture_laplacian_matches_reference():
    _, T = _fields(128, 64)
    jx, jy = jst.texture_laplacian(jnp.asarray(T), JGrid(128, 64))
    tx, ty = tst.texture_laplacian(torch.from_numpy(T), TGrid(128, 64))
    for got, want in ((tx, jx), (ty, jy)):
        scale = float(np.abs(np.asarray(want)).max())
        np.testing.assert_allclose(got.numpy() / scale,
                                   np.asarray(want) / scale, atol=1e-6)
    # a regional grid: the gather branch, exactly the reference's
    regional = (-1.0, 1.0, -2.0, 2.0)
    jx, jy = jst.texture_laplacian(jnp.asarray(T), JGrid(128, 64, regional))
    tx, ty = tst.texture_laplacian(torch.from_numpy(T),
                                   TGrid(128, 64, regional))
    for got, want in ((tx, jx), (ty, jy)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_qday_and_init_temperature():
    phi = np.linspace(-1.57, 1.57, 181, dtype=np.float32).reshape(-1, 1)
    M = np.linspace(0, 2 * np.pi, 48, dtype=np.float32).reshape(1, -1)
    want = np.asarray(jt.qday(jnp.asarray(phi), jnp.asarray(M)))
    got = tt.qday(torch.from_numpy(phi), torch.from_numpy(M)).numpy()
    scale = float(np.abs(want).max())
    assert scale > 400
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-6)
    T0 = tt.init_temperature(TGrid(64, 32), CPU)
    np.testing.assert_array_equal(T0.numpy(),
                                  np.asarray(jt.init_temperature(
                                      JGrid(64, 32))))


def test_substep_reference_form_matches():
    h, T = _fields(128, 64)
    want = jt._substep(jnp.asarray(T), jnp.asarray(h), jnp.float32(0.7),
                       JGrid(128, 64), 0.30, 0.55e6)
    got = tt._substep(torch.from_numpy(T), torch.from_numpy(h),
                      torch.tensor(0.7), TGrid(128, 64), 0.30, 0.55e6)
    _close(got, want)


@pytest.mark.parametrize("i0", [0.0, 3.0, 7499.0])
def test_temperature_step_matches_xla(i0):
    h, T = _fields(128, 64)
    jT, ji = jt.temperature_step(jnp.asarray(T), jnp.asarray(h), i0,
                                 JGrid(128, 64), substeps=10)
    tT, ti = tt.temperature_step(torch.from_numpy(T), torch.from_numpy(h),
                                 i0, TGrid(128, 64), substeps=10)
    assert float(ti) == float(ji) == i0 + 10
    assert ti.dtype == torch.float32 and ti.shape == ()
    _close(tT, jT)


def test_temperature_step_matches_pallas_interpret():
    """Against the TPU kernel itself (interpret mode, band 64): the same
    corner-tap algebra, with halos instead of direct pole indexing."""
    h, T = _fields(256, 128, seed=1)
    jT, ji = climate_step_pallas(jnp.asarray(T), jnp.asarray(h), 3.0,
                                 JGrid(256, 128), substeps=10, band=64,
                                 interpret=True)
    tT, ti = tt.temperature_step(torch.from_numpy(T), torch.from_numpy(h),
                                 3.0, TGrid(256, 128), substeps=10)
    assert float(ti) == float(ji)
    _close(tT, jT)


def test_run_years_matches_reference():
    h, T = _fields(64, 32, seed=2)
    years = 300 / tt.SUBSTEPS_PER_YEAR
    jT, ji = jt.run_years(jnp.asarray(T), jnp.asarray(h), JGrid(64, 32),
                          years=years, substeps_per_dispatch=100)
    seen = []
    tT, ti = tt.run_years(torch.from_numpy(T), torch.from_numpy(h),
                          TGrid(64, 32), years=years,
                          substeps_per_dispatch=100,
                          progress=lambda i, n: seen.append(i) or True)
    assert float(ti) == float(ji) == 300.0
    assert seen == [99, 199, 299]
    _close(tT, jT)

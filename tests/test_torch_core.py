"""The port's grid and wrap topology against the reference package.

Same inputs (numpy, from a seed) through both packages; JAX runs on the CPU.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demiurge_tpu.core import topology as jtopo
from demiurge_tpu.core.grid import Grid as JGrid
from demiurge_tpu_torch.core import topology as ttopo
from demiurge_tpu_torch.core.grid import Grid as TGrid

torch.set_num_threads(2)

PI = math.pi
CPU = torch.device("cpu")

# a global grid, a regional grid that clamps on every side, and a polar cap
# that reflects across the south pole only
GRIDS = {
    "global": (64, 32, (-PI / 2, PI / 2, -PI, PI)),
    "regional": (48, 24, (-1.0, 0.8, -2.0, 1.5)),
    "south_cap": (64, 20, (-PI / 2, -0.3, -PI, PI)),
}


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_grid_geometry_matches_reference(name):
    W, H, coords = GRIDS[name]
    jg, tg = JGrid(W, H, coords), TGrid(W, H, coords)
    assert (tg.wrap_x, tg.wrap_south, tg.wrap_north) == \
        (jg.wrap_x, jg.wrap_south, jg.wrap_north)
    jdx, jdy = jg.pixelsize_rows()
    tdx, tdy = tg.pixelsize_rows(CPU)
    np.testing.assert_allclose(tdx.numpy(), np.asarray(jdx), rtol=1e-6)
    np.testing.assert_allclose(float(tdy), float(jdy), rtol=1e-6)
    jlam, jphi = jg.lam_phi()
    tlam, tphi = tg.lam_phi(CPU)
    np.testing.assert_allclose(tlam.numpy(), np.asarray(jlam), rtol=1e-6)
    np.testing.assert_allclose(tphi.numpy(), np.asarray(jphi), rtol=1e-6)
    np.testing.assert_allclose(tg.row_t(CPU).numpy(), np.asarray(jg.row_t()),
                               rtol=1e-6)
    np.testing.assert_allclose(tg.cell_area_rows(CPU).numpy(),
                               np.asarray(jg.cell_area_rows()), rtol=1e-6)
    assert tphi.dtype == tlam.dtype == tdx.dtype == torch.float32


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_shift_matches_reference_exactly(name):
    W, H, coords = GRIDS[name]
    jg, tg = JGrid(W, H, coords), TGrid(W, H, coords)
    f = np.random.default_rng(5).standard_normal((H, W)).astype(np.float32)
    jf, tf = jnp.asarray(f), torch.from_numpy(f)
    for dx in range(-2, 3):
        for dy in range(-2, 3):
            want = np.asarray(jtopo.shift(jf, dx, dy, jg))
            got = ttopo.shift(tf, dx, dy, tg).numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"{dx},{dy}")


def test_shift_batched_matches_per_field():
    tg = TGrid(*GRIDS["global"][:2])
    f = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 32, 64)).astype(np.float32))
    for dx, dy in ((1, 0), (0, 1), (-1, -2), (2, 2)):
        both = ttopo.shift(f, dx, dy, tg)
        for i in range(2):
            assert torch.equal(both[i], ttopo.shift(f[i], dx, dy, tg))


def test_pole_reflection_off_the_ring_is_not_ported():
    """Ported since: a grid that touches both poles but is not x-periodic
    reflects through the general nearest sampler, as the reference does
    (the name is kept from when the port raised here)."""
    coords = (-PI / 2, PI / 2, -1.0, 1.0)
    jg, tg = JGrid(32, 16, coords), TGrid(32, 16, coords)
    f = np.random.default_rng(7).standard_normal((16, 32)).astype(np.float32)
    for dx in (-2, 0, 1):
        for dy in (-3, -1, 1, 2):
            np.testing.assert_array_equal(
                ttopo.shift(torch.from_numpy(f), dx, dy, tg).numpy(),
                np.asarray(jtopo.shift(jnp.asarray(f), dx, dy, jg)))

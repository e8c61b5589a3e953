"""The port's Jacobi solves (kernels/jacobi.py) against the reference.

The plain twins run here on the CPU against both reference forms: the
Pallas resident kernels in interpret mode and the XLA sweeps of
ops.ocean.  The CUDA kernel is held to its plain twin on the card in
test_torch_cuda.py.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demiurge_tpu.core.grid import Grid as JGrid
from demiurge_tpu.ops import ocean as jocean
from demiurge_tpu.pallas_kernels import jacobi as jjacobi
from demiurge_tpu_torch.core.grid import Grid as TGrid
from demiurge_tpu_torch.kernels import jacobi as kj

torch.set_num_threads(2)

PI = math.pi
CPU = torch.device("cpu")
REGIONAL = (-1.0, 0.9, -2.5, 1.0)


def _setup(W, H, coords=(-PI / 2, PI / 2, -PI, PI), seed=0):
    """A smooth land mask with real coastlines and random (u, v), in numpy."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((H, W)).astype(np.float32)
    for _ in range(3):
        h = (h + np.roll(h, 1, 0) + np.roll(h, -1, 0)
             + np.roll(h, 1, 1) + np.roll(h, -1, 1)) / 5
    u = (rng.standard_normal((H, W)) * 0.1).astype(np.float32)
    v = (rng.standard_normal((H, W)) * 0.1).astype(np.float32)
    return JGrid(W, H, coords), TGrid(W, H, coords), h, u, v


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _divergence(jg, h, u, v):
    cfg = jocean.OceanConfig()
    return np.asarray(jocean.divergence(jnp.asarray(u), jnp.asarray(v),
                                        jnp.asarray(h), jg, cfg))


@pytest.mark.parametrize("coords", ["global", "regional"])
def test_coefficients_match_reference(coords):
    c = REGIONAL if coords == "regional" else (-PI / 2, PI / 2, -PI, PI)
    jg, tg, h, u, v = _setup(64, 32, c)
    div = _divergence(jg, h, u, v)
    want = jjacobi._coefficients(jnp.asarray(div), jnp.asarray(h), jg)
    got = kj.coefficients(_t(div), _t(h), tg)
    for name, w, g in zip(("cN", "cS", "cE", "cW", "cC", "b"), want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-30, err_msg=name)
    want = jjacobi._diffusion_coefficients(jnp.asarray(h), jg)
    got = kj.diffusion_coefficients(_t(h), tg)
    for name, w, g in zip(("cN", "cS", "cE", "cW", "cC"), want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-30, err_msg=name)


def test_pressure_plain_matches_resident_kernel_and_xla():
    """40 sweeps at 256x128 from zero, within 2e-4 of max|p| of both the
    interpret-mode resident kernel and the XLA sweep (f32 reassociation:
    the coefficient form regroups the reference formula; the tolerance is
    the reference's own resident-vs-XLA bound)."""
    jg, tg, h, u, v = _setup(256, 128)
    div = _divergence(jg, h, u, v)
    cfg = jocean.OceanConfig(jacobi_iters=40, pressure_method="xla")
    xla = np.asarray(jocean.pressure_solve(jnp.asarray(div), jnp.asarray(h),
                                           jg, cfg))
    res = np.asarray(jjacobi.pressure_solve_resident(
        jnp.asarray(div), jnp.asarray(h), jg, iters=40, k=20, interpret=True))
    coeffs = kj.coefficients(_t(div), _t(h), tg)
    got = kj.pressure_solve_plain(*coeffs, torch.zeros(tg.shape), tg,
                                  40).numpy()
    scale = np.abs(xla).max()
    assert scale > 0
    np.testing.assert_allclose(got / scale, res / scale, atol=2e-4)
    np.testing.assert_allclose(got / scale, xla / scale, atol=2e-4)


def test_diffusion_plain_matches_resident_kernel_and_xla():
    """50 sweeps on (u, v) at 256x128, within 2e-5 of max|u| of both the
    interpret-mode resident kernel (with its remainder round) and the XLA
    sweep."""
    jg, tg, h, u, v = _setup(256, 128)
    cfg = jocean.OceanConfig(diffusion_iters=50)
    xu, xv = (np.asarray(a) for a in jocean.diffusion(
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(h), jg, cfg))
    ru, rv = (np.asarray(a) for a in jjacobi.diffusion_solve_resident(
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(h), jg, iters=50, k=12,
        interpret=True))
    coeffs = kj.diffusion_coefficients(_t(h), tg)
    gu, gv = (a.numpy() for a in kj.diffusion_solve_plain(
        *coeffs, _t(u), _t(v), tg, 50))
    scale = np.abs(xu).max()
    for got, res, xla in ((gu, ru, xu), (gv, rv, xv)):
        np.testing.assert_allclose(got / scale, res / scale, atol=2e-5)
        np.testing.assert_allclose(got / scale, xla / scale, atol=2e-5)


def test_solves_on_a_regional_grid_match_xla():
    """A grid that clamps on all four edges (no ring, no pole): the clamp
    folds of the coefficients against the XLA sweeps' clamped shifts."""
    jg, tg, h, u, v = _setup(96, 64, REGIONAL)
    div = _divergence(jg, h, u, v)
    cfg = jocean.OceanConfig(jacobi_iters=40, diffusion_iters=50,
                             pressure_method="xla")
    xla = np.asarray(jocean.pressure_solve(jnp.asarray(div), jnp.asarray(h),
                                           jg, cfg))
    got = kj.pressure_solve_plain(*kj.coefficients(_t(div), _t(h), tg),
                                  torch.zeros(tg.shape), tg, 40).numpy()
    scale = np.abs(xla).max()
    np.testing.assert_allclose(got / scale, xla / scale, atol=2e-4)

    xu, xv = (np.asarray(a) for a in jocean.diffusion(
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(h), jg, cfg))
    gu, gv = (a.numpy() for a in kj.diffusion_solve_plain(
        *kj.diffusion_coefficients(_t(h), tg), _t(u), _t(v), tg, 50))
    scale = np.abs(xu).max()
    np.testing.assert_allclose(gu / scale, xu / scale, atol=2e-5)
    np.testing.assert_allclose(gv / scale, xv / scale, atol=2e-5)


def test_dispatch_runs_the_plain_twin_on_cpu():
    jg, tg, h, u, v = _setup(64, 32)
    coeffs = kj.diffusion_coefficients(_t(h), tg)
    before = kj.DIFFUSION_LAUNCHES
    a = kj.diffusion_solve(*coeffs, _t(u), _t(v), tg, 3)
    b = kj.diffusion_solve_plain(*coeffs, _t(u), _t(v), tg, 3)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert kj.DIFFUSION_LAUNCHES == before

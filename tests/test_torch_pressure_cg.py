"""The port's preconditioned CG pressure solve (ops/pressure_cg.py)
against the reference, run op by op, on the divergence of an advected
state at 64x32 (the recipe of tests/test_pressure_cg.py).

Tolerances, and why:

- The iteration count: equal to the reference's (read from its
  ``while_loop`` carry), at the default rtol, at rtol 0 with a fixed
  count, and at a tight rtol that runs to the cap.
- p: within 1e-4 of max|p|.  The dot products sum in another order (XLA's
  dot against torch's sum), which moves alpha and beta by ulps each
  iteration; measured 2e-5 to 4e-5.
- The system (A applied, rhs, the diagonal) and the preconditioner on the
  same vector: within 1e-6 relative (the rFFT is pocketfft in both, the
  order of its butterflies not guaranteed).
- The property of tests/test_pressure_cg.py:39: the obstacle-adjusted
  gradients of the port's CG within 2% of a deep Jacobi solve of the same
  screened system.
- ``OceanConfig(pressure_method="cg")`` drives ``ocean_step`` with the CG
  solve: u and v within 1e-4 of max|u| of the reference's jitted step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demiurge_tpu.core.grid import Grid as JGrid
from demiurge_tpu.ops import ocean as jo
from demiurge_tpu.ops import pressure_cg as jcg
from demiurge_tpu.ops.noise import NoiseParams, fbm
from demiurge_tpu_torch.core.grid import Grid as TGrid
from demiurge_tpu_torch.core.topology import shift
from demiurge_tpu_torch.ops import ocean as to
from demiurge_tpu_torch.ops import pressure_cg as tcg
from demiurge_tpu_torch.utils import interop

torch.set_num_threads(2)

W, H = 64, 32
JG, TG = JGrid(W, H), TGrid(W, H)


@pytest.fixture(scope="module")
def state():
    with jax.disable_jit():
        h = fbm(JG, NoiseParams(octaves=4, scale=2.0, min=-2.0, max=3.0,
                                seed=7))
    cfg = jo.OceanConfig(jacobi_iters=300, diffusion_iters=5)
    u, v = jo.init_ocean(JG)
    for _ in range(3):
        u, v = jo.advect(u, v, h, JG, cfg)
    d = jo.divergence(u, v, h, JG, cfg)
    return np.array(h), np.array(d)


def _reference_cg(h, d, monkeypatch, **kw):
    """The reference op by op, with its loop's final carry kept: returns
    (p, iterations)."""
    carry = {}

    def while_loop(cond, body, init):
        val = init
        while cond(val):
            val = body(val)
        carry["it"] = int(val[-1])
        return val

    monkeypatch.setattr(jax.lax, "while_loop", while_loop)
    with jax.disable_jit():
        p = jcg.pressure_solve_cg(jnp.asarray(d), jnp.asarray(h), JG, **kw)
    return np.asarray(p), carry["it"]


@pytest.mark.parametrize("iters, rtol", [(200, 1e-4), (40, 0.0),
                                         (200, 1e-6)])
def test_cg_iterations_and_pressure_match(state, monkeypatch, iters, rtol):
    h, d = state
    want, want_it = _reference_cg(h, d, monkeypatch, iters=iters, rtol=rtol)
    got = tcg.pressure_solve_cg(torch.from_numpy(d), torch.from_numpy(h),
                                TG, iters=iters, rtol=rtol).numpy()
    assert tcg.LAST_SOLVE["iterations"] == want_it
    if rtol == 0.0:
        assert want_it == iters
    scale = np.abs(want).max()
    assert scale > 0
    err = np.abs(got - want).max() / scale
    print(f"iters {iters} rtol {rtol}: {want_it} iterations, p err/max "
          f"{err:.2e}")
    assert err <= 1e-4


def test_cg_warm_start_matches(state, monkeypatch):
    h, d = state
    p0 = np.random.default_rng(0).normal(0, 1e3, d.shape).astype(np.float32)
    want, want_it = _reference_cg(h, d, monkeypatch, iters=30, rtol=0.0,
                                  p0=jnp.asarray(p0))
    got = tcg.pressure_solve_cg(torch.from_numpy(d), torch.from_numpy(h),
                                TG, iters=30, rtol=0.0,
                                p0=torch.from_numpy(p0)).numpy()
    assert tcg.LAST_SOLVE["iterations"] == want_it == 30
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_system_and_preconditioner_match(state):
    h, d = state
    rng = np.random.default_rng(1)
    x = rng.normal(size=d.shape).astype(np.float32)
    jA, jrhs, jdiag, joC = jcg._system(jnp.asarray(d), jnp.asarray(h), JG,
                                       eps=1e-3)
    tA, trhs, tdiag, toC = tcg._system(torch.from_numpy(d),
                                       torch.from_numpy(h), TG, eps=1e-3)
    np.testing.assert_array_equal(toC.numpy(), np.asarray(joC))
    np.testing.assert_array_equal(trhs.numpy(), np.asarray(jrhs))
    np.testing.assert_allclose(tdiag.numpy(), np.asarray(jdiag), rtol=1e-6)
    want = np.asarray(jA(jnp.asarray(x)))
    np.testing.assert_allclose(tA(torch.from_numpy(x)).numpy(), want,
                               rtol=0, atol=1e-6 * np.abs(want).max())
    jM = jcg._row_spectral_precond(jnp.asarray(d), JG, eps=1e-3)
    tM = tcg._row_spectral_precond(torch.from_numpy(d), TG, eps=1e-3)
    want = np.asarray(jM(jnp.asarray(x)))
    got = tM(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_cg_gradients_match_converged_jacobi(state):
    """The property of tests/test_pressure_cg.py:39 for the port: its CG
    agrees with a deep Jacobi solve of the same screened system on the
    gradients that the projection consumes."""
    h, d = state
    th, td = torch.from_numpy(h), torch.from_numpy(d)
    eps = 1e-3
    A, rhs, diag, _ = tcg._system(td, th, TG, eps=eps)
    p_j = torch.zeros_like(td)
    for _ in range(4000):
        p_j = p_j + (rhs - A(p_j)) / diag
    p_c = tcg.pressure_solve_cg(td, th, TG, iters=200, rtol=1e-6, eps=eps)

    def grads(p):
        out = []
        for dx, dy in ((1, 0), (0, 1)):
            plus = torch.where(shift(th, dx, dy, TG) > 0, p,
                               shift(p, dx, dy, TG))
            minus = torch.where(shift(th, -dx, -dy, TG) > 0, p,
                                shift(p, -dx, -dy, TG))
            out.append((plus - minus).numpy())
        return out

    water = h <= 0
    for a, b in zip(grads(p_j), grads(p_c)):
        scale = np.abs(a[water]).max() + 1e-9
        assert np.abs(a - b)[water].max() / scale < 0.02


def test_ocean_step_with_cg_matches_reference(state):
    h, _ = state
    jcfg = jo.OceanConfig(jacobi_iters=50, diffusion_iters=5,
                          pressure_method="cg", cg_iters=100)
    tcfg = interop.ocean_config_from_dict(dataclasses.asdict(jcfg))
    assert tcfg.pressure_method == "cg"
    ju, jv = jo.init_ocean(JG)
    tu, tv = to.init_ocean(TG, "cpu")
    th = torch.from_numpy(h)
    for _ in range(2):
        ju, jv, _, _ = jo.ocean_step(ju, jv, jnp.asarray(h), JG, jcfg)
        tu, tv, _, _ = to.ocean_step(tu, tv, th, TG, tcfg)
    for got, want in ((tu, ju), (tv, jv)):
        want = np.asarray(want)
        assert np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())

"""The port's DeTerrace (ops/deterrace.py) against the reference at 32x16,
on four terrains: a quantized fBm (steps of 0.25, what the filter is
for), a lone bump on a flat plateau and a lone step (both full of
singular thin-plate-spline systems), and a flat terrain (every system
singular).  The reference runs op by op.

Tolerances, and why:

- The directional ids: exactly equal with XLA's sin, cos, asin and sqrt
  swapped into the port (tests/torch_xla_libm.py); without them the
  flips are counted, at most 1% of the ids (0 measured): two candidates
  are often equidistant on the lattice, so an ulp of a distance picks the
  other id.
- The 19x19 systems (A, b) of every pixel: bit for bit (XLA's log swapped
  in).  The spline value, fallback and clamps from the reference's own
  solutions: bit for bit (the 16 terms summed in point order, as XLA
  reduces; they cancel at ~1e6 in near-singular systems).
- The whole pipeline with the reference's LU solve put in place of the
  port's: bit for bit.  So the LU is the only difference left.
- The heights with the port's own LU (LAPACK through torch, no error
  check, an exactly zero pivot -> NaN -> h + step/2): the systems are
  ill-conditioned in float32 (median condition ~1e7 on these terrains),
  so two LU implementations disagree after the clamp at some pixels.  The
  off pixels (beyond 1e-6) are counted and bounded by 3x the reference's
  own jitted-vs-op-by-op disagreement plus 2% of the pixels (measured:
  38, 53 and 137 of 512 against its 27, 36 and 64; 0 on the flat
  terrain).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import demiurge_tpu_torch.core.grid as tgrid_module
from demiurge_tpu.core.grid import Grid as JGrid
from demiurge_tpu.ops import deterrace as jd
from demiurge_tpu.ops.noise import NoiseParams, fbm
from demiurge_tpu_torch.core.grid import Grid as TGrid
from demiurge_tpu_torch.ops import deterrace as td
from torch_xla_libm import xla_libm

torch.set_num_threads(2)

W, H = 32, 16
N = W * H
JG, TG = JGrid(W, H), TGrid(W, H)
TERRAINS = ("fbm", "bump", "step", "flat")


def _terrain(name):
    h = np.zeros((H, W), np.float32)
    if name == "fbm":
        f = np.asarray(fbm(JG, NoiseParams(octaves=4, scale=2.0, min=-2.0,
                                           max=3.0, seed=5)))
        h = (np.round(f / 0.25) * 0.25).astype(np.float32)
    elif name == "bump":
        h[5, 5] = 0.5
    elif name == "step":
        h[:, W // 2:] = 0.25
    return h


@pytest.fixture(scope="module")
def ref(request):
    """Per terrain, the reference op by op: the ids, the systems and
    solutions its solve saw, the heights, the whole pipeline; and the
    jitted heights."""
    out = {}
    seen = {}
    solve = jnp.linalg.solve

    def recording(a, b):
        x = solve(a, b)
        seen.update(A=np.asarray(a)[:N], b=np.asarray(b)[:N, :, 0],
                    x=np.asarray(x)[:N, :, 0])
        return x

    for name in TERRAINS:
        h = _terrain(name)
        with jax.disable_jit():
            pids = {n: jd.directional_pid(jnp.asarray(h), JG, pr, se)
                    for n, (pr, se) in zip(jd._SWEEP_NAMES, jd._SWEEPS)}
            jnp.linalg.solve = recording
            try:
                heights = jd.deterrace_heights(jnp.asarray(h), JG, pids)
            finally:
                jnp.linalg.solve = solve
            dist = jd.distance_field(JG, pids)
            full = jd.directional_smooth(heights, jnp.asarray(h), dist, JG)
        jit_heights = jd.deterrace_heights(jnp.asarray(h), JG, pids)
        out[name] = dict(h=h, pids={k: np.asarray(v) for k, v in pids.items()},
                         heights=np.asarray(heights), full=np.asarray(full),
                         jit_heights=np.asarray(jit_heights), **seen)
    return out


def _tpids(r):
    return {k: torch.from_numpy(v.astype(np.int64)) for k, v in
            r["pids"].items()}


@pytest.mark.parametrize("terrain", TERRAINS)
def test_pids_exact_with_xla_libm(ref, terrain):
    r = ref[terrain]
    with xla_libm(td, tgrid_module):
        got = td.all_pids(torch.from_numpy(r["h"]), TG)
    for name, want in r["pids"].items():
        assert got[name].dtype == torch.int64
        np.testing.assert_array_equal(got[name].numpy(), want, err_msg=name)
    got = td.all_pids(torch.from_numpy(r["h"]), TG)
    flips = sum(int((got[n].numpy() != w).sum())
                for n, w in r["pids"].items())
    print(f"{terrain}: {flips} of {8 * N} ids flipped with torch's libm")
    assert flips <= 0.01 * 8 * N


@pytest.mark.parametrize("terrain", TERRAINS)
def test_tps_systems_and_values_bit_for_bit(ref, terrain):
    r = ref[terrain]
    with xla_libm(td, tgrid_module):
        px, py, pz, val_m, h, step = td._candidates(
            torch.from_numpy(r["h"]), TG, _tpids(r))
        val_m = td._dedup(px, py, pz, val_m)
        A, b = td._tps_system(px, py, pz, val_m)
        np.testing.assert_array_equal(A.numpy(), r["A"])
        np.testing.assert_array_equal(b.numpy(), r["b"])
        got = td._clamp_heights(
            td._tps_value(torch.from_numpy(r["x"].copy()), px, py, val_m), h,
            step)
    np.testing.assert_array_equal(got.numpy().reshape(H, W), r["heights"])


def _reference_solve(A, b):
    x = jnp.linalg.solve(jnp.asarray(A.numpy()),
                         jnp.asarray(b.numpy())[..., None])[..., 0]
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("terrain", TERRAINS)
def test_pipeline_bit_for_bit_with_the_reference_solve(ref, terrain,
                                                       monkeypatch):
    r = ref[terrain]
    monkeypatch.setattr(td, "_tps_solve", _reference_solve)
    with jax.disable_jit(), xla_libm(td, tgrid_module):
        got = td.deterrace(torch.from_numpy(r["h"]), TG)
    np.testing.assert_array_equal(got.numpy(), r["full"])


@pytest.mark.parametrize("terrain", TERRAINS)
def test_heights_with_the_port_solve_bounded(ref, terrain):
    r = ref[terrain]
    got = td.deterrace_heights(torch.from_numpy(r["h"]), TG,
                               _tpids(r)).numpy()
    assert np.isfinite(got).all()
    off = int((np.abs(got - r["heights"]) > 1e-6).sum())
    spread = int((np.abs(r["jit_heights"] - r["heights"]) > 1e-6).sum())
    print(f"{terrain}: {off} of {N} heights off (the reference's own "
          f"jit-vs-op-by-op: {spread})")
    assert off <= 3 * spread + 0.02 * N
    # every height stays inside its clamp
    hh = r["h"]
    assert (np.where(hh < 0, got <= -1e-6, got >= 0)).all()
    assert (got >= np.minimum(hh, -1e-6) - 1e-6).all()


def test_singular_systems_fall_back():
    """An exactly singular system (every point invalid) gives NaN, and the
    height falls back to h + step/2 (step 0: h) on any LU library."""
    K = 16
    cpx = torch.zeros(3, K)
    cpy = torch.zeros(3, K)
    cpz = torch.zeros(3, K)
    cvm = torch.zeros(3, K, dtype=torch.bool)
    A, b = td._tps_system(cpx, cpy, cpz, cvm)
    x = td._tps_solve(A, b)
    assert torch.isnan(x).all(dim=1).all()
    h = torch.tensor([0.5, -0.25, 0.0])
    got = td._clamp_heights(td._tps_value(x, cpx, cpy, cvm), h,
                            torch.zeros(3))
    np.testing.assert_array_equal(got.numpy(), [0.5, -0.25, 0.0])


def test_deterrace_config():
    """``smooth_iters`` reaches the smoothing (0: the clamped heights)."""
    h = _terrain("fbm")
    got = td.deterrace(torch.from_numpy(h), TG, td.DeTerraceConfig(0))
    pids = td.all_pids(torch.from_numpy(h), TG)
    np.testing.assert_array_equal(
        got.numpy(), td.deterrace_heights(torch.from_numpy(h), TG,
                                          pids).numpy())

"""The port's ocean passes, step and CLI against the reference package.

Both packages get the same fBm terrain and numpy-made (u, v); JAX runs on
the CPU, so its XLA paths are the reference here (single-radius advect
taps, XLA Jacobi sweeps).  Tolerances, each relative to the field's max:

- advect: the departure point comes from atan2/asin, which round an ulp
  apart in torch and XLA.  asin is ill-conditioned at |z| -> 1, so on the
  two rows nearest each pole an ulp of z moves the sample by ~2e-4 rows;
  elsewhere by ~3e-5 columns.  Through a field that changes O(1) per pixel
  that is 2e-4 at the poles and 5e-5 elsewhere.
- diffusion / pressure: f32 reassociation of the coefficient form (2e-5 /
  2e-4, the reference's own resident-vs-XLA bounds).
- divergence, project, metrics: the same operations in the same order;
  1e-6 (a few ulps through the stencil sums).
- three ocean steps: each step adds the advect and solver differences of
  one step (measured ~5e-6 of max|u| per step at 256x128); 1e-4 of max|u|.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demiurge_tpu.api import cli as jcli
from demiurge_tpu.core.grid import Grid as JGrid
from demiurge_tpu.ops import noise as jnoise
from demiurge_tpu.ops import ocean as jocean
from demiurge_tpu.utils import metrics as jmetrics
from demiurge_tpu_torch.api import cli as tcli
from demiurge_tpu_torch.core.grid import Grid as TGrid
from demiurge_tpu_torch.ops import ocean as tocean
from demiurge_tpu_torch.utils import interop
from demiurge_tpu_torch.utils import metrics as tmetrics

torch.set_num_threads(2)

CPU = torch.device("cpu")
W, H = 256, 128
JCFG = jocean.OceanConfig(jacobi_iters=40, diffusion_iters=50, coriolis=1.0,
                          pressure_method="xla")
TERRAIN = jnoise.NoiseParams(octaves=8, scale=2.0, min=-4.0, max=6.0, seed=7)


@pytest.fixture(scope="module")
def case():
    jg = JGrid(W, H)
    h = np.asarray(jnoise.fbm(jg, TERRAIN))
    rng = np.random.default_rng(0)
    u = (rng.standard_normal((H, W)) * 0.2).astype(np.float32)
    v = (rng.standard_normal((H, W)) * 0.2).astype(np.float32)
    u[h > 0] = 0.0
    v[h > 0] = 0.0
    t = interop.fields_from_numpy({"h": h, "u": u, "v": v}, CPU)
    tcfg = interop.ocean_config_from_dict(dataclasses.asdict(JCFG))
    return dict(jg=jg, tg=TGrid(W, H), h=h, u=u, v=v, t=t, tcfg=tcfg)


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want, rel, rows=slice(None)):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    scale = float(np.abs(want).max()) + 1e-30
    np.testing.assert_allclose(got[rows] / scale, want[rows] / scale,
                               atol=rel)


def test_advect(case):
    jg, t = case["jg"], case["t"]
    ju, jv = jocean.advect(*_j(case["u"], case["v"], case["h"]), jg, JCFG)
    tu, tv = tocean.advect(t["u"], t["v"], t["h"], case["tg"], case["tcfg"])
    for got, want in ((tu, ju), (tv, jv)):
        _close(got, want, 2e-4)
        _close(got, want, 5e-5, rows=slice(2, -2))


def test_diffusion(case):
    t = case["t"]
    ju, jv = jocean.diffusion(*_j(case["u"], case["v"], case["h"]),
                              case["jg"], JCFG)
    tu, tv = tocean.diffusion(t["u"], t["v"], t["h"], case["tg"],
                              case["tcfg"])
    _close(tu, ju, 2e-5)
    _close(tv, jv, 2e-5)


def test_diffusion_exact_quirks(case):
    """exact_quirks keeps the reference's sweep as written (the x component
    as both components' rhs)."""
    t = case["t"]
    jcfg = dataclasses.replace(JCFG, exact_quirks=True)
    tcfg = dataclasses.replace(case["tcfg"], exact_quirks=True)
    ju, jv = jocean.diffusion(*_j(case["u"], case["v"], case["h"]),
                              case["jg"], jcfg)
    tu, tv = tocean.diffusion(t["u"], t["v"], t["h"], case["tg"], tcfg)
    _close(tu, ju, 2e-5)
    _close(tv, jv, 2e-5)


def test_divergence(case):
    t = case["t"]
    want = jocean.divergence(*_j(case["u"], case["v"], case["h"]),
                             case["jg"], JCFG)
    got = tocean.divergence(t["u"], t["v"], t["h"], case["tg"], case["tcfg"])
    _close(got, want, 1e-6)


def test_pressure_solve(case):
    t = case["t"]
    div = np.array(jocean.divergence(*_j(case["u"], case["v"], case["h"]),
                                       case["jg"], JCFG))
    want = jocean.pressure_solve(*_j(div, case["h"]), case["jg"], JCFG)
    got = tocean.pressure_solve(torch.from_numpy(div), t["h"], case["tg"],
                                case["tcfg"])
    _close(got, want, 2e-4)


def test_project(case):
    t = case["t"]
    div = np.array(jocean.divergence(*_j(case["u"], case["v"], case["h"]),
                                       case["jg"], JCFG))
    p = np.array(jocean.pressure_solve(*_j(div, case["h"]), case["jg"],
                                         JCFG))
    ju, jv = jocean.project(*_j(case["u"], case["v"], p, case["h"]),
                            case["jg"], JCFG)
    tu, tv = tocean.project(t["u"], t["v"], torch.from_numpy(p), t["h"],
                            case["tg"], case["tcfg"])
    _close(tu, ju, 1e-6)
    _close(tv, jv, 1e-6)


def test_advect_clamped_fraction_and_divergence_norm(case):
    """At 20x the velocity some pixels exceed the tap radii, so the
    fraction is a real count (equal unless an ulp flips one pixel)."""
    t = case["t"]
    fast = [case["u"] * 20, case["v"] * 20]
    want = float(jocean.advect_clamped_fraction(*_j(*fast, case["h"]),
                                                case["jg"], JCFG))
    got = float(tocean.advect_clamped_fraction(
        t["u"] * 20, t["v"] * 20, t["h"], case["tg"], case["tcfg"]))
    assert want > 0
    assert abs(got - want) <= 2.0 / (W * H)
    want = float(jmetrics.divergence_norm(*_j(case["u"], case["v"],
                                              case["h"]), case["jg"], JCFG))
    got = float(tmetrics.divergence_norm(t["u"], t["v"], t["h"], case["tg"],
                                         case["tcfg"]))
    assert got == pytest.approx(want, rel=1e-6)


def test_three_ocean_steps(case):
    jg, tg, t = case["jg"], case["tg"], case["t"]
    ju, jv = jocean.init_ocean(jg)
    tu, tv = tocean.init_ocean(tg, CPU)
    jh = jnp.asarray(case["h"])
    for _ in range(3):
        ju, jv, jp, jd = jocean.ocean_step(ju, jv, jh, jg, JCFG)
        tu, tv, tp, td = tocean.ocean_step(tu, tv, t["h"], tg, case["tcfg"])
    for got in (tu, tv, tp, td):
        assert got.shape == (H, W) and bool(torch.isfinite(got).all())
    _close(tu, ju, 1e-4)
    _close(tv, jv, 1e-4)
    _close(tp, jp, 2e-4)
    _close(td, jd, 1e-4)
    assert float(jnp.abs(ju).max()) > 0


def test_unported_modes_raise(case):
    """Every pressure method of the reference is ported ("cg" in
    tests/test_torch_pressure_cg.py); a method it does not have raises."""
    t, tg = case["t"], case["tg"]
    with pytest.raises(ValueError):
        tocean.pressure_solve(t["u"], t["h"], tg,
                              dataclasses.replace(case["tcfg"],
                                                  pressure_method="sor"))


def test_cli_ocean_save_matches_reference(tmp_path):
    """The port's CLI runs the ocean at 128x64 and saves what the reference
    CLI saves (the terrain).  The reference's fBm is jitted, so the terrain
    is held to the reference's own jit-vs-op-by-op spread (see
    test_torch_noise.py)."""
    args = ["ocean", "--width", "128", "--height", "64", "--steps", "2",
            "--jacobi", "40"]
    tlog, jlog = tmp_path / "t.jsonl", tmp_path / "j.jsonl"
    tcli.main(args + ["--device", "cpu", "--save", str(tmp_path / "t.npz"),
                      "--log", str(tlog)])
    jcli.main(args + ["--save", str(tmp_path / "j.npz"), "--log", str(jlog)])
    got, want = np.load(tmp_path / "t.npz"), np.load(tmp_path / "j.npz")
    assert sorted(got.files) == sorted(want.files)
    np.testing.assert_array_equal(got["coords"], want["coords"])
    assert float(got["circumference"]) == float(want["circumference"])
    with jax.disable_jit():
        eager = np.asarray(jnoise.fbm(JGrid(128, 64), TERRAIN))
    spread = np.abs(want["terrain"] - eager).max()
    span = TERRAIN.max - TERRAIN.min
    assert np.abs(got["terrain"] - want["terrain"]).max() <= \
        spread + 1e-5 * span
    trecs = [json.loads(line) for line in tlog.read_text().splitlines()]
    jrecs = [json.loads(line) for line in jlog.read_text().splitlines()]
    assert [r["step"] for r in trecs] == [r["step"] for r in jrecs] == [0, 1]
    for rec in trecs:
        for key in ("div_norm", "vmax", "advect_clamped"):
            assert np.isfinite(rec[key])

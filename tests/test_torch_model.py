"""The port's erosion pass, coupled step and CLI against the reference.

Tolerances, and why:

- ``init_uplift``: exact; ``erosion_pass``: the same operations in the same
  order, 1e-6 of max (an ulp through the slope divisions).
- five coupled steps at 128x64 against ``tests/golden/coupled_128x64_5steps
  .npz``, which is the reference's ``coupled_step`` on the CPU bit for bit
  (``tests/test_golden.py`` holds it there), starting from the reference's
  initial state carried across by ``coupled_state_from_numpy``.
  ``tests/test_golden.py``'s tolerance, 5e-5 of max, holds for u, v and T
  everywhere, and for the height everywhere but downstream of one
  direction tie: 25 pixels, up to 3.9e-3 of max.  That tie is the
  reference's own: compiled with one more output (a debug callback that
  reads its direction codes), the reference lands on the port's result
  there, the same 25 pixels, to the bit.  The bound allows 32 pixels and
  5e-3.
- the CLIs: the logged diagnostics finite and keyed as the reference's;
  the climate CLI's mean temperature within 1e-5 of the reference CLI's
  (its terrain differs by the jitted fBm's rounding, which moves a
  coastline pixel's heat capacity at most).
"""

import dataclasses
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demiurge_tpu.api import cli as jcli
from demiurge_tpu.core.grid import Grid as JGrid
from demiurge_tpu.model import CoupledConfig as JConfig
from demiurge_tpu.model import init_coupled as jinit
from demiurge_tpu.ops import erosion as je
from demiurge_tpu.ops.noise import NoiseParams, fbm
from demiurge_tpu.ops.ocean import OceanConfig as JOcean
from demiurge_tpu_torch.api import cli as tcli
from demiurge_tpu_torch.core.grid import Grid as TGrid
from demiurge_tpu_torch.model import CoupledConfig, CoupledState, \
    coupled_step, init_coupled
from demiurge_tpu_torch.ops import erosion as te
from demiurge_tpu_torch.utils import interop

torch.set_num_threads(2)

CPU = torch.device("cpu")
GOLDEN = pathlib.Path(__file__).parent / "golden" / "coupled_128x64_5steps.npz"


@pytest.fixture(scope="module")
def reference_start():
    """The golden run's configuration and the reference's initial state
    (tests/test_golden.py:28-39), as numpy."""
    jg = JGrid(128, 64)
    jcfg = JConfig(climate_substeps=4,
                   ocean=JOcean(jacobi_iters=40, diffusion_iters=10))
    h = fbm(jg, NoiseParams(octaves=4, scale=2.0, min=-2.0, max=3.0,
                            seed=11))
    state = jinit(h, jg)
    arrays = {f.name: np.asarray(getattr(state, f.name))
              for f in dataclasses.fields(state)}
    return jcfg, arrays


def test_init_uplift_and_erosion_pass(reference_start):
    _, arrays = reference_start
    h0 = np.array(fbm(JGrid(128, 64), NoiseParams(
        octaves=4, scale=2.0, min=-2.0, max=3.0, seed=11)))
    U, h = te.init_uplift(torch.from_numpy(h0))
    np.testing.assert_array_equal(U.numpy(), arrays["uplift"])
    np.testing.assert_array_equal(h.numpy(), arrays["height"])

    rng = np.random.default_rng(0)
    fm = np.where(h.numpy() > 0, rng.uniform(0, 3, h.shape), -1.0)
    fm = fm.astype(np.float32)
    want = np.asarray(je.erosion_pass(jnp.asarray(h.numpy()),
                                      jnp.asarray(fm), jnp.asarray(U.numpy()),
                                      JGrid(128, 64), 1.0, 1.0))
    got = te.erosion_pass(h, torch.from_numpy(fm), U, TGrid(128, 64), 1.0,
                          1.0).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    assert (got != h.numpy()).any()


def test_interop_carries_every_field(reference_start):
    jcfg, arrays = reference_start
    state = interop.coupled_state_from_numpy(arrays, CPU)
    assert state.t_index.shape == () and state.flow_acc.shape == (64, 128)
    back = interop.coupled_state_to_numpy(state)
    assert sorted(back) == sorted(arrays)
    for k, a in arrays.items():
        np.testing.assert_array_equal(back[k], a)
    with pytest.raises(ValueError):
        interop.coupled_state_from_numpy(
            {k: a for k, a in arrays.items() if k != "flow_acc"}, CPU)
    cfg = interop.coupled_config_from_dict(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    hash(cfg)
    with pytest.raises(ValueError):
        interop.coupled_config_from_dict({"no_such_field": 1})


def test_coupled_steps_match_golden(reference_start):
    jcfg, arrays = reference_start
    grid = TGrid(128, 64)
    cfg = interop.coupled_config_from_dict(dataclasses.asdict(jcfg))
    state = interop.coupled_state_from_numpy(arrays, CPU)
    for _ in range(5):
        state = coupled_step(state, grid, cfg)
    assert float(state.t_index) == 20.0
    z = np.load(GOLDEN)
    for name in ("u", "v", "temperature", "height"):
        got = getattr(state, name).numpy()
        assert np.isfinite(got).all()
        want = z[name]
        err = np.abs(got - want) / (np.abs(want).max() + 1e-9)
        if name == "height":
            assert (err > 5e-5).sum() <= 32 and err.max() <= 5e-3
        else:
            assert err.max() <= 5e-5, name


def test_init_coupled_and_cold_start():
    grid = TGrid(64, 32)
    h = torch.from_numpy(np.linspace(-2, 3, 64 * 32, dtype=np.float32)
                         .reshape(32, 64))
    s = init_coupled(h, grid)
    assert isinstance(s, CoupledState)
    assert s.t_index.shape == () and float(s.t_index) == 0.0
    assert float(s.flow_acc.abs().max()) == 0.0
    cfg = CoupledConfig(climate_substeps=2, ocean=dataclasses.replace(
        CoupledConfig().ocean, jacobi_iters=10, diffusion_iters=4))
    s2 = coupled_step(s, grid, cfg)
    assert float(s2.t_index) == 2.0
    assert float(s2.flow_acc.max()) > 0.0
    assert s2.uplift is s.uplift and s2.sel is s.sel


def _records(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_cli_coupled_and_climate(tmp_path):
    args = ["--width", "64", "--height", "32", "--device", "cpu"]
    log = tmp_path / "coupled.jsonl"
    state = tcli.main(["coupled", "--steps", "2", "--log", str(log),
                       "--save", str(tmp_path / "c.npz")] + args)
    recs = _records(log)
    assert [r["step"] for r in recs] == [0, 1]
    for r in recs:
        for key in ("mass", "mean_T", "advect_clamped"):
            assert np.isfinite(r[key])
    assert float(state.t_index) == 20.0
    assert sorted(np.load(tmp_path / "c.npz").files) == \
        ["circumference", "coords", "terrain"]

    tlog, jlog = tmp_path / "t.jsonl", tmp_path / "j.jsonl"
    tcli.main(["climate", "--steps", "300", "--log", str(tlog)] + args)
    jcli.main(["climate", "--width", "64", "--height", "32", "--steps",
               "300", "--log", str(jlog)])
    trecs, jrecs = _records(tlog), _records(jlog)
    assert [r["substeps"] for r in trecs] == [r["substeps"] for r in jrecs] \
        == [250, 300]
    for t, j in zip(trecs, jrecs):
        assert t["mean_T"] == pytest.approx(j["mean_T"], rel=1e-5)


@pytest.mark.parametrize("mesh, says", [("2x2", "needs 4 processes"),
                                        ("2by2", "expected NYxNX")])
def test_cli_mesh_needs_its_processes(mesh, says, capsys):
    """--mesh is ported (tests/test_torch_dist.py runs it under gloo);
    a mesh that is malformed or does not match the process count is
    refused before any process group is joined."""
    import torch.distributed as dist

    with pytest.raises(SystemExit) as exc:
        tcli.main(["coupled", "--device", "cpu", "--mesh", mesh])
    assert exc.value.code != 0
    assert says in capsys.readouterr().err
    assert not dist.is_initialized()

"""The port's erosion loop (BASELINE config 1) and its CLI against the
reference.

Tolerances, and why:

- 10 ``landscape_evolution`` iterations at 64x32 (the reference's fBm, 4
  octaves, seed 5, as tests/test_composed_parity.py), with and without
  lakes: the height within 1e-6 of max everywhere.  Each iteration's flow
  map differs by the cell area's and pow's ulps (tests/test_torch_flow_
  lakes.py) and the erosion pass by an ulp through the slope divisions
  (tests/test_torch_model.py); a direction tie would move a patch of
  pixels by far more, and none occurs here.
- ``erosion --width 64 --height 32 --steps 3``: the saved terrain within
  1e-6 of max of the reference CLI's, and every logged mass within 1e-6
  relative.  The reference CLI runs with its terrain made op by op, as
  the port makes it: the reference's jitted fBm differs from its own op
  by op form by up to 2.2e-2 here (tests/test_torch_noise.py holds the
  port to both), which three erosion steps carry to 1.4e-2 of max.
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
from demiurge_tpu.ops import erosion as je
from demiurge_tpu.ops.noise import NoiseParams, fbm
from demiurge_tpu_torch.api import cli as tcli
from demiurge_tpu_torch.core.grid import Grid as TGrid
from demiurge_tpu_torch.native import lakes as nlakes
from demiurge_tpu_torch.ops import erosion as te
from demiurge_tpu_torch.utils import interop

torch.set_num_threads(2)


def _start():
    return np.array(fbm(JGrid(64, 32), NoiseParams(
        mode="default", octaves=4, scale=2.0, min=-1.5, max=2.0, seed=5)))


@pytest.mark.parametrize("lakes", [True, False])
def test_landscape_evolution_10_iterations(lakes):
    h0 = _start()
    jcfg = je.ErosionConfig(lakes=lakes)
    want = np.asarray(je.landscape_evolution(
        jnp.asarray(h0), jnp.ones((32, 64)), JGrid(64, 32), jcfg,
        iterations=10))
    tcfg = interop.erosion_config_from_dict(dataclasses.asdict(jcfg))
    seen = []
    got = te.landscape_evolution(torch.from_numpy(h0), torch.ones(32, 64),
                                 TGrid(64, 32), tcfg, iterations=10,
                                 callback=lambda i, h: seen.append(i))
    assert seen == list(range(10))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * scale)
    assert np.abs(want - h0).max() > 1e-3 * scale  # the terrain moved


def test_landscape_evolution_progress_stops_the_loop():
    """``progress`` returning false ends the loop after that iteration;
    the result is the last completed state (the callback's)."""
    h0 = torch.from_numpy(_start())
    states = []
    out = te.landscape_evolution(
        h0, torch.ones(32, 64), TGrid(64, 32),
        te.ErosionConfig(lakes=True), iterations=10,
        callback=lambda i, h: states.append(h),
        progress=lambda i, n: i < 1)
    assert len(states) == 2 and out is states[-1]


def _eager_terrain(grid, seed):
    """The reference CLI's terrain, its fBm run op by op."""
    with jax.disable_jit():
        return jnp.asarray(np.asarray(fbm(grid, NoiseParams(
            octaves=8, scale=2.0, min=-4.0, max=6.0, seed=seed))))


def test_cli_erosion_matches_reference_cli(tmp_path, monkeypatch):
    args = ["erosion", "--width", "64", "--height", "32", "--steps", "3"]
    tlog, jlog = tmp_path / "t.jsonl", tmp_path / "j.jsonl"
    calls = nlakes.CALLS
    out = tcli.main(args + ["--device", "cpu", "--save",
                            str(tmp_path / "t.npz"), "--log", str(tlog)])
    assert nlakes.CALLS == calls + 3  # the native solver, once a step
    monkeypatch.setattr(jcli, "_terrain", _eager_terrain)
    np.testing.assert_array_equal(
        tcli._terrain(TGrid(64, 32), 7, "cpu").numpy(),
        np.asarray(_eager_terrain(JGrid(64, 32), 7)))
    jcli.main(args + ["--save", str(tmp_path / "j.npz"), "--log", str(jlog)])
    got, want = np.load(tmp_path / "t.npz"), np.load(tmp_path / "j.npz")
    assert sorted(got.files) == sorted(want.files)
    np.testing.assert_array_equal(got["coords"], want["coords"])
    assert float(got["circumference"]) == float(want["circumference"])
    np.testing.assert_array_equal(got["terrain"], out["terrain"].numpy())
    np.testing.assert_allclose(got["terrain"], want["terrain"], rtol=0,
                               atol=1e-6 * np.abs(want["terrain"]).max())
    trecs = [json.loads(line) for line in tlog.read_text().splitlines()]
    jrecs = [json.loads(line) for line in jlog.read_text().splitlines()]
    assert [r["step"] for r in trecs] == [r["step"] for r in jrecs] \
        == [0, 1, 2]
    for t, j in zip(trecs, jrecs):
        assert t["mass"] == pytest.approx(j["mass"], rel=1e-6)


def test_cli_erosion_prints_its_launches(capsys):
    tcli.main(["erosion", "--device", "cpu", "--width", "32", "--height",
               "16", "--steps", "1"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    launches = json.loads(last)["kernel_launches"]
    assert launches["blur"] == launches["flow_directions"] == 0  # CPU


@pytest.mark.parametrize("argv, says", [
    (["erosion", "--mesh", "1x1"], "--mesh is not supported"),
    (["tectonic-erosion", "--mesh", "1x1"], "--mesh is not supported")])
def test_cli_refuses_erosion_mesh_and_tectonic_erosion(argv, says, capsys):
    import torch.distributed as dist

    with pytest.raises(SystemExit) as exc:
        tcli.main(argv + ["--device", "cpu"])
    assert exc.value.code != 0
    assert says in capsys.readouterr().err
    assert not dist.is_initialized()


def test_interop_carries_flow_and_erosion_configs_and_lakes():
    from demiurge_tpu.ops import flow as jf
    from demiurge_tpu_torch.ops import flow as tf

    jcfg = jf.FlowConfig(preblur=0.0, exponent=1.0, lakes=False)
    tcfg = interop.flow_config_from_dict(dataclasses.asdict(jcfg))
    assert isinstance(tcfg, tf.FlowConfig)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    ecfg = interop.erosion_config_from_dict(
        dataclasses.asdict(je.ErosionConfig(lakes=True, n=40)))
    assert isinstance(ecfg, te.ErosionConfig) and ecfg.n == 40
    for fn in (interop.flow_config_from_dict,
               interop.erosion_config_from_dict):
        with pytest.raises(ValueError):
            fn({"no_such_field": 1})
    sol = jf.LakeSolution(np.array([3, 1], np.int64),
                          np.array([7, 9], np.int64),
                          np.array([0.5, 1.5], np.float32),
                          np.array([np.nan, 0.0, np.nan], np.float32))
    got = interop.lake_solution_from_numpy(sol)
    assert isinstance(got, tf.LakeSolution)
    for a, b in zip(got, sol):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        interop.lake_solution_from_numpy(sol._replace(
            conn_to=np.array([7], np.int64)))

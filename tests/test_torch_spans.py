"""The program's spans (``core.trace``): each stage of the coupled and
ocean steps and each flow-solve host read under a running profiler, each
stage nested in its parent; nothing entered without one; the CLI's
``--xprof`` trace and the erosion CLI's lake spans."""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from demiurge_tpu_torch import model
from demiurge_tpu_torch.api import cli as tcli
from demiurge_tpu_torch.core.grid import Grid
from demiurge_tpu_torch.core.trace import span
from demiurge_tpu_torch.kernels import build
from demiurge_tpu_torch.kernels import flow as kf
from demiurge_tpu_torch.ops import noise, ocean

torch.set_num_threads(2)

GRID = Grid(64, 32)
OCEAN = ocean.OceanConfig(jacobi_iters=20, diffusion_iters=5)

# each span of a step, and the span it sits in
PARENT = {
    "climate": "coupled_step", "ocean": "coupled_step",
    "flow": "coupled_step", "erosion": "coupled_step",
    "ocean.advect": "ocean", "ocean.viscosity": "ocean",
    "ocean.divergence": "ocean", "ocean.pressure": "ocean",
    "ocean.project": "ocean",
    "ocean.viscosity.coefficients": "ocean.viscosity",
    "ocean.pressure.coefficients": "ocean.pressure",
    "flow.blur": "flow", "flow.directions": "flow", "flow.area": "flow",
    "flow.vis": "flow", "flow.map": "flow"}


def _terrain():
    return noise.fbm(GRID, noise.NoiseParams(octaves=8, scale=2.0, min=-4.0,
                                             max=6.0, seed=7), "cpu")


def _spans(prof, tmp_path) -> list:
    """(name, start, end) of each ``record_function`` range of a profile."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return _trace_spans(path)


def _trace_spans(path) -> list:
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("cat") == "user_annotation"]


def _coupled(h):
    cfg = model.CoupledConfig(ocean=OCEAN)
    return model.coupled_step(model.init_coupled(h, GRID), GRID, cfg)


def _ocean(h):
    u, v = ocean.init_ocean(GRID, "cpu")
    return ocean.ocean_step(u, v, h, GRID, OCEAN)


@pytest.mark.parametrize("step, top", [(_coupled, "coupled_step"),
                                       (_ocean, "ocean")],
                         ids=["coupled", "ocean"])
def test_a_step_records_every_span_nested_in_its_parent(step, top,
                                                         tmp_path):
    h = _terrain()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(h)
    spans = _spans(prof, tmp_path)
    names = [n for n, _, _ in spans]
    want = {top} | {n for n, p in PARENT.items()
                    if p == top or PARENT.get(p) == top
                    or PARENT.get(PARENT.get(p)) == top}
    assert set(names) == want
    for name in want - {top}:
        assert names.count(name) == 1, name
        (a, b), = [(a, b) for n, a, b in spans if n == name]
        (pa, pb), = [(a, b) for n, a, b in spans if n == PARENT[name]]
        assert pa <= a <= b <= pb, name


def test_without_a_profiler_no_range_is_entered(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    state = _coupled(_terrain())
    assert torch.isfinite(state.height).all()
    assert span("a") is span("b")        # one shared context, no range
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="entered"):
            span("a")


def _fake_library(monkeypatch):
    """The C entry points of a tiled solve as no-ops: every round writes
    nothing, so the first batch certifies."""
    class Lib:
        def __getattr__(self, name):
            return lambda *args: 0

    monkeypatch.setattr(build, "library", lambda: Lib())


def test_each_flow_host_read_is_one_span(monkeypatch, tmp_path):
    """A batch of a tiled solve, or a round of the sweep rounds, reads its
    flags once, inside a ``flow.read`` span: the spans count the reads."""
    _fake_library(monkeypatch)
    solve = ("demiurge_flow_area_tiles", lambda *batch: batch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        stats = kf.solve_tiles_cuda([solve, solve], "cpu", (32, 256), 64)
        rounds = kf.solve_rounds_cuda("demiurge_flow_area", lambda *a: a,
                                      "cpu", 100)
    names = [n for n, _, _ in _spans(prof, tmp_path)]
    assert [s["host_reads"] for s in stats] == [1, 1]
    assert rounds["host_reads"] == 1
    assert names.count("flow.read") == 2


def test_xprof_writes_one_trace_of_the_steps(tmp_path, capsys):
    out = tmp_path / "xprof"
    tcli.main(["ocean", "--device", "cpu", "--width", "64", "--height", "32",
               "--steps", "2", "--jacobi", "20", "--xprof", str(out)])
    names = [n for n, _, _ in _trace_spans(out / "trace.json")]
    assert names.count("ocean.pressure") == 2
    assert names.count("ocean") == 2


def test_without_xprof_nothing_is_profiled(tmp_path, monkeypatch, capsys):
    def refuse(*a, **k):
        raise AssertionError("profiled")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    monkeypatch.chdir(tmp_path)
    tcli.main(["ocean", "--device", "cpu", "--width", "64", "--height", "32",
               "--steps", "1", "--jacobi", "20"])
    assert list(tmp_path.iterdir()) == []


def test_erosion_cli_records_the_lake_copies_and_solve(tmp_path, capsys):
    out = tmp_path / "xprof"
    tcli.main(["erosion", "--device", "cpu", "--width", "32", "--height",
               "16", "--steps", "2", "--xprof", str(out)])
    spans = _trace_spans(out / "trace.json")
    names = [n for n, _, _ in spans]
    # each iteration: the copies to the host, the solve, the copies back
    assert names.count("flow.lake_solve") == 2
    assert names.count("flow.lake_copies") == 4
    order = [n for n, _, _ in sorted(spans, key=lambda s: s[1])
             if n.startswith("flow.lake")]
    assert order == ["flow.lake_copies", "flow.lake_solve",
                     "flow.lake_copies"] * 2

"""The harness finds a cell's files by the names in BENCHMARK.json, and a
cell made of new files alone runs: a configuration, a traffic mix and a
per-layer metric added without editing a file that is there."""

import json
import shutil
import time

import pytest

from h100bench import harness
from h100bench.tests.helpers import ROOT


def test_every_cell_finds_its_files():
    spec = harness.load_spec(ROOT)
    names = {m["name"] for m in spec["per_layer"]}
    for w in spec["workloads"]:
        cell = harness.Cell(spec, w["name"])
        assert cell.cfg["width"] > 0 and "run_steps" in cell.traffic
        assert hasattr(cell.reference, "step")
        assert hasattr(cell.entry_module(), "Entry")
        assert {m["name"] for m in cell.end_to_end} >= {"step_ms", "setup_s"}
        assert set(cell.per_layer) <= names
        for unit, reader in cell.per_layer.values():
            assert callable(reader.read)
    for c in spec["configs"]:
        assert (ROOT / c["file"]).is_file()


def test_an_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        harness.Cell(harness.load_spec(ROOT), "no-such-cell")


def test_a_cell_of_new_files_alone_runs(tmp_path):
    bench = tmp_path / "h100bench"
    shutil.copytree(ROOT / "h100bench", bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    cfg = json.loads((bench / "configs" / "ocean.json").read_text())
    cfg.update(width=32, height=16, run_steps=2)
    cfg["ocean"]["jacobi_iters"] = 20
    (bench / "configs" / "tiny_ocean.json").write_text(json.dumps(cfg))
    (bench / "entries" / "tiny_ocean.py").write_text(
        "from h100bench.entries.ocean import Entry, stages  # noqa: F401\n")
    (bench / "reference" / "tiny_ocean.py").write_text(
        "from h100bench.reference.ocean import init, step  # noqa: F401\n")
    (bench / "traffic" / "two-steps.json").write_text(json.dumps(
        {"run_steps": 2}))
    (bench / "metrics" / "steps_traced.py").write_text(
        "def read(t):\n    return float(t.steps)\n")
    spec = harness.load_spec(ROOT)
    spec["configs"].append({"name": "tiny_ocean", "source": "test",
                            "file": "h100bench/configs/tiny_ocean.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny-ocean.two", "config":
                              "tiny_ocean", "traffic": "two-steps",
                              "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "steps_traced", "unit": "count",
                              "better": "higher", "source": "device_trace",
                              "layer": "model", "moves": "step_ms",
                              "workloads": ["tiny-ocean.two"]})
    cell = harness.Cell(spec, "tiny-ocean.two", bench=bench)
    out = harness.run_cell(cell, 11, 0.01, False, "cpu", time.perf_counter())
    assert out["correct"] is True and out["attempted"] == 2
    traced = harness.run_cell(cell, 11, 0.01, True, "cpu",
                              time.perf_counter())
    assert traced["metrics"]["steps_traced"] == {"value": 2.0,
                                                 "unit": "count"}
    after = {p: p.read_bytes() for p in before}
    assert after == before          # no file that was there was edited

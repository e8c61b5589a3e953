"""The result line: its keys, the units BENCHMARK.json names, the
compared numbers last; and the refusals of ``run.py``."""

import json
import subprocess
import sys
import time

import pytest

from h100bench import harness
from h100bench.tests.helpers import ROOT, small_cell


@pytest.mark.parametrize("trace", [False, True], ids=["timed", "traced"])
def test_result_keys_and_units(trace):
    spec = harness.load_spec(ROOT)
    cell = small_cell("ocean-2048")
    out = harness.run_cell(cell, 2 ** 31 + 3, 0.05, trace, "cpu",
                           time.perf_counter())
    json.dumps(out)
    keys = list(out)
    assert keys[:3] == ["correct", "attempted", "failed"]
    assert keys[-1] == "compared"
    assert {"metrics", "device"} <= set(keys)
    dev = out["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        units = {m["name"]: m["unit"] for m in spec["per_layer"]}
    else:
        units = {m["name"]: m["unit"] for m in spec["end_to_end"]}
        assert set(out["metrics"]) == set(units)
        assert out["metrics"]["step_ms"]["value"] > 0
    for name, m in out["metrics"].items():
        assert m["unit"] == units[name]
    for c in out["compared"].values():
        assert set(c) == {"value", "limit"}


def test_run_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here: the refusal is for machines without")
    p = subprocess.run([sys.executable, "h100bench/run.py", "--workload",
                        "ocean-2048", "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode == 2 and p.stdout == ""


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "demiurge_tpu_torch_like", sys)
    assert "demiurge_tpu_torch_like" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax.numpy"]


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    """A whole run of ``ocean-2048`` on the card: correct, with every
    end-to-end metric."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, "h100bench/run.py", "--workload",
                        "ocean-2048", "--seed", "2147483648", "--seconds",
                        "2"], cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu"
    assert set(out["metrics"]) == {"step_ms", "step_p95_ms", "peak_mem_gib",
                                   "setup_s"}

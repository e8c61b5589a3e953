"""Each configuration's plain reference against the program, at a tiny
grid on the CPU (the program's plain twins), through a whole run of the
harness: every compared number reads 0."""

import time

import pytest

from h100bench.tests.helpers import small_cell
from h100bench import harness


@pytest.mark.parametrize("workload", ["coupled-8192", "ocean-2048"])
def test_reference_agrees_with_the_program(workload):
    cell = small_cell(workload)
    out = harness.run_cell(cell, 2 ** 31 + 77, 0.05, False, "cpu",
                           time.perf_counter())
    assert out["correct"] is True
    assert out["failed"] == 0
    assert set(out["compared"]) == set(cell.cfg["check"]["limits"])
    assert all(c["value"] == 0.0 for c in out["compared"].values())


@pytest.mark.parametrize("workload", ["coupled-8192", "ocean-2048"])
def test_reference_follows_several_steps(workload):
    """The reference's own run of three steps from its start against the
    program's three steps: the same fields."""
    import torch

    from h100bench import compare, terrain

    cell = small_cell(workload)
    cfg = cell.cfg
    t = terrain.fbm(cfg["width"], cfg["height"], cfg["terrain"], 3, "cpu")
    entry = cell.entry_module().Entry(cfg, t)
    state, ref = entry.start(), cell.reference.init(cfg, t)
    for i in range(1, 4):
        state = entry.step(state)
        ref = cell.reference.step(cfg, ref, t, i)
        got = entry.fields(state)
        for name in cfg["check"]["limits"]:
            assert compare.mismatch_share(got[name], ref[name], 1e-4,
                                          1e-5) == 0.0, (i, name)
            assert torch.isfinite(got[name]).all()

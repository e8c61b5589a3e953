"""The comparison's controls at a tiny grid: the reference in bfloat16 in
the program's place, and faults planted under the timed path, must each
come out not correct."""

import dataclasses
import time

import pytest
import torch

from h100bench import control, harness
from h100bench.tests.helpers import small_cell


@pytest.mark.parametrize("workload", ["coupled-8192", "ocean-2048"])
def test_bfloat16_control_is_not_correct(workload):
    out = control.control(small_cell(workload), 2 ** 31 + 5, "cpu")
    assert out["passed"] is False
    assert max(c["value"] / c["limit"] for c in out["compared"].values()) > 3


@pytest.mark.parametrize("workload", ["coupled-8192", "ocean-2048"])
def test_control_later_steps_compare_with_float32(workload, monkeypatch):
    """The reference of each later step the control is compared on runs
    in float32 from the control's state, not in the control's bfloat16."""
    cell = small_cell(workload)
    ref, seen = cell.reference, []
    step = ref.step

    def spy(cfg, state, terrain, index):
        seen.append((index, state["u"].dtype, terrain.dtype))
        return step(cfg, state, terrain, index)

    monkeypatch.setattr(ref, "step", spy)
    control.control(cell, 2 ** 31 + 5, "cpu")
    later = harness.later_steps(2 ** 31 + 5, cell.cfg["run_steps"],
                                cell.cfg["check"]["later_steps"])
    compared = [d for i, d, t in seen if t == torch.float32 and i in later]
    assert compared and set(compared) == {torch.float32}


def _unchanged(step):
    def broken(state):
        if dataclasses.is_dataclass(state):
            return state
        u, v, p = state
        return u, v, torch.zeros_like(u) if p is None else p
    return broken


def _map(state, fn):
    if dataclasses.is_dataclass(state):
        return dataclasses.replace(state, **{
            f: fn(getattr(state, f), i) for i, f in enumerate(
                ("height", "u", "v", "temperature", "flow_acc"))})
    return tuple(fn(x, i) for i, x in enumerate(state))


def _half(step):
    """Half of the grid's rows left at their input values."""
    def broken(state):
        out = step(state)
        H = out[0].shape[0] if isinstance(out, tuple) else out.height.shape[0]

        def keep(x, i):
            old = state[i] if isinstance(state, tuple) else getattr(
                state, ("height", "u", "v", "temperature", "flow_acc")[i])
            if old is None:
                return x
            x = x.clone()
            x[H // 2:] = old[H // 2:]
            return x
        return _map(out, keep)
    return broken


def _altered(step):
    """One answer altered where it is produced: the first field off by a
    hundredth of its range on every 20th pixel."""
    def broken(state):
        out = step(state)

        def alter(x, i):
            if i != 0:
                return x
            x = x.clone()
            flat = x.view(-1)
            flat[::20] += 0.01 * float(x.abs().max()) + 0.01
            return x
        return _map(out, alter)
    return broken


@pytest.mark.parametrize("workload", ["coupled-8192", "ocean-2048"])
@pytest.mark.parametrize("fault", [_unchanged, _half, _altered],
                         ids=["state-unchanged", "half-left-out",
                              "answer-altered"])
def test_planted_fault_is_not_correct(workload, fault):
    out = harness.run_cell(small_cell(workload), 2 ** 31 + 9, 0.05, False,
                           "cpu", time.perf_counter(), break_step=fault)
    assert out["correct"] is False
    assert out["failed"] >= 1

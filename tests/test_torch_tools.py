"""The port's flow tools (demiurge_tpu_torch/tools) on the CPU.

``flow_rounds`` and ``flow_tune`` run with ``--device cpu`` at small sizes
(the kernels' plain twins): they print the reference tools' lines and a
last line of kernel launches (0 on the CPU: the counters count CUDA
launches), ``flow_tune`` holds every solver to K7/K8 and exits 1 on a
mismatch, and without ``--device`` both ask for the card and fail here.
"""

import json

import pytest
import torch

from demiurge_tpu_torch.kernels import flow_deadends as kd
from demiurge_tpu_torch.tools import flow_rounds, flow_tune

torch.set_num_threads(2)


def _run(main, argv, capsys):
    rc = main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    return rc, lines


def test_flow_rounds_prints_the_reference_lines(capsys):
    rc, lines = _run(flow_rounds.main, ["256", "128", "16", "8", "--device",
                                        "cpu"], capsys)
    assert rc == 0 and len(lines) == 4
    head, active, total, launches = lines
    assert head.startswith("band=16 k=8 nbands=8: rounds=")
    rounds = int(head.split("rounds=")[1].split()[0])
    assert head.endswith(f"sweeps<={rounds * 8}")
    hist = json.loads(active.split(": ", 1)[1])
    assert len(hist) == rounds and hist[0] == 8 and min(hist) >= 1
    assert total == f"total band-runs: {sum(hist)}"
    assert json.loads(launches) == {
        "kernel_launches": {"flow_banded_rounds": 0,
                            "flow_banded_sweeps": 0},
        "host_reads": rounds, "design": "twin"}


def test_flow_tune_checks_every_solver(capsys):
    rc, lines = _run(flow_tune.main, ["128", "64", "--device", "cpu"],
                            capsys)
    assert rc == 0
    assert lines[0].startswith("flow_tune 128x64 after 10 coupled steps on "
                               "cpu")
    rows = lines[1:-1]
    names = ["K7+K8", "K11a TMA", "K11a earlier", "K11b fused both",
             "K11b fused split", "K11c wave tiles", "K11c earlier",
             "K11d cluster", "K11d earlier"]
    assert len(rows) == len(names)
    for name, row in zip(names, rows):
        assert row.startswith(name) and "  ok  " in row, row
    assert "differing from K7 0;" in rows[1]
    counts = json.loads(lines[-1])["kernel_launches"]
    assert set(counts) == {"flow_solve", "flow_vis", "flow_solve_2d_tma",
                           "flow_solve_2d", "flow_solve_fused",
                           "flow_solve_wave_tiles", "flow_solve_wave",
                           "flow_banded_rounds", "flow_banded_sweeps"}
    assert not any(counts.values())


def test_flow_tune_exits_1_on_a_mismatch(capsys, monkeypatch):
    real = kd.flow_solve_2d

    def off_by_one(packed, area, grid, *args, **kw):
        A, vis, stats = real(packed, area, grid, *args, **kw)
        return A.clone().index_fill_(0, torch.tensor([3]), 1.0), vis, stats

    monkeypatch.setattr(kd, "flow_solve_2d", off_by_one)
    rc, lines = _run(flow_tune.main, ["128", "64", "--device", "cpu"],
                            capsys)
    assert rc == 1
    (bad,) = [row for row in lines if "MISMATCH" in row]
    assert bad.startswith("K11a")


def test_flow_tune_run_holds_each_solver_to_its_twin(capsys):
    """``run(twins=True)``, as the chip smoke calls it: a row for each
    solver, every K11 row timed against its twin too."""
    packed, rows, ok = flow_tune.run(128, 64, "cpu", twins=True)
    out = capsys.readouterr().out
    assert ok and packed.shape == (64, 128)
    assert [r["kernel"] for r in rows] == [
        None, "flow_solve_2d_tma", "flow_solve_2d", "flow_solve_fused",
        "flow_solve_fused", "flow_solve_wave_tiles", "flow_solve_wave",
        "flow_banded_rounds", "flow_banded_sweeps"]
    assert rows[0]["twin_ms"] is None
    assert all(r["twin_ms"] >= 0 and r["ms"] >= 0 for r in rows[1:])
    assert out.count("bit-exact") == 8 and "DIFFERS" not in out
    assert rows[1]["differ"] == 0 and rows[1]["stats"]["rounds"] > 0


@pytest.mark.parametrize("main", [flow_rounds.main, flow_tune.main],
                         ids=["flow_rounds", "flow_tune"])
def test_tools_default_to_the_card(main):
    """No fallback: without --device the tools ask for CUDA."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the tool would run for real")
    with pytest.raises((RuntimeError, AssertionError)):
        main(["64", "32"])


def test_flow_tune_races_the_card_kernels_only_on_the_card():
    """``--kernel`` races the new K11a's and K11c's sweeps, the default
    first, each once; it asks for the card."""
    two_d, wave = flow_tune.variants("2d"), flow_tune.variants("wave")
    assert two_d[0][1] == {"k": kd.TMA_K} and wave[0][1] == {"k": kd.WAVE_K}
    for runs in (two_d, wave):
        assert sorted(kw["k"] for _, kw in runs) == [4, 8, 16]
    with pytest.raises(SystemExit):
        flow_tune.main(["64", "32", "--kernel", "2d", "--device", "cpu"])


def test_tools_refuse_extra_numbers():
    with pytest.raises(SystemExit):
        flow_rounds.main(["1", "2", "3", "4", "5", "--device", "cpu"])
    with pytest.raises(SystemExit):
        flow_tune.main(["1", "2", "3", "--device", "cpu"])

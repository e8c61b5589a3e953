"""The port's weak-scaling tool (demiurge_tpu_torch/tools/scaling_bench.py)
on the CPU: gloo groups of 1, 2 and 4 processes at a 64x32 tile, the
records' keys (the reference's, plus each rank's traffic), the grid
growing as ``choose_mesh_shape`` says, the single-device step at one
rank, and the refusal of more CUDA ranks than cards."""

import json
import os
import subprocess
import sys

import pytest
import torch

from demiurge_tpu_torch.dist.mesh import TRAFFIC, choose_mesh_shape
from demiurge_tpu_torch.tools import scaling_bench

REF_KEYS = {"devices", "mesh", "grid", "grid_points_per_s", "per_device",
            "efficiency_vs_1", "mode"}


def test_weak_scaling_on_gloo():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, "-m", "demiurge_tpu_torch.tools.scaling_bench",
         "--device", "cpu", "--base-width", "64", "--base-height", "32",
         "--steps", "1", "--ranks", "4"], capture_output=True, text=True,
        timeout=300, env=env)
    assert run.returncode == 0, run.stderr[-3000:]
    recs = [json.loads(line) for line in run.stdout.splitlines()
            if line.startswith("{")]
    assert [r["devices"] for r in recs] == [1, 2, 4]
    for r in recs:
        assert REF_KEYS <= set(r), r
        ny, nx = choose_mesh_shape(r["devices"])
        assert r["mesh"] == [ny, nx] and r["grid"] == [32 * ny, 64 * nx]
        assert r["mode"] == "weak" and r["finite"]
        assert r["grid_points_per_s"] > 0
        assert r["per_device"] == pytest.approx(
            r["grid_points_per_s"] / r["devices"])
        assert len(r["bytes_per_step"]) == r["devices"]
        for b in r["bytes_per_step"]:
            assert set(b) == set(TRAFFIC)
            assert (b["permute"] > 0) == (r["devices"] > 1)
            assert b["gather_field"] == 0
        assert r["sharded_calls_per_step"] == 0
        assert r["field_gathers_per_step"] == 0
    assert recs[0]["efficiency_vs_1"] == 1.0
    assert all(r["efficiency_vs_1"] > 0 for r in recs)


def test_overlap_flag_splits_the_solver_rounds(monkeypatch):
    """``--overlap`` on a 1x2 gloo group: the pressure solve's rounds
    split into the centre, swept while the exchange is in flight, and the
    frame; without it (the default) no round splits."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    recs = {}
    for flag in ([], ["--overlap"]):
        rec = scaling_bench.run_size(scaling_bench._parser().parse_args(
            ["--device", "cpu", "--base-width", "64", "--base-height", "32",
             "--steps", "1", "--jacobi", "16"] + flag), 2)
        assert "error" not in rec, rec
        recs[bool(flag)] = rec
    assert recs[False]["last_solve_rounds"] == {"rounds": 2, "split": 0,
                                                "in_flight": 0}
    assert recs[True]["last_solve_rounds"] == {"rounds": 2, "split": 2,
                                               "in_flight": 2}
    assert recs[True]["overlap"] and not recs[False]["overlap"]


def test_one_rank_runs_the_single_device_step(monkeypatch):
    """At n = 1 the tool steps without a mesh (``mesh=None``) and without
    a process group, as the reference does."""
    import torch.distributed as dist

    from demiurge_tpu_torch import model

    meshes = []
    step = model.coupled_step

    def spy(state, grid, cfg, mesh=None):
        meshes.append(mesh)
        return step(state, grid, cfg, mesh=mesh)

    monkeypatch.setattr(model, "coupled_step", spy)
    args = scaling_bench._parser().parse_args(
        ["--one", "1", "--device", "cpu", "--base-width", "32",
         "--base-height", "16", "--steps", "1", "--jacobi", "8"])
    rec = scaling_bench.run_rank(args)
    assert meshes == [None, None] and not dist.is_initialized()
    assert rec["devices"] == 1 and rec["grid"] == [16, 32] and rec["finite"]


def test_cuda_refuses_more_ranks_than_cards(monkeypatch, capsys):
    """``--device cuda`` asks for one card a rank and never runs on the
    CPU instead: more ranks than cards (or no card) exit 2 with a
    message, before any rank starts."""
    started = []
    monkeypatch.setattr(scaling_bench, "run_size",
                        lambda args, n: started.append(n))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert scaling_bench.main(["--ranks", "2"]) == 2
    assert "2 ranks need 2 CUDA devices" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert scaling_bench.main([]) == 2
    assert "this machine has 0" in capsys.readouterr().err
    assert started == []

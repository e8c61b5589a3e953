"""Package-wide rules of the port: no JAX, one device predicate, kernel
wrappers that refuse CPU tensors, and a chip smoke that refuses to run
without a card."""

import dataclasses
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import demiurge_tpu_torch
from demiurge_tpu.ops import ocean as jocean
from demiurge_tpu_torch.core.grid import Grid
from demiurge_tpu_torch.core.platform import check_kernel_inputs, \
    use_cuda_kernels
from demiurge_tpu_torch.kernels import advect as ka
from demiurge_tpu_torch.kernels import jacobi as kj
from demiurge_tpu_torch.utils import interop

torch.set_num_threads(2)

PKG = pathlib.Path(demiurge_tpu_torch.__file__).parent
REPO = PKG.parent


def _sources():
    """The package's Python sources, without what a build left behind."""
    return sorted(p for p in PKG.rglob("*.py")
                  if "_build" not in p.relative_to(PKG).parts)


# modules the grep tests must reach (they scan every source of the package)
PORTED = ("model.py", "core/stencils.py", "core/fastroll.py",
          "ops/temperature.py", "ops/blur.py", "ops/flow.py",
          "ops/erosion.py", "kernels/climate.py", "kernels/blur.py",
          "kernels/directions.py", "kernels/flow.py", "kernels/flow2.py",
          "dist/mesh.py", "dist/halo.py", "dist/flowdist.py",
          "dist/climate.py", "dist/advect.py", "kernels/flow_deadends.py",
          "kernels/jacobi_packed.py", "kernels/lakeflow.py",
          "tools/__init__.py",
          "tools/flow_rounds.py", "tools/flow_tune.py",
          "tools/jacobi_race.py", "native/__init__.py", "native/build.py",
          "native/lakes.py", "api/cli.py", "utils/interop.py",
          "core/state.py", "core/topology.py", "ops/tectonics.py",
          "ops/pressure_cg.py", "ops/adjust.py", "ops/blend.py",
          "ops/thermal.py", "ops/morphological.py", "ops/brush.py",
          "ops/deterrace.py", "select/selection.py", "utils/png.py",
          "utils/progress.py", "native/snapc.py", "api/project.py",
          "viz/__init__.py", "viz/projections.py", "viz/appearance.py",
          "utils/checkpoint.py", "examples/make_planet.py",
          "examples/ocean_climate.py", "tools/multiprocess_test.py")


def test_grep_tests_cover_the_ported_modules():
    scanned = {str(p.relative_to(PKG)) for p in _sources()}
    assert set(PORTED) <= scanned


def test_package_never_imports_jax():
    pattern = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b"
                         r"|import\s+demiurge_tpu\b|from\s+demiurge_tpu\b"
                         r"|from\s+demiurge_tpu\.)", re.M)
    offenders = [str(p.relative_to(PKG)) for p in _sources()
                 if pattern.search(p.read_text())]
    assert not offenders, offenders
    smoke = (REPO / "chip_smoke.py").read_text()
    assert not pattern.search(smoke)
    assert "demiurge_tpu." not in smoke.replace("demiurge_tpu_torch", "")


def test_only_platform_tests_the_device():
    """Choosing between a kernel and its twin is core/platform.py's job; no
    other module may look at the device to pick a path."""
    pattern = re.compile(r"\.is_cuda\b|\.device\.type\b"
                         r"|torch\.cuda\.is_available\(\)")
    offenders = [str(p.relative_to(PKG)) for p in _sources()
                 if not (p.name == "platform.py" and p.parent.name == "core")
                 and pattern.search(p.read_text())]
    assert not offenders, offenders


def test_only_platform_picks_the_collective_backend():
    """NCCL or gloo follows the device the caller names
    (``collective_backend``); no other module names a backend, so none
    can pick one because a card is missing."""
    pattern = re.compile(r"""["'](nccl|gloo)["']""")
    offenders = [str(p.relative_to(PKG)) for p in _sources()
                 if not (p.name == "platform.py" and p.parent.name == "core")
                 and pattern.search(p.read_text())]
    assert not offenders, offenders
    from demiurge_tpu_torch.core.platform import collective_backend

    assert collective_backend("cpu") == "gloo"
    assert collective_backend("cuda") == collective_backend("cuda:1") \
        == "nccl"


def test_use_cuda_kernels_is_false_for_cpu_tensors():
    x = torch.zeros(2, 2)
    assert use_cuda_kernels(x, x) is False
    assert use_cuda_kernels() is False


def test_check_kernel_inputs_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        check_kernel_inputs(("x",), (torch.zeros(4, 4),), shape=(4, 4))
    with pytest.raises(TypeError):
        check_kernel_inputs(("x",), (np.zeros((4, 4)),))


def test_kernel_wrappers_raise_on_cpu_tensors():
    g = Grid(64, 32)
    z = torch.zeros(g.shape)
    launches = (kj.PRESSURE_LAUNCHES, kj.DIFFUSION_LAUNCHES, ka.LAUNCHES,
                ka.LAUNCHES_STAGE)
    with pytest.raises(ValueError, match="CUDA"):
        kj.pressure_solve_cuda(z, z, z, z, z, z, z, g, 3)
    with pytest.raises(ValueError, match="CUDA"):
        kj.diffusion_solve_cuda(z, z, z, z, z, z, z, g, 3)
    with pytest.raises(ValueError, match="CUDA"):
        ka.advect_sample_cuda(z, z, z, z, ka.global_meta(8), 32, 2)
    from demiurge_tpu_torch.ops.ocean import OceanConfig

    with pytest.raises(ValueError, match="CUDA"):
        ka.advect_stage_cuda(z, z, z, g, OceanConfig())
    assert (kj.PRESSURE_LAUNCHES, kj.DIFFUSION_LAUNCHES, ka.LAUNCHES,
            ka.LAUNCHES_STAGE) == launches


def test_coupled_kernel_wrappers_raise_on_cpu_tensors():
    from demiurge_tpu_torch.kernels import blur as kb
    from demiurge_tpu_torch.kernels import climate as kc
    from demiurge_tpu_torch.kernels import directions as kd
    from demiurge_tpu_torch.kernels import flow as kf

    g = Grid(64, 32)
    z = torch.zeros(g.shape)
    packed = torch.zeros(g.shape, dtype=torch.int32)
    counts = (kc.LAUNCHES, kb.LAUNCHES, kd.LAUNCHES, kd.LAUNCHES_PACKED,
              kf.LAUNCHES_A, kf.LAUNCHES_VIS)
    for call in (lambda: kc.climate_step_cuda(z, z, torch.zeros(4, 32), g,
                                              0.55e6),
                 lambda: kb.blur_cuda(z, g, [0.1, 0.2]),
                 lambda: kd.flow_directions_cuda(z, z, g),
                 lambda: kd.directions_packed_cuda(z, z, g),
                 lambda: kf.flow_solve_area_cuda(packed, z, g),
                 lambda: kf.vis_solve_cuda(packed, g)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert (kc.LAUNCHES, kb.LAUNCHES, kd.LAUNCHES, kd.LAUNCHES_PACKED,
            kf.LAUNCHES_A, kf.LAUNCHES_VIS) == counts


def test_k11_kernel_wrappers_raise_on_cpu_tensors():
    from demiurge_tpu_torch.kernels import flow_deadends as kx
    from demiurge_tpu_torch.kernels import jacobi_packed as kp

    g = Grid(256, 128)
    z = torch.zeros(g.shape)
    packed = torch.zeros(g.shape, dtype=torch.int32)
    counts = (kx.LAUNCHES_2D, kx.LAUNCHES_FUSED, kx.LAUNCHES_WAVE,
              kx.LAUNCHES_BANDED, kp.LAUNCHES, kx.LAUNCHES_FUSED_BANDS,
              kp.LAUNCHES_SWEEPS, kx.LAUNCHES_2D_TMA,
              kx.LAUNCHES_WAVE_TILES, kx.LAUNCHES_BANDED_SWEEPS)
    for call in (lambda: kx.flow_solve_2d_cuda(packed, z, g),
                 lambda: kx.flow_solve_2d_tma_cuda(packed, z, g),
                 lambda: kx.flow_solve_wave_tiles_cuda(packed, z, g),
                 lambda: kx.flow_solve_fused_cuda(packed, z, g),
                 lambda: kx.flow_solve_fused_bands_cuda(packed, z, g),
                 lambda: kx.flow_solve_wave_cuda(packed, z, g),
                 lambda: kx.flow_solve_banded_rounds_cuda(packed, z, g),
                 lambda: kx.flow_solve_banded_sweeps_cuda(packed, z, g),
                 lambda: kp.resident_call_packed_cuda(
                     packed, torch.zeros(128, 3), None, [z], g, 2, False,
                     True),
                 lambda: kp.resident_call_packed_sweeps_cuda(
                     packed, torch.zeros(128, 3), None, [z], g, 2, False,
                     True)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert (kx.LAUNCHES_2D, kx.LAUNCHES_FUSED, kx.LAUNCHES_WAVE,
            kx.LAUNCHES_BANDED, kp.LAUNCHES, kx.LAUNCHES_FUSED_BANDS,
            kp.LAUNCHES_SWEEPS, kx.LAUNCHES_2D_TMA,
            kx.LAUNCHES_WAVE_TILES, kx.LAUNCHES_BANDED_SWEEPS) == counts


def test_launch_counts_name_every_counter():
    """The CLI's kernel_launches line names every wrapper's counter."""
    from demiurge_tpu_torch.kernels import launch_counts

    names = set(launch_counts())
    assert {"advect_sample_pallas", "flow_solve_2d", "flow_solve_fused",
            "flow_solve_wave", "flow_banded_rounds", "jacobi_packed",
            "advect_stage", "advect_stage_one_row",
            "flow_directions_packed", "blur_strip",
            "flow_directions_strip", "lake_relax", "lake_area_tiles",
            "lake_vis_tiles", "lake_root_tiles", "flow_solve_fused_bands",
            "jacobi_packed_sweeps", "flow_solve_2d_tma",
            "flow_solve_wave_tiles", "flow_banded_sweeps",
            "ocean_project"} <= names
    assert len(names) == 31


def test_interop_round_trip_and_config():
    rng = np.random.default_rng(0)
    arrays = {"u": rng.standard_normal((4, 8)),
              "p": rng.standard_normal((4, 8)).astype(np.float32)}
    tensors = interop.fields_from_numpy(arrays, torch.device("cpu"))
    assert all(t.dtype == torch.float32 for t in tensors.values())
    back = interop.fields_to_numpy(tensors)
    for k, a in arrays.items():
        np.testing.assert_array_equal(back[k], a.astype(np.float32))
    jcfg = jocean.OceanConfig(jacobi_iters=200, diffusion_iters=50)
    tcfg = interop.ocean_config_from_dict(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    hash(tcfg)
    with pytest.raises(ValueError):
        interop.ocean_config_from_dict({"no_such_field": 1})


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """With no card (this suite's host) and alone in a directory, the
    smoke exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the smoke would run for real")
    here = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=120,
                          cwd=REPO)
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    alone = subprocess.run([sys.executable, "chip_smoke.py"],
                           capture_output=True, text=True, timeout=120,
                           cwd=tmp_path)
    for run in (here, alone):
        assert run.returncode != 0
        assert '"ok": true' not in run.stdout

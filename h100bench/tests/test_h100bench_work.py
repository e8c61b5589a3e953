"""The work counts of the rooflines and of ``step_mfu``, from the shapes,
and the readers on a hand-made trace."""

import pytest

from h100bench import trace, work
from h100bench.entries import coupled, ocean
from h100bench.tests.helpers import small_cell

H100 = work.PEAKS["NVIDIA H100 80GB HBM3"]


def test_jacobi_bounds_match_the_kernel_table():
    """K2's 200 sweeps and K3's 50 at 2048x1024, bound by operations:
    0.0626 ms (10 operations a sweep with the source term; PERF.md's
    table of kernels counts 9, 0.0563) and 0.0282 ms."""
    st = ocean.ocean_stages(2048 * 1024, {"diffusion_iters": 50,
                                          "jacobi_iters": 200})
    ms = {n: work.bound_s(b, f, H100) * 1e3 for n, b, f in st}
    assert ms["pressure"] == pytest.approx(0.0626, rel=1e-2)
    assert ms["viscosity"] == pytest.approx(0.0282, rel=1e-2)
    flops = {n: f for n, b, f in st}
    assert flops["pressure"] == 10 * 200 * 2048 * 1024


def test_coupled_stages_count_every_stage():
    cfg = small_cell("coupled-8192").cfg
    cfg.update(width=8192, height=4096)
    st = coupled.stages(cfg)
    names = [n for n, _, _ in st]
    assert names == ["climate", "advect", "viscosity", "divergence",
                     "pressure", "project", "flow_blur", "flow_directions",
                     "flow_area", "flow_vis", "flow_map", "erosion"]
    n = 8192 * 4096
    assert dict((k, b) for k, b, _ in st)["flow_area"] == 16 * n
    # the pre-blur of radius 0.5 is 5 iterations of two passes
    assert dict((k, f) for k, _, f in st)["flow_blur"] == 310 * n
    assert work.stages_bound_s(st, H100) > work.stages_bound_s(
        st, H100, ("pressure",))


def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _trace():
    """A window of 100 us with two steps: a Jacobi kernel launched inside
    an ``ocean_step`` span, a flow kernel outside it, a copy; 40 us idle."""
    events = [
        _ev("user_annotation", trace.WINDOW_SPAN, 0, 100),
        _ev("user_annotation", "ocean_step", 5, 20),
        _ev("cuda_runtime", "cudaLaunchKernel", 10, 1, 1),
        _ev("kernel", "jacobi_tile_kernel<1>", 20, 30, 1),
        _ev("cuda_runtime", "cudaLaunchKernel", 40, 1, 2),
        _ev("kernel", "area_tile_kernel<16>", 45, 20, 2),
        _ev("cuda_runtime", "cudaMemcpyAsync", 70, 1, 3),
        _ev("gpu_memcpy", "Memcpy DtoH", 80, 10, 3),
    ]
    stages = [("pressure", 0, 67e12 * 1e-6), ("flow_area", 3.35e12 * 2e-6,
                                              0)]
    return trace.Trace(events, 2, stages, H100, step_s=60e-6)


def _reader(name):
    from h100bench import harness
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py",
                               f"h100bench.metrics.{name}")


def test_readers_on_a_hand_made_trace():
    t = _trace()
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s() == pytest.approx(55e-6)    # 20-65 merged, 80-90
    assert _reader("device_idle_pct").read(t) == pytest.approx(45.0)
    assert _reader("launches_per_step").read(t) == 1.5
    assert _reader("ocean_ms").read(t) == pytest.approx(15e-6 * 1e3)
    assert _reader("flow_ms").read(t) is None
    # 2 steps x 1 us of bound over 30 us of Jacobi kernels
    assert _reader("jacobi_roofline_pct").read(t) == pytest.approx(
        100 * 2e-6 / 30e-6)
    assert _reader("flow_roofline_pct").read(t) == pytest.approx(
        100 * 4e-6 / 20e-6)
    # the bound over the unprofiled steps' wall time, not the window's
    assert _reader("step_mfu").read(t) == pytest.approx(
        100 * 3e-6 / 60e-6)
    b = t.breakdown()
    assert b["device_ops"][0] == ["jacobi_tile_kernel<1>", pytest.approx(
        30e-6)]
    assert b["idle_gaps"][0] == ["ocean_step", pytest.approx(20e-6)]


def test_readers_find_nothing_without_device_events():
    t = trace.Trace([_ev("user_annotation", trace.WINDOW_SPAN, 0, 100)], 2,
                    [("pressure", 1, 1)], H100)
    for name in ("device_idle_pct", "launches_per_step", "ocean_ms",
                 "flow_ms", "jacobi_roofline_pct", "flow_roofline_pct",
                 "step_mfu"):
        assert _reader(name).read(t) is None, name


def test_peaks_only_for_the_exact_card():
    """The data-sheet peaks are the H100 SXM's: another H100 form has
    lower ones, so it gets none, and its rooflines are not read."""
    assert work.peaks_for("NVIDIA H100 80GB HBM3") is H100
    assert work.peaks_for("NVIDIA H100 PCIe") is None
    assert work.peaks_for("NVIDIA H100 NVL") is None


def test_step_mfu_needs_unprofiled_steps():
    t = _trace()
    t.step_s = None
    assert _reader("step_mfu").read(t) is None

#!/usr/bin/env python3
"""Smoke run of the PyTorch port (demiurge_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit), torch and CUDA;
2. builds the CUDA kernels from csrc/ (one nvcc per source, sm_90a) and
   prints the time;
3. the ocean kernels at 2048x1024 (the ocean CLI's terrain: fBm, 8 octaves,
   seed 7, and a (u, v) after one ocean step through the plain twins), each
   against its plain PyTorch twin on the card, timed with CUDA events:
   pressure Jacobi (200 and 1000 sweeps, within 1e-4 of max|p|), viscosity
   Jacobi (50 sweeps, within 2e-5 of max|u|), the tiered advect sampler
   (atol 1e-5);
4. the ocean path with every launch counter at 0: the ``ocean`` CLI (1 step
   at --jacobi 1000, 5 at --jacobi 200) and 5 ``ocean_step``s at the coupled
   model's solver depths; fails unless its three kernels launched, the
   fields are finite, the CLI logged ``advect_clamped``, and the kernel
   path's (u, v) match the same 5 steps through the plain twins (1e-5 of
   max|u|);
5. the coupled step's kernels at 2048x1024 (the same terrain, and a state
   after one coupled step through the plain twins), each against its twin:
   climate (10 substeps, exact expected, fails above 1e-6 of max|T|), blur
   (radius 0.5, same bound on max|h|), directions (ties at most 1 per 10^4
   pixels), the flow A fixpoint cold and warm (bit for bit) and vis
   (exact);
6. the coupled path with every launch counter at 0: the ``coupled`` CLI at
   2048x1024 for 3 steps and at its default 8192x4096 for 1 step, and the
   ``climate`` CLI at its default 4096x2048 for 500 substeps; fails unless
   every kernel of the step launched and every logged number and field of
   the coupled runs is finite.  The climate run's grid is past the
   reference model's stability bound on land (explicit substep,
   a = D dt / C > 1/8), where the reference diverges too; that run is held
   to the same 500 substeps through the plain twins, NaNs included;
7. 5 ``coupled_step``s at 2048x1024 on the kernels (host clock, ms per
   step) against the same 5 through the plain twins: u, v and T within
   1e-5 of max, the height beyond 1e-5 of max at no more than 1e-3 of the
   pixels; and a per-stage device profile of one step (CUDA events; the
   rows sum to the step);
8. the sharded path on a 1x1 mesh, in this process, in a world-size-1
   NCCL group: the two-level flow kernels (K10a with exit ids, K10b with a
   zero and a nonzero seed) at 2048x1024 on the coupled path's masks
   (band 128), each bit for bit against its twin; ``flow_solve_twolevel``
   at 2048x1024 and 8192x4096 against K7's A (rtol 1e-5, atol 1e-7), and
   both sharded flow solves on the mesh against K7 and K8 (same bound, vis
   exact), each timed beside K7; then, with every launch counter at 0, 3
   ``coupled_step(mesh=1x1)``s against 3 single-card steps (height rtol
   1e-5 atol 1e-6, T rtol 1e-5 atol 1e-4, u and v rtol 1e-5 atol 1e-6),
   ms per step, fails unless K5, K6, K10a and K10b launched; a per-stage
   device profile of one mesh step; and ``coupled --mesh 1x1`` through
   ``torch.distributed.run`` (2 steps at 2048x1024): finite logs and K10
   launches;
9. prints the kernels' JSON line, the card line and, last, the result line
   ``{"ok": true, "device": {...}}``.

Any failure raises and the exit code is non-zero.  Without a card, or
without the package beside this script, it exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import pathlib
import subprocess
import sys
import time
from unittest import mock

import torch

REPO = pathlib.Path(__file__).resolve().parent
W, H = 2048, 1024
SEED = 7
DEVICE = "cuda"
BIG = (8192, 4096)      # the coupled CLI's default size
CLIMATE = (4096, 2048)  # the climate CLI's default size

# published peaks of one H100 SXM (dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` on the card over ``reps`` calls, after a
    warm-up call (CUDA events around the whole run)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def bound(nbytes: float, flops: float):
    """(ms, what bounds it): the larger of the bytes over the memory rate
    and the float32 operations over the peak rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on a GPU",
              file=sys.stderr)
        return 2
    if not (REPO / "demiurge_tpu_torch" / "__init__.py").is_file():
        print(f"chip_smoke: demiurge_tpu_torch/ not found beside "
              f"{__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))

    from demiurge_tpu_torch import model
    from demiurge_tpu_torch.api import cli
    from demiurge_tpu_torch.core.grid import Grid
    from demiurge_tpu_torch.kernels import advect as ka
    from demiurge_tpu_torch.kernels import blur as kb
    from demiurge_tpu_torch.kernels import build
    from demiurge_tpu_torch.kernels import climate as kc
    from demiurge_tpu_torch.kernels import directions as kd
    from demiurge_tpu_torch.kernels import flow as kf
    from demiurge_tpu_torch.kernels import flow2 as k2
    from demiurge_tpu_torch.kernels import jacobi as kj
    from demiurge_tpu_torch.ops import blur as ob
    from demiurge_tpu_torch.ops import erosion, ocean, temperature
    from demiurge_tpu_torch.ops import flow as of

    # -- 1. setup ------------------------------------------------------------
    card = card_line()
    dev = torch.device(DEVICE)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path, log, nvcc_s = build.build()
    build.library()
    print(f"built {lib_path.name}: nvcc {nvcc_s:.1f} s (one process per "
          f"source), build+load {time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    counters = {"jacobi_pressure": (kj, "PRESSURE_LAUNCHES"),
                "jacobi_diffusion": (kj, "DIFFUSION_LAUNCHES"),
                "advect_sample_tiered": (ka, "LAUNCHES"),
                "climate": (kc, "LAUNCHES"),
                "blur": (kb, "LAUNCHES"),
                "flow_directions": (kd, "LAUNCHES"),
                "flow_solve": (kf, "LAUNCHES_A"),
                "flow_vis": (kf, "LAUNCHES_VIS"),
                "flow_local_solve": (k2, "LAUNCHES_LOCAL"),
                "flow_local_vis": (k2, "LAUNCHES_LOCAL_VIS")}
    # the kernels of the single-card path; the mesh path's are phase 8's
    single_card = [n for n in counters if not n.startswith("flow_local")]

    def zero_counts():
        for mod, attr in counters.values():
            setattr(mod, attr, 0)

    def read_counts(names):
        return {n: getattr(*counters[n]) for n in names}

    @contextlib.contextmanager
    def plain_twins():
        """Every op with every kernel swapped for its plain twin."""
        swaps = [(kj, "pressure_solve", kj.pressure_solve_plain),
                 (kj, "diffusion_solve", kj.diffusion_solve_plain),
                 (ka, "advect_sample", ka.advect_sample_tiered_plain),
                 (kc, "climate_step", kc.climate_step_plain),
                 (kb, "blur", kb.blur_plain),
                 (kd, "flow_directions", kd.flow_directions_plain),
                 (kf, "flow_solve_area", kf.flow_solve_area_plain),
                 (kf, "vis_solve", kf.vis_solve_plain)]
        with contextlib.ExitStack() as stack:
            for mod, name, fn in swaps:
                stack.enter_context(mock.patch.object(mod, name, fn))
            yield

    kernels = []
    N = W * H
    plane = 4.0 * N

    def record(name, source, replaces, err, ms, plain_ms, nbytes, flops,
               note):
        bound_ms, bound_by = bound(nbytes, flops)
        print(f"{name}: {note}; max_abs_err {err:.3e}; kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}) ({card})")
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "max_abs_err": err, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": None})

    # -- 3. the ocean kernels against their twins at 2048x1024 -----------
    grid = Grid(W, H)
    terrain = cli._terrain(grid, SEED, dev)
    cfg = ocean.OceanConfig(jacobi_iters=200, diffusion_iters=50)
    u0, v0 = ocean.init_ocean(grid, dev)
    with plain_twins():
        u, v, _, _ = ocean.ocean_step(u0, v0, terrain, grid, cfg)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(u).all() and torch.isfinite(v).all())
    print(f"inputs: terrain {tuple(terrain.shape)} land "
          f"{float((terrain > 0).float().mean()):.3f}, max|u| "
          f"{float(u.abs().max()):.4g}, max|v| {float(v.abs().max()):.4g}")

    div = ocean.divergence(u, v, terrain, grid, cfg)
    coeffs = kj.coefficients(div, terrain, grid)
    p0 = torch.zeros_like(div)
    worst = 0.0
    for iters in (200, 1000):
        got = kj.pressure_solve_cuda(*coeffs, p0, grid, iters)
        want = kj.pressure_solve_plain(*coeffs, p0, grid, iters)
        torch.cuda.synchronize()
        scale = float(want.abs().max())
        err = max_err(got, want)
        assert scale > 0 and bool(torch.isfinite(got).all())
        assert err <= 1e-4 * scale, (iters, err, scale)
        print(f"  pressure {iters} sweeps: max|p| {scale:.4g}, "
              f"err/max {err / scale:.3e}")
        worst = max(worst, err)
    ms = cuda_ms(lambda: kj.pressure_solve_cuda(*coeffs, p0, grid, 200), 10)
    plain_ms = cuda_ms(
        lambda: kj.pressure_solve_plain(*coeffs, p0, grid, 200), 3)
    record("jacobi_pressure", "demiurge_tpu_torch/csrc/jacobi.cu",
           "demiurge_tpu/pallas_kernels/jacobi.py:407", worst, ms, plain_ms,
           8 * plane, 200 * 9 * N,
           "200+1000 sweeps within 1e-4 of max|p|, time per 200-sweep solve")

    dco = kj.diffusion_coefficients(terrain, grid)
    gu, gv = kj.diffusion_solve_cuda(*dco, u, v, grid, 50)
    wu, wv = kj.diffusion_solve_plain(*dco, u, v, grid, 50)
    torch.cuda.synchronize()
    scale = float(wu.abs().max())
    err = max(max_err(gu, wu), max_err(gv, wv))
    assert scale > 0 and err <= 2e-5 * scale, (err, scale)
    ms = cuda_ms(lambda: kj.diffusion_solve_cuda(*dco, u, v, grid, 50), 10)
    plain_ms = cuda_ms(lambda: kj.diffusion_solve_plain(*dco, u, v, grid, 50),
                       3)
    record("jacobi_diffusion", "demiurge_tpu_torch/csrc/jacobi.cu",
           "demiurge_tpu/pallas_kernels/jacobi.py:429", err, ms, plain_ms,
           9 * plane, 50 * 2 * 9 * N,
           "50 sweeps on (u, v) within 2e-5 of max|u|")

    s2, t2 = ocean._departure(u, v, grid, cfg)[:2]
    c, r = ocean._row_col(grid, dev)
    radii = ka.strip_radii(grid, ocean.resolved_vmax(cfg), cfg.timestep)
    meta = ka.strip_meta(radii, W)
    ry = ocean.tap_radius_y(grid, cfg)
    rxrow = ocean._strip_radius_rows(radii, ka.STRIP, dev)
    dx = torch.clamp(s2 * W - 0.5 - c, -rxrow, rxrow)
    dy = torch.clamp(t2 * H - 0.5 - r, -ry, ry)
    gu, gv = ka.advect_sample_cuda(u, v, dx, dy, meta, ka.STRIP, ry)
    wu, wv = ka.advect_sample_tiered_plain(u, v, dx, dy, meta, ka.STRIP, ry)
    torch.cuda.synchronize()
    err = max(max_err(gu, wu), max_err(gv, wv))
    assert err <= 1e-5, err
    print(f"  advect strips (rx, q): {sorted(set(map(tuple, meta.tolist())))}"
          f", Ry {ry}, max|dx| {float(dx.abs().max()):.3g}")
    ms = cuda_ms(lambda: ka.advect_sample_cuda(u, v, dx, dy, meta, ka.STRIP,
                                               ry), 20)
    plain_ms = cuda_ms(lambda: ka.advect_sample_tiered_plain(
        u, v, dx, dy, meta, ka.STRIP, ry), 3)
    record("advect_sample_tiered", "demiurge_tpu_torch/csrc/advect.cu",
           "demiurge_tpu/pallas_kernels/advect.py:235", err, ms, plain_ms,
           6 * plane, 40 * N, "real clamped (dx, dy), atol 1e-5")

    # -- 4. the ocean path, counted ------------------------------------------
    zero_counts()
    log_text = io.StringIO()
    with contextlib.redirect_stderr(log_text):
        cli.main(["ocean", "--steps", "1"])
        cli.main(["ocean", "--steps", "5", "--jacobi", "200"])
    torch.cuda.synchronize()
    u, v = u0, v0
    t0 = time.perf_counter()
    for _ in range(5):
        u, v, p, d = ocean.ocean_step(u, v, terrain, grid, cfg)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / 5
    ocean_launches = read_counts(["jacobi_pressure", "jacobi_diffusion",
                                  "advect_sample_tiered"])
    records = [json.loads(line) for line in log_text.getvalue().splitlines()
               if line.startswith("{")]
    for rec in records:
        print("cli:", json.dumps(rec))
    assert len(records) == 6, log_text.getvalue()
    assert all("advect_clamped" in rec for rec in records)
    for name, n in ocean_launches.items():
        assert n > 0, f"{name} was never launched on the ocean path"
    for f in (u, v, p, d):
        assert f.shape == (H, W) and bool(torch.isfinite(f).all())
    u_ref, v_ref = u0, v0
    with plain_twins():
        t0 = time.perf_counter()
        for _ in range(5):
            u_ref, v_ref, _, _ = ocean.ocean_step(u_ref, v_ref, terrain,
                                                  grid, cfg)
        torch.cuda.synchronize()
        plain_step_ms = (time.perf_counter() - t0) * 1e3 / 5
    scale = float(u_ref.abs().max())
    err = max(max_err(u, u_ref), max_err(v, v_ref))
    print(f"5 ocean steps: kernel path {step_ms:.2f} ms/step, plain twins "
          f"{plain_step_ms:.2f} ms/step ({card}); max|u| {scale:.4g}, "
          f"kernel vs plain err/max {err / scale:.3e}")
    assert scale > 0 and err <= 1e-5 * scale, (err, scale)
    print(f"launches on the ocean path: {ocean_launches}")

    # -- 5. the coupled step's kernels against their twins at 2048x1024 ---
    ccfg = model.CoupledConfig()
    with plain_twins():
        state = model.coupled_step(model.init_coupled(terrain, grid), grid,
                                   ccfg)
    torch.cuda.synchronize()
    h = state.height
    print(f"coupled inputs after 1 plain step: land "
          f"{float((h > 0).float().mean()):.3f}, max|h| "
          f"{float(h.abs().max()):.4g}, mean T "
          f"{float(state.temperature.mean()):.4g}, t_index "
          f"{float(state.t_index):g}")

    T = state.temperature
    asr = temperature.insolation_table(grid, state.t_index, 10, 0.30)
    cinv = (temperature.YEAR_SECONDS / temperature.SUBSTEPS_PER_YEAR
            / temperature.heat_capacity(h)).contiguous()
    got = kc.climate_step_cuda(T, cinv, asr, grid, 0.55e6)
    want = kc.climate_step_plain(T, cinv, asr, grid, 0.55e6)
    torch.cuda.synchronize()
    err, scale = max_err(got, want), float(want.abs().max())
    assert bool(torch.isfinite(got).all()) and err <= 1e-6 * scale, err
    ms = cuda_ms(lambda: kc.climate_step_cuda(T, cinv, asr, grid, 0.55e6),
                 20)
    plain_ms = cuda_ms(
        lambda: kc.climate_step_plain(T, cinv, asr, grid, 0.55e6), 3)
    record("climate", "demiurge_tpu_torch/csrc/climate.cu",
           "demiurge_tpu/pallas_kernels/climate.py:132", err, ms, plain_ms,
           3 * plane, 10 * 14 * N,
           "10 substeps, exact expected (bound 1e-6 of max|T|)")

    rlist = ob.sigma_list(ccfg.flow_preblur)
    got = kb.blur_cuda(h, grid, rlist)
    want = kb.blur_plain(h, grid, rlist)
    torch.cuda.synchronize()
    err, scale = max_err(got, want), float(want.abs().max())
    assert err <= 1e-6 * scale, err
    ms = cuda_ms(lambda: kb.blur_cuda(h, grid, rlist), 20)
    plain_ms = cuda_ms(lambda: kb.blur_plain(h, grid, rlist), 3)
    record("blur", "demiurge_tpu_torch/csrc/blur.cu",
           "demiurge_tpu/pallas_kernels/blur.py:135", err, ms, plain_ms,
           2 * plane, len(rlist) * 62 * N,
           f"radius {ccfg.flow_preblur}: {len(rlist)} iterations, exact "
           f"expected (bound 1e-6 of max|h|)")

    hb = want
    sel = state.sel
    got = kd.flow_directions_cuda(hb, sel, grid)
    want = kd.flow_directions_plain(hb, sel, grid)
    torch.cuda.synchronize()
    ties = int((got != want).sum())
    err = max_err(got, want)
    assert ties <= N // 10000, ties
    ms = cuda_ms(lambda: kd.flow_directions_cuda(hb, sel, grid), 20)
    plain_ms = cuda_ms(lambda: kd.flow_directions_plain(hb, sel, grid), 3)
    record("flow_directions", "demiurge_tpu_torch/csrc/directions.cu",
           "demiurge_tpu/pallas_kernels/directions.py:152", err, ms,
           plain_ms, 3 * plane, 90 * N,
           f"{ties} ties of {N} pixels (bound 1 per 10^4)")

    code = want
    _, mouth, _ = of.incoming_mask(code, grid)
    area = of.cell_area_lower_edge(grid, dev)
    packed = kf.pack_masks(code, mouth, grid)
    edges = float(sum(((packed >> i) & 1).sum() for i in range(8)))
    warm = state.flow_acc  # the fixpoint of the previous terrain
    solves = {}
    for label, a0 in (("cold", torch.zeros_like(area)), ("warm", warm)):
        got = kf.flow_solve_area_cuda(packed, area, grid, a0)
        stats = dict(kf.LAST_SOLVE["A"])
        want = kf.flow_solve_area_plain(packed, area, grid, a0)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (label, max_err(got, want))
        k_ms = cuda_ms(lambda: kf.flow_solve_area_cuda(packed, area, grid,
                                                       a0), 3)
        p_ms = cuda_ms(lambda: kf.flow_solve_area_plain(packed, area, grid,
                                                        a0), 1)
        solves[label] = (k_ms, p_ms, stats)
        print(f"  flow A {label}: bit-exact; {stats['sweeps']} sweeps to "
              f"the certifying one, {stats['launched']} launched, "
              f"{stats['host_reads']} host reads; kernel {k_ms:.3f} ms, "
              f"plain {p_ms:.3f} ms ({card})")
    k_ms, p_ms, _ = solves["warm"]
    record("flow_solve", "demiurge_tpu_torch/csrc/flow.cu",
           "demiurge_tpu/pallas_kernels/flow.py:294", 0.0, k_ms, p_ms,
           4 * plane, edges + N,
           "A bit-exact cold and warm; time of the warm solve (a step "
           "after the first)")

    got = kf.vis_solve_cuda(packed, grid)
    stats = dict(kf.LAST_SOLVE["vis"])
    want = kf.vis_solve_plain(packed, grid)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    ms = cuda_ms(lambda: kf.vis_solve_cuda(packed, grid), 3)
    plain_ms = cuda_ms(lambda: kf.vis_solve_plain(packed, grid), 1)
    print(f"  vis: exact; {stats['sweeps']} sweeps, {stats['launched']} "
          f"launched, {stats['host_reads']} host reads; reachable "
          f"{float(got.float().mean()):.3f}")
    record("flow_vis", "demiurge_tpu_torch/csrc/flow.cu",
           "demiurge_tpu/pallas_kernels/visbits.py:102", 0.0, ms, plain_ms,
           plane + N, edges, "vis exact (K8; also serves K9)")

    # -- 6. the coupled path, counted ----------------------------------------
    def climate_unstable(g) -> bool:
        """Whether the reference's explicit substep is unstable on land at
        this grid: the corner-tap stencil's worst mode grows by
        |1 - 16 a| per substep, a = D * dt / C_land, so it needs a <= 1/8
        (a depends on the row spacing dy alone)."""
        a = kc.diff_scale(g, 0.55e6) * (temperature.YEAR_SECONDS
                                        / temperature.SUBSTEPS_PER_YEAR
                                        / 1.5e7)
        print(f"  climate stability at {g.width}x{g.height}: a = {a:.4f}, "
              f"worst growth per substep {abs(1 - 16 * a):.3f}")
        return 16 * a > 2

    zero_counts()
    log_text = io.StringIO()
    with contextlib.redirect_stderr(log_text):
        cli.main(["coupled", "--width", str(W), "--height", str(H),
                  "--steps", "3"])
        big = cli.main(["coupled", "--steps", "1"])
        clim = cli.main(["climate", "--steps", "500"])
    torch.cuda.synchronize()
    launches = read_counts(single_card)
    records = [json.loads(line) for line in log_text.getvalue().splitlines()
               if line.startswith("{")]
    for rec in records:
        print("cli:", json.dumps(rec))
    print(f"launches on the coupled path: {launches}")
    for name, n in launches.items():
        assert n > 0, f"{name} was never launched on the coupled path"
    assert len(records) == 3 + 1 + 2, log_text.getvalue()
    assert not climate_unstable(grid)
    for rec in records[:4]:
        for key, val in rec.items():
            assert isinstance(val, (int, float)) and val == val, rec
    big_grid = Grid(*BIG)
    for f in dataclasses.fields(big):
        x = getattr(big, f.name)
        assert bool(torch.isfinite(x).all()), f.name
        if x.dim() == 2:
            assert tuple(x.shape) == big_grid.shape, f.name
    # the climate CLI: its grid is past the reference's stability bound on
    # land (so the reference diverges there too); the kernel path is held
    # to the plain twins through the same 500 substeps, NaNs included
    clim_grid = Grid(*CLIMATE)
    T = clim["temperature"]
    assert tuple(T.shape) == clim_grid.shape
    assert float(clim["t_index"]) == 500.0
    with plain_twins(), contextlib.redirect_stderr(io.StringIO()):
        T_ref = cli.main(["climate", "--steps", "500"])["temperature"]
    same = torch.equal(torch.isnan(T), torch.isnan(T_ref)) and torch.equal(
        torch.nan_to_num(T, nan=0.0), torch.nan_to_num(T_ref, nan=0.0))
    finite = float(torch.isfinite(T).float().mean())
    print(f"  climate CLI {CLIMATE[0]}x{CLIMATE[1]}, 500 substeps: finite "
          f"share {finite:.4f}; kernel path equals the plain twins: {same}")
    assert same
    assert finite == 1.0 or climate_unstable(clim_grid)
    del big, clim, T, T_ref
    torch.cuda.empty_cache()

    # -- 7. five coupled steps, kernels against twins; the step profile ----
    start = model.init_coupled(terrain, grid)
    s = start
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    heights = []
    for _ in range(5):
        heights.append(s.height)
        s = model.coupled_step(s, grid, ccfg)
    torch.cuda.synchronize()
    coupled_ms = (time.perf_counter() - t0) * 1e3 / 5
    ref = start
    with plain_twins():
        t0 = time.perf_counter()
        for _ in range(5):
            ref = model.coupled_step(ref, grid, ccfg)
        torch.cuda.synchronize()
        plain_coupled_ms = (time.perf_counter() - t0) * 1e3 / 5
    step_ties = []
    for hh in heights:
        hbk = kb.blur_cuda(hh, grid, rlist)
        step_ties.append(int((kd.flow_directions_cuda(hbk, sel, grid)
                              != kd.flow_directions_plain(hbk, sel, grid))
                             .sum()))
    for name in ("u", "v", "temperature"):
        a, b = getattr(s, name), getattr(ref, name)
        e, m = max_err(a, b), float(b.abs().max())
        print(f"  5 coupled steps, {name}: kernel vs plain err/max "
              f"{e / m:.3e}")
        assert bool(torch.isfinite(a).all()) and e <= 1e-5 * m, (name, e, m)
    dh = (s.height - ref.height).abs() / ref.height.abs().max()
    share = float((dh > 1e-5).float().mean())
    print(f"  5 coupled steps, height: err/max {float(dh.max()):.3e}, "
          f"share beyond 1e-5 of max {share:.3e} (bound 1e-3); direction "
          f"ties per step {step_ties}")
    assert bool(torch.isfinite(s.height).all()) and share <= 1e-3
    print(f"coupled step at {W}x{H}: kernel path {coupled_ms:.2f} ms/step, "
          f"plain twins {plain_coupled_ms:.2f} ms/step (5 steps each, host "
          f"clock, {card})")

    def staged_step(st, mark):
        """coupled_step written out stage by stage, ``mark(name)`` after
        each stage."""
        T, ti = temperature.temperature_step(st.temperature, st.height,
                                             st.t_index, grid,
                                             ccfg.climate_substeps)
        mark("climate (10 substeps)")
        oc = ccfg.ocean
        uu, vv = ocean.advect(st.u, st.v, st.height, grid, oc)
        mark("ocean advect")
        uu, vv = ocean.diffusion(uu, vv, st.height, grid, oc)
        mark("ocean viscosity (50 sweeps)")
        dv = ocean.divergence(uu, vv, st.height, grid, oc)
        mark("ocean divergence")
        pp = ocean.pressure_solve(dv, st.height, grid, oc)
        mark("ocean pressure (200 sweeps)")
        uu, vv = ocean.project(uu, vv, pp, st.height, grid, oc)
        mark("ocean projection")
        hbs = ob.blur(st.height, grid, ccfg.flow_preblur)
        mark("flow pre-blur")
        cd = of.flow_directions(hbs, st.sel, grid)
        mark("flow directions")
        _, mo, _ = of.incoming_mask(cd, grid)
        ar = of.cell_area_lower_edge(grid, dev)
        pk = kf.pack_masks(cd, mo, grid)
        mark("flow masks")
        acc = kf.flow_solve_area(pk, ar, grid, a0=st.flow_acc)
        mark("flow A fixpoint")
        vis = kf.vis_solve(pk, grid)
        mark("flow vis fixpoint")
        fm = torch.where(vis, torch.pow(acc, ccfg.flow_exponent), -1.0)
        hh = erosion.erosion_pass(st.height, fm, st.uplift, grid,
                                  ccfg.erosion_factor,
                                  ccfg.erosion_slope_exponent)
        mark("flow map + erosion")
        return model.CoupledState(height=hh, uplift=st.uplift, sel=st.sel,
                                  u=uu, v=vv, temperature=T, t_index=ti,
                                  flow_acc=acc)

    prev = model.coupled_step(start, grid, ccfg)  # a warm flow_acc
    want = model.coupled_step(prev, grid, ccfg)
    events = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((name, ev))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mark("start")
    got = staged_step(prev, mark)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    for name in ("height", "u", "v", "temperature", "flow_acc"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    rows = [(name, events[i][1].elapsed_time(ev))
            for i, (name, ev) in enumerate(events[1:])]
    total = events[0][1].elapsed_time(events[-1][1])
    print(f"profile of one warm coupled step at {W}x{H} (CUDA events on the "
          f"stream; device-timeline ms, gaps included; {card}):")
    for name, t in rows:
        print(f"  {name:32s} {t:9.3f} ms  {100 * t / total:5.1f}%")
    print(f"  {'sum of rows':32s} {sum(t for _, t in rows):9.3f} ms; "
          f"first-to-last event {total:.3f} ms; host clock {host_ms:.3f} ms")

    # -- 8. the sharded path on a 1x1 mesh (NCCL, world size 1) -----------
    import torch.distributed as tdist

    from demiurge_tpu_torch.dist import mesh as dmesh
    from demiurge_tpu_torch.dist.flowdist import (_pick_dist_band,
                                                  flow_solve_sharded_twolevel)
    from demiurge_tpu_torch.dist.halo import flow_solve_sharded

    mdev = dmesh.initialize(DEVICE)
    mesh = dmesh.make_mesh(shape=(1, 1), device=mdev)
    print(f"mesh {mesh.ny}x{mesh.nx} on {mdev}: backend "
          f"{tdist.get_backend()}, world size {tdist.get_world_size()}")

    # K10a / K10b on the coupled path's packed masks (phase 5)
    band = _pick_dist_band(H // mesh.size)
    ploc = k2.mask_local(packed, band)
    local_edges = float(sum(((ploc >> i) & 1).sum() for i in range(8)))
    got_A, got_E = k2.flow_local_solve_cuda(ploc, area, area, band)
    stats = dict(k2.LAST_SOLVE["A"])
    want_A, want_E = k2.flow_local_solve_plain(ploc, area, area, band)
    torch.cuda.synchronize()
    assert torch.equal(got_A, want_A) and torch.equal(got_E, want_E)
    k_ms = cuda_ms(lambda: k2.flow_local_solve_cuda(ploc, area, area, band),
                   3)
    p_ms = cuda_ms(lambda: k2.flow_local_solve_plain(ploc, area, area, band),
                   1)
    record("flow_local_solve", "demiurge_tpu_torch/csrc/flow.cu",
           "demiurge_tpu/pallas_kernels/flow2.py:150", 0.0, k_ms, p_ms,
           5 * plane, local_edges + N,
           f"band {band}: A and exit ids bit-exact; {stats['sweeps']} "
           f"sweeps, {stats['launched']} launched, {stats['host_reads']} "
           f"host reads; {int((got_E >= 0).sum())} cells exit their band")
    del want_A, want_E

    seed = torch.zeros_like(area)
    seed[band - 1::band, ::7] = 1.0    # last rows of the bands
    seed[band::band, 3::11] = 1.0      # first rows of the next bands
    vis_notes = []
    for label, s_ in (("zero seed", torch.zeros_like(area)),
                      ("seeded", seed)):
        got = k2.flow_local_vis_cuda(ploc, s_, band)
        st_ = dict(k2.LAST_SOLVE["vis"])
        want = k2.flow_local_vis_plain(ploc, s_, band)
        torch.cuda.synchronize()
        assert torch.equal(got, want), label
        vis_notes.append(f"{label}: {st_['sweeps']} sweeps, "
                         f"{st_['launched']} launched, reachable "
                         f"{float(got.mean()):.3f}")
    ms = cuda_ms(lambda: k2.flow_local_vis_cuda(ploc, seed, band), 3)
    plain_ms = cuda_ms(lambda: k2.flow_local_vis_plain(ploc, seed, band), 1)
    out_edges = float((((ploc >> 8) & 0xFF) != 0).sum())
    record("flow_local_vis", "demiurge_tpu_torch/csrc/flow.cu",
           "demiurge_tpu/pallas_kernels/flow2.py:331", 0.0, ms, plain_ms,
           3 * plane, out_edges,
           "vis exact; " + "; ".join(vis_notes) + " (time: seeded)")

    # flow_solve_twolevel against K7, both from the codes (masks packed)
    def twolevel_against_k7(g, code_, mouth_):
        ar = of.cell_area_lower_edge(g, dev)
        want = kf.flow_solve_area_cuda(kf.pack_masks(code_, mouth_, g), ar, g)
        k7_stats = dict(kf.LAST_SOLVE["A"])
        before = k2.LAUNCHES_LOCAL
        got = k2.flow_solve_twolevel(code_, ar, mouth_, g)
        resolve = dict(k2.LAST_SOLVE["A"])
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)
        print(f"  at {g.width}x{g.height}: K7 {k7_stats['sweeps']} sweeps, "
              f"{k7_stats['launched']} launched; two-level: K10a "
              f"{k2.LAUNCHES_LOCAL - before} launched in its two solves, "
              f"the re-solve {resolve['sweeps']} sweeps")
        t_two = cuda_ms(lambda: k2.flow_solve_twolevel(code_, ar, mouth_, g),
                        3)
        t_k7 = cuda_ms(lambda: kf.flow_solve_area_cuda(
            kf.pack_masks(code_, mouth_, g), ar, g), 3)
        print(f"  flow_solve_twolevel at {g.width}x{g.height} (band "
              f"{k2.pick_band(g.height)}): within rtol 1e-5, atol 1e-7 of "
              f"K7; {t_two:.3f} ms against K7 {t_k7:.3f} ms (both with "
              f"pack_masks; {card})")
        return t_two, t_k7

    twolevel_ms = {"2048x1024": twolevel_against_k7(grid, code, mouth)}
    big_grid = Grid(*BIG)
    hb_big = ob.blur(cli._terrain(big_grid, SEED, dev), big_grid,
                     ccfg.flow_preblur)
    code_big = of.flow_directions(hb_big, torch.ones_like(hb_big), big_grid)
    _, mouth_big, _ = of.incoming_mask(code_big, big_grid)
    twolevel_ms["8192x4096"] = twolevel_against_k7(big_grid, code_big,
                                                   mouth_big)
    del hb_big, code_big, mouth_big
    torch.cuda.empty_cache()

    # both sharded flow solves on the mesh against K7 and K8
    A7 = kf.flow_solve_area_cuda(packed, area, grid)
    vis8 = kf.vis_solve_cuda(packed, grid)
    sharded_flow_ms = {}
    for fname, fn in (("flow_solve_sharded_twolevel",
                       flow_solve_sharded_twolevel),
                      ("flow_solve_sharded", flow_solve_sharded)):
        A_s, vis_s = fn(code, area, mouth, grid, mesh)
        torch.cuda.synchronize()
        torch.testing.assert_close(A_s, A7, rtol=1e-5, atol=1e-7)
        assert torch.equal(vis_s, vis8), fname
        sharded_flow_ms[fname] = cuda_ms(
            lambda: fn(code, area, mouth, grid, mesh), 1)
        print(f"  {fname} on the 1x1 mesh: A within rtol 1e-5, atol 1e-7 "
              f"of K7, vis equal to K8; {sharded_flow_ms[fname]:.3f} ms "
              f"({card})")

    # the mesh path, counted: 3 coupled steps on the 1x1 mesh
    s_mesh = model.init_coupled(terrain, grid, mesh=mesh)
    s_one = model.init_coupled(terrain, grid)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    for _ in range(3):
        s_mesh = model.coupled_step(s_mesh, grid, ccfg, mesh=mesh)
    torch.cuda.synchronize()
    mesh_step_ms = (time.perf_counter() - t0) * 1e3 / 3
    mesh_launches = read_counts(list(counters))
    print(f"launches on the mesh path (3 steps): {mesh_launches}")
    for name in ("blur", "flow_directions", "flow_local_solve",
                 "flow_local_vis"):
        assert mesh_launches[name] > 0, f"{name} never launched on the mesh"
    t0 = time.perf_counter()
    for _ in range(3):
        s_one = model.coupled_step(s_one, grid, ccfg)
    torch.cuda.synchronize()
    one_step_ms = (time.perf_counter() - t0) * 1e3 / 3
    mesh_bounds = {"height": (1e-5, 1e-6), "temperature": (1e-5, 1e-4),
                   "u": (1e-5, 1e-6), "v": (1e-5, 1e-6)}

    def hold_to_single(got_state, want_state, what):
        for name, (rtol, atol) in mesh_bounds.items():
            a, b = getattr(got_state, name), getattr(want_state, name)
            assert a.shape == (H, W) and bool(torch.isfinite(a).all()), name
            torch.testing.assert_close(a, b, rtol=rtol, atol=atol,
                                       msg=lambda m: f"{what} {name}: {m}")
            print(f"  {what}, {name}: max abs err {max_err(a, b):.3e} "
                  f"(rtol {rtol}, atol {atol})")

    hold_to_single(s_mesh, s_one, "3 mesh steps against 3 single-card")
    assert float(s_mesh.t_index) == float(s_one.t_index)
    print(f"coupled step at {W}x{H} on the 1x1 mesh: {mesh_step_ms:.2f} "
          f"ms/step; on one card without a mesh {one_step_ms:.2f} ms/step "
          f"(3 steps each, host clock, {card})")

    def staged_mesh_step(st, mark):
        """coupled_step(mesh=...) written out stage by stage."""
        def sc(fn):
            return dmesh.sharded_call(fn, mesh)

        T_, ti = temperature.temperature_step(
            st.temperature, st.height, st.t_index, grid,
            ccfg.climate_substeps, mesh=mesh)
        mark("climate (row groups, 10 substeps; torch)")
        oc = ccfg.ocean
        uu, vv = ocean.advect(st.u, st.v, st.height, grid, oc, mesh=mesh)
        mark("ocean advect (sampler on blocks; torch)")
        uu, vv = ocean.diffusion(uu, vv, st.height, grid, oc, mesh=mesh)
        mark("ocean viscosity (halo rounds, 50 sweeps; torch)")
        dv = sc(ocean.divergence)(uu, vv, st.height, grid, oc)
        mark("ocean divergence (sharded_call)")
        pp = ocean.pressure_solve(dv, st.height, grid, oc, mesh=mesh)
        mark("ocean pressure (halo rounds, 200 sweeps; torch)")
        uu, vv = sc(ocean.project)(uu, vv, pp, st.height, grid, oc)
        mark("ocean projection (sharded_call)")
        cd, mo = sc(of._codes_and_mouths)(st.height, st.sel, grid,
                                          ccfg.flow_preblur)
        mark("flow blur, directions, mouths (sharded_call; K5, K6)")
        ar = dmesh.local_part(of.cell_area_lower_edge(grid, dev), grid.shape,
                              mesh)
        acc, vis = flow_solve_sharded_twolevel(cd, ar, mo, grid, mesh)
        mark("flow two-level solve (K10a x2, K10b x2, coarse graph)")
        fm = torch.where(vis, torch.pow(acc, ccfg.flow_exponent), -1.0)
        hh = sc(erosion.erosion_pass)(st.height, fm, st.uplift, grid,
                                      ccfg.erosion_factor,
                                      ccfg.erosion_slope_exponent)
        mark("flow map + erosion (sharded_call)")
        return model.CoupledState(height=hh, uplift=st.uplift, sel=st.sel,
                                  u=uu, v=vv, temperature=T_, t_index=ti,
                                  flow_acc=acc)

    want = model.coupled_step(s_mesh, grid, ccfg, mesh=mesh)
    events.clear()
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    mark("start")
    got = staged_mesh_step(s_mesh, mark)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    step_launches = read_counts(["flow_local_solve", "flow_local_vis"])
    # the coarse graph's scatter-adds run in atomics: the two runs may
    # round the chain sums apart
    hold_to_single(got, want, "the staged mesh step against coupled_step")
    rows = [(name, events[i][1].elapsed_time(ev))
            for i, (name, ev) in enumerate(events[1:])]
    total = events[0][1].elapsed_time(events[-1][1])
    print(f"profile of one coupled step on the 1x1 mesh at {W}x{H} (CUDA "
          f"events; device-timeline ms, gaps included; {card}):")
    for name, t in rows:
        print(f"  {name:56s} {t:9.3f} ms  {100 * t / total:5.1f}%")
    print(f"  {'sum of rows':56s} {sum(t for _, t in rows):9.3f} ms; "
          f"first-to-last event {total:.3f} ms; host clock {host_ms:.3f} ms;"
          f" K10 launches in the step {step_launches}")
    del s_mesh, s_one, want, got
    tdist.destroy_process_group()

    # the CLI under torch.distributed.run, one process on this card
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "1", "-m", "demiurge_tpu_torch.api.cli",
           "coupled", "--mesh", "1x1", "--width", str(W), "--height", str(H),
           "--steps", "2"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    assert run.returncode == 0, (run.returncode, run.stderr[-4000:])

    def json_lines(text):
        out = []
        for line in text.splitlines():
            i = line.find("{")
            if i >= 0:
                with contextlib.suppress(ValueError):
                    out.append(json.loads(line[i:]))
        return out

    logs = [r for r in json_lines(run.stderr) if "step" in r]
    (cli_launches,) = [r["kernel_launches"] for r in json_lines(run.stdout)
                       if "kernel_launches" in r]
    for rec in logs:
        print("cli --mesh 1x1:", json.dumps(rec))
    print(f"cli --mesh 1x1 launches: {cli_launches} ({cli_s:.1f} s with "
          f"start-up)")
    assert [r["step"] for r in logs] == [0, 1], run.stderr[-4000:]
    for rec in logs:
        for key, val in rec.items():
            assert isinstance(val, (int, float)) and val == val, rec
    assert cli_launches["flow_local_solve"] > 0
    assert cli_launches["flow_local_vis"] > 0

    # -- 9. results ----------------------------------------------------------
    main_launches = {**launches, **{n: mesh_launches[n] for n in counters
                                    if n not in single_card}}
    for k in kernels:
        k["launches"] = main_launches[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

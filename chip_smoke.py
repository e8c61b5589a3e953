#!/usr/bin/env python3
"""Smoke run of the PyTorch port (demiurge_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit), torch and CUDA;
2. builds the CUDA kernels from csrc/ (nvcc, sm_90a) and prints the time;
3. at 2048x1024 (the ocean CLI's terrain: fBm, 8 octaves, seed 7, and a
   (u, v) after one ocean step through the plain twins) holds each kernel
   against its plain PyTorch twin on the card and times both with CUDA
   events: pressure Jacobi (200 and 1000 sweeps, within 1e-4 of max|p|),
   viscosity Jacobi (50 sweeps, within 2e-5 of max|u|), the tiered advect
   sampler (atol 1e-5);
4. drives the main path with every launch counter at 0: the port's
   ``ocean`` CLI (1 step at its default --jacobi 1000, then 5 steps at
   --jacobi 200) and 5 ``ocean_step``s at the coupled model's solver depths
   (jacobi 200, diffusion 50); fails unless every kernel launched, the
   fields are finite, the CLI logged ``advect_clamped``, and the kernel
   path's (u, v) match the same 5 steps through the plain twins;
5. prints the kernels' JSON line, the card line and, last, the result line
   ``{"ok": true, "device": {...}}``.

Any failure raises and the exit code is non-zero.  Without a card, or
without the package beside this script, it exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import io
import json
import pathlib
import subprocess
import sys
import time
from unittest import mock

import torch

REPO = pathlib.Path(__file__).resolve().parent
W, H = 2048, 1024
SEED = 7


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
    return float((a - b).abs().max())


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

    from demiurge_tpu_torch.api import cli
    from demiurge_tpu_torch.core.grid import Grid
    from demiurge_tpu_torch.kernels import advect as ka
    from demiurge_tpu_torch.kernels import build
    from demiurge_tpu_torch.kernels import jacobi as kj
    from demiurge_tpu_torch.ops import ocean

    # -- 1. setup ------------------------------------------------------------
    card = card_line()
    dev = torch.device("cuda")
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path, log, nvcc_s = build.build()
    build.library()
    print(f"built {lib_path.name}: nvcc {nvcc_s:.1f} s, "
          f"build+load {time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    @contextlib.contextmanager
    def plain_twins():
        """The ocean op with every kernel swapped for its plain twin."""
        with mock.patch.object(kj, "pressure_solve", kj.pressure_solve_plain), \
                mock.patch.object(kj, "diffusion_solve",
                                  kj.diffusion_solve_plain), \
                mock.patch.object(ka, "advect_sample",
                                  ka.advect_sample_tiered_plain):
            yield

    # -- 3. each kernel against its twin at 2048x1024 ---------------------
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

    kernels = []

    def record(name, source, replaces, err, ms, plain_ms, note):
        print(f"{name}: {note}; max_abs_err {err:.3e}; kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms ({card})")
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms})

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
           "real clamped (dx, dy), atol 1e-5")

    # -- 4. the main path, counted ------------------------------------------
    kj.PRESSURE_LAUNCHES = kj.DIFFUSION_LAUNCHES = ka.LAUNCHES = 0
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
    launches = {"jacobi_pressure": kj.PRESSURE_LAUNCHES,
                "jacobi_diffusion": kj.DIFFUSION_LAUNCHES,
                "advect_sample_tiered": ka.LAUNCHES}

    records = [json.loads(line) for line in log_text.getvalue().splitlines()
               if line.startswith("{")]
    for rec in records:
        print("cli:", json.dumps(rec))
    assert len(records) == 6, log_text.getvalue()
    assert all("advect_clamped" in rec for rec in records)
    for name, n in launches.items():
        assert n > 0, f"{name} was never launched on the main path"
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
    print(f"launches on the main path: {launches}")

    # -- 5. results ----------------------------------------------------------
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
